"""The bytes of encodings the program copied back (its ``d2h_bytes``
counter) over the device-to-host copy time launched inside its
``readback`` spans: the rate the encodings come down at."""
from benchmark.program import program
from benchmark.readers import Context


def read(ctx: Context):
    back = program(ctx, "readback")
    if ctx.kind != "closed" or back is None or not getattr(ctx, "counters", None):
        return None
    t = back["memcpy_s"]["DtoH"]
    return ctx.counters.get("d2h_bytes", 0) / t / 1e9 if t > 0 else None
