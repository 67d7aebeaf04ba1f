"""The bytes the program handed to the device (its ``h2d_bytes`` counter)
over the host-to-device copy time launched inside its ``ingest.upload``
spans: the rate the images go up at."""
from benchmark.program import program
from benchmark.readers import Context


def read(ctx: Context):
    upload = program(ctx, "ingest.upload")
    if ctx.kind != "closed" or upload is None or not getattr(ctx, "counters", None):
        return None
    t = upload["memcpy_s"]["HtoD"]
    return ctx.counters.get("h2d_bytes", 0) / t / 1e9 if t > 0 else None
