"""Device time of the host-to-device and device-to-host copies, per image
encoded: the images going up, the encodings coming back."""
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "closed" or ctx.items == 0:
        return None
    m = ctx.trace["memcpy_s"]
    total = m["HtoD"] + m["DtoH"]
    return 1e3 * total / ctx.items if total > 0 else None
