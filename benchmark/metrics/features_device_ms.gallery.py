"""Device time launched inside the ``features`` range, per image encoded."""
from benchmark.readers import Context, device_s


def read(ctx: Context):
    if ctx.kind != "closed" or ctx.items == 0:
        return None
    return 1e3 * device_s(ctx, "features") / ctx.items
