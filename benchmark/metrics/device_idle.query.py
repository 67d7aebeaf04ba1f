"""The share of the traced window in which the card ran no kernel, memset
or copy: 1 - (union of their intervals) / window."""
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "open" or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
