"""The exact scan's least time (every gallery row read once, and the
query, at the HBM rate) for each query served, over the device time
launched inside the ``search`` range (the index's ``query_vectors``)."""
from benchmark import roofline
from benchmark.readers import Context, device_s


def read(ctx: Context):
    if ctx.kind != "open" or ctx.items == 0:
        return None
    least = roofline.scan_least_s(ctx.cfg["index"]["rows"], ctx.cfg["encoding_dim"]) * ctx.items
    return roofline.share_pct(least, device_s(ctx, "search"))
