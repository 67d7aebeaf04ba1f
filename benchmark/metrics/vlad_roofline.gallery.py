"""VLAD's least time at the window's shapes (``roofline.vlad_least_s``, the
weighted rows alone assigned and summed), over the device time launched
inside ``encode`` and outside ``features``: the aggregation kernel, the
casts and the normalisation."""
from benchmark import roofline
from benchmark.readers import Context, device_s


def read(ctx: Context):
    if ctx.kind != "closed" or ctx.items == 0:
        return None
    cfg = ctx.cfg
    least = roofline.vlad_least_s(ctx.items, ctx.rows // ctx.items, ctx.valid_rows,
                                  cfg["descriptor_dim"], cfg["vlad"]["k"])
    return roofline.share_pct(least, device_s(ctx, "encode") - device_s(ctx, "features"))
