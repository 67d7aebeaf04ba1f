"""The gallery step's share of the card's peak: the least time of the
features (``roofline.features_least_s``: the trunk's convs at their stated
routes' peaks, or the SIFT scale space) and of VLAD at the window's shapes,
for every image encoded in the traced window, over the window."""
from benchmark import roofline
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "closed" or ctx.items == 0:
        return None
    cfg = ctx.cfg
    least = roofline.features_least_s(cfg) * ctx.items + roofline.vlad_least_s(
        ctx.items, ctx.rows // ctx.items, ctx.valid_rows, cfg["descriptor_dim"], cfg["vlad"]["k"])
    return roofline.share_pct(least, ctx.trace["window_s"])
