"""The DINOv3 gallery step's share of the card's peak: the least time of the
trunk (``dinov3_roofline.trunk_least_s``) and of VLAD at the window's
shapes (``roofline.vlad_least_s``), for every image encoded in the traced
window, over the window."""
from benchmark import dinov3_roofline, roofline
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "closed" or "dinov3" not in ctx.cfg or ctx.items == 0:
        return None
    cfg = ctx.cfg
    least = dinov3_roofline.trunk_least_s(cfg) * ctx.items + roofline.vlad_least_s(
        ctx.items, ctx.rows // ctx.items, ctx.valid_rows, cfg["descriptor_dim"], cfg["vlad"]["k"])
    return roofline.share_pct(least, ctx.trace["window_s"])
