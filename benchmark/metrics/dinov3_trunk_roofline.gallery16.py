"""The DINOv3 trunk's least time (``dinov3_roofline.trunk_least_s``: each op
at the bf16 peak or by its bytes) for the images encoded in the traced
window, over the device time launched inside the ``features`` range (the
extractor's ``extract_batch``: the resize and the trunk)."""
from benchmark import dinov3_roofline, roofline
from benchmark.readers import Context, device_s


def read(ctx: Context):
    if ctx.kind != "closed" or "dinov3" not in ctx.cfg or ctx.items == 0:
        return None
    return roofline.share_pct(dinov3_roofline.trunk_least_s(ctx.cfg) * ctx.items,
                              device_s(ctx, "features"))
