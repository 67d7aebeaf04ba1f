"""The attention kernel's share of its roofline in the DINOv3 trunk: the
least time of the forward's attention cores
(``dinov3_roofline.attention_least_s``: 4 N^2 D operations a block at the
bf16 peak, or q, k, v and the output moved once) for the images encoded in
the traced window, over the device time launched inside the ``attention``
range, which the system opens around each block's attention core alone."""
from benchmark import dinov3_roofline, roofline
from benchmark.readers import Context, device_s


def read(ctx: Context):
    if ctx.kind != "closed" or "dinov3" not in ctx.cfg or ctx.items == 0:
        return None
    return roofline.share_pct(dinov3_roofline.attention_least_s(ctx.cfg) * ctx.items,
                              device_s(ctx, "attention"))
