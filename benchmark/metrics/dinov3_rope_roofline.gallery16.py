"""The RoPE kernel's share of its roofline: the least time of the forward's
rotations (``dinov3_roofline.rope_least_s``: the patch rows' bfloat16 q and
k read and written once a block, at 3.35 TB/s) for the images encoded in
the traced window, over the device time launched inside the ``rope`` range,
which the system opens around each block's rotation alone."""
from benchmark import dinov3_roofline, roofline
from benchmark.readers import Context, device_s


def read(ctx: Context):
    if ctx.kind != "closed" or "dinov3" not in ctx.cfg or ctx.items == 0:
        return None
    return roofline.share_pct(dinov3_roofline.rope_least_s(ctx.cfg) * ctx.items,
                              device_s(ctx, "rope"))
