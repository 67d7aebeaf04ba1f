"""The ResNet trunk's least time (``resnet_roofline.trunk_least_s``: each
conv at its route's peak or by its bytes) for the images encoded in the
traced window, over the device time launched inside the ``features``
range (the extractor's ``extract_batch``: the resize and the trunk)."""
from benchmark import resnet_roofline, roofline
from benchmark.readers import Context, device_s


def read(ctx: Context):
    if ctx.kind != "closed" or "resnet" not in ctx.cfg or ctx.items == 0:
        return None
    return roofline.share_pct(resnet_roofline.trunk_least_s(ctx.cfg) * ctx.items,
                              device_s(ctx, "features"))
