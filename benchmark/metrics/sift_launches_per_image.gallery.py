"""Kernels launched inside the program's ``features`` spans per image
encoded, in a SIFT cell: the SIFT core's launches (and the keypoint
counter's two), which a CUDA graph or fused kernels would cut."""
from benchmark.program import program
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "closed" or ctx.cfg.get("system") != "rootsift" or ctx.items == 0:
        return None
    features = program(ctx, "features")
    return None if features is None else features["launches"] / ctx.items
