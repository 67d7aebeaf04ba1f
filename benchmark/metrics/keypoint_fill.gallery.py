"""The share of SIFT's keypoint slots that hold a valid keypoint over the
window (the program's ``sift.keypoints`` over its ``sift.slots``): the
rest of the fixed budget is padding that every later stage carries."""
from benchmark.readers import Context


def read(ctx: Context):
    counters = getattr(ctx, "counters", None)
    if ctx.kind != "closed" or not counters or not counters.get("sift.slots"):
        return None
    return 100.0 * counters.get("sift.keypoints", 0) / counters["sift.slots"]
