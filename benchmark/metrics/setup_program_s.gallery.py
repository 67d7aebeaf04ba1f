"""Host time of the program's outermost spans that closed before the
window (``init`` of the extractor and the encoder, ``load_kernels``, and
the warm-up's ``encode``): the program's share of ``setup_s``; the rest
is the harness's (imports, images, the vocabulary drawn through the
reference)."""
from benchmark.readers import Context


def read(ctx: Context):
    spans, window = getattr(ctx, "spans", None), getattr(ctx, "window_ns", None)
    if ctx.kind != "closed" or not spans or window is None:
        return None
    before = [s for s in spans
              if s.parent is None and s.end_ns is not None and s.end_ns <= window[0]]
    return sum(s.end_ns - s.start_ns for s in before) / 1e9 if before else None
