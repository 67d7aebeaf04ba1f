"""A query's share of the card's peak: the least time of one query's work
(its features, VLAD, and the exact scan's bytes at the HBM rate) over the
mean service time, from the call to its return, queue wait excluded."""
import numpy as np

from benchmark import roofline
from benchmark.readers import Context


def read(ctx: Context):
    if ctx.kind != "open" or ctx.items == 0:
        return None
    cfg = ctx.cfg
    per_query = (roofline.features_least_s(cfg)
                 + roofline.vlad_least_s(1, ctx.rows // ctx.items, ctx.valid_rows / ctx.items,
                                         cfg["descriptor_dim"], cfg["vlad"]["k"])
                 + roofline.scan_least_s(cfg["index"]["rows"], cfg["encoding_dim"]))
    return roofline.share_pct(per_query, float(np.nanmean(ctx.service_s)))
