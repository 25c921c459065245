"""k2_roofline: K2 (one score_topk call per top-k query batch) in the
profiled slice, its least time (the filled DB rows it scans read once at 3.35
TB/s) over its device time."""

from portbench.readers import kernel_roofline, score_topk_bound


def read(ctx):
    return kernel_roofline(ctx, "K2", ("score_topk_partial", "score_topk_merge"), score_topk_bound)
