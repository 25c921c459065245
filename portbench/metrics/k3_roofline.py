"""k3_roofline.<cells>: K3 (stereo block matching, one launch per verify group)
in the profiled slice: the fewest operations it needs (k3_ops) at the f32
peak, or its bytes at 3.35 TB/s, whichever is longer, over its device time."""

from portbench.readers import k3_bound, kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "K3", ("stereo_bm_kernel",), k3_bound)
