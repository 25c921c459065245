"""step_mfu.live: the FLOPs the window's describe and detect steps need
(the net's FLOPs per real frame, counted from its shapes, and 2 Q N D per
detect, N the DB rows filled) over those steps' wall time (traced: each
ends in a device sync), as a share of 989 TFLOP/s (H100 SXM, bf16, dense)."""

from portbench.readers import step_flops, window_calls
from portbench.yardstick import BF16_FLOPS


def read(ctx):
    if ctx.run.trace is None:
        return None
    det = window_calls(ctx, "detect")
    desc = window_calls(ctx, "describe")
    t = sum(c[1] - c[0] for c in det + desc)
    return 100.0 * step_flops(ctx, det) / t / BF16_FLOPS if det and t > 0 else None
