"""step_mfu.relocalize: the FLOPs of the window's completed work (describe
and detect as in step_mfu.live, plus K3's fewest operations for every
launch in the window) over the window's seconds, as a share of 989 TFLOP/s
(H100 SXM, bf16, dense)."""

from portbench.readers import step_flops, window_calls
from portbench.yardstick import BF16_FLOPS, k3_ops


def read(ctx):
    run = ctx.run
    if run.trace is None or run.window_s <= 0:
        return None
    det = window_calls(ctx, "detect")
    k3 = sum(k3_ops(*a) for t, a in run.spans.launches.get("K3", [])
             if run.window_t0 <= t <= run.window_t1)
    return 100.0 * (step_flops(ctx, det) + k3) / run.window_s / BF16_FLOPS if det else None
