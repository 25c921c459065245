"""describe_mfu.<cells>: the describe net's FLOPs for the frames described
in the profiled slice (Δ``keyframes.described``, times the net module's
FLOPs a frame) over the device time of the operations launched under the
program's ``describe`` spans there, as a share of 989 TFLOP/s (H100 SXM,
bf16, dense)."""

from portbench.progtrace import delta
from portbench.yardstick import BF16_FLOPS


def read(ctx):
    run = ctx.run
    tr = run.trace
    d = delta(run, *run.trace_t) if tr is not None else None
    if d is None or "device_spans" not in tr:
        return None
    frames = d[0].get("keyframes.described", 0)
    dev_s = sum(e[1] - e[0] for e, chain in zip(tr["device_events"], tr["device_spans"])
                if "describe" in chain)
    if not frames or dev_s <= 0:
        return None
    return 100.0 * frames * ctx.describe_flops / dev_s / BF16_FLOPS
