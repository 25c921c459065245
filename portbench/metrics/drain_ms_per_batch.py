"""drain_ms_per_batch.<cells>: host milliseconds in the program's ``drain``
stage in the window (the read-back of detection results, which waits for
the queued device work, and the host gates after it) over the detection
batches it read back there. Needs the program's counters on the run
(``portbench/progtrace.py``); none without them."""

from portbench.progtrace import delta


def read(ctx):
    run = ctx.run
    d = delta(run, run.window_t0, run.window_t1)
    if d is None:
        return None
    counters, totals = d
    batches = counters.get("detections.read_back", 0)
    return 1e3 * totals.get("drain", (0.0, 0))[0] / batches if batches else None
