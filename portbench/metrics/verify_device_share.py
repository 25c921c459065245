"""verify_device_share.<cells>: the device's busy seconds (union) of the
kernels, copies and memsets launched inside the program's ``verify`` spans
in the profiled slice, over those spans' wall seconds in the slice, as a
share. A ``verify`` span is one verification call: a chunk of pairs at one
tier (its graph replays) or a depth pair (its stereo depth with it). The
host's work around the calls (fetching and stacking the images, emitting
the edges) lies outside them, so the share reads the calls' own overhead,
whichever mix of tiers the slice holds. Needs the program's tracer
(``portbench/progtrace.py``); none without it."""

from portbench.progtrace import program
from portbench.yardstick import union_seconds

SPAN = "verify"


def read(ctx):
    run = ctx.run
    tr, prog = run.trace, program(run)
    if tr is None or prog is None or "device_spans" not in tr:
        return None
    t0, t1 = run.trace_t
    busy, _ = union_seconds([(s, e) for (s, e, _), chain in zip(tr["device_events"], tr["device_spans"])
                             if SPAN in chain])
    wall, _ = union_seconds([(max(s["t0"], t0), min(s["t1"], t1))
                             for s in prog["spans"] if s["name"] == SPAN and s["t0"] < t1 and s["t1"] > t0])
    return 100.0 * busy / wall if wall > 0 else None
