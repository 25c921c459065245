"""solve_ms_per_cg_iter: host milliseconds in the program's ``solve.cg``
spans in the window over the conjugate-gradient iterations it counted there
(each iteration reads its stopping test back, so its time includes the
device's). Needs the program's tracer (``portbench/progtrace.py``); none
without it."""

from portbench.progtrace import delta


def read(ctx):
    run = ctx.run
    d = delta(run, run.window_t0, run.window_t1)
    if d is None:
        return None
    counters, totals = d
    iters = counters.get("solve.cg_iters", 0)
    cg_s, n = totals.get("solve.cg", (0.0, 0))
    return 1e3 * cg_s / iters if iters and n else None
