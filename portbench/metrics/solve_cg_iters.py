"""solve_cg_iters: the conjugate-gradient iterations the program counted in
the window (``solve.cg_iters``) over the solves it ran there (its
``optimize`` stage). Needs the program's counters on the run
(``portbench/progtrace.py``); none without them."""

from portbench.progtrace import delta


def read(ctx):
    run = ctx.run
    d = delta(run, run.window_t0, run.window_t1)
    if d is None:
        return None
    counters, totals = d
    solves = totals.get("optimize", (0.0, 0))[1]
    return counters.get("solve.cg_iters", 0) / solves if solves else None
