"""describe_share.<cells>: the share (%) of the window's host-clock seconds
spent in the program's ``describe`` stage (its StageTimer totals over the
window). In a traced run the stage waits for the device (``timer.sync``),
so it holds the net's device time; untraced, only its launches."""

from portbench.progtrace import delta


def read(ctx):
    run = ctx.run
    d = delta(run, run.window_t0, run.window_t1)
    if d is None or run.window_s <= 0:
        return None
    seconds, calls = d[1].get("describe", (0.0, 0))
    return 100.0 * seconds / run.window_s if calls else None
