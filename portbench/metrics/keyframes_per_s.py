"""keyframes_per_s: keyframes fully processed in the window (ingested,
described, detected, every candidate they raised decided, the solves due
among them done) over the window's host-clock seconds."""


def read(ctx):
    run = ctx.run
    return run.keyframes_done / run.window_s if run.keyframes_done and run.window_s > 0 else None
