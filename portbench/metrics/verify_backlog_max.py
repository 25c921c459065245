"""verify_backlog_max: the most candidates waiting for verification, from
the 50 Hz samples of the pending queue through the window."""


def read(ctx):
    b = [n for _, n in ctx.run.backlog]
    return float(max(b)) if b else None
