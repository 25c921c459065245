"""setup_s: process start to the window's start (loading, warm-up, the
traffic's own set-up), on the host clock."""


def read(ctx):
    return ctx.run.setup_s
