"""solve_ms: the mean host-clock duration of optimize_trajectory calls made
in the window."""


def read(ctx):
    from portbench.readers import window_calls

    calls = window_calls(ctx, "solve")
    return 1e3 * sum(c[1] - c[0] for c in calls) / len(calls) if calls else None
