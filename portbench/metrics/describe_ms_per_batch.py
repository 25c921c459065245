"""describe_ms_per_batch: the mean of the pipeline's StageTimer ``describe``
stage with its device sync on (traced runs only: the sync perturbs)."""


def read(ctx):
    run = ctx.run
    if run.trace is None:
        return None
    st = run.timer_stats.get("describe")
    return st["mean_ms"] if st and st.get("count") else None
