"""verify_launches_per_pair.<cells>: device operations (kernels, copies,
memsets) launched under the program's ``verify*`` spans in the profiled
slice, over the pairs the program's counters decided (accepted or rejected)
in that slice. Needs the program's tracer (``portbench/progtrace.py``); none
without it."""

from portbench.progtrace import decided, delta


def read(ctx):
    run = ctx.run
    tr = run.trace
    if tr is None or "device_spans" not in tr:
        return None
    d = delta(run, *run.trace_t)
    pairs = decided(d[0]) if d is not None else 0
    if not pairs:
        return None
    return sum(any(s.startswith("verify") for s in chain) for chain in tr["device_spans"]) / pairs
