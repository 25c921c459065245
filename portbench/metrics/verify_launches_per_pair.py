"""verify_launches_per_pair.<cells>: device operations (kernels, copies,
memsets) launched under the program's ``verify*`` spans in the profiled
slice, over the pairs verified in that slice, a pair counted once for each
tier that verified it (the program's ``pairs.verified.*`` counters: tier 1,
tier 2, depth). One pair's pass through one tier is one graph replay on the
card, so the number reads what such a pass costs, whichever mix of tiers
the slice holds. Needs the program's tracer (``portbench/progtrace.py``);
none without it."""

from portbench.progtrace import delta, verified


def read(ctx):
    run = ctx.run
    tr = run.trace
    if tr is None or "device_spans" not in tr:
        return None
    d = delta(run, *run.trace_t)
    passes = verified(d[0]) if d is not None else 0
    if not passes:
        return None
    return sum(any(s.startswith("verify") for s in chain) for chain in tr["device_spans"]) / passes
