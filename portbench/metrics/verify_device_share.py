"""verify_device_share.<cells>: the device's busy seconds (union) of the
kernels, copies and memsets launched under the program's ``verify*`` spans
in the profiled slice, over the wall seconds of the program's top-level
``verify*`` spans in the slice, as a share. Needs the program's tracer
(``portbench/progtrace.py``); none without it."""

from portbench.progtrace import program, top_level
from portbench.yardstick import union_seconds


def read(ctx):
    run = ctx.run
    tr, prog = run.trace, program(run)
    if tr is None or prog is None or "device_spans" not in tr:
        return None
    t0, t1 = run.trace_t
    busy, _ = union_seconds([(s, e) for (s, e, _), chain in zip(tr["device_events"], tr["device_spans"])
                             if any(n.startswith("verify") for n in chain)])
    wall, _ = union_seconds([(max(s["t0"], t0), min(s["t1"], t1))
                             for s in top_level(prog["spans"], "verify") if s["t0"] < t1 and s["t1"] > t0])
    return 100.0 * busy / wall if wall > 0 else None
