"""The program's own tracer, read by the benchmark.

The port's ``StageTimer`` (``cerebro_tpu_torch/utils/timing.py``) keeps,
always, per-stage totals and counters, and while ``pipe.timer.trace`` is on
nested spans on ``time.perf_counter_ns`` (the clock of the benchmark's own
spans), each also a ``cerebro.<name>`` annotation in a running
torch.profiler trace. This module reads them:

* ``reduce_trace`` is ``probe.reduce_trace`` with the program's annotations
  left out of the device intervals (the profiler also lays them on the
  device's timeline as user annotations: counted as busy time they would
  move ``device_idle``), each kernel, copy and memset attributed to the
  program spans open at its launch (``device_spans``, ``device_by_span``),
  and each idle gap named by the benchmark's span and the program's
  innermost span open at its start (``verify/cerebro.verify.ransac``);
  every number ``probe.reduce_trace`` gives is the same;
* ``program`` / ``delta`` / ``verified``: the program's
  spans and the snapshots of its counters and totals on a run
  (``Run.program``: ``system.py`` takes them at the window's and the
  profiled slice's ends), and what changed between two instants; the
  readers ``metrics/{verify_launches_per_pair, verify_device_share,
  solve_cg_iters, solve_ms_per_cg_iter, drain_ms_per_batch}.py`` read
  them, and read nothing from a run that holds none.

``system.py`` turns the program's tracer on in traced runs only, and
reduces their profiled slice with ``reduce_trace``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench import probe
from portbench.yardstick import union_seconds

PROGRAM = "cerebro."
OUTSIDE = "outside the program's spans"
# the host calls that put work on the device: kernels, copies, memsets
LAUNCH_PREFIXES = ("cuda", "cu")


def _stacks_at(spans: List[tuple], queries: List[tuple]) -> Dict[object, tuple]:
    """For each query (time, key), the spans of ``spans`` ((start, end,
    name), properly nested, one thread's) open at that time, outermost
    first."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, k = {}, [], 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] <= spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        out[key] = tuple(s for s in stack if s[1] > t)
    return out


def _open_at(prog: Dict[object, list], queries: List[tuple], tid=None) -> Dict[object, tuple]:
    """The program spans open at each query (time, key): on thread ``tid``,
    or, where it is None, on the thread whose innermost open span started
    last."""
    best: Dict[object, tuple] = {key: () for _, key in queries}
    for th in ([tid] if tid is not None else list(prog)):
        for key, stack in _stacks_at(prog[th], queries).items():
            if stack and (not best[key] or stack[-1][0] > best[key][-1][0]):
                best[key] = stack
    return best


def reduce_trace(prof, t_mark: float, host_s: float, spans_obj: probe.Spans) -> dict:
    """``probe.reduce_trace``'s reduction, with the program's spans: see the
    module's docstring. ``device_spans[i]`` is the tuple of program span
    names (without ``cerebro.``) open at the launch of ``device_events[i]``,
    outermost first: on the thread that made the launch call where the
    trace links the call to a host event, else on the thread whose
    innermost span started last."""
    from torch.autograd import DeviceType

    dev = []  # the correlation id of each kernel, copy and memset
    ops = {}  # correlation id -> thread, of host events other than launch calls
    calls = {}  # correlation id -> (start, linked correlation id), of launch calls
    prog: Dict[object, list] = {}  # thread -> [(start, end, name)], program spans
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith((probe.PREFIX, PROGRAM)):
                dev.append(e.correlation_id())
            continue
        start = probe._ns(e, "start") * 1e-9
        if name.startswith(LAUNCH_PREFIXES):
            calls[e.correlation_id()] = (start, e.linked_correlation_id())
        else:
            ops[e.correlation_id()] = e.start_thread_id()
            if name.startswith(PROGRAM):
                end = start + probe._ns(e, "duration") * 1e-9
                prog.setdefault(e.start_thread_id(), []).append((start, end, name[len(PROGRAM):]))

    # each device event -> its launch call (the same correlation id) -> the
    # thread of the host event the call ran under (the call's linked id)
    queries: Dict[object, list] = {}
    for i, corr in enumerate(dev):
        call = calls.get(corr)
        if call is not None:
            tid = ops.get(call[1]) if call[1] else None
            queries.setdefault(tid if tid in prog else None, []).append((call[0], i))
    chains = [()] * len(dev)
    for tid, qs in queries.items():
        for i, stack in _open_at(prog, qs, tid).items():
            chains[i] = tuple(s[2] for s in stack)

    out = probe.reduce_trace(_Without(prof), t_mark, host_s, spans_obj)
    events = out["device_events"]
    if len(events) != len(dev):
        raise RuntimeError(f"{len(dev)} device events here, {len(events)} in the probe's reduction")
    # the probe's gaps, each named also by the program's innermost span
    bench_gaps = out["idle_gaps"]
    _, gaps = union_seconds([(s, e) for s, e, _ in events])
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    inner = _open_at(prog, [(g0, j) for j, (g0, _) in enumerate(top)])
    out["idle_gaps"] = [[f"{label}/{PROGRAM + inner[j][-1][2] if inner[j] else OUTSIDE}", s]
                        for j, (label, s) in enumerate(bench_gaps)]
    by_span: Dict[str, float] = {}
    for chain, (s, e, _) in zip(chains, events):
        key = PROGRAM + chain[-1] if chain else OUTSIDE
        by_span[key] = by_span.get(key, 0.0) + (e - s)
    total = sum(by_span.values())
    out["device_spans"] = chains
    out["device_by_span"] = [[n, s] for n, s in sorted(by_span.items(), key=lambda kv: -kv[1])[:10]]
    out["device_attributed_share"] = 1.0 - by_span.get(OUTSIDE, 0.0) / total if total else None
    return out


class _Without:
    """A finished profiler's events less the program's annotations on the
    device's timeline, in the form ``probe.reduce_trace`` reads: its
    numbers are computed by its own code from what it would have seen
    without the program's tracer."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.profiler = self.kineto_results = self
        self._events = [e for e in prof.profiler.kineto_results.events()
                        if not (e.device_type() == DeviceType.CUDA and e.name().startswith(PROGRAM))]

    def events(self):
        return self._events


# ---------------------------------------------------------------------------
# The program's spans and counters on a run
# ---------------------------------------------------------------------------


def program(run) -> Optional[dict]:
    """``run.program``: {"spans": the timer's exported spans (as dicts,
    times in perf_counter seconds; none where the tracer was off),
    "snapshots": [(perf_counter seconds, counters, totals)]}, or None where
    the run holds none."""
    return getattr(run, "program", None)


def delta(run, t0: float, t1: float) -> Optional[tuple]:
    """(counters, totals) changed between the last snapshot taken at or
    before ``t0`` and the first taken at or after ``t1``: the nearest pair
    that holds the interval. Totals as {stage: (seconds, count)}."""
    prog = program(run)
    if prog is None:
        return None
    snaps = prog["snapshots"]

    a = next((s for s in reversed(snaps) if s[0] <= t0), None)
    b = next((s for s in snaps if s[0] >= t1), None)
    if a is None or b is None:
        return None
    counters = {k: v - a[1].get(k, 0) for k, v in b[1].items()}
    totals = {}
    for k, v in b[2].items():
        w = a[2].get(k, {"total_s": 0.0, "count": 0})
        totals[k] = (v["total_s"] - w["total_s"], v["count"] - w["count"])
    return counters, totals


def verified(counters: dict) -> int:
    """Pairs verified, a pair once for each tier that verified it (tier 1,
    tier 2, depth)."""
    return sum(v for k, v in counters.items() if k.startswith("pairs.verified."))


def spans_as_dicts(export: dict) -> List[dict]:
    fields = export["span_fields"]
    out = []
    for s in export["spans"]:
        d = dict(zip(fields, s))
        d["t0"], d["t1"] = d.pop("t0_ns") * 1e-9, d.pop("t1_ns") * 1e-9
        out.append(d)
    return out


# the readers of the program's metrics
METRICS = ("verify_launches_per_pair.relocalize", "verify_device_share.relocalize",
           "solve_cg_iters", "solve_ms_per_cg_iter", "drain_ms_per_batch.relocalize")
