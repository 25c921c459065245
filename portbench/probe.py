"""What the benchmark observes of the system from outside.

* ``Spans``: wrappers the benchmark puts around the calls into each layer
  (instance attributes of the pipeline, the ingestor and the kernel
  handles), timing each call on the host clock and, in a traced run,
  marking it for the profiler (``portbench.<layer>``) and recording each
  kernel launch's shape.
* ``Poller``: a thread that reads the pipeline's append-only host state at
  50 Hz (described and drained keyframes, pending candidates, edges and
  rejections) and stamps each change with the host clock.
* ``start_profiler`` / ``reduce_trace``: a torch.profiler slice of the
  window and its reduction to device-busy seconds, kernel times and the
  idle gaps by what the host was doing.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

PREFIX = "portbench."
BEFORE = object()  # the marker of an extra's call before the wrapped call


class Spans:
    def __init__(self, trace: bool, sync=None):
        self.trace = trace
        self.sync = sync  # device synchronise for a traced span's end
        self.calls: Dict[str, list] = {}  # name -> [(t0, t1, extra)]
        self.launches: Dict[str, list] = {}  # kernel -> [(t, args)]
        self._lock = threading.Lock()

    def wrap(self, obj, attr: str, name: str, extra=None, sync: bool = False):
        """Replace ``obj.attr`` by a timed call; ``extra(args, before,
        out)`` adds a record to it: it is called once before the call with
        ``out=BEFORE`` (its value is ``before``), and once after it."""
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            before = extra(args, None, BEFORE) if extra else None
            t0 = time.perf_counter()
            if self.trace:
                import torch

                with torch.profiler.record_function(PREFIX + name):
                    out = fn(*args, **kw)
                    if sync and self.sync is not None:
                        self.sync()
            else:
                out = fn(*args, **kw)
            t1 = time.perf_counter()
            rec = extra(args, before, out) if extra else None
            with self._lock:
                self.calls.setdefault(name, []).append((t0, t1, rec))
            return out

        setattr(obj, attr, timed)

    def wrap_launch(self, kernel, name: str, arg_slice: slice, fill=None):
        """Record the shape arguments of every launch of ``kernel``, and
        ``fill()`` after them where it is given."""
        fn = kernel.launch

        def launch(fname, *args):
            rec = tuple(args[arg_slice]) + ((fill(),) if fill is not None else ())
            with self._lock:
                self.launches.setdefault(name, []).append((time.perf_counter(), rec))
            return fn(fname, *args)

        kernel.launch = launch

    def between(self, name: str, t0: float, t1: float) -> list:
        return [c for c in self.calls.get(name, []) if c[0] >= t0 and c[1] <= t1]


class Poller:
    """Samples the pipeline's host state every ``period`` seconds."""

    def __init__(self, pipe, period: float = 0.02):
        self.pipe = pipe
        self.period = period
        self.drained_at: List[float] = []  # per DB gid: when its detection was drained
        self.decided: Dict[tuple, float] = {}  # (curr, prev) -> when it was accepted or rejected
        self.backlog: List[tuple] = []  # (t, pending candidates)
        self._n_edges = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self):
        pipe, now = self.pipe, time.perf_counter()
        n = len(pipe._score_history)
        while len(self.drained_at) < n:
            self.drained_at.append(now)
        edges = pipe.loop_edges
        while self._n_edges < len(edges):
            e = edges[self._n_edges]
            self.decided.setdefault((e.idx_curr, e.idx_prev), now)
            self._n_edges += 1
        rej = pipe.rejected_candidates
        for k in range(len(rej) - 1, -1, -1):
            r = rej[k]
            key = (r.idx_curr, r.idx_prev)
            if key in self.decided:
                break
            self.decided[key] = now
        self.backlog.append((now, len(pipe._candidates)))

    def _run(self):
        while not self._stop.is_set():
            self.sample()
            time.sleep(self.period)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                raise RuntimeError("the poller thread did not stop")
        self.sample()


def start_profiler():
    """A running profiler and the host clock's reading inside its marker
    span (``portbench.clock``), which ties the benchmark's own spans, timed
    on any thread, to the trace's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    with torch.profiler.record_function(PREFIX + "clock"):
        t_mark = time.perf_counter()
    return prof, t_mark


def _ns(e, which: str) -> float:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, f"{which}_us")()) * 1e3


def reduce_trace(prof, t_mark: float, host_s: float, spans_obj: Spans) -> dict:
    """Device intervals of a finished profiler slice and the benchmark's
    spans: ``busy_s`` (union of kernels, copies and memsets), ``window_s``
    (the slice's host-clock length), per-name device seconds, and the ten
    longest idle gaps named by the innermost benchmark span open at the
    gap's start, on whichever thread (clocks tied by the marker span)."""
    from torch.autograd import DeviceType

    from portbench.yardstick import union_seconds

    dev, offset = [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start") * 1e-9
        dur = _ns(e, "duration") * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(PREFIX):
                dev.append((start, start + dur, name))
        elif name == PREFIX + "clock":
            offset = start - t_mark
    spans = []
    if offset is not None:
        spans = [(t0 + offset, t1 + offset, name) for name, calls in spans_obj.calls.items()
                 for t0, t1, _ in calls]
    busy, gaps = union_seconds([(s, e) for s, e, _ in dev])
    per: Dict[str, float] = {}
    for s, e, n in dev:
        per[n] = per.get(n, 0.0) + (e - s)
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        open_ = [sp for sp in spans if sp[0] <= g0 < sp[1]]
        label = max(open_, key=lambda sp: sp[0])[2] if open_ else "host outside the benchmark's spans"
        named.append((label, g1 - g0))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy, "window_s": host_s, "device_events": dev,
        "device_ops": [[n[:120], s] for n, s in top], "idle_gaps": [[n, s] for n, s in named[:10]],
    }
