"""Per-stage timing, counters and the port's tracer (counterpart of
cerebro_tpu/utils/timing.py).

Replaces the reference's pervasive ElapsedTime tic/toc inline profiling
(src/utils/ElapsedTime.h; e.g. descriptor latency feeding the adaptive skip,
src/Cerebro.cpp:108-118,281) with a structured collector: named stages,
rolling statistics, monotonic counters, and, with ``trace`` on, a bounded
record of nested spans that also lands in any active torch.profiler trace.

Code below the pipeline (the verifier, the pose-graph solve, the kernel
handles) holds no timer: the pipeline binds its own to a context variable
at each public entry (``StageTimer.bind``, ``entry``), and the module-level
``span`` and ``count`` reach it from there. With no timer bound, or tracing
off, ``span`` costs one context-variable read.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

PREFIX = "cerebro."  # the profiler's name of a span: cerebro.<name>
SPAN_CAPACITY = 1 << 20
# one exported span: name, perf_counter_ns start and end, span id, parent
# span id (0 at the top of its thread), thread id, attributes
SPAN_FIELDS = ("name", "t0_ns", "t1_ns", "id", "parent", "thread", "attrs")

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("cerebro_timer", default=None)


class _NullSpan:
    """What a span yields when nothing records it."""

    id = 0

    def set(self, **attrs):
        pass


class _Span:
    __slots__ = ("id", "attrs")

    def __init__(self, span_id: int, attrs: dict):
        self.id = span_id
        self.attrs = attrs

    def set(self, **attrs):
        """Attributes known only once the span's work is done."""
        self.attrs.update(attrs)


_NULL = _NullSpan()
_OFF = contextlib.nullcontext(_NULL)


class StageTimer:
    """Host wall-clock per stage, counters, and optionally a trace.

    CUDA work is asynchronous, so a stage that launches device work returns
    before the work finishes; with ``sync=False`` (the default, used for
    throughput runs) a stage measures launch cost only and device time
    surfaces at whichever later stage first waits on the device. With
    ``sync=True`` each device stage closed by ``sync_point(outputs)`` waits
    for the device before the clock stops. With ``trace=True`` no sync is
    needed for device attribution: every span runs inside
    ``torch.profiler.record_function("cerebro.<name>")``, so a profiler
    trace puts each kernel under the span that launched it.

    Always on: rolling per-stage samples (``stats``), per-stage ``total_s``
    and ``count`` (``totals``; a ratio over a window is the difference of
    two readings) and integer counters (``count``, ``counters``). While
    ``trace`` is on: each span (``stage``, the module's ``span``,
    ``event``; a gauge is an event carrying ``value``) is kept, up to
    ``capacity`` of them, with its start and end on
    ``time.perf_counter_ns``, its id, its parent (per thread) and
    attributes; the ``spans_dropped`` counter counts those past the
    capacity."""

    def __init__(self, window: int = 200, sync: bool = False, trace: bool = False):
        self.window = window
        self.sync = sync
        self.trace = trace
        self.capacity = SPAN_CAPACITY
        self._samples: Dict[str, list] = defaultdict(list)
        self._totals: Dict[str, list] = defaultdict(lambda: [0.0, 0])
        self._counters: Dict[str, int] = defaultdict(int)
        self._spans: list = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def sync_point(self, *values):
        """Wait for the device when sync attribution is on. Call as the last
        statement inside a ``stage()`` block; passes values through."""
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return values[0] if len(values) == 1 else values

    def stage(self, name: str, **attrs):
        """Time a block as stage ``name``, always; with ``trace`` on, also a
        span carrying ``attrs``. Yields the span (``.id``, ``.set(**attrs)``;
        a no-op without tracing)."""
        if self.trace:
            return self._traced(name, attrs)
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield _NULL
        finally:
            self.record(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def _traced(self, name: str, attrs: dict):
        stack = self._stack()
        sp = _Span(next(self._ids), attrs)
        parent = stack[-1] if stack else 0
        stack.append(sp.id)
        t0 = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(PREFIX + name):
                yield sp
        finally:
            t1 = time.perf_counter_ns()
            stack.pop()
            self._keep((name, t0, t1, sp.id, parent, threading.get_ident(), sp.attrs))
            self.record(name, (t1 - t0) * 1e-9)

    def event(self, name: str, t0_ns: Optional[int] = None, **attrs):
        """While tracing, a span that ends now: from ``t0_ns`` (a
        ``perf_counter_ns`` reading) or of zero length, under the thread's
        open span. Counts nothing in the stage statistics."""
        if not self.trace:
            return
        t1 = time.perf_counter_ns()
        stack = self._stack()
        self._keep((name, t1 if t0_ns is None else t0_ns, t1, next(self._ids),
                    stack[-1] if stack else 0, threading.get_ident(), attrs))

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] += n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, rec: tuple):
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(rec)
            else:
                self._counters["spans_dropped"] += 1

    def record(self, name: str, seconds: float):
        """Add one sample of ``seconds`` to stage ``name`` (for spans timed
        by the caller, such as the service's worker tick)."""
        with self._lock:
            buf = self._samples[name]
            buf.append(seconds)
            if len(buf) > self.window:
                del buf[: len(buf) - self.window]
            tot = self._totals[name]
            tot[0] += seconds
            tot[1] += 1

    def stats(self, skip_first: int = 0) -> Dict[str, Dict[str, float]]:
        """Per-stage statistics over each stage's last ``window`` samples.
        ``skip_first`` drops that many leading samples per stage from the
        aggregates (a first call pays one-time costs — kernel builds,
        allocator growth); the excluded first sample is still reported as
        ``first_ms``."""
        out = {}
        with self._lock:
            samples = {k: list(v) for k, v in self._samples.items() if v}
        for name, buf in samples.items():
            steady = buf[skip_first:] if len(buf) > skip_first else buf
            s = sorted(steady)
            out[name] = {
                "count": len(steady),
                "mean_ms": 1e3 * sum(steady) / len(steady),
                "p50_ms": 1e3 * s[len(s) // 2],
                "p95_ms": 1e3 * s[int(len(s) * 0.95)],
                "last_ms": 1e3 * steady[-1],
            }
            if skip_first and len(buf) > skip_first:
                out[name]["first_ms"] = 1e3 * buf[0]
                out[name]["warmup_excluded"] = skip_first
        return out

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Each stage's ``total_s`` and ``count`` since the timer was made."""
        with self._lock:
            return {k: {"total_s": v[0], "count": v[1]} for k, v in self._totals.items()}

    def export(self) -> dict:
        """The spans kept so far (tuples of ``span_fields``), the counters
        and the totals."""
        with self._lock:
            spans = list(self._spans)
        return {"span_fields": SPAN_FIELDS, "spans": spans, "counters": self.counters(),
                "totals": self.totals()}

    @contextlib.contextmanager
    def bind(self):
        """Make this the timer that ``span`` and ``count`` reach, in this
        thread's context, for the block."""
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)


def entry(method):
    """Bind ``self.timer`` around a public method of the pipeline."""

    @functools.wraps(method)
    def bound(self, *args, **kwargs):
        token = _CURRENT.set(self.timer)
        try:
            return method(self, *args, **kwargs)
        finally:
            _CURRENT.reset(token)

    return bound


def span(name: str, **attrs):
    """A span on the bound timer while it traces, else a no-op."""
    t = _CURRENT.get()
    if t is None or not t.trace:
        return _OFF
    return t._traced(name, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` to a counter of the bound timer, if one is bound."""
    t = _CURRENT.get()
    if t is not None:
        t.count(name, n)


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: bool):
    """torch.profiler trace around a block, host operators always and CUDA
    activity when ``cuda``, exported on exit as a Chrome trace
    ``<log_dir>/trace_<time>_<pid>.trace.json`` (open in chrome://tracing
    or Perfetto). Yields the path it will write."""
    import os

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.trace.json"
    )
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)
