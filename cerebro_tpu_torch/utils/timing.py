"""Per-stage timing metrics (counterpart of cerebro_tpu/utils/timing.py).

Replaces the reference's pervasive ElapsedTime tic/toc inline profiling
(src/utils/ElapsedTime.h; e.g. descriptor latency feeding the adaptive skip,
src/Cerebro.cpp:108-118,281) with a structured collector: named stages,
rolling statistics, JSON export.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    """Host wall-clock per stage. CUDA work is asynchronous, so a stage
    that launches device work returns before the work finishes; with
    ``sync=False`` (the default, used for throughput runs) a stage measures
    launch cost only and device time surfaces at whichever later stage
    first waits on the device. For per-stage device attribution, construct
    with ``sync=True`` (or set ``.sync``) and close each device stage with
    ``sync_point(outputs)`` — the stage then waits for the device before
    the clock stops."""

    def __init__(self, window: int = 200, sync: bool = False):
        self.window = window
        self.sync = sync
        self._samples: Dict[str, list] = defaultdict(list)

    def sync_point(self, *values):
        """Wait for the device when sync attribution is on. Call as the last
        statement inside a ``stage()`` block; passes values through."""
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return values[0] if len(values) == 1 else values

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        """Add one sample of ``seconds`` to stage ``name`` (for spans timed
        by the caller, such as the service's worker tick)."""
        buf = self._samples[name]
        buf.append(seconds)
        if len(buf) > self.window:
            del buf[: len(buf) - self.window]

    def stats(self, skip_first: int = 0) -> Dict[str, Dict[str, float]]:
        """Per-stage statistics. ``skip_first`` drops that many leading
        samples per stage from the aggregates (a first call pays one-time
        costs — kernel builds, allocator growth); the excluded first sample
        is still reported as ``first_ms``."""
        out = {}
        for name, buf in self._samples.items():
            if not buf:
                continue
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
