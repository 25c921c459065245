"""Shared pieces of the metric readers (``portbench/metrics/<name>.py``).

A reader is a module with ``read(ctx) -> float | None``: it takes its
number from the run's spans (the benchmark's wrappers, ``Run.spans``, and
the program's own, ``Run.program``), counters and profiler slice, and
returns None when the run holds nothing for it to read (the metric is then
left out of the result line). ``ctx`` is a ``Context``. The reader of
``<name>.<cells>`` is ``metrics/<name>.<cells>.py``, or the shared
``metrics/<name>.py`` where the quantity is read alike in every cell.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Optional

from portbench import yardstick as Y
from portbench.progtrace import program

METRICS = Path(__file__).resolve().parent / "metrics"


@dataclasses.dataclass
class Context:
    run: object  # system.Run
    describe_flops: float  # one frame through the describe net
    width: int  # the descriptor's width


def load(name: str):
    path = METRICS / f"{name}.py"
    if not path.exists():
        path = METRICS / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} ({METRICS / name}.py)")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window_calls(ctx: Context, name: str) -> list:
    run = ctx.run
    return run.spans.between(name, run.window_t0, run.window_t1)


def kernel_roofline(ctx: Context, kernel: str, event_names: tuple, cost) -> Optional[float]:
    """``launches_roofline`` of the launches of the benchmark's handle
    ``kernel`` (``probe.Spans.wrap_launch``) made in the profiled slice;
    None where another handle launched the same kernels in the slice."""
    run = ctx.run
    if run.trace is None:
        return None
    t0, t1 = run.trace_t
    launches = [a for t, a in run.spans.launches.get(kernel, []) if t0 <= t <= t1]
    others = [t for t, _ in run.spans.launches.get(TWINS.get(kernel, ""), []) if t0 <= t <= t1]
    return None if others else launches_roofline(ctx, launches, event_names, cost)


def launches_roofline(ctx: Context, launches: list, event_names: tuple, cost) -> Optional[float]:
    """Share (%) of its least time that a kernel's calls in the profiled
    slice reach: the mean bound ``cost(*shape)`` of ``launches`` (the shapes
    of the launches made in the slice) over the mean device time per call
    of the kernel's events there (the first of ``event_names`` is launched
    once per call, the rest beside it). None without launches or events."""
    run = ctx.run
    if run.trace is None:
        return None
    calls = [e for e in run.trace["device_events"] if event_names[0] in e[2]]
    if not launches or not calls:
        return None
    dev_s = sum(e[1] - e[0] for e in run.trace["device_events"]
                if any(n in e[2] for n in event_names))
    bound = sum(cost(*a) for a in launches) / len(launches)
    return 100.0 * bound / (dev_s / len(calls))


def program_launches(ctx: Context) -> dict:
    """The program's own launch spans (``kernel.<function>``, with the
    integer arguments of the launch as ``shape``) that started in the
    profiled slice: {function: [shape, ...]}, e.g. ``stereo_bm_launch``:
    [(B, H, W, num_disp, block), ...]. Empty without the program's tracer or
    a slice. A roofline reader of a new kernel passes its list to
    ``launches_roofline``."""
    run, prog = ctx.run, program(ctx.run)
    if run.trace is None or prog is None:
        return {}
    t0, t1 = run.trace_t
    out: dict = {}
    for s in prog["spans"]:
        if s["name"].startswith(KERNEL) and t0 <= s["t0"] <= t1:
            out.setdefault(s["name"][len(KERNEL):], []).append(tuple(s["attrs"].get("shape", ())))
    return out


KERNEL = "kernel."  # the program's span of one launch: kernel.<function>
TWINS = {"K1": "K2", "K2": "K1"}  # handles that launch the same CUDA kernels


def score_topk_bound(Q, N, D, KB, K, filled) -> float:
    """The least time of a K1 / K2 launch over the ``filled`` rows of its
    N-row DB: the rows beyond them hold nothing to find."""
    flops, nbytes = Y.score_topk_cost(Q, min(filled, N), D, K)
    return Y.bound_s(flops, nbytes, Y.BF16_FLOPS)


def k3_bound(B, H, W, nd) -> float:
    ops, nbytes = Y.k3_cost(B, H, W, nd)
    return Y.bound_s(ops, nbytes, Y.F32_FLOPS)


def step_flops(ctx: Context, detects: list) -> float:
    """The describe net's FLOPs for each real frame of the ``detect``
    calls, and 2 Q N D for each, N the rows filled when it searched."""
    frames = sum(c[2][0] for c in detects)
    return frames * ctx.describe_flops + sum(2.0 * q * n * ctx.width for _, _, (q, n) in detects)


def verify_ms_per_pair(ctx: Context) -> Optional[float]:
    calls = window_calls(ctx, "verify")
    pairs = sum(c[2] for c in calls)
    if not pairs:
        return None
    return 1e3 * sum(c[1] - c[0] for c in calls) / pairs


def device_idle(ctx: Context) -> Optional[float]:
    tr = ctx.run.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
