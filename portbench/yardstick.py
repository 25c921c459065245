"""The benchmark's arithmetic: percentiles, the published H100 peaks, and the
operations and bytes of the kernels, all from shapes (each describe net's
FLOP rule is its module's, ``portbench/nets/``).

Frozen here so that a change to the system cannot move the yardstick. The
kernel counts follow the bring-up smoke run's (``k3_ops``, ``bound``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank q-quantile (0 < q < 1): the smallest value with at
    least q of the samples at or below it. None for no samples."""
    s = sorted(values)
    if not s:
        return None
    return float(s[max(math.ceil(q * len(s)) - 1, 0)])


def tail(values: Sequence[float], q: float, beyond: int) -> Optional[float]:
    """The nearest-rank q-quantile, or, where fewer than ``beyond`` samples
    lie above its rank, the sample with exactly ``beyond`` above it: the
    highest percentile up to q with that many samples beyond it. None for
    ``beyond`` samples or fewer."""
    s = sorted(values)
    if len(s) <= beyond:
        return None
    k = max(math.ceil(q * len(s)) - 1, 0)
    return float(s[min(k, len(s) - 1 - beyond)])


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median (statistics.quantiles, n=4)."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def keyframe_latencies(keyframes, due: dict, gid_frame, drained_at) -> tuple:
    """(ms from each keyframe's due time until its detection was drained,
    lost keyframes): ``gid_frame`` maps DB ids to stream frames,
    ``drained_at[g]`` is when id g's detection was drained. A keyframe
    never drained counts as infinitely late and as lost."""
    got = {f: drained_at[g] for g, f in enumerate(gid_frame) if g < len(drained_at)}
    out = [(got[f] - due[f]) * 1e3 if f in got else float("inf") for f in keyframes]
    return out, sum(f not in got for f in keyframes)


def decision_latencies(candidates, frame_of, keyframes: set, due: dict, decided_at: dict,
                       window_end: float) -> list:
    """ms from the due time of each candidate's keyframe (only keyframes in
    ``keyframes``) until the candidate was decided, or until the window's
    end for one undecided then (its age at the end)."""
    out = []
    for curr, prev in set(candidates):
        f = frame_of[curr]
        if f in keyframes:
            t = decided_at.get((curr, prev), float("inf"))
            out.append((min(t, window_end) - due[f]) * 1e3)
    return sorted(out)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def score_topk_cost(Q: int, N: int, D: int, K: int) -> tuple:
    """(FLOPs, bytes) of one K1/K2 call: Q queries scored against all N DB
    rows of D bf16 values, the best K kept. Each input byte read once (the
    DB, the queries, the row gids and the query limits), each output byte
    written once ((score, gid) per kept hit)."""
    flops = 2.0 * Q * N * D
    nbytes = 2.0 * N * D + 2.0 * Q * D + 4.0 * N + 4.0 * Q + 8.0 * Q * K
    return flops, nbytes


def k3_ops(B: int, H: int, W: int, num_disp: int) -> float:
    """The fewest operations block matching needs: per pixel and disparity
    |L - R| (2), running vertical and horizontal box sums (4) and the
    winner and second-best compares (2); per pixel the texture term and its
    sums (6) and the parabola and validity tests (~10)."""
    return float(B) * H * W * (8.0 * num_disp + 16.0)


def k3_cost(B: int, H: int, W: int, num_disp: int) -> tuple:
    """(operations, bytes) of one K3 call: two f32 image stacks read, a f32
    disparity and a bool validity map written."""
    return k3_ops(B, H, W, num_disp), 2.0 * B * H * W * 4 + B * H * W * 5.0


def bound_s(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least time the chip could take: the larger of the operations
    over their peak and the bytes over HBM's bandwidth."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)


def union_seconds(intervals: Sequence[tuple]) -> tuple:
    """(seconds covered by the union of (start, end) intervals, the gaps
    between them as (start, end) pairs), times in seconds."""
    iv = sorted(intervals)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps
