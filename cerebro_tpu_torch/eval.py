"""Evaluation: ATE metrics and sequence runners (counterpart of
cerebro_tpu/eval.py).

  * ``ate_rmse``            — absolute trajectory error with optional rigid
                              Umeyama alignment;
  * ``run_sequence``        — drive a CerebroPipeline over any frame
                              iterator, collecting stage timings and outputs;
  * ``evaluate_against_gt`` — before/after-optimization ATE report.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch

from cerebro_tpu_torch.ops.umeyama import umeyama_rigid
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline
from cerebro_tpu_torch.utils.timing import StageTimer


def ate_rmse(
    est_xyz: np.ndarray,  # (N, 3) estimated positions
    gt_xyz: np.ndarray,  # (N, 3) ground-truth positions
    align: bool = True,
) -> float:
    """Absolute trajectory error (RMSE of positions), optionally after a
    rigid Umeyama alignment (the standard ATE protocol). The alignment is
    solved in f32 on the CPU, as the JAX package solves it."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if align and len(est) >= 3:
        T, _ = umeyama_rigid(
            torch.as_tensor(est, dtype=torch.float32),
            torch.as_tensor(gt, dtype=torch.float32),
            torch.ones(len(est), dtype=torch.float32),
        )
        T = T.numpy().astype(np.float64)
        est = est @ T[:3, :3].T + T[:3, 3]
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


@dataclasses.dataclass
class RunReport:
    n_frames: int
    n_keyframes: int
    n_candidates: int
    n_loop_edges: int
    keyframes_per_s: float
    timings: dict
    ate_before: Optional[float] = None
    ate_after: Optional[float] = None

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


def run_sequence(
    pipe: CerebroPipeline,
    frames: Iterable,  # yields objects with .stamp, .left(), .right(), .pose
    n_tracked_default: int = 100,
    verify: bool = True,
    max_frames: Optional[int] = None,
    trace_dir: Optional[str] = None,
) -> RunReport:
    """Feed ``frames`` through ``pipe``, flush, and verify the candidates
    (``verify_pending`` raises while ``cfg.verify.cascade`` is on: the
    cascade is not ported)."""
    if trace_dir is not None:
        raise NotImplementedError(
            "run_sequence(trace_dir=...) is not ported yet (ROADMAP Queue 1: "
            "item 5, a device trace through torch.profiler)"
        )
    timer = StageTimer()
    n = 0
    t0 = time.perf_counter()
    for f in frames:
        if max_frames is not None and n >= max_frames:
            break
        with timer.stage("ingest"):
            pipe.ingest_frame(
                f.stamp,
                f.left(),
                n_tracked=getattr(f, "n_tracked", n_tracked_default),
                pose=f.pose,
                right_img=f.right() if hasattr(f, "right") else None,
            )
        n += 1
    with timer.stage("flush"):
        pipe.flush_descriptors()
    if verify and pipe.rig is not None:
        with timer.stage("verify"):
            pipe.verify_pending()
    wall = time.perf_counter() - t0
    st = pipe.status()
    return RunReport(
        n_frames=st["frames"],
        n_keyframes=st["keyframes"],
        n_candidates=st["pending_candidates"],
        n_loop_edges=st["loop_edges"],
        keyframes_per_s=st["described"] / max(wall, 1e-9),
        timings=timer.stats(),
    )


def evaluate_against_gt(
    pipe: CerebroPipeline,
    report: RunReport,
    gt_positions: np.ndarray,  # (K, 3) ground truth for keyframes with poses
    align: bool = True,
) -> RunReport:
    """Fill in ATE before (raw ingested odometry) and after (pose-graph
    optimized) against ground-truth keyframe positions."""
    kf = np.nonzero(pipe.store.pose_valid[: pipe.store.size])[0]
    if len(kf) < 3 or len(gt_positions) != len(kf):
        return report
    before = pipe.store.poses[kf][:, :3, 3]
    report.ate_before = ate_rmse(before, gt_positions, align=align)
    out = pipe.optimize_trajectory()
    if out is not None:
        report.ate_after = ate_rmse(out[:, :3, 3], gt_positions, align=align)
    return report
