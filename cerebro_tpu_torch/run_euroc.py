"""Run the full engine over a EuRoC sequence (ASL folder layout): the port's
counterpart of scripts/run_euroc.py.

The offline equivalent of the reference's
``roslaunch cerebro euroc_vinsfusion.launch`` + ``rosbag play``
(ref launch/euroc_vinsfusion.launch): loads the rig from the opencv-yaml
config, rectifies every frame, streams it through the pipeline, verifies
candidates, optimizes the trajectory, and writes ``report.json``,
``trajectory.npy`` and ``trajectory_render.npy`` under ``--out``.

Usage:
  python -m cerebro_tpu_torch.run_euroc /data/MH_01_easy/mav0 --out DIR \\
      [--descriptor ported|gist|netvlad] [--stride 2] [--max-frames N] [--cpu] \\
      [--ate [--odom-drift D]] [--save-state DIR | --load-state DIR] \\
      [--trace DIR] [--config RIG.yaml]

Runs on the CUDA device; ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "configs", "euroc", "euroc_stereo_config.yaml"
)


class RectFrame:
    """A loader frame undistorted and rectified into the verification rig."""

    __slots__ = ("stamp", "pose", "_l", "_r")

    def __init__(self, stamp, pose, left, right):
        self.stamp, self.pose, self._l, self._r = stamp, pose, left, right

    def left(self):
        return self._l

    def right(self):
        return self._r


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run cerebro_tpu_torch over a EuRoC sequence.")
    ap.add_argument("mav0")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "cerebro_run"))
    ap.add_argument(
        "--descriptor", default="ported", choices=["ported", "gist", "netvlad"],
        help="'ported' runs the reference's own trained flagship weights "
             "(artifacts/descriptor_ported); 'netvlad' the in-framework net "
             "with its seeded weights; 'gist' the training-free descriptor",
    )
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    ap.add_argument("--save-state", default=None, help="teach: save map here")
    ap.add_argument("--load-state", default=None, help="repeat: load map from here")
    ap.add_argument(
        "--trace", default=None,
        help="record a torch.profiler trace of the run (Chrome *.trace.json) in this dir",
    )
    ap.add_argument(
        "--ate", action="store_true",
        help="report ATE RMSE before (fed odometry) and after pose-graph "
             "optimization against the sequence ground truth "
             "(state_groundtruth_estimate0)",
    )
    ap.add_argument(
        "--odom-drift", type=float, default=0.0,
        help="with --ate: per-frame random-walk drift (metres std) injected "
             "into the fed odometry, simulating VINS drift so the "
             "loop-closure correction is visible (ground truth stays clean)",
    )
    ap.add_argument(
        "--config", default=DEFAULT_CONFIG,
        help="opencv-yaml rig config (VINS-Fusion format, ref config/vinsfusion/**)",
    )
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from cerebro_tpu_torch.config import CerebroConfig, DescriptorConfig
    from cerebro_tpu_torch.eval import evaluate_against_gt, run_sequence
    from cerebro_tpu_torch.geometry.stereo import StereoRectifier
    from cerebro_tpu_torch.io import load_pipeline_state, save_pipeline_state
    from cerebro_tpu_torch.io.euroc import EurocSequence
    from cerebro_tpu_torch.io.rig_config import load_rig_config
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline
    from cerebro_tpu_torch.utils.plot import trajectory_topdown

    device = "cpu" if args.cpu else None  # None: the CUDA device, or raise
    # the rig from the opencv-yaml config front-end (the reference boots
    # from the same format, src/cerebro_node.cpp:105-373)
    spec = load_rig_config(args.config)
    if spec.cam1 is None or spec.c1_T_c0 is None:
        raise ValueError(f"{args.config}: a stereo rig is required (cam1 and its extrinsic)")
    rect = StereoRectifier(
        spec.cam0, spec.cam1, spec.c1_T_c0.astype(np.float32), out_hw=spec.image_hw,
        device=device,
    )
    cfg = CerebroConfig(
        descriptor=DescriptorConfig(image_hw=spec.image_hw, kind=args.descriptor)
    )
    seq = EurocSequence(args.mav0)
    print(f"sequence: {len(seq)} cam0 frames", flush=True)

    if args.load_state:
        pipe = load_pipeline_state(args.load_state, cfg=cfg, rig=rect.rig, device=device)
    else:
        pipe = CerebroPipeline(cfg, rig=rect.rig, device=device)

    gt_positions = []  # clean ground truth per pose-carrying frame
    drift_rng = np.random.default_rng(0)
    drift_t = np.zeros(3, np.float32)

    def rectified_frames(frames):
        nonlocal drift_t
        for f in frames:
            left, right = rect.rectify(f.left(), f.right())
            pose = f.pose
            if pose is not None and args.ate:
                gt_positions.append(np.asarray(pose)[:3, 3].copy())
                if args.odom_drift > 0:
                    # a translation random walk, the dominant VINS error
                    # mode loop closure exists to correct
                    drift_t = drift_t + drift_rng.normal(0, args.odom_drift, 3).astype(np.float32)
                    pose = np.array(pose, np.float32)
                    pose[:3, 3] += drift_t
            yield RectFrame(f.stamp, pose, left, right)

    try:
        report = run_sequence(
            pipe,
            rectified_frames(seq.frames(stride=args.stride)),
            max_frames=args.max_frames,
            trace_dir=args.trace,
        )
        if args.ate and gt_positions:
            # the generator may have yielded one frame past max_frames before
            # run_sequence stopped: keep the ground truth of stored rows only
            n_posed = int(pipe.store.pose_valid[: pipe.store.size].sum())
            report = evaluate_against_gt(
                pipe, report, np.asarray(gt_positions[:n_posed], np.float32)
            )

        os.makedirs(args.out, exist_ok=True)
        traj = pipe.optimize_trajectory()
        if traj is not None:
            np.save(os.path.join(args.out, "trajectory.npy"), traj)
            img = trajectory_topdown(
                traj,
                world_id=pipe.store.world_id[: pipe.store.size],
                loop_pairs=[(e.idx_prev, e.idx_curr) for e in pipe.loop_edges],
            )
            np.save(os.path.join(args.out, "trajectory_render.npy"), img)

        with open(os.path.join(args.out, "report.json"), "w") as f:
            json.dump(
                {
                    "report": report.as_json(),
                    "status": pipe.status(),
                    "loop_edges": [e.as_json() for e in pipe.loop_edges],
                    "found_loops": pipe.found_loops_json(),
                },
                f,
                indent=2,
            )
        print(json.dumps(report.as_json()), flush=True)

        if args.save_state:
            save_pipeline_state(pipe, args.save_state)
            print(f"state saved to {args.save_state}", flush=True)
    finally:
        pipe.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
