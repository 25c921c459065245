"""Self-contained full-system demo on a synthetic world, no dataset needed
(counterpart of scripts/run_synthetic.py).

Renders a textured two-plane scene from a loopy trajectory, then a kidnap
and a mis-anchored second session that revisits the start, streams it
through the whole engine (batched gist descriptors, loop detection on
kernel K1, tier-1 geometric verification on kernel K3, the multi-world
pose-graph merge) and writes ``result.json``, ``trajectory_render.npy``
and the ``debug/`` dump under ``--out``:

    python -m cerebro_tpu_torch.run_synthetic --out DIR [--cpu] [--frames 14]

It prints the result without its timings, then ``OK`` when at least one
loop edge was verified and the second session's merged ATE is under 0.3 m,
else ``DEGRADED``. It runs on the CUDA device; ``--cpu`` runs on the CPU.
The frames are rendered on the CPU through ``geometry.stereo.
remap_bilinear`` (they are the run's input data), so both packages feed
the engine the same images.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from cerebro_tpu_torch.pretrain_synthetic import fractal_texture

H, W, FX = 240, 320, 300.0
CX, CY, BASE = W / 2, H / 2, 0.11
Z_NEAR, Z_FAR, X_SPLIT = 4.0, 7.0, 0.0
TEXTURE_SEED = 11
# the second session's anchor: yaw 0.35 rad and 4 m off the first's
KIDNAP_YAW, KIDNAP_X = 0.35, 4.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run the engine over a synthetic two-session world.")
    # no default: the JAX script writes to /tmp/cerebro_synth
    ap.add_argument("--out", required=True, help="directory for result.json, the render and debug/")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA device")
    ap.add_argument("--frames", type=int, default=14)
    return ap.parse_args(argv)


def _pose(ypr, t) -> np.ndarray:
    from cerebro_tpu_torch.geometry import se3

    R = se3.ypr_to_rot(torch.tensor(ypr, dtype=torch.float32))
    return se3.make_pose(R, torch.tensor(t, dtype=torch.float32)).numpy()


def cam_pose(i: int) -> np.ndarray:
    """(4, 4) float32 w_T_c of the first session's frame ``i``."""
    return _pose([0.02 * i, 0.0, 0.0], [0.35 * i, 0.05 * i, 0.0])


def kidnap_offset() -> np.ndarray:
    """(4, 4) float32: the second session's world in the first's."""
    return _pose([KIDNAP_YAW, 0.0, 0.0], [KIDNAP_X, 0.0, 0.0])


def render(tex: np.ndarray, w_T_c: np.ndarray) -> np.ndarray:
    """(H, W) uint8 view of the two-plane world (near plane left of
    X_SPLIT, far plane right of it) from ``w_T_c``: rays in numpy, the
    texture sampled by ``remap_bilinear`` on the CPU."""
    from cerebro_tpu_torch.geometry.stereo import remap_bilinear

    R, tv = w_T_c[:3, :3], w_T_c[:3, 3]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    rays = np.stack([(u - CX) / FX, (v - CY) / FX, np.ones_like(u)], -1)
    dirs = rays @ R.T
    s_near = (Z_NEAR - tv[2]) / dirs[..., 2]
    p_near = tv[None, None] + s_near[..., None] * dirs
    s = np.where(p_near[..., 0] < X_SPLIT, s_near, (Z_FAR - tv[2]) / dirs[..., 2])
    p = tv[None, None] + s[..., None] * dirs
    tx = p[..., 0] * 150.0 + tex.shape[1] / 2
    ty = p[..., 1] * 150.0 + tex.shape[0] / 2
    img = remap_bilinear(torch.from_numpy(tex), torch.from_numpy(np.stack([tx, ty], -1))).numpy()
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def stereo_pair(tex: np.ndarray, T: np.ndarray):
    """(left, right) views of a rectified rig whose left camera is at ``T``."""
    Tr = T.copy()
    Tr[:3, 3] += T[:3, :3] @ np.array([BASE, 0, 0], np.float32)
    return render(tex, T), render(tex, Tr)


def make_config(out: str):
    """The demo's engine settings (the JAX script's)."""
    from cerebro_tpu_torch.config import (
        CerebroConfig, DescriptorConfig, LoopConfig, PoseGraphConfig, RuntimeConfig, VerifyConfig,
    )

    return CerebroConfig(
        descriptor=DescriptorConfig(image_hw=(H, W), trunk_dim=64, num_clusters=4, kind="gist"),
        loop=LoopConfig(db_capacity=1024, exclusion_window=6),
        verify=dataclasses.replace(
            VerifyConfig(), max_features=1024, ransac_hypotheses=128,
            gms_factor=4.0, min_matches_accept=200, min_pair_dt_s=2.0,
        ),
        posegraph=PoseGraphConfig(max_gn_iters=10, cg_iters=60),
        runtime=RuntimeConfig(descriptor_batch=4, stash_dir=os.path.join(out, "stash"),
                              image_ram_window_s=1e9),
    )


def main(argv=None) -> dict:
    """Run the demo; returns the result dict written to ``result.json``
    (``status``, ``verified_edges``, ``session2_merged_ate_m``,
    ``session2_anchor_error_m``, ``timings_ms``) plus ``ok``, the verdict."""
    args = parse_args(argv)
    from cerebro_tpu_torch.eval import ate_rmse
    from cerebro_tpu_torch.geometry import stereo
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline
    from cerebro_tpu_torch.utils.plot import trajectory_topdown
    from cerebro_tpu_torch.utils.timing import StageTimer

    # None: the CUDA device, or the pipeline raises
    device = "cpu" if args.cpu else None
    rig = stereo.RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=FX, fy=FX, cx=CX, cy=CY, baseline=BASE)
    pipe = CerebroPipeline(make_config(args.out), rig=rig, device=device)
    tex = fractal_texture(np.random.default_rng(TEXTURE_SEED))
    timer = StageTimer()
    try:
        print("session 1: mapping...", flush=True)
        t = 0.0
        n = args.frames
        for i in range(n):
            la, ra = stereo_pair(tex, cam_pose(i))
            with timer.stage("ingest"):
                pipe.ingest_frame(t, la, n_tracked=100, pose=cam_pose(i), right_img=ra)
            t += 1.0

        print("kidnap + session 2 (mis-anchored): revisiting...", flush=True)
        off = kidnap_offset()
        t += 50.0
        revisit = list(range(2, min(6, n - 1)))
        for i in revisit:
            la, ra = stereo_pair(tex, cam_pose(i))
            with timer.stage("ingest"):
                pipe.ingest_frame(t, la, n_tracked=100, pose=off @ cam_pose(i), right_img=ra)
            t += 1.0

        with timer.stage("flush"):
            pipe.flush_descriptors()
        with timer.stage("verify"):
            n_acc = pipe.verify_pending()
        with timer.stage("optimize"):
            traj = pipe.optimize_trajectory()

        gt = np.stack([cam_pose(i)[:3, 3] for i in revisit])
        est = traj[n : n + len(revisit), :3, 3]
        ate = ate_rmse(est, gt, align=False)

        os.makedirs(args.out, exist_ok=True)
        pipe.dump_debug(os.path.join(args.out, "debug"))
        img = trajectory_topdown(
            traj, world_id=pipe.store.world_id[: pipe.store.size],
            loop_pairs=[(e.idx_prev, e.idx_curr) for e in pipe.loop_edges],
        )
        np.save(os.path.join(args.out, "trajectory_render.npy"), img)

        result = {
            "status": pipe.status(),
            "verified_edges": n_acc,
            "session2_merged_ate_m": round(ate, 4),
            "session2_anchor_error_m": KIDNAP_X,
            "timings_ms": timer.stats(),
        }
    finally:
        pipe.close()
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "timings_ms"}, indent=2))
    ok = n_acc >= 1 and ate < 0.3
    print("OK" if ok else "DEGRADED", flush=True)
    return {**result, "ok": ok}


if __name__ == "__main__":
    main()
