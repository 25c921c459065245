"""Procedural long-sequence world for end-to-end accuracy benchmarking.

The reference's accuracy evidence is live EuRoC runs watched in rviz
(README.md:17-60); no dataset ships with this environment, so this module
renders a controlled substitute with *exact* ground truth: an aerial
stereo rig on a circular survey circuit over two-level textured terrain,
traversed several laps (planted revisits), with a mid-run kidnap
(teleport + feature collapse, the physical scenario of
src/Cerebro.cpp:2235-2381) and a VINS-like drifting odometry model.

Geometry: nadir camera at height ``H`` over ground plane z=0 with raised
plateaus z=``PLATEAU``; because the orientation is constant, per-pixel ray
directions and plane range factors are precomputed once — rendering is two
texture gathers per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# rig (matches the scale of the reference's EuRoC runs: 240x320 descriptor
# input, fx 300, baseline 0.11 — same constants as the verification tests)
IMG_H, IMG_W = 240, 320
FX = FY = 300.0
CX, CY = IMG_W / 2, IMG_H / 2
BASELINE = 0.11

FLIGHT_H = 6.0  # camera height (m)
PLATEAU = 1.5  # raised-terrain height (m): depths 4.5 and 6.0
TEX_M = 150.0  # texture pixels per metre


def _smooth_noise(rng, n, octaves) -> np.ndarray:
    out = np.zeros((n, n), np.float32)
    for scale, amp in octaves:
        small = rng.normal(size=(n // scale, n // scale)).astype(np.float32)
        big = np.kron(small, np.ones((scale, scale), np.float32))
        for _ in range(3):
            big = 0.25 * (
                np.roll(big, 1, 0) + np.roll(big, -1, 0)
                + np.roll(big, 1, 1) + np.roll(big, -1, 1)
            )
        out += amp * big
    return (out - out.min()) / (out.max() - out.min())


@dataclasses.dataclass
class CircuitWorld:
    tex: np.ndarray  # (N, N) float32 ground texture
    mask: np.ndarray  # (N, N) bool — True where terrain is raised

    @classmethod
    def create(cls, seed: int = 0, n: int = 4096) -> "CircuitWorld":
        rng = np.random.default_rng(seed)
        tex = _smooth_noise(rng, n, [(4, 0.5), (16, 1.0), (64, 2.0)])
        height = _smooth_noise(rng, n, [(128, 1.0), (256, 1.0)])
        return cls(tex=tex, mask=height > 0.62)

    def _sample(self, wx: np.ndarray, wy: np.ndarray, arr: np.ndarray):
        n = arr.shape[0]
        tx = (wx * TEX_M + n / 2).astype(np.int64) % n
        ty = (wy * TEX_M + n / 2).astype(np.int64) % n
        return arr[ty, tx]


# nadir mount: body x -> cam x, body y -> cam -y (image rows look +x/+(-y)),
# optical axis (cam z) points down (world -z)
R_NADIR = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)


def body_T_cam() -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R_NADIR
    return T


class Renderer:
    """Constant-orientation renderer: ray directions and per-plane range
    factors precomputed once; each frame is two gathers + a mask select."""

    def __init__(self, world: CircuitWorld):
        self.world = world
        u, v = np.meshgrid(
            np.arange(IMG_W, dtype=np.float32), np.arange(IMG_H, dtype=np.float32)
        )
        rays = np.stack([(u - CX) / FX, (v - CY) / FY, np.ones_like(u)], axis=-1)
        self.dirs = rays @ R_NADIR.T  # world directions, dz < 0
        # per-plane scale s solves t_z + s*dz = Z  ->  s = (Z - H)/dz
        self.s_low = (0.0 - FLIGHT_H) / self.dirs[..., 2]
        self.s_high = (PLATEAU - FLIGHT_H) / self.dirs[..., 2]
        # precomputed ray-plane offsets in world x/y (translation-invariant)
        self.off_low = self.s_low[..., None] * self.dirs[..., :2]
        self.off_high = self.s_high[..., None] * self.dirs[..., :2]

    def render(self, x: float, y: float) -> np.ndarray:
        """(H, W) uint8 view from camera at (x, y, FLIGHT_H), nadir."""
        w = self.world
        lx, ly = x + self.off_low[..., 0], y + self.off_low[..., 1]
        hx, hy = x + self.off_high[..., 0], y + self.off_high[..., 1]
        raised = w._sample(lx, ly, w.mask)
        gx = np.where(raised, hx, lx)
        gy = np.where(raised, hy, ly)
        img = w._sample(gx, gy, w.tex)
        return (img * 255.0).astype(np.uint8)

    def stereo(self, x: float, y: float) -> Tuple[np.ndarray, np.ndarray]:
        # right camera offset by +BASELINE along camera x = world x
        return self.render(x, y), self.render(x + BASELINE, y)

    def depth(self, x: float, y: float) -> np.ndarray:
        """(H, W) float32 metric depth (z in camera frame) — exact GT."""
        w = self.world
        lx, ly = x + self.off_low[..., 0], y + self.off_low[..., 1]
        raised = w._sample(lx, ly, w.mask)
        return np.where(raised, FLIGHT_H - PLATEAU, FLIGHT_H).astype(np.float32)

    def rig(self):
        from cerebro_tpu_torch.geometry import stereo

        return stereo.RectifiedRig(
            R0=np.eye(3, dtype=np.float32), R1=np.eye(3, dtype=np.float32),
            fx=FX, fy=FY, cx=CX, cy=CY, baseline=BASELINE,
        )


# ---------------------------------------------------------------------------
# Trajectory + odometry-noise model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Sequence:
    """Fully-specified benchmark sequence."""

    xy: np.ndarray  # (N, 2) GT camera positions (world)
    gt_poses: np.ndarray  # (N, 4, 4) GT w_T_cam
    odom_poses: np.ndarray  # (N, 4, 4) drifted VINS-like w_T_cam (per world)
    n_tracked: np.ndarray  # (N,) feature counts (collapses during kidnap)
    is_keyframe: np.ndarray  # (N,) bool
    stamps: np.ndarray  # (N,) seconds
    kidnap_span: Tuple[int, int]  # [start, end) frames of the kidnap


def make_sequence(
    n_frames: int = 1000,
    laps: float = 3.5,
    radius: float = 8.0,
    dt: float = 0.1,
    kidnap_at: float = 0.55,  # fraction of the run
    kidnap_frames: int = 35,  # > 3 s at dt=0.1 (ref sustained threshold)
    teleport_phase: float = 0.3,  # laps jumped during the kidnap
    yaw_drift: float = 0.0012,  # rad/frame bias (VINS-like slow heading drift)
    noise_seed: int = 7,
) -> Sequence:
    rng = np.random.default_rng(noise_seed)
    theta = np.linspace(0.0, 2 * np.pi * laps, n_frames).astype(np.float64)
    k0 = int(n_frames * kidnap_at)
    k1 = min(k0 + kidnap_frames, n_frames)
    # teleport: everything after the kidnap continues at a jumped phase
    theta[k0:] += 2 * np.pi * teleport_phase

    xy = np.stack([radius * np.cos(theta), radius * np.sin(theta)], axis=-1)
    b_T_c = body_T_cam()

    gt = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    gt[:, :3, :3] = R_NADIR
    gt[:, 0, 3] = xy[:, 0]
    gt[:, 1, 3] = xy[:, 1]
    gt[:, 2, 3] = FLIGHT_H

    # drifting odometry: integrate GT body-frame increments with a yaw
    # random-walk + translation noise; world 1 (post-kidnap) restarts from
    # identity in a NEW frame (VINS reset semantics, README.md:177-186)
    odom = np.zeros_like(gt)
    kappa = 0.0  # accumulated yaw error
    cur = np.eye(4, dtype=np.float64)
    cur[:3, :3] = R_NADIR.astype(np.float64)
    cur[:3, 3] = gt[0, :3, 3]
    for i in range(n_frames):
        if i == k1:  # recovery: new world origin (arbitrary frame)
            cur = np.eye(4, dtype=np.float64)
            cur[:3, :3] = R_NADIR.astype(np.float64)
            kappa = 0.0
        if i > 0 and i != k1:
            d = gt[i, :3, 3].astype(np.float64) - gt[i - 1, :3, 3]
            kappa += yaw_drift + rng.normal(0.0, 0.0004)
            c, s = np.cos(kappa), np.sin(kappa)
            Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            step = Rz @ d * (1.0 + rng.normal(0.0, 0.01))
            cur = cur.copy()
            cur[:3, 3] += step
            cur[:3, :3] = Rz @ R_NADIR.astype(np.float64)
        odom[i] = cur.astype(np.float32)

    n_tracked = np.full(n_frames, 120, np.int32)
    n_tracked[k0:k1] = 4  # feature collapse (ref <15 kidnap rule)
    is_kf = np.ones(n_frames, bool)
    is_kf[k0:k1] = False
    stamps = 1.0 + dt * np.arange(n_frames)
    return Sequence(
        xy=xy.astype(np.float32),
        gt_poses=gt,
        odom_poses=odom,
        n_tracked=n_tracked,
        is_keyframe=is_kf,
        kidnap_span=(k0, k1),
        stamps=stamps.astype(np.float64),
    )


def revisit_ground_truth(
    seq: Sequence, exclusion: int = 50, min_dt: float = 10.0, radius_m: float = 0.8
) -> np.ndarray:
    """(N,) bool: frame i has at least one genuine revisit opportunity — an
    earlier frame at the same place, outside the temporal exclusion window.
    Used for candidate recall; precision checks a pair's GT distance."""
    xy = seq.xy
    n = len(xy)
    out = np.zeros(n, bool)
    for i in range(n):
        if not seq.is_keyframe[i]:
            continue
        js = np.arange(0, i - exclusion)
        if len(js) == 0:
            continue
        ok = (seq.stamps[i] - seq.stamps[js] > min_dt) & seq.is_keyframe[js]
        if not ok.any():
            continue
        d = np.linalg.norm(xy[js][ok] - xy[i], axis=1)
        out[i] = bool((d < radius_m).any())
    return out
