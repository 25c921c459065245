"""The photo world and its stereo renderer: the benchmark's own frozen copy.

The ground is a polar mosaic of the nine photographs in
``artifacts/photoworld_photos.npz``: one photo per angular sector, each
~2 m polar cell painted with a different crop of its sector's photo, plus a
5% dither, over a plateau mask (raised terrain 1.5 m below a 6 m flight
height). A nadir rectified stereo rig flies over it; its image size,
intrinsics and baseline are the configuration's ``rig`` (the EuRoC rig:
752x480, fx 458.654, baseline 0.11 m). The world is built in numpy, once per checkout, and kept in
``portbench/_cache``; frames are rendered on the run's device in batches
(two gathers and a select per frame), so a run pays neither the build nor a
per-frame host render.

The arithmetic follows ``PhotoWorld.create`` and ``Renderer`` of the
system's photo world at the time the benchmark was written; the benchmark
never imports them, so a change to the system cannot move its inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PHOTOS_NPZ = ROOT.parent / "artifacts" / "photoworld_photos.npz"
CACHE_DIR = ROOT / "_cache"

FLIGHT_H = 6.0
PLATEAU = 1.5
R_NADIR = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)


def body_T_cam() -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R_NADIR
    return T


BAND_ROWS = 256  # rows of the world built at once: host memory beyond the output is a band's


def _smooth_mask(rng, n: int) -> np.ndarray:
    """The plateau mask: two scales of noise blown up and smoothed by three
    passes of a 4-neighbour mean that wraps around the world, normalised
    by its range, above 0.62. Built in bands of ``BAND_ROWS`` rows, each
    with the three rows beyond it on either side that the passes read."""
    band = BAND_ROWS
    scales = [(128, rng.normal(size=(n // 128, n // 128)).astype(np.float32)),
              (256, rng.normal(size=(n // 256, n // 256)).astype(np.float32))]
    halo = 3

    def smoothed(i0: int, i1: int) -> np.ndarray:
        rows = np.arange(i0 - halo, i1 + halo) % n
        out = np.zeros((len(rows), n), np.float32)
        for scale, small in scales:
            big = np.repeat(small[rows // scale], scale, axis=1)
            for _ in range(3):
                big = 0.25 * (np.roll(big, 1, 0) + np.roll(big, -1, 0)
                              + np.roll(big, 1, 1) + np.roll(big, -1, 1))
            out += big
        return out[halo:halo + i1 - i0]

    bands = [(i0, min(i0 + band, n)) for i0 in range(0, n, band)]
    lo, hi = np.float32(np.inf), np.float32(-np.inf)
    for i0, i1 in bands:
        s = smoothed(i0, i1)
        lo, hi = min(lo, s.min()), max(hi, s.max())
    mask = np.empty((n, n), bool)
    for i0, i1 in bands:
        mask[i0:i1] = (smoothed(i0, i1) - lo) / (hi - lo) > 0.62
    return mask


def build_world(seed: int, n: int, tex_m: float, n_sectors: int, cell_m: float,
                r_max_m: float) -> tuple:
    """(texture (n, n) float32 in [0, 1], plateau mask (n, n) bool), built
    in bands of ``BAND_ROWS`` rows: the same numbers for any band, the
    generator drawn in the same order."""
    band = BAND_ROWS
    rng = np.random.default_rng(seed)
    with np.load(PHOTOS_NPZ) as z:
        photos = [z[f"photo_{k}"] for k in range(len(z.files))]
    if len(photos) < n_sectors:
        raise ValueError(f"{n_sectors} sectors need as many photos, have {len(photos)}")
    cell_px = int(cell_m * tex_m)
    ax = (np.arange(n, dtype=np.float32) - n / 2) / tex_m
    sector_phi = 2 * np.pi / n_sectors
    cell_phi = cell_m / (r_max_m / 1.4)
    cells_per_sector = max(int(round(sector_phi / cell_phi)), 1)
    cell_phi = sector_phi / cells_per_sector
    tex = np.empty((n, n), np.float32)
    for i0 in range(0, n, band):
        wx, wy = np.meshgrid(ax, ax[i0:i0 + band])
        r = np.hypot(wx, wy)
        phi = np.mod(np.arctan2(wy, wx), 2 * np.pi)
        sector = np.minimum((phi / sector_phi).astype(np.int32), n_sectors - 1)
        ci = (phi / cell_phi).astype(np.int64)
        rj = (r / cell_m).astype(np.int64)
        u = (phi / cell_phi - ci).astype(np.float32)
        v = (r / cell_m - rj).astype(np.float32)
        t = np.zeros(r.shape, np.float32)
        for k in range(n_sectors):
            m = sector == k
            if not m.any():
                continue
            ph = photos[k]
            ph_h, ph_w = ph.shape
            sh, sw = min(cell_px, ph_h - 1), min(cell_px, ph_w - 1)
            cid = ci[m] * 100003 + rj[m] * 193
            h1 = (cid * 2654435761 + seed) & 0xFFFFFFFF
            h2 = (cid * 40503 + 9176 + seed) & 0xFFFFFFFF
            oy = (h1 % max(ph_h - sh, 1)).astype(np.int64)
            ox = (h2 % max(ph_w - sw, 1)).astype(np.int64)
            py = oy + np.minimum((v[m] * sh).astype(np.int64), sh - 1)
            px = ox + np.minimum((u[m] * sw).astype(np.int64), sw - 1)
            t[m] = ph[py, px]
        tex[i0:i0 + band] = t
    # the dither, drawn row after row as one (n, n) draw would be
    for i0 in range(0, n, band):
        rows = tex[i0:i0 + band]
        rows[:] = np.clip(rows + 0.05 * rng.standard_normal(rows.shape).astype(np.float32), 0, 1)
    return tex, _smooth_mask(rng, n)


def load_world(params: dict) -> tuple:
    """The world of ``params`` (the traffic file's ``world``), from the
    checkout's cache when an earlier run built it. Returns (tex, mask,
    tex_m, built): ``built`` says whether this call built it."""
    key = hashlib.sha1(json.dumps(params, sort_keys=True).encode()).hexdigest()[:12]
    path = CACHE_DIR / f"world-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["tex"], z["mask"], float(params["tex_m"]), False
    tex, mask = build_world(**params)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, tex=tex, mask=mask)
    os.replace(tmp, path)
    return tex, mask, float(params["tex_m"]), True


class Renderer:
    """Nadir stereo frames of the world on ``device``, in batches. The
    per-pixel ground offsets of the two terrain planes are fixed (the
    orientation never changes), so a frame is two texture gathers and a
    select, as in the system's renderer."""

    def __init__(self, tex: np.ndarray, mask: np.ndarray, tex_m: float, device, rig: dict):
        self.device = torch.device(device)
        self.rig = rig
        h, w = rig["image_hw"]
        self.n = tex.shape[0]
        self.tex_m = tex_m
        self.tex = torch.from_numpy(tex).to(self.device).reshape(-1)
        self.mask = torch.from_numpy(mask).to(self.device).reshape(-1)
        u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        rays = np.stack([(u - rig["cx"]) / rig["fx"], (v - rig["cy"]) / rig["fy"], np.ones_like(u)], axis=-1)
        dirs = rays @ R_NADIR.T
        s_low = (0.0 - FLIGHT_H) / dirs[..., 2]
        s_high = (PLATEAU - FLIGHT_H) / dirs[..., 2]
        self.off_low = torch.from_numpy(s_low[..., None] * dirs[..., :2]).to(self.device)
        self.off_high = torch.from_numpy(s_high[..., None] * dirs[..., :2]).to(self.device)

    def _index(self, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
        n = self.n
        tx = torch.remainder((wx * self.tex_m + n / 2).to(torch.int64), n)
        ty = torch.remainder((wy * self.tex_m + n / 2).to(torch.int64), n)
        return ty * n + tx

    def render(self, xy: np.ndarray) -> torch.Tensor:
        """(F, H, W) uint8 views from cameras at xy (F, 2), on the device."""
        x = torch.as_tensor(np.asarray(xy, np.float32), device=self.device)
        X, Y = x[:, 0, None, None], x[:, 1, None, None]
        lx, ly = X + self.off_low[..., 0], Y + self.off_low[..., 1]
        hx, hy = X + self.off_high[..., 0], Y + self.off_high[..., 1]
        raised = self.mask[self._index(lx, ly)]
        gx = torch.where(raised, hx, lx)
        gy = torch.where(raised, hy, ly)
        return (self.tex[self._index(gx, gy)] * 255.0).to(torch.uint8)

    def stereo_frames(self, xy: np.ndarray, chunk: int = 128) -> tuple:
        """(left, right) host uint8 stacks (F, H, W) of the stereo pairs at
        xy: the right camera sits the rig's baseline along world x."""
        xy = np.asarray(xy, np.float32)
        right_xy = xy + np.array([self.rig["baseline"], 0.0], np.float32)
        left = np.empty((len(xy), *self.rig["image_hw"]), np.uint8)
        right = np.empty_like(left)
        for s in range(0, len(xy), chunk):
            left[s:s + chunk] = self.render(xy[s:s + chunk]).cpu().numpy()
            right[s:s + chunk] = self.render(right_xy[s:s + chunk]).cpu().numpy()
        return left, right


def ground_footprint(rig: dict) -> tuple:
    """(x_min, x_max, y_min, y_max): the ground plane's offsets from the
    left camera that the rig's image edges reach from the flight height."""
    h, w = rig["image_hw"]
    u, v = np.meshgrid([0.0, float(w)], [0.0, float(h)])
    rays = np.stack([(u - rig["cx"]) / rig["fx"], (v - rig["cy"]) / rig["fy"], np.ones_like(u)], -1)
    dirs = rays.reshape(-1, 3) @ R_NADIR.T.astype(np.float64)
    off = dirs[:, :2] * ((0.0 - FLIGHT_H) / dirs[:, 2:])
    return tuple(float(f(off[:, k])) for k in (0, 1) for f in (np.min, np.max))


def union_footprint(rig: dict) -> tuple:
    """(x_min, x_max, y_min, y_max): the ground that either camera sees,
    as offsets from the left one; the right camera sits the baseline
    along x."""
    x0, x1, y0, y1 = ground_footprint(rig)
    return x0, x1 + float(rig["baseline"]), y0, y1


def check_period(xy: np.ndarray, params: dict, rig: dict):
    """Refuse camera positions whose ground footprint, both cameras', leaves
    the texture's period: the renderer wraps the world, so ground beyond it
    is ground seen elsewhere."""
    n, tex_m = int(params["n"]), float(params["tex_m"])
    half = n / (2 * tex_m)
    x0, x1, y0, y1 = union_footprint(rig)
    xy = np.asarray(xy, np.float64)
    lo = np.array([xy[:, 0].min() + x0, xy[:, 1].min() + y0])
    hi = np.array([xy[:, 0].max() + x1, xy[:, 1].max() + y1])
    reach = float(max(-lo.min(), hi.max()))
    if reach >= half:
        raise ValueError(f"the cameras see ground {reach:.2f} m from the world's centre; the texture "
                         f"repeats with a period of {2 * half:.2f} m ({n} px at {tex_m:g} px/m), so it "
                         f"holds ground within +-{half:.2f} m")


def rig_params(rig: dict) -> dict:
    """The rectified rig's numbers (identity rectification)."""
    return {k: float(rig[k]) for k in ("fx", "fy", "cx", "cy", "baseline")}
