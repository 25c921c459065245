"""Stereo geometry: rectification, block-matching disparity and 3D point
maps (counterpart of cerebro_tpu/geometry/stereo.py).

  * ``stereo_rectify``  — Bouguet-style rectifying rotations + common
                          pinhole intrinsics from two camera models and the
                          extrinsic ``c1_T_c0`` (cv::stereoRectify, ref
                          src/utils/CameraGeometry.cpp:271-357);
  * ``rectify_map``     — per-pixel source coordinates through the original
                          (distorted) camera (initUndistortRectifyMap);
  * ``remap_bilinear``  — bilinear warp, zero beyond a half-pixel border;
  * ``StereoRectifier`` — both maps built once on the device, every frame
                          remapped in numpy on the host;
  * ``block_match``     — SAD block matching over a disparity sweep (parity
                          target StereoBM numDisparities=64, blockSize=21,
                          ref src/utils/CameraGeometry.cpp:81): the plain
                          version of kernel K3 (``ops/stereo_kernel.py``)
                          and the CPU path. ``depth_pipeline_rectified``
                          launches K3 for CUDA tensors at any image height
                          (the TPU's ``H % 16`` condition is a TPU layout
                          rule).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cerebro_tpu_torch.geometry import cameras as cam_mod
from cerebro_tpu_torch.geometry import se3


@dataclasses.dataclass(frozen=True)
class RectifiedRig:
    """Everything needed to triangulate a rectified stereo pair."""

    R0: np.ndarray  # (3,3) rectifying rotation for cam0
    R1: np.ndarray  # (3,3) rectifying rotation for cam1
    fx: float  # common focal
    fy: float
    cx: float
    cy: float
    baseline: float  # metres


def stereo_rectify(cam0, cam1, c1_T_c0) -> RectifiedRig:
    """Bouguet rectification: split the relative rotation between both
    cameras, then align the x-axis with the baseline (cv::stereoRectify as
    used at ref src/utils/CameraGeometry.cpp:271-357). Float32 on the host,
    as the JAX package computes it."""
    T = torch.as_tensor(np.asarray(c1_T_c0), dtype=torch.float32)
    R, t = T[:3, :3], T[:3, 3]
    # each camera rotates by half of R
    w = se3.so3_log(R)
    R_half_0 = se3.so3_exp(w / 2.0)
    R_half_1 = se3.so3_exp(-w / 2.0)
    # the baseline in the "mean" frame; new x along it, pointing +x
    t_mean = R_half_1 @ t
    e1 = t_mean / torch.linalg.vector_norm(t_mean)
    e1 = -e1 if bool(t_mean[0] < 0) else e1
    e2 = torch.stack([-e1[1], e1[0], torch.zeros_like(e1[0])])
    e2 = e2 / torch.clamp(torch.linalg.vector_norm(e2), min=1e-9)
    R_align = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], dim=0)

    def mean(a, b):
        return float((a + b) / 2.0)  # the f32 value, exactly

    return RectifiedRig(
        R0=(R_align @ R_half_0).numpy(),
        R1=(R_align @ R_half_1).numpy(),
        fx=mean(cam0.fx, cam1.fx),
        fy=mean(cam0.fy, cam1.fy),
        cx=mean(cam0.cx, cam1.cx),
        cy=mean(cam0.cy, cam1.cy),
        baseline=float(torch.linalg.vector_norm(t)),
    )


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def rectify_map(cam, R_rect, rig: RectifiedRig, out_hw: Tuple[int, int], device=None):
    """(H, W, 2) map on ``device``: rectified pixel -> source pixel in the
    original distorted image (initUndistortRectifyMap equivalent).
    ``device`` defaults to the CUDA device; without CUDA pass
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rectify_map runs on the CUDA device and none is available; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    H, W = out_hw
    R = torch.as_tensor(np.asarray(R_rect), dtype=torch.float32, device=device)
    f32 = torch.float32
    vv, uu = torch.meshgrid(
        torch.arange(H, dtype=f32, device=device),
        torch.arange(W, dtype=f32, device=device),
        indexing="ij",
    )
    x = (uu - _f32(rig.cx)) / _f32(rig.fx)
    y = (vv - _f32(rig.cy)) / _f32(rig.fy)
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)  # (H, W, 3)
    rays_src = rays @ R  # R_rect^T applied: rotates back to the source camera
    return cam_mod.project(cam, rays_src.reshape(-1, 3)).reshape(H, W, 2)


def remap_bilinear(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (H, W) at map_xy (..., 2); out-of-range -> 0."""
    H, W = img.shape
    x_raw, y_raw = map_xy[..., 0], map_xy[..., 1]
    # replicate-edge: clamp BEFORE floor so near-border coords use the
    # right neighbour pair (floor(-1e-6) would otherwise flip the weights)
    x = torch.clamp(x_raw, 0.0, W - 1.0)
    y = torch.clamp(y_raw, 0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = torch.clamp(x0.long(), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    out = (
        img[y0i, x0i] * (1 - wx) * (1 - wy)
        + img[y0i, x1i] * wx * (1 - wy)
        + img[y1i, x0i] * (1 - wx) * wy
        + img[y1i, x1i] * wx * wy
    )
    # half-pixel tolerance at the border (replicate-edge), hard zero beyond
    inside = (x_raw >= -0.5) & (x_raw <= W - 0.5) & (y_raw >= -0.5) & (y_raw <= H - 0.5)
    return torch.where(inside, out, torch.zeros_like(out))


def _np_bilinear_taps(map_xy: np.ndarray, hw: Tuple[int, int]):
    """The four (flat source index, weight) taps per output pixel of a
    replicate-edge bilinear sample at ``map_xy`` (the JAX package's
    ``_np_bilinear``: clamp, floor, neighbours clipped at the last row and
    column; no zeroing outside)."""
    H, W = hw
    x = np.clip(map_xy[..., 0], 0.0, W - 1.0)
    y = np.clip(map_xy[..., 1], 0.0, H - 1.0)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx, wy = x - x0, y - y0
    idx = np.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1]).reshape(4, -1)
    wts = np.stack(
        [(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy]
    ).reshape(4, -1)
    return idx.astype(np.intp), wts


class StereoRectifier:
    """Precomputed raw->rectified remapping for a stereo rig, the front half
    of the reference's StereoGeometry (stereoRectify +
    initUndistortRectifyMap + remap, ref CameraGeometry.cpp:271-383).

    Both maps are computed once on ``device`` (rectify_map through the full
    camera models) and kept on the host with their bilinear taps; every
    frame is then remapped in numpy, so ingest never round-trips the
    device for preprocessing. ``device`` defaults to the CUDA device;
    without CUDA pass ``device="cpu"``.
    """

    def __init__(self, cam0, cam1, c1_T_c0, out_hw, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "StereoRectifier builds its maps on the CUDA device and none "
                    "is available; pass device='cpu' to build them on the CPU"
                )
            device = "cuda"
        self.rig = stereo_rectify(cam0, cam1, c1_T_c0)
        self.out_hw = tuple(out_hw)
        self.map0 = rectify_map(cam0, self.rig.R0, self.rig, self.out_hw, device).cpu().numpy()
        self.map1 = rectify_map(cam1, self.rig.R1, self.rig, self.out_hw, device).cpu().numpy()
        self._taps = {}  # raw image shape -> the two maps' taps

    def _remap(self, which: int, raw) -> np.ndarray:
        raw = np.asarray(raw, np.float32)
        key = (which, raw.shape)
        if key not in self._taps:
            self._taps[key] = _np_bilinear_taps((self.map0, self.map1)[which], raw.shape)
        idx, wts = self._taps[key]
        out = (raw.reshape(-1)[idx] * wts).sum(axis=0)
        return out.reshape(self.out_hw).astype(np.float32)

    def rectify(self, left_raw, right_raw=None):
        """(left, right) rectified float32 images; right is None when
        ``right_raw`` is."""
        left = self._remap(0, left_raw)
        return left, None if right_raw is None else self._remap(1, right_raw)


def _box(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centred size x size box sum over the last two axes, zeros outside:
    a vertical then a horizontal pass, like the JAX ``_box``."""
    if size % 2 != 1:
        raise ValueError(f"block size must be odd, got {size}")
    shape = x.shape
    y = x.reshape(-1, 1, shape[-2], shape[-1])
    h = size // 2
    ones_v = torch.ones((1, 1, size, 1), dtype=x.dtype, device=x.device)
    ones_h = torch.ones((1, 1, 1, size), dtype=x.dtype, device=x.device)
    y = F.conv2d(y, ones_v, padding=(h, 0))
    y = F.conv2d(y, ones_h, padding=(0, h))
    return y.reshape(shape)


def block_match(
    left: torch.Tensor,  # (H, W) or (B, H, W) float32 rectified
    right: torch.Tensor,
    num_disp: int = 64,
    block: int = 21,
    uniqueness: float = 0.85,
    texture_thresh: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAD block matching. Returns (disparity float32, valid bool), each of
    the input's shape.

    Cost volume = |L(x,y) - R(x-d,y)| (1e3 where x < d) box-filtered
    (block x block, zeros outside the image), swept over d in
    [0, num_disp); first-minimum winner + parabola subpixel on the d0 +-1
    costs (d0 = clamp(winner, 1, num_disp-2)). Validity: uniqueness ratio
    against the best cost outside +-1 of the winner, texture check on
    box(|L - roll(L, 1)|), and border/d-range exclusion."""
    single = left.dim() == 2
    if single:
        left, right = left[None], right[None]
    left = left.float()
    right = right.float()
    B, H, W = left.shape
    dev = left.device
    d = torch.arange(num_disp, device=dev)
    col = torch.arange(W, device=dev)
    src = torch.clamp(col[None, :] - d[:, None], min=0)  # (D, W): column x - d
    shifted = right[:, :, src].permute(0, 2, 1, 3)  # (B, D, H, W)
    sad = (left[:, None] - shifted).abs()
    sad = torch.where(col >= d[:, None, None], sad, torch.full_like(sad, 1e3))
    costs = _box(sad, block)  # (B, D, H, W)

    best = costs.argmin(dim=1)  # first minimum
    cmin = costs.amin(dim=1)
    d0 = torch.clamp(best, 1, num_disp - 2)
    cm = torch.gather(costs, 1, (d0 - 1)[:, None])[:, 0]
    cc = torch.gather(costs, 1, d0[:, None])[:, 0]
    cp = torch.gather(costs, 1, (d0 + 1)[:, None])[:, 0]
    denom = torch.clamp(cm - 2 * cc + cp, min=1e-6)
    delta = torch.clamp(0.5 * (cm - cp) / denom, -1.0, 1.0)
    disp = d0.float() + delta

    far = (d[None, :, None, None] - best[:, None]).abs() > 1
    second = torch.where(far, costs, torch.full_like(costs, float("inf"))).amin(dim=1)
    unique_ok = cmin < uniqueness * second

    gx = left - torch.roll(left, 1, dims=-1)
    tex_ok = _box(gx.abs(), block) > texture_thresh

    range_ok = (best > 0) & (best < num_disp - 1) & (col >= num_disp)
    valid = unique_ok & tex_ok & range_ok
    if single:
        return disp[0], valid[0]
    return disp, valid


def disparity_to_points(
    disp: torch.Tensor,  # (..., H, W)
    valid: torch.Tensor,  # (..., H, W)
    rig: RectifiedRig,
    min_depth: float = 0.1,
    max_depth: float = 25.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., H, W, 3) points in the rectified cam0 frame + validity
    (reprojectImageTo3D + the 0.1-25 m gate of
    ref src/utils/PointFeatureMatching.cpp:125)."""
    H, W = disp.shape[-2:]
    z = rig.fx * rig.baseline / torch.clamp(disp, min=1e-6)
    u = torch.arange(W, dtype=torch.float32, device=disp.device)
    v = torch.arange(H, dtype=torch.float32, device=disp.device)[:, None]
    x = (u - rig.cx) * z / rig.fx
    y = (v - rig.cy) * z / rig.fy
    pts = torch.stack([x, y, z], dim=-1)
    ok = valid & (z > min_depth) & (z < max_depth)
    return pts, ok


def depth_to_points(
    depth: torch.Tensor,  # (..., H, W) metres (0 / non-finite = invalid)
    rig: RectifiedRig,
    min_depth: float = 0.1,
    max_depth: float = 25.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct depth-image unprojection, the depth-camera input path (the
    reference ingests CV_16UC1 depth images from realsense rigs,
    src/DataManager.cpp:851-886, src/ImageDataManager.cpp:254-259) in place
    of stereo block matching: no K3 launch."""
    H, W = depth.shape[-2:]
    z = depth
    u = torch.arange(W, dtype=torch.float32, device=depth.device)
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - rig.cx) * z / rig.fx
    y = (v - rig.cy) * z / rig.fy
    pts = torch.stack([x, y, z], dim=-1)
    ok = torch.isfinite(z) & (z > min_depth) & (z < max_depth)
    return pts, ok


def depth_pipeline_rectified(
    left: torch.Tensor,  # (H, W) or (B, H, W)
    right: torch.Tensor,
    rig: RectifiedRig,
    num_disp: int = 64,
    block: int = 21,
):
    """rectified pair(s) -> (points (...,H,W,3), valid (...,H,W), disparity).
    The 'rectified -> disparity -> 3d map' stack of ref
    CameraGeometry.h:94-231. CUDA tensors go through kernel K3."""
    from cerebro_tpu_torch.ops import stereo_kernel

    disp, dvalid = stereo_kernel.block_match(left, right, num_disp=num_disp, block=block)
    pts, ok = disparity_to_points(disp, dvalid, rig)
    return pts, ok, disp
