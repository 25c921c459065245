"""Stereo geometry: block-matching disparity and 3D point maps (counterpart
of cerebro_tpu/geometry/stereo.py, the rectified path verification uses).

``block_match`` is the port's one stereo function: SAD block matching over
a disparity sweep (parity target StereoBM numDisparities=64, blockSize=21,
ref src/utils/CameraGeometry.cpp:81). It is the plain version of kernel K3
(``ops/stereo_kernel.py``), the CPU path, and the counterpart of the JAX
package's XLA ``block_match``. ``depth_pipeline_rectified`` launches K3 for
CUDA tensors at any image height (the TPU's ``H % 16`` condition is a TPU
layout rule).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


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
