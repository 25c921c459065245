"""Intrinsic camera calibration from planar-target observations
(counterpart of cerebro_tpu/geometry/calibration.py).

The capability of camodocal's calibration tooling (reference
src/utils/camodocal/: CameraCalibration.cc, CostFunctionFactory.cc):
Zhang's method for the closed-form start (homographies -> the image of
the absolute conic -> K, then each view's pose), then a joint refinement
of the intrinsics and every view's se(3) pose minimizing the pixel
reprojection error over all views at once. The Jacobian is
``torch.func.jacfwd`` of the residual, which is batched over the views;
each iteration solves one set of normal equations.

Inputs are point correspondences (board-plane coordinates, observed
pixels); ``geometry/chessboard.py`` finds them in images. The functions
take numpy arrays or tensors and compute in float32, as the JAX package
does, on the tensors' device; ``calibrate_planar`` puts numpy inputs on
the CUDA device unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from cerebro_tpu_torch.geometry import cameras, se3
from cerebro_tpu_torch.geometry.cameras import CameraParams, make_pinhole

_F32 = torch.float32


def as_device_tensor(x, device: Optional[str], what: str) -> torch.Tensor:
    """``x`` as float32 on ``device``: a tensor stays on its device unless
    ``device`` is given; numpy goes to ``device``, by default the CUDA
    device (without one the caller must ask for the CPU)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(_F32)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on the CUDA device and none is available; "
                "pass device='cpu' (or CPU tensors) to run on the CPU"
            )
        device = "cuda"
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=_F32, device=device)


# ---------------------------------------------------------------------------
# Homographies (normalized DLT)
# ---------------------------------------------------------------------------


def _normalize(p: torch.Tensor):
    c = p.mean(dim=0)
    s = math.sqrt(2.0) / torch.clamp(torch.linalg.vector_norm(p - c, dim=-1).mean(), min=1e-9)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * c[0]]),
        torch.stack([z, s, -s * c[1]]),
        torch.stack([z, z, o]),
    ])
    return (p - c) * s, T


def estimate_homography(src, dst) -> torch.Tensor:
    """(N, 2) -> (N, 2) homography by the normalized DLT: (3, 3) H with
    dst ~ H src, H[2, 2] = 1. The null vector is ``eigh``'s first
    eigenvector of A^T A (its sign does not survive the normalization)."""
    src, dst = torch.as_tensor(src, dtype=_F32), torch.as_tensor(dst, dtype=_F32)
    sn, Ts = _normalize(src)
    dn, Td = _normalize(dst)
    x, y = sn[:, 0], sn[:, 1]
    u, v = dn[:, 0], dn[:, 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1, r2])
    _, vecs = torch.linalg.eigh(A.T @ A)
    Hn = vecs[:, 0].reshape(3, 3)
    H = torch.linalg.solve(Td, Hn @ Ts)
    return H / H[2, 2]


# ---------------------------------------------------------------------------
# Zhang closed-form intrinsics
# ---------------------------------------------------------------------------


def _v_ij(H: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Zhang's v_ij rows of (V, 3, 3) homographies: (V, 6)."""
    h = lambda r, c: H[:, r, c]  # noqa: E731
    return torch.stack([
        h(0, i) * h(0, j),
        h(0, i) * h(1, j) + h(1, i) * h(0, j),
        h(1, i) * h(1, j),
        h(2, i) * h(0, j) + h(0, i) * h(2, j),
        h(2, i) * h(1, j) + h(1, i) * h(2, j),
        h(2, i) * h(2, j),
    ], dim=-1)


def intrinsics_from_homographies(Hs: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) homographies -> (3, 3) K (Zhang's B-matrix construction);
    the rows are stacked view by view, as the JAX package stacks them."""
    V = torch.stack([_v_ij(Hs, 0, 1), _v_ij(Hs, 0, 0) - _v_ij(Hs, 1, 1)], dim=1).reshape(-1, 6)
    _, vecs = torch.linalg.eigh(V.T @ V)
    b11, b12, b22, b13, b23, b33 = vecs[:, 0]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = torch.sqrt(torch.abs(lam / b11))
    fy = torch.sqrt(torch.abs(lam * b11 / (b11 * b22 - b12 * b12)))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fx - b13 * fx * fx / lam
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, skew, cx]), torch.stack([z, fy, cy]), torch.stack([z, z, o])])


def extrinsics_from_homography(K: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Each view's c_T_board (..., 4, 4) from K and its homography
    (..., 3, 3): the rotation's columns from K^-1 H, projected onto SO(3)
    by an SVD, and the board put in front of the camera."""
    Kinv = torch.linalg.inv(K)
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    k1 = (Kinv @ h1[..., None])[..., 0]
    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(k1, dim=-1), min=1e-12)
    r1 = lam[..., None] * k1
    r2 = lam[..., None] * (Kinv @ h2[..., None])[..., 0]
    r3 = torch.linalg.cross(r1, r2)
    t = lam[..., None] * (Kinv @ h3[..., None])[..., 0]
    R = torch.stack([r1, r2, r3], dim=-1)
    U, _, Vt = torch.linalg.svd(R)
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    flip = torch.sign(t[..., 2])
    return se3.make_pose(R, t * flip[..., None])


# ---------------------------------------------------------------------------
# Joint nonlinear refinement
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    camera: CameraParams
    view_poses: torch.Tensor  # (V, 4, 4) c_T_board per view
    rms_px: torch.Tensor  # () final reprojection RMS in pixels
    success: bool = True  # False on degenerate view sets (NaN or absurd focals)


def _board3(board: torch.Tensor) -> torch.Tensor:
    return torch.cat([board, torch.zeros_like(board[:, :1])], dim=-1)


def _project_all(theta: torch.Tensor, views: torch.Tensor, board: torch.Tensor) -> torch.Tensor:
    """theta = [fx, fy, cx, cy, k1, k2, p1, p2]; views (V, 6) twists; board
    (N, 2) plane points -> (V, N, 2) pixels through the radtan pinhole."""
    fx, fy, cx, cy, k1, k2, p1, p2 = theta
    T = se3.se3_exp(views)  # (V, 4, 4)
    P = _board3(board) @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
    xy = P[..., :2] / P[..., 2:3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([fx * (x * radial + dx) + cx, fy * (y * radial + dy) + cy], dim=-1)


def _rms(r: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((r.reshape(-1, 2) ** 2).sum(-1).mean())


def refine_calibration(K0, view_poses0, board, obs, iters: int = 20, damping: float = 1e-4):
    """Gauss-Newton over [fx, fy, cx, cy, k1, k2, p1, p2] and every view's
    twist, ``iters`` steps damped by ``damping``. Returns (theta (8,), view
    poses (V, 4, 4), RMS px)."""
    V = view_poses0.shape[0]
    z = torch.zeros(4, dtype=_F32, device=K0.device)
    theta0 = torch.cat([torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]), z])
    flat = torch.cat([theta0, se3.se3_log(view_poses0).reshape(-1)])

    def residual(f):
        return (_project_all(f[:8], f[8:].reshape(V, 6), board) - obs).reshape(-1)

    eye = torch.eye(flat.shape[0], dtype=_F32, device=flat.device)
    for _ in range(iters):
        r = residual(flat)
        J = torch.func.jacfwd(residual)(flat)
        flat = flat - torch.linalg.solve(J.T @ J + damping * eye, J.T @ r)
    rms = _rms(residual(flat))
    return flat[:8], se3.se3_exp(flat[8:].reshape(V, 6)), rms


def _theta_camera(model: str, theta: torch.Tensor) -> CameraParams:
    return CameraParams(fx=theta[0], fy=theta[1], cx=theta[2], cy=theta[3],
                        dist=theta[4:8], xi=theta[8], model=model)


def _project_views(model, theta, views, board) -> torch.Tensor:
    T = se3.se3_exp(views)
    P = _board3(board) @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
    return cameras.project(_theta_camera(model, theta), P)


def refine_calibration_model(model: str, theta0, view_poses0, board, obs, iters: int = 40):
    """Levenberg-Marquardt over [fx, fy, cx, cy, d0..d3, xi] and every
    view's twist for any camera model, through ``cameras.project``: a step
    is kept only if it lowers the cost; lambda (from 1e-3) shrinks by 0.3 on
    a kept step (down to 1e-9) and grows by 4 on a rejected one. Slots a
    model ignores have zero Jacobian columns, pinned by the damping.
    Returns (theta (9,), view poses (V, 4, 4), RMS px)."""
    V = view_poses0.shape[0]
    flat = torch.cat([theta0, se3.se3_log(view_poses0).reshape(-1)])

    def residual(f):
        return (_project_views(model, f[:9], f[9:].reshape(V, 6), board) - obs).reshape(-1)

    lam = torch.tensor(1e-3, dtype=_F32, device=flat.device)
    for _ in range(iters):
        r = residual(flat)
        J = torch.func.jacfwd(residual)(flat)
        H = J.T @ J
        step = torch.linalg.solve(H + lam * torch.diag(torch.diagonal(H) + 1e-6), J.T @ r)
        cand = flat - step
        rc = residual(cand)
        better = (rc * rc).sum() < (r * r).sum()
        flat = torch.where(better, cand, flat)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-9), lam * 4.0)
    rms = _rms(residual(flat))
    return flat[:9], se3.se3_exp(flat[9:].reshape(V, 6)), rms


def _theta_init(model: str, cam: CameraParams) -> torch.Tensor:
    """The target model's start from the refined pinhole. Near the optical
    axis every model is a pinhole: Mei's paraxial focal is gamma / (1 + xi)
    (xi = 1 -> gamma = 2 f); Kannala-Brandt's r(theta) ~ theta is the
    pinhole's; Scaramuzza's a0 is the paraxial focal (affine c = 1)."""
    fx, fy, cx, cy = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    z4 = [0.0] * 4
    if model == cameras.MEI:
        vals = [2 * fx, 2 * fy, cx, cy, *z4, 1.0]
    elif model == cameras.SCARAMUZZA:
        vals = [1.0, 1.0, cx, cy, fx, 0.0, 0.0, 0.0, 0.0]
    else:  # KANNALA_BRANDT (and PINHOLE)
        vals = [fx, fy, cx, cy, *z4, 0.0]
    return torch.tensor(vals, dtype=_F32, device=cam.fx.device)


def calibrate_planar(
    board,  # (N, 2) planar target points (board frame)
    obs,  # (V, N, 2) observed pixels per view
    image_size: Tuple[int, int] = (752, 480),
    iters: int = 20,
    model: str = cameras.PINHOLE,
    device: Optional[str] = None,
) -> CalibrationResult:
    """Homographies -> Zhang's start -> the joint GN refinement; for the
    other models the pinhole solution seeds the poses and focal scale and
    the model's LM refinement takes over. ``success`` is False for a
    degenerate view set (Zhang needs 3 or more views of distinct
    orientations; identical views give NaN or absurd focals). Runs on the
    CUDA device, or on the inputs' device if they are tensors, or where
    ``device`` says."""
    board = as_device_tensor(board, device, "calibrate_planar")
    obs = as_device_tensor(obs, device or str(board.device), "calibrate_planar")
    Hs = torch.stack([estimate_homography(board, o) for o in obs])
    K0 = intrinsics_from_homographies(Hs)
    poses0 = extrinsics_from_homography(K0, Hs)
    theta, views, rms = refine_calibration(K0, poses0, board, obs, iters=iters)
    cam = make_pinhole(theta[0], theta[1], theta[2], theta[3], theta[4:8],
                       width=image_size[0], height=image_size[1])
    if model != cameras.PINHOLE:
        theta, views, rms = refine_calibration_model(
            model, _theta_init(model, cam), views, board, obs, iters=max(iters, 40),
        )
        cam = dataclasses.replace(_theta_camera(model, theta), width=image_size[0],
                                  height=image_size[1])
    th = theta.detach().cpu().numpy()
    focals = (th[4],) if model == cameras.SCARAMUZZA else (th[0], th[1])
    ok = bool(np.isfinite(float(rms)) and np.isfinite(th).all() and all(1.0 < f < 1e5 for f in focals))
    return CalibrationResult(camera=cam, view_poses=views, rms_px=rms, success=ok)
