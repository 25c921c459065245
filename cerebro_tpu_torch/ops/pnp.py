"""Perspective-n-Point solvers (counterpart of cerebro_tpu/ops/pnp.py).

The reference wraps theia's DLS-PnP in RANSAC (``DlsPnpWithRansac``,
src/DlsPnpWithRansac.h:42-100) and refines with ceres
(src/DlsPnpWithRansac.cpp:253-398). Here: a weighted DLT (12x12 normal
matrix, smallest eigenvector) with Hartley normalization, then a
fixed-iteration Gauss-Newton polish on the inlier weights.

Every function broadcasts over leading batch axes (the RANSAC hypotheses),
where the JAX package used ``vmap``. Masked correspondences get weight 0,
so variable-size match sets ride fixed-shape tensors.
"""

from __future__ import annotations

import torch

from cerebro_tpu_torch.geometry import se3
from cerebro_tpu_torch.ops import small_eig


def _build_dlt_rows(X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """DLT rows for P = [R|t]: for each 3D point X and normalized image
    point x=(u,v), two rows of A @ vec(P) = 0. (..., N, 3), (..., N, 2) ->
    (..., 2N, 12)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., N, 4)
    z = torch.zeros_like(Xh)
    u = x[..., 0:1]
    v = x[..., 1:2]
    r1 = torch.cat([Xh, z, -u * Xh], dim=-1)  # (..., N, 12)
    r2 = torch.cat([z, Xh, -v * Xh], dim=-1)
    return torch.stack([r1, r2], dim=-2).reshape(X.shape[:-2] + (2 * X.shape[-2], 12))


def _spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """(..., n, n) SPD inverse by Gauss-Jordan without pivoting (SPD needs
    none): plain multiply-adds that batch over the hypotheses."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Inv = eye.expand(A.shape).clone()
    A = A.clone()
    for k in range(n):
        pivot = A[..., k, k]
        arow = A[..., k, :] / pivot[..., None]
        irow = Inv[..., k, :] / pivot[..., None]
        col = A[..., :, k].clone()
        ek = eye[k]
        A = A - col[..., :, None] * arow[..., None, :] + ek[:, None] * arow[..., None, :]
        Inv = Inv - col[..., :, None] * irow[..., None, :] + ek[:, None] * irow[..., None, :]
    return Inv


def _smallest_eigvec_iter(M: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Near-null eigenvector of SPD M (..., n, n) by inverse iteration with an
    explicit SPD inverse."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    eps = 1e-7 * M.diagonal(dim1=-2, dim2=-1).sum(-1) / n + 1e-20
    Ainv = _spd_inverse(M + eps[..., None, None] * eye)
    v = torch.full(M.shape[:-1], 1.0 / float(n) ** 0.5, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        w = (Ainv @ v[..., None])[..., 0]
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-20)
    return v


def _inv3(X: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 3, 3) inverse (adjugate / det)."""
    a, b, c = X[..., 0, 0], X[..., 0, 1], X[..., 0, 2]
    d, e, f = X[..., 1, 0], X[..., 1, 1], X[..., 1, 2]
    g, h, i = X[..., 2, 0], X[..., 2, 1], X[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F_ = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I_ = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack(
        [torch.stack([A, B, C], -1), torch.stack([D, E, F_], -1), torch.stack([G, H, I_], -1)],
        dim=-2,
    )
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    return adj / det[..., None, None]


def _polar_rotation(Rraw: torch.Tensor, iters: int = 8):
    """Orthogonal polar factor of (..., 3, 3) by Newton iteration
    X <- (X + X^{-T})/2. Returns (R, scale) with scale = mean singular
    value. A reflection (det < 0) converges to det -1; callers treat those
    hypotheses as degenerate."""
    nf = torch.sqrt((Rraw * Rraw).sum(dim=(-2, -1)) / 3.0)
    X = Rraw / torch.clamp(nf, min=1e-20)[..., None, None]
    for _ in range(iters):
        X = 0.5 * (X + _inv3(X).transpose(-1, -2))
    scale = (X.transpose(-1, -2) @ Rraw).diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    return X, scale


def pnp_dlt(
    X: torch.Tensor,  # (..., N, 3) 3D points in frame A
    x: torch.Tensor,  # (..., N, 2) normalized image coords in frame B
    w: torch.Tensor,  # (..., N) weights, 0 = masked
    exact: bool = True,
) -> torch.Tensor:
    """Weighted DLT PnP: returns b_T_a (..., 4, 4) with x ~ project(R X + t).

    Hartley-normalize both point sets, take the smallest eigenvector of
    A^T W A (12x12; ``exact`` solves the eigenproblem, otherwise inverse
    iteration, the RANSAC hypothesis path), un-normalize, fix sign by
    cheirality (weighted mean depth positive), then project the 3x3 block
    onto SO(3). The exact path's eigenvector and SVD are ``small_eig``'s:
    ``torch.linalg`` on the CPU, the kernel on the card."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    wn = w / wsum[..., None]

    c3 = (wn[..., None] * X).sum(-2)
    d3 = (wn * torch.linalg.vector_norm(X - c3[..., None, :], dim=-1)).sum(-1)
    s3 = 3.0**0.5 / torch.clamp(d3, min=1e-9)
    Xn = (X - c3[..., None, :]) * s3[..., None, None]

    c2 = (wn[..., None] * x).sum(-2)
    d2 = (wn * torch.linalg.vector_norm(x - c2[..., None, :], dim=-1)).sum(-1)
    s2 = 2.0**0.5 / torch.clamp(d2, min=1e-9)
    xn = (x - c2[..., None, :]) * s2[..., None, None]

    A = _build_dlt_rows(Xn, xn)  # (..., 2N, 12)
    ww = w.repeat_interleave(2, dim=-1)
    M = (A * ww[..., None]).transpose(-1, -2) @ A  # (..., 12, 12)
    if exact:
        p = small_eig.smallest_eigvec(M)
    else:
        p = _smallest_eigvec_iter(M)
    Pn = p.reshape(p.shape[:-1] + (3, 4))

    # un-normalize: P = T2^{-1} Pn T3
    batch = Pn.shape[:-2]
    T2inv = torch.zeros(batch + (3, 3), dtype=X.dtype, device=X.device)
    T2inv[..., 0, 0] = 1.0 / s2
    T2inv[..., 1, 1] = 1.0 / s2
    T2inv[..., 0, 2] = c2[..., 0]
    T2inv[..., 1, 2] = c2[..., 1]
    T2inv[..., 2, 2].fill_(1.0)  # a fill on the device: assigning a number copies it from the host
    T3 = torch.zeros(batch + (4, 4), dtype=X.dtype, device=X.device)
    T3[..., :3, :3] = torch.eye(3, dtype=X.dtype, device=X.device) * s3[..., None, None]
    T3[..., :3, 3] = -s3[..., None] * c3
    T3[..., 3, 3].fill_(1.0)
    P = T2inv @ Pn @ T3
    Rraw, t_raw = P[..., :3], P[..., 3]

    depths = (X @ Rraw.transpose(-1, -2) + t_raw[..., None, :])[..., 2]
    sign = torch.sign((w * depths).sum(-1) + 1e-12)
    Rraw = Rraw * sign[..., None, None]
    t_raw = t_raw * sign[..., None]

    if exact:
        U, S, Vt = small_eig.svd3(Rraw)
        d = torch.sign(small_eig.det3(U @ Vt))
        diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
        R = U @ torch.diag_embed(diag) @ Vt
        scale = (S * diag).sum(-1) / 3.0
    else:
        R, scale = _polar_rotation(Rraw)
        # a reflection (det<0) is a degenerate hypothesis: poison the pose
        # so RANSAC's finite/inlier guards drop it
        bad = small_eig.det3(R) < 0.0
        R = torch.where(bad[..., None, None], torch.full_like(R, float("nan")), R)
    t = t_raw / torch.clamp(scale, min=1e-12)[..., None]
    return se3.make_pose(R, t)


def _project(T: torch.Tensor, X: torch.Tensor):
    """Camera coords, the z used to divide (|z| < 1e-6 -> 1e-6) and the
    projection of (N, 3) points by (..., 4, 4) poses."""
    Pc = X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    z = Pc[..., 2]
    small = z.abs() < 1e-6
    zc = torch.where(small, torch.full_like(z, 1e-6), z)
    return Pc, zc, small, Pc[..., :2] / zc[..., None]


def reprojection_error(
    T: torch.Tensor,  # (..., 4, 4) b_T_a
    X: torch.Tensor,  # (N, 3) points in A
    x: torch.Tensor,  # (N, 2) normalized coords in B
) -> torch.Tensor:
    """Per-point L1 reprojection error in normalized coords — the
    reference's RANSAC error metric (thresh 0.03, src/DlsPnpWithRansac.h:79-87).
    Points behind the camera score 1e6."""
    Pc, _, _, proj = _project(T, X)
    err = (proj - x).abs().sum(-1)
    return torch.where(Pc[..., 2] > 0, err, torch.full_like(err, 1e6))


def pnp_refine_gn(
    T0: torch.Tensor,  # (4,4) initial pose
    X: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    iters: int = 5,
    damping: float = 1e-6,
) -> torch.Tensor:
    """Fixed-iteration damped Gauss-Newton polish on se(3), weighted — the
    batched replacement for the reference's ceres refinement
    (src/DlsPnpWithRansac.cpp:253-340). The Jacobian of the weighted
    residual under a left perturbation exp(xi) T is written out: d Pc /
    d(v, w) = [I, -hat(Pc)]. The 6x6 step is ``small_eig.spd_solve``."""
    T = T0
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        Pc, zc, small, proj = _project(T, X)
        r = ((proj - x) * w[:, None]).reshape(-1)
        zero = torch.zeros_like(zc)
        inv_z = 1.0 / zc
        # d proj / d Pc, with the clamped z constant where |z| < 1e-6
        dz_u = torch.where(small, zero, -Pc[:, 0] / (zc * zc))
        dz_v = torch.where(small, zero, -Pc[:, 1] / (zc * zc))
        J_u = torch.stack([inv_z, zero, dz_u], dim=-1)  # (N, 3)
        J_v = torch.stack([zero, inv_z, dz_v], dim=-1)
        dP = torch.cat(
            [torch.eye(3, dtype=T.dtype, device=T.device).expand(Pc.shape[0], 3, 3), -se3.hat(Pc)],
            dim=-1,
        )  # (N, 3, 6)
        J = torch.stack(
            [(J_u[:, :, None] * dP).sum(1), (J_v[:, :, None] * dP).sum(1)], dim=1
        ) * w[:, None, None]  # (N, 2, 6)
        J = J.reshape(-1, 6)
        H = J.T @ J + damping * eye6
        g = J.T @ r
        dx = -small_eig.spd_solve(H, g)
        T = se3.se3_exp(dx) @ T
    return T
