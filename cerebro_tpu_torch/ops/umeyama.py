"""Weighted Umeyama 3D-3D rigid alignment (counterpart of
cerebro_tpu/ops/umeyama.py).

Behavioral equivalent of the reference's
``AlignPointCloudsUmeyama(WithRansac)`` (src/DlsPnpWithRansac.h:117-166):
find R, t minimizing sum_i w_i || q_i - (R p_i + t) ||^2 in closed form,
and report the residual scale for the reference's sanity gate. Broadcasts
over leading batch axes (RANSAC hypotheses). The SVD and determinants are
``ops.small_eig``'s: ``torch.linalg`` on the CPU, the kernel on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cerebro_tpu_torch.geometry import se3
from cerebro_tpu_torch.ops import small_eig


def umeyama_rigid(
    src: torch.Tensor,  # (..., N, 3) points in frame A
    dst: torch.Tensor,  # (..., N, 3) points in frame B
    w: torch.Tensor,  # (..., N) nonneg weights (0 = masked out)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (b_T_a (..., 4, 4), scale_estimate (...)). dst ~= R @ src + t."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    wn = w / wsum[..., None]
    mu_s = (wn[..., None] * src).sum(-2)
    mu_d = (wn[..., None] * dst).sum(-2)
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    H = (wn[..., None] * dc).transpose(-1, -2) @ sc  # sum_i w_i dc_i sc_i^T
    U, S, Vt = small_eig.svd3(H)
    d = torch.sign(small_eig.det3(U) * small_eig.det3(Vt))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = U @ torch.diag_embed(diag) @ Vt
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    var_s = torch.clamp((wn * (sc * sc).sum(-1)).sum(-1), min=1e-12)
    scale = (S * diag).sum(-1) / var_s
    return se3.make_pose(R, t), scale


def alignment_error(T: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Per-point Euclidean residual ||dst - T*src|| — the RANSAC inlier
    metric for 3D-3D (ref error thresh 0.1 m, src/DlsPnpWithRansac.cpp:88)."""
    pred = src @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    return torch.linalg.vector_norm(dst - pred, dim=-1)
