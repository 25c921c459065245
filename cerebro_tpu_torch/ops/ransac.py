"""RANSAC with every hypothesis solved at once (counterpart of
cerebro_tpu/ops/ransac.py).

The reference runs theia's sequential RANSAC (5-50 iterations, min inlier
ratio 0.7, MLE scoring — src/DlsPnpWithRansac.cpp:88-93,206-212) on one
CPU core per candidate. Here H minimal samples are drawn up front, all H
minimal problems are solved as one batch (the hypothesis axis written out
where the JAX package used ``vmap``), all H x N residuals are scored at
once, the best hypothesis is refit on its inlier set, and the refit is kept
if it scores no worse. Fixed shapes throughout; masked correspondences ride
weight vectors.

Sampling: the default sampler is a Gumbel top-k over the validity mask on a
``torch.Generator`` (distinct points per hypothesis). JAX's ``jax.random``
bits cannot be reproduced with torch's generator, so ``sample_idx`` (H, S)
lets a caller supply the samples instead (the tests feed JAX's own).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cerebro_tpu_torch.ops import pnp, umeyama


@dataclasses.dataclass(frozen=True)
class RansacResult:
    T: torch.Tensor  # (4, 4) best model (b_T_a)
    inliers: torch.Tensor  # (N,) bool inlier mask of the best model
    inlier_count: torch.Tensor  # () int32
    n_valid: torch.Tensor  # () int32 valid input correspondences
    confidence: torch.Tensor  # () float32 — inlier_count / n_valid
    success: torch.Tensor  # () bool — enough points + inlier ratio


def sample_indices(
    generator: torch.Generator, valid: torch.Tensor, n_hyp: int, sample_size: int
) -> torch.Tensor:
    """(H, S) indices drawn without replacement from valid rows: Gumbel
    top-k over the validity mask (invalid rows get -inf), ties toward the
    lower index."""
    n = valid.shape[0]
    u = torch.rand((n_hyp, n), generator=generator, device=valid.device)
    g = -torch.log(-torch.log(u))
    g = torch.where(valid[None, :], g, torch.full_like(g, -float("inf")))
    return torch.sort(g, dim=1, descending=True, stable=True)[1][:, :sample_size]


def _run(
    solver: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    error_fn: Callable[[torch.Tensor], torch.Tensor],
    refit: Callable[[torch.Tensor], torch.Tensor],
    A: torch.Tensor,  # (N, 3) source points
    Bp: torch.Tensor,  # (N, 2 or 3) targets
    valid: torch.Tensor,  # (N,) bool
    idx: torch.Tensor,  # (H, S) sample indices
    inlier_thresh,
    min_inlier_ratio: float,
    min_points: int,
) -> RansacResult:
    n_hyp, sample_size = idx.shape
    n_valid = valid.to(torch.int32).sum()

    sample_w = torch.ones((n_hyp, sample_size), dtype=A.dtype, device=A.device)
    Ts = solver(A[idx], Bp[idx], sample_w)  # (H, 4, 4)
    errs = error_fn(Ts)  # (H, N)
    inl = (errs < inlier_thresh) & valid[None, :]
    counts = inl.to(torch.int32).sum(1)  # (H,)

    # degenerate hypotheses (NaN poses) count zero inliers
    finite = torch.isfinite(Ts.reshape(n_hyp, -1)).all(1)
    counts = torch.where(finite, counts, torch.zeros_like(counts))

    # the first maximum, as a one-element index: indexing by a 0-d tensor
    # reads it back to the host
    best = counts.argmax().reshape(1)
    best_inl = inl[best][0]
    best_count = counts[best][0]

    # refit on the best inlier set (weighted least squares), then rescore
    T_ref = refit(best_inl.to(A.dtype))
    ref_inl = (error_fn(T_ref) < inlier_thresh) & valid
    ref_count = ref_inl.to(torch.int32).sum()

    use_ref = torch.isfinite(T_ref).all() & (ref_count >= best_count)
    T_best = torch.where(use_ref, T_ref, Ts[best][0])
    inl_best = torch.where(use_ref, ref_inl, best_inl)
    cnt_best = torch.where(use_ref, ref_count, best_count)

    conf = cnt_best.float() / torch.clamp(n_valid, min=1).float()
    success = (n_valid >= min_points) & (conf >= min_inlier_ratio) & torch.isfinite(T_best).all()
    return RansacResult(
        T=T_best,
        inliers=inl_best,
        inlier_count=cnt_best,
        n_valid=n_valid,
        confidence=conf,
        success=success,
    )


def ransac_pnp(
    generator: Optional[torch.Generator],
    X: torch.Tensor,  # (N, 3) 3D points in frame A
    x: torch.Tensor,  # (N, 2) normalized image coords in frame B
    valid: torch.Tensor,  # (N,) bool
    n_hyp: int = 256,
    sample_size: int = 6,
    inlier_thresh: float = 0.03,  # ref src/DlsPnpWithRansac.cpp:206
    min_inlier_ratio: float = 0.7,  # ref :208
    min_points: int = 20,  # ref :136
    refine_iters: int = 5,
    sample_idx: Optional[torch.Tensor] = None,  # (H, S) replaces the sampler
) -> RansacResult:
    """3D-2D pose (the reference's StaticTheiaPoseCompute::PNP,
    src/DlsPnpWithRansac.cpp:188-241). Returns b_T_a."""
    idx = sample_idx if sample_idx is not None else sample_indices(
        generator, valid, n_hyp, sample_size
    )

    def solver(Xs, xs, ws):
        # the iterative small-matrix path for the hypothesis batch; the
        # refit below keeps the exact path for the final pose
        return pnp.pnp_dlt(Xs, xs, ws, exact=False)

    def error_fn(T):
        return pnp.reprojection_error(T, X, x)

    def refit(w):
        T0 = pnp.pnp_dlt(X, x, w)
        return pnp.pnp_refine_gn(T0, X, x, w, iters=refine_iters)

    return _run(
        solver, error_fn, refit, X, x, valid, idx.to(X.device),
        inlier_thresh, min_inlier_ratio, min_points,
    )


def ransac_icp(
    generator: Optional[torch.Generator],
    P: torch.Tensor,  # (N, 3) points in frame A
    Q: torch.Tensor,  # (N, 3) corresponding points in frame B
    valid: torch.Tensor,  # (N,) bool
    n_hyp: int = 256,
    sample_size: int = 4,
    inlier_thresh=0.1,  # scalar or per-point (N,); ref src/DlsPnpWithRansac.cpp:88
    min_inlier_ratio: float = 0.7,
    min_points: int = 20,  # ref :19
    scale_sanity: float = 0.9,  # ref src/DlsPnpWithRansac.h:117-166
    sample_idx: Optional[torch.Tensor] = None,  # (H, S) replaces the sampler
) -> RansacResult:
    """3D-3D alignment (the reference's AlignPointCloudsUmeyamaWithRansac /
    StaticTheiaPoseCompute::P3P_ICP, src/DlsPnpWithRansac.cpp:73-121).
    Returns b_T_a with Q ~= T * P."""
    idx = sample_idx if sample_idx is not None else sample_indices(
        generator, valid, n_hyp, sample_size
    )

    def solver(Ps, Qs, ws):
        T, scale = umeyama.umeyama_rigid(Ps, Qs, ws)
        # scale sanity: far-from-rigid samples are degenerate
        s = torch.minimum(scale, 1.0 / torch.clamp(scale, min=1e-9))
        return torch.where((s > scale_sanity)[..., None, None], T, torch.full_like(T, float("nan")))

    def error_fn(T):
        return umeyama.alignment_error(T, P, Q)

    def refit(w):
        return umeyama.umeyama_rigid(P, Q, w)[0]

    return _run(
        solver, error_fn, refit, P, Q, valid, idx.to(P.device),
        inlier_thresh, min_inlier_ratio, min_points,
    )
