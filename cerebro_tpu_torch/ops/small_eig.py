"""Small dense solvers of verification's PnP and Umeyama steps: the kernel
``csrc/small_eig.cu`` on CUDA tensors, ``torch.linalg`` on CPU tensors.

Per pair, verification solves a few small problems: the smallest
eigenvector of a 12x12 DLT normal matrix (``pnp.pnp_dlt``'s exact path),
3x3 SVDs (its rotation, and ``umeyama.umeyama_rigid`` over every RANSAC
hypothesis), and 6x6 damped normal equations (``pnp.pnp_refine_gn``). On the
card, ``torch.linalg``'s eigh, svd and solve (``solve_ex`` with
``check_errors=False`` too) and the batched 3x3 determinant synchronise with
the host on every call (``torch.cuda.set_sync_debug_mode`` flags each); that
stalls the host and forbids capturing a pair's verification as a CUDA
graph. The kernel's three entries compute the
same functions with nothing read back. On CPU tensors each of the three is
the ``torch.linalg`` call the callers made before: the plain version, which
the CPU tests hold against the JAX package and the card tests hold the
kernel against. The determinant of a 3x3 is its closed form on either
device; the callers take only its sign, of near-orthogonal matrices.
Eigenvectors and singular vectors are defined up to sign; the callers' sign
fixes (``sign(det(U Vt))``, the DLT's cheirality) make their results
independent of it.

The solve is where the two devices can decide differently: on CUDA it is a
float32 Cholesky, which gives NaN for an H that is not positive definite in
float32, where the CPU's LU solve gives a finite step. The callers' H =
JᵀJ + 1e-6 I is positive definite unless the refit's weighted points cannot
fix a pose (fewer than three, or a degenerate layout): JᵀJ is then singular
and its float32 rounding can outweigh the 1e-6. ``ransac._run`` keeps the
best hypothesis' pose for a refit that is not finite, as it does for one
that scores fewer inliers than the hypothesis; the devices part only where
the CPU's step happens to score at least as many. A PnP option succeeds
only at 14 inliers or more (0.7 of ``min_points_for_solve``, 20), and at 14
the card test holds both devices' refits to 1e-4 of each other.
"""

from __future__ import annotations

import ctypes

import torch

from cerebro_tpu_torch.ops._cuda import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
# Three handles on one source, each counting its own launches.
EIG12 = Kernel("small_eig.cu", {"small_eig_sym12_launch": [_P, _P, _I, _P]})
SVD3 = Kernel("small_eig.cu", {"small_eig_svd3_launch": [_P, _P, _P, _P, _I, _P]})
SPD6 = Kernel("small_eig.cu", {"small_eig_spd6_solve_launch": [_P, _P, _P, _I, _P]})
KERNELS = (EIG12, SVD3, SPD6)


def _batch(x: torch.Tensor, tail: tuple, what: str) -> torch.Tensor:
    """``x`` as a contiguous float32 (B, *tail) CUDA tensor; raises on a
    shape or dtype the kernel does not take."""
    if x.dim() < len(tail) or tuple(x.shape[x.dim() - len(tail):]) != tail:
        raise ValueError(f"{what} takes (..., {', '.join(map(str, tail))}), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what} takes float32 on CUDA, got {x.dtype}")
    return x.reshape((-1,) + tail).contiguous()


def smallest_eigvec(M: torch.Tensor) -> torch.Tensor:
    """(..., n, n) symmetric -> (..., n): the eigenvector of the smallest
    eigenvalue (unit norm, either sign). CUDA takes n = 12."""
    if not M.is_cuda:
        return torch.linalg.eigh(M)[1][..., :, 0]
    m = _batch(M, (12, 12), "smallest_eigvec")
    out = torch.empty((m.shape[0], 12), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        EIG12.launch("small_eig_sym12_launch", m.data_ptr(), out.data_ptr(), m.shape[0])
    return out.reshape(M.shape[:-1])


def svd3(A: torch.Tensor):
    """(..., 3, 3) -> (U, S, Vt) with A = U diag(S) Vt, S descending and
    non-negative, U and Vt orthogonal (each column either sign)."""
    if not A.is_cuda:
        return torch.linalg.svd(A)
    a = _batch(A, (3, 3), "svd3")
    B = a.shape[0]
    U = torch.empty((B, 3, 3), dtype=torch.float32, device=a.device)
    S = torch.empty((B, 3), dtype=torch.float32, device=a.device)
    Vt = torch.empty((B, 3, 3), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        SVD3.launch("small_eig_svd3_launch", a.data_ptr(), U.data_ptr(), S.data_ptr(),
                    Vt.data_ptr(), B)
    return U.reshape(A.shape), S.reshape(A.shape[:-1]), Vt.reshape(A.shape)


def spd_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g for (..., n, n) symmetric positive definite H and (..., n)
    g. CUDA takes n = 6 (Cholesky: an H that is not positive definite in
    float32 gives NaN)."""
    if not H.is_cuda:
        return torch.linalg.solve(H, g)
    h = _batch(H, (6, 6), "spd_solve")
    r = _batch(g, (6,), "spd_solve")
    if r.shape[0] != h.shape[0]:
        raise ValueError(f"spd_solve: {tuple(H.shape)} against {tuple(g.shape)}")
    x = torch.empty((h.shape[0], 6), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        SPD6.launch("small_eig_spd6_solve_launch", h.data_ptr(), r.data_ptr(), x.data_ptr(),
                    h.shape[0])
    return x.reshape(g.shape)


def det3(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (...) determinants: the closed form (cofactors along
    row 0), which reads nothing back on CUDA."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
