"""The small-matrix kernel's arithmetic (``csrc/small_eig.cu``) replayed in
numpy float32 and held against ``numpy.linalg``, and the CPU path of
``ops/small_eig``: exactly the ``torch.linalg`` calls, and the 3x3
determinant's closed form.

The models follow the kernel step for step: the same Jacobi rotation (Golub
& Van Loan's sym.schur2, Rutishauser's update of the 2x2 block), the same
cyclic order and sweep counts (read from the source, so the two cannot
drift apart), the one-sided Jacobi of the 3x3 SVD with its sort and its
completion of U, and the 6x6 Cholesky solve. The kernel itself runs only on
the card: ``tests/test_torch_kernels_cuda.py`` holds it against
``torch.linalg`` there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cerebro_tpu_torch.ops import small_eig

SOURCE = Path(small_eig.__file__).resolve().parent.parent / "csrc" / "small_eig.cu"
F32 = np.float32


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


EIG_SWEEPS = _constant("EIG_SWEEPS")
SVD_SWEEPS = _constant("SVD_SWEEPS")


def rotation(app, aqq, apq):
    """The kernel's ``jacobi_rotation``: (c, s, t) zeroing a_pq."""
    if apq == 0:
        return F32(1), F32(0), F32(0)
    with np.errstate(over="ignore"):
        tau = (aqq - app) / (F32(2) * apq)
        t = np.copysign(F32(1), tau) / (np.abs(tau) + np.sqrt(F32(1) + tau * tau))
    c = F32(1) / np.sqrt(F32(1) + t * t)
    return c, t * c, t


def jacobi_eig_model(M: np.ndarray, sweeps: int = EIG_SWEEPS):
    """``sym12_min_eigvec``: (eigenvector of the smallest diagonal entry
    after ``sweeps`` cyclic sweeps, the final matrix)."""
    a = M.astype(F32).copy()
    n = a.shape[0]
    v = np.eye(n, dtype=F32)
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = a[p, p], a[q, q], a[p, q]
                c, s, t = rotation(app, aqq, apq)
                k = np.array([i for i in range(n) if i not in (p, q)])
                akp, akq = a[k, p].copy(), a[k, q].copy()
                a[k, p] = a[p, k] = c * akp - s * akq
                a[k, q] = a[q, k] = s * akp + c * akq
                vp, vq = v[:, p].copy(), v[:, q].copy()
                v[:, p] = c * vp - s * vq
                v[:, q] = s * vp + c * vq
                a[p, p] = app - t * apq
                a[q, q] = aqq + t * apq
                a[p, q] = a[q, p] = 0
    return v[:, int(np.argmin(np.diag(a)))], a


def _orthogonalize(u, w):
    for _ in range(2):
        w = w - F32(u @ w) * u
    return w


def svd3_model(A: np.ndarray, sweeps: int = SVD_SWEEPS):
    """``svd3``: one-sided Jacobi on the columns, a descending sort, then
    U completed from the first two columns."""
    c = A.astype(F32).T.copy()  # c[j] = column j
    v = np.eye(3, dtype=F32)  # v[j] = column j of V
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            cs, sn, _ = rotation(F32(c[p] @ c[p]), F32(c[q] @ c[q]), F32(c[p] @ c[q]))
            c[p], c[q] = cs * c[p] - sn * c[q], sn * c[p] + cs * c[q]
            v[p], v[q] = cs * v[p] - sn * v[q], sn * v[p] + cs * v[q]
    s = np.sqrt(np.einsum("ji,ji->j", c, c)).astype(F32)
    for lo, hi in ((0, 1), (1, 2), (0, 1)):
        if s[hi] > s[lo]:
            s[[lo, hi]] = s[[hi, lo]]
            c[[lo, hi]] = c[[hi, lo]]
            v[[lo, hi]] = v[[hi, lo]]
    u = np.zeros((3, 3), F32)
    u[0] = c[0] / s[0] if s[0] > 0 else np.eye(3, dtype=F32)[0]
    u[1] = _orthogonalize(u[0], c[1])
    n1 = np.sqrt(u[1] @ u[1])
    if not n1 > 1e-30:
        u[1] = _orthogonalize(u[0], np.eye(3, dtype=F32)[int(np.argmin(np.abs(u[0])))])
        n1 = np.sqrt(u[1] @ u[1])
    u[1] /= n1
    u[2] = np.cross(u[0], u[1])
    u[2] *= (F32(-1) if u[2] @ c[2] < 0 else F32(1)) / np.sqrt(u[2] @ u[2])
    return u.T, s, v  # U (columns u[j]), S, Vt (rows v[j])


def chol6_model(H: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``spd6_solve``: Cholesky, then L y = g and L^T x = y."""
    n = H.shape[0]
    H, g = H.astype(F32), g.astype(F32)
    L = np.zeros((n, n), F32)
    for j in range(n):
        L[j, j] = np.sqrt(H[j, j] - L[j, :j] @ L[j, :j])
        for i in range(j + 1, n):
            L[i, j] = (H[i, j] - L[i, :j] @ L[j, :j]) / L[j, j]
    y = np.zeros(n, F32)
    for i in range(n):
        y[i] = (g[i] - L[i, :i] @ y[:i]) / L[i, i]
    for i in reversed(range(n)):
        y[i] = (y[i] - L[i + 1:, i] @ y[i + 1:]) / L[i, i]
    return y


def _dlt_normal(rng, n=60, noise=2e-3):
    """A DLT normal matrix AᵀA of Hartley-normalised correspondences with
    pixel noise (pnp_dlt's exact path on an inlier set)."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    t = np.array([0.3, -0.1, 0.2])
    x = (X + t)[:, :2] / (X + t)[:, 2:] + rng.normal(0, noise, (n, 2))
    X = (X - X.mean(0)) * np.sqrt(3) / np.linalg.norm(X - X.mean(0), axis=1).mean()
    x = (x - x.mean(0)) * np.sqrt(2) / np.linalg.norm(x - x.mean(0), axis=1).mean()
    Xh = np.concatenate([X, np.ones((n, 1))], 1)
    z = np.zeros_like(Xh)
    A = np.concatenate([np.concatenate([Xh, z, -x[:, :1] * Xh], 1),
                        np.concatenate([z, Xh, -x[:, 1:] * Xh], 1)])
    return (A.T @ A).astype(F32)


def _spectrum(rng, eigs):
    Q, _ = np.linalg.qr(rng.normal(size=(len(eigs), len(eigs))))
    return ((Q * np.asarray(eigs)) @ Q.T).astype(F32)


def _sym12(kind: str, rng) -> np.ndarray:
    if kind == "random_spd":
        X = rng.normal(size=(40, 12))
        return (X.T @ X).astype(F32)
    if kind == "dlt":
        return _dlt_normal(rng)
    if kind == "graded":  # 8 decades, the DLT's spread
        return _spectrum(rng, np.logspace(-3, 5, 12))
    if kind == "clustered":  # the smallest apart, the rest in near-equal pairs
        return _spectrum(rng, [1e-4, 1.0, 1.0 + 1e-6, 2.0, 2.0, 3.0, 3.0 + 1e-5, 4, 4, 5, 5, 6])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random_spd", "dlt", "graded", "clustered"])
def test_jacobi_eig_model_matches_numpy(kind):
    """The smallest eigenvector up to sign, its residual at f32 rounding of
    the matrix's norm, and the off-diagonal gone after the source's sweep
    count."""
    M = _sym12(kind, np.random.default_rng(len(kind)))
    v, a = jacobi_eig_model(M)
    w, V = np.linalg.eigh(M.astype(np.float64))
    norm = np.abs(w).max()
    assert abs(abs(v @ V[:, 0]) - 1) < 1e-5 * max(1.0, norm / (w[1] - w[0]))
    assert np.abs(M.astype(np.float64) @ v - w[0] * v).max() < 5e-6 * norm
    off = a - np.diag(np.diag(a))
    assert np.abs(off).max() <= 1e-6 * norm
    np.testing.assert_allclose(np.sort(np.diag(a)), w, rtol=0, atol=5e-6 * norm)


def test_jacobi_sweep_count_has_margin():
    """Half the source's sweeps already reach f32 rounding on the DLT normal
    matrix: the fixed count is not tuned to the edge."""
    M = _sym12("dlt", np.random.default_rng(3))
    _, a = jacobi_eig_model(M, sweeps=EIG_SWEEPS // 2 + 1)
    assert np.abs(a - np.diag(np.diag(a))).max() <= 1e-6 * np.abs(np.diag(a)).max()


def _mat3(kind: str, rng) -> np.ndarray:
    A = rng.normal(size=(3, 3)).astype(F32)
    if kind == "reflection":
        A = A if np.linalg.det(A) < 0 else A[:, ::-1].copy()
    elif kind == "rank2":  # coplanar points: Umeyama's H over a flat ground
        A = (rng.normal(size=(3, 2)) @ rng.normal(size=(2, 3))).astype(F32)
    elif kind == "near_degenerate":
        # two singular values 1e-6 apart, det > 0: the closest rotation is
        # then U Vt, well defined (with det < 0 it would turn on the
        # ill-defined last singular vector)
        U, _, Vt = np.linalg.svd(rng.normal(size=(3, 3)))
        U[:, 2] *= np.sign(np.linalg.det(U @ Vt))
        A = (U @ np.diag([2.0, 1.0 + 1e-6, 1.0]) @ Vt).astype(F32)
    elif kind == "rank1":
        A = np.outer(rng.normal(size=3), rng.normal(size=3)).astype(F32)
    elif kind == "zero":
        A = np.zeros((3, 3), F32)
    return A


def _closest_rotation(U, Vt):
    d = np.sign(np.linalg.det(U @ Vt))
    return U @ np.diag([1.0, 1.0, d]) @ Vt


@pytest.mark.parametrize("kind", ["random", "reflection", "rank2", "near_degenerate", "rank1", "zero"])
def test_svd3_model_matches_numpy(kind):
    """Singular values, orthogonal factors, A rebuilt, and the rotation
    U diag(1, 1, sign det(U Vt)) Vt the callers take, where it is unique
    (rank 2 and up)."""
    A = _mat3(kind, np.random.default_rng(7 + len(kind)))
    U, S, Vt = svd3_model(A)
    Un, Sn, Vtn = np.linalg.svd(A.astype(np.float64))
    scale = max(float(Sn[0]), 1.0)
    np.testing.assert_allclose(S, Sn, rtol=0, atol=2e-6 * scale)
    assert np.all(S[:-1] >= S[1:]) and np.all(S >= 0)
    for Q in (U, Vt):
        np.testing.assert_allclose(Q @ Q.T, np.eye(3), rtol=0, atol=2e-6)
    np.testing.assert_allclose(U @ np.diag(S) @ Vt, A, rtol=0, atol=4e-6 * scale)
    if Sn[1] > 1e-3 * Sn[0]:
        np.testing.assert_allclose(_closest_rotation(U, Vt), _closest_rotation(Un, Vtn),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("cond", [1.0, 1e3, 1e6])
def test_chol6_model_matches_numpy(cond):
    """pnp_refine_gn's system JᵀJ + 1e-6 I at three column scalings of J
    (the Jacobian's translation and rotation columns differ by the depth)."""
    rng = np.random.default_rng(int(np.log10(cond)))
    J = rng.normal(size=(200, 6)) * np.sqrt(np.logspace(0, np.log10(cond), 6))
    H = (J.T @ J + 1e-6 * np.eye(6)).astype(F32)
    g = rng.normal(size=6).astype(F32)
    x = chol6_model(H, g)
    want = np.linalg.solve(H.astype(np.float64), g.astype(np.float64))
    np.testing.assert_allclose(x, want, rtol=0, atol=2e-5 * cond * np.abs(want).max())


def test_chol6_model_gives_nan_for_an_indefinite_matrix():
    """An H that is not positive definite takes the root of a negative
    pivot: NaN, which RANSAC's finite guard drops."""
    H = np.diag([1.0, 1.0, -1.0, 1.0, 1.0, 1.0]).astype(F32)
    with np.errstate(invalid="ignore"):
        assert np.isnan(chol6_model(H, np.ones(6, F32))).any()


def test_cpu_path_is_torch_linalg():
    """CPU tensors take exactly the torch.linalg calls the callers made
    before the kernel: bit for bit, batched and not."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn(5, 30, 12, generator=g)
    M = X.transpose(-1, -2) @ X
    assert torch.equal(small_eig.smallest_eigvec(M), torch.linalg.eigh(M)[1][..., :, 0])
    A = torch.randn(7, 3, 3, generator=g)
    for got, want in zip(small_eig.svd3(A), torch.linalg.svd(A)):
        assert torch.equal(got, want)
    J = torch.randn(50, 6, generator=g)
    H = J.T @ J + 1e-6 * torch.eye(6)
    r = torch.randn(6, generator=g)
    assert torch.equal(small_eig.spd_solve(H, r), torch.linalg.solve(H, r))


def test_det3_is_the_determinant():
    """The closed form against torch.linalg.det: within float32 rounding of
    the products, and the sign the callers take exactly, on rotations and
    reflections (U, Vt and U Vt of an SVD) and at every batch shape."""
    g = torch.Generator().manual_seed(1)
    A = torch.randn(4, 64, 3, 3, generator=g)
    torch.testing.assert_close(small_eig.det3(A), torch.linalg.det(A), atol=1e-5, rtol=1e-5)
    U, _, Vt = torch.linalg.svd(A)
    for Q in (U, Vt, U @ Vt):
        assert torch.equal(torch.sign(small_eig.det3(Q)), torch.sign(torch.linalg.det(Q)))
        torch.testing.assert_close(small_eig.det3(Q).abs(), torch.ones(4, 64), atol=1e-5, rtol=0)
    assert small_eig.det3(torch.eye(3)).shape == ()
