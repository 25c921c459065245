"""Whitening PCA (WPCA) descriptor post-projection (counterpart of
cerebro_tpu/models/wpca.py).

The reference's ReljaNetVLAD pipeline follows VGG16 + NetVLAD64 with a
learned WPCA layer projecting the VLAD vector to 4096 dims before L2
normalization (scripts/whole_image_desc_compute_server.py:62-165). Here, as
in the JAX package, the projection is closed-form, fitted on a descriptor
bank from the deployment domain:

    fit:    mean mu, eigvecs U, eigvals L of the bank covariance
            P = U[:, :k] @ diag(1/(L[:k] + shrinkage*L[0] + eps)^power)
    apply:  y = L2( (x - mu) @ P )

The fit is host numpy (the same numbers as the JAX package); the apply is
one torch matmul and a normalisation on the descriptors' device. Artifacts
are npz files with keys ``mean`` and ``proj``, so one written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WPCAParams:
    mean: np.ndarray  # (D,) float32
    proj: np.ndarray  # (D, K) float32 whitened principal directions

    @property
    def out_dim(self) -> int:
        return self.proj.shape[1]


def fit_wpca(
    bank: np.ndarray,
    out_dim: int,
    power: float = 0.0,
    shrinkage: float = 0.1,
    eps: float = 1e-9,
) -> WPCAParams:
    """Fit a (whitening) PCA projection on a (N, D) descriptor bank.

    The gram trick (eigendecomposition of the N x N inner-product matrix)
    never forms a D x D covariance. out_dim is capped at N - 1, the rank of
    the centred bank. Direction i is scaled by 1 / (lambda_i +
    shrinkage*lambda_0)^power: the default power 0 is a centred PCA
    projection (full whitening, power 0.5, needs a large bank; see the JAX
    package's docstring for the measurement behind the default)."""
    bank = np.asarray(bank, np.float64)
    n, d = bank.shape
    k = min(out_dim, n - 1, d)
    mu = bank.mean(axis=0)
    x = bank - mu
    lam, u = np.linalg.eigh(x @ x.T)  # ascending
    lam, u = lam[::-1][:k], u[:, ::-1][:, :k]
    lam = np.maximum(lam, 0.0)
    s = np.sqrt(lam + eps)
    cov_eig = lam / max(n - 1, 1)  # covariance eigenvalues
    scale = 1.0 / np.power(cov_eig + shrinkage * cov_eig[0] + eps, power)
    # right singular vectors V = x.T @ u / s, the variance scaling folded in
    proj = (x.T @ u) / s[None, :] * scale[None, :]
    return WPCAParams(mean=mu.astype(np.float32), proj=proj.astype(np.float32))


def apply_wpca(params: WPCAParams, descs: torch.Tensor) -> torch.Tensor:
    """(B, D) descriptors -> (B, K) whitened unit float32 descriptors on
    their device."""
    return _apply(*_on(params, descs.device), descs)


def _apply(mean: torch.Tensor, proj: torch.Tensor, descs: torch.Tensor) -> torch.Tensor:
    y = (descs.float() - mean) @ proj
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)


def _on(params: WPCAParams, device) -> tuple:
    return (
        torch.from_numpy(params.mean).to(device),
        torch.from_numpy(params.proj).to(device),
    )


def save_wpca(params: WPCAParams, path: str) -> None:
    np.savez(path, mean=np.asarray(params.mean), proj=np.asarray(params.proj))


def load_wpca(path: str) -> WPCAParams:
    with np.load(path) as z:
        return WPCAParams(
            mean=np.asarray(z["mean"], np.float32), proj=np.asarray(z["proj"], np.float32)
        )


def whitened_describe_fn(describe_fn, params: WPCAParams):
    """Wrap a describe_fn so the engine emits WPCA-projected descriptors
    (the ReljaNetVLAD shape: backbone -> VLAD -> WPCA -> L2). The mean and
    projection move to a device once, at its first call there."""
    cache: dict = {}

    @functools.wraps(describe_fn)
    def fn(imgs):
        d = describe_fn(imgs)
        if d.device not in cache:
            cache[d.device] = _on(params, d.device)
        return _apply(*cache[d.device], d)

    return fn
