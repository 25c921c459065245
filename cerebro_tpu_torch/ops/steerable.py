"""Steerable ring-Fourier patch descriptors: rotation/scale banks as matmuls
(counterpart of cerebro_tpu/ops/steerable.py).

  * ONE contiguous superpatch extraction per keypoint, per pyramid level;
  * descriptors = superpatch @ B, where B projects onto Gaussian annuli x
    angular harmonics e^{i m phi} (a steerable basis): one matmul;
  * ROTATION acts on the coefficients as a per-harmonic phase, so
    orientation normalization and the +-15 deg offset banks are elementwise
    complex multiplies — no extra image sampling;
  * SCALE banks are alternate basis matrices with dilated ring radii.

Coefficients are stored as interleaved real/imag pairs; m=0 ring means are
dropped (patch-mean invariance) and the vector is L2-normalized (contrast
invariance). Reference roles: ORB's steered BRIEF + the GMS rotation/scale
sweeps (src/utils/PointFeatureMatching.cpp:21, gms_matcher.h:9-46).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# superpatch half-extent in level pixels: must cover the outermost ring at
# the largest fractional spacing (7.2 * 2 * 1.5 = 21.6 < 24)
HALF = 24
S = 2 * HALF  # 48


@functools.lru_cache(maxsize=None)
def ring_basis(
    spacing: float,
    n_rad: int = 8,
    n_ang: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag basis matrices (S*S, n_rad*n_ang) for sampling spacing
    ``spacing`` (descriptor support = 16 samples * spacing). Host numpy,
    computed once per spacing."""
    o = np.arange(S, dtype=np.float64) - (S - 1) / 2.0
    gy, gx = np.meshgrid(o, o, indexing="ij")
    rad = np.hypot(gx, gy)
    phi = np.arctan2(gy, gx)
    rj = spacing * np.linspace(1.2, 7.2, n_rad)
    sigma = spacing * (7.2 - 1.2) / (n_rad - 1) / 2.0
    re = np.zeros((S * S, n_rad * n_ang), np.float64)
    im = np.zeros((S * S, n_rad * n_ang), np.float64)
    k = 0
    for j in range(n_rad):
        g = np.exp(-((rad - rj[j]) ** 2) / (2.0 * sigma**2))
        for m in range(n_ang):
            br = (g * np.cos(m * phi)).reshape(-1)
            bi = (g * np.sin(-m * phi)).reshape(-1)
            if m == 0:
                br = br - br.mean()  # zero-mean m=0 rings: patch-mean invariance
            n = np.sqrt((br**2 + bi**2).sum())
            re[:, k] = br / n
            im[:, k] = bi / n
            k += 1
    return re.astype(np.float32), im.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ring_basis_on(spacing: float, n_rad: int, n_ang: int, device: torch.device):
    """``ring_basis`` as tensors on ``device``, copied there once per process
    and device."""
    re, im = ring_basis(spacing, n_rad, n_ang)
    return torch.from_numpy(re).to(device), torch.from_numpy(im).to(device)


def extract_superpatches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(K, S, S) contiguous patches centered on integer coords, with the
    start semantics of the reference's ``lax.dynamic_slice``: a negative
    start wraps by the image size (Python-style), then the start is clamped
    so the patch lies inside the image. A keypoint within HALF pixels of the
    top or left edge therefore takes its patch from the bottom or right
    edge; the port keeps that for parity (ROADMAP Queue 3)."""
    H, W = img.shape
    if H < S or W < S:  # tiny coarse pyramid levels: zero-pad to the patch
        img = F.pad(img, (0, max(S - W, 0), 0, max(S - H, 0)))
        H, W = img.shape

    def start(c, n):
        c = c.to(torch.int64) - HALF
        return torch.clamp(torch.where(c < 0, c + n, c), 0, n - S)

    y0 = start(xy[:, 1], H)
    x0 = start(xy[:, 0], W)
    o = torch.arange(S, device=img.device)
    rows = (y0[:, None] + o)[:, :, None]  # (K, S, 1)
    cols = (x0[:, None] + o)[:, None, :]  # (K, 1, S)
    return img[rows, cols]


def features_from_superpatches(
    patches: torch.Tensor,  # (K, S, S)
    spacing: float,
    n_rad: int = 8,
    n_ang: int = 8,
) -> torch.Tensor:
    """(K, n_rad, n_ang, 2) normalized steerable coefficients."""
    re, im = _ring_basis_on(spacing, n_rad, n_ang, patches.device)
    flat = patches.reshape(patches.shape[0], S * S)
    cr = flat @ re
    ci = flat @ im
    c = torch.stack([cr, ci], dim=-1).reshape(-1, n_rad, n_ang, 2)
    n = torch.sqrt((c * c).sum(dim=(1, 2, 3), keepdim=True))
    return c / torch.clamp(n, min=1e-6)


def dominant_orientation(c: torch.Tensor) -> torch.Tensor:
    """(K,) patch orientation from the m=1 harmonics (the intensity-
    centroid analog): arg of the radially aggregated m=1 coefficient."""
    z = c[:, :, 1, :].sum(dim=1)  # (K, 2)
    return torch.atan2(z[:, 1], z[:, 0])


def steer(c: torch.Tensor, theta) -> torch.Tensor:
    """Rotate the PATCH CONTENT by ``theta`` in coefficient space:
    c_{r,m} -> c_{r,m} e^{-i m theta}. theta scalar or (K,)."""
    m = torch.arange(c.shape[2], dtype=torch.float32, device=c.device)
    if isinstance(theta, (int, float)):
        ang = -m[None, :] * float(theta)  # stays on the host: nothing copied to the device
    else:
        theta = torch.as_tensor(theta, dtype=torch.float32, device=c.device)
        ang = -m[None, :] * theta.reshape(-1, 1)  # (K, M)
    cos = torch.cos(ang)[:, None, :, None]
    sin = torch.sin(ang)[:, None, :, None]
    cr, ci = c[..., 0:1], c[..., 1:2]
    return torch.cat([cr * cos - ci * sin, cr * sin + ci * cos], dim=-1)


def score_matrix(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(Ka, Kb) Re<ca, cb> — cosine similarity of normalized coefficient
    vectors (one matmul over the flattened real representation)."""
    return ca.reshape(ca.shape[0], -1) @ cb.reshape(cb.shape[0], -1).T
