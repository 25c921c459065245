"""Training-free whole-image descriptor, gist-style (counterpart of
cerebro_tpu/models/gist.py).

A deterministic descriptor from multi-scale local statistics, the useful
version of the reference's ``SampleGPUComputer`` dummy
(scripts/whole_image_desc_compute_server.py:27-60): mean and gradient
energy on 8- and 16-pixel grids, each group standardized per image, then a
fixed random projection to ``dim`` and L2 normalisation.

The projection is the JAX package's ``jax.random.normal(PRNGKey(7), (F,
dim)) / sqrt(F)``, drawn by ``utils/jaxrand`` (the same bits) and cached
per (F, dim, device): F is 3,000 at 240x320 and 14,100 at 480x752.
"""

from __future__ import annotations

import math

import torch

from cerebro_tpu_torch.utils import jaxrand

_PROJ_CACHE: dict = {}


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W) -> (B, H/k, W/k) mean pooling."""
    B, H, W = x.shape
    return x.reshape(B, H // k, k, W // k, k).mean(dim=(2, 4))


def _projection(F: int, dim: int, device) -> torch.Tensor:
    key = (F, dim, str(device))
    if key not in _PROJ_CACHE:
        proj = torch.from_numpy(jaxrand.normal(jaxrand.prng_key(7), (F, dim)))
        _PROJ_CACHE[key] = (proj / math.sqrt(F)).to(device=device, dtype=torch.float32)
    return _PROJ_CACHE[key]


def gist_descriptors(images_u8: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 1) uint8 -> (B, dim) unit float32
    descriptors. H and W must be divisible by 16."""
    if images_u8.dim() == 4:
        images_u8 = images_u8[..., 0]
    x = images_u8.float() / 255.0
    B = x.shape[0]
    gx = x - torch.roll(x, 1, dims=2)
    gy = x - torch.roll(x, 1, dims=1)
    grad = torch.sqrt(gx * gx + gy * gy + 1e-12)

    # each group (brightness / gradient energy, per scale) standardized on
    # its own, then weighted equally whatever its cell count
    feats = []
    for k in (8, 16):
        for chan in (x, grad):
            g = _avg_pool(chan, k).reshape(B, -1)
            g = g - g.mean(dim=-1, keepdim=True)
            g = g / (g.std(dim=-1, keepdim=True, unbiased=False) + 1e-6)
            feats.append(g / math.sqrt(float(g.shape[-1])))
    f = torch.cat(feats, dim=-1)  # (B, F)
    d = f @ _projection(f.shape[-1], dim, f.device)
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
