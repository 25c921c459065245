"""NetVLAD / GhostVLAD aggregation (counterpart of
cerebro_tpu/models/netvlad.py).

Re-designed from the behavior of the reference's custom Keras layers
(scripts/predict_utils.py:11-79 ``NetVLADLayer`` and :83-155
``GhostVLADLayer``): a 1x1 soft assignment over K cluster centers, softmax,
residual aggregation to the centers, intra-normalization per cluster,
flatten (K-major), and a final L2 normalization. Ghost clusters take part
in the softmax and are dropped after it.

The two products take ``dtype``-rounded operands and give an f32 result
(the JAX package's ``preferred_element_type=f32``): they multiply the
rounded values in f32, since a bf16 ``torch.matmul`` would round its
result to bf16. The softmax, the sums and the norms are f32. A float32
net's products on CUDA run with TF32 off (``utils.precision.exact_fp32``).
"""

from __future__ import annotations

import torch
from torch import nn

from cerebro_tpu_torch.utils.precision import exact_fp32


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


class NetVLAD(nn.Module):
    """K clusters (plus G ghosts) over C-dim local features -> (K*C,) unit
    descriptor. ``forward`` takes the trunk's (B, C, H, W) map."""

    def __init__(self, channels: int, num_clusters: int = 16, num_ghost: int = 0):
        super().__init__()
        self.num_clusters, self.num_ghost = num_clusters, num_ghost
        K = num_clusters + num_ghost
        self.assign_w = nn.Parameter(torch.zeros(channels, K))
        self.assign_b = nn.Parameter(torch.zeros(K))
        self.centers = nn.Parameter(torch.zeros(num_clusters, channels))

    def forward(self, x: torch.Tensor, dtype, return_ghost_mass: bool = False):
        B, C = x.shape[:2]
        K = self.num_clusters
        # (B, N, C) tokens in the JAX package's order: row-major over H, W
        feats = _round(x.flatten(2).transpose(1, 2), dtype)
        with exact_fp32(x, dtype):
            logits = torch.matmul(feats, _round(self.assign_w, dtype)) + self.assign_b.float()
            a_full = torch.softmax(logits, dim=-1)  # (B, N, K + G) f32
            a = a_full[..., :K]  # ghost columns dropped after the softmax
            # V[b,k,c] = sum_n a[b,n,k] * (f[b,n,c] - mu[k,c])
            af = torch.matmul(_round(a, dtype).transpose(1, 2), feats)  # (B, K, C)
        V = af - a.sum(dim=1)[..., None] * self.centers.float()[None]
        V = V / (torch.linalg.vector_norm(V, dim=-1, keepdim=True) + 1e-12)
        v = V.reshape(B, K * C)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
        if return_ghost_mass:
            # per-token mass the ghost columns absorbed: (B, H*W)
            return v, a_full[..., K:].sum(dim=-1)
        return v


class GhostVLAD(NetVLAD):
    """NetVLAD with G >= 1 ghost clusters absorbing uninformative features
    (ref scripts/predict_utils.py:83-155)."""

    def __init__(self, channels: int, num_clusters: int = 16, num_ghost: int = 1):
        if num_ghost < 1:
            raise ValueError(f"GhostVLAD needs num_ghost >= 1, got {num_ghost}")
        super().__init__(channels, num_clusters, num_ghost)
