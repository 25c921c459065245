"""Descriptor-training loss (counterpart of cerebro_tpu/train/loss.py).

The reference's bundled model is ``mobilenet_conv7_allpairloss``, trained
in the external repo mpkuse/cartwheel_train (ref README.md:151,155). Here
the training lives in the package: an all-pairs margin loss over a batch of
place-labelled images, every (anchor, positive) descriptor pair pushed above
every (anchor, negative) pair by a margin.
"""

from __future__ import annotations

import torch


def allpair_loss(
    descriptors: torch.Tensor,  # (B, D) unit-norm
    labels: torch.Tensor,  # (B,) integer place ids
    margin: float = 0.5,
) -> torch.Tensor:
    """Mean hinge over all (anchor, pos, neg) triples within the batch:

        mean_{i, j: y_j = y_i, j != i, k: y_k != y_i} max(0, margin + s_ik - s_ij)

    with s the (B, B) cosine similarities. The (B, B, B) hinge is
    materialized, as the JAX package does (32 K entries at a batch of 32);
    a batch with no (positive, negative) triple gives 0."""
    s = descriptors @ descriptors.T
    B = s.shape[0]
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(B, dtype=torch.bool, device=s.device)
    pos_mask = same & ~eye
    neg_mask = ~same
    # hinge[i, j, k] = relu(margin + s[i, k] - s[i, j]) for j pos, k neg
    hinge = torch.relu(margin + s[:, None, :] - s[:, :, None])
    pair_mask = pos_mask[:, :, None] & neg_mask[:, None, :]
    total = torch.where(pair_mask, hinge, torch.zeros_like(hinge)).sum()
    count = torch.clamp(pair_mask.sum(), min=1)
    return total / count
