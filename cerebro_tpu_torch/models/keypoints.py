"""Learned keypoint detector and descriptor, the SuperPoint-class model
(counterpart of cerebro_tpu/models/keypoints.py).

The reference vendors MagicLeap's SuperPoint as an exploratory alternative
to ORB+GMS matching (scripts/unittest/demo_superpoint.py,
rtry_superpoint.py; never wired into the node). Here it is a small shared
conv encoder (/8) with a cell-softmax detector head (8x8 cells + a
dustbin, SuperPoint's decoding) and a coarse descriptor head sampled
bilinearly at the keypoints. ``detect_keypoints`` plugs into the matching
stack (``ops.features.Matches``, mutual NN, optional GMS) as an
alternative to the Harris corners and patch descriptors.

Training is self-supervised on synthetic geometry (the "Synthetic Shapes"
stage of the SuperPoint recipe): random quads, checkers and line crossings
with known corners supervise the detector, and two photometrically
augmented views of each image, InfoNCE over corresponding cells, the
descriptor (``synthetic_corner_batch``, ``train_step``).

The net is an ``nn.Module`` that computes NCHW and takes and returns the
JAX package's NHWC: (B, H, W, 1) in [-1, 1] in, logits (B, H/8, W/8, 65)
and unit descriptors (B, H/8, W/8, D) out, both f32. Its blocks are
``backbones.Conv`` (XLA's SAME pads, ``dtype``-rounded operands) and
``backbones.GroupNorm`` (flax's), so a bf16 net on the card convolves in
bf16 on the tensor cores. Parameters come as the descriptor net's do:
``create_keypoint_model`` draws what flax's ``net.init`` draws and
``convert_params`` takes flax's arrays, both from one table,
``keypoint_layout``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cerebro_tpu_torch.models.backbones import Conv, GroupNorm
from cerebro_tpu_torch.models.descriptor import init_from_layout, state_from_layout
from cerebro_tpu_torch.ops.features import (
    Keypoints,
    gms_filter,
    mutual_nn_match,
    topk_lowest_index,
)
from cerebro_tpu_torch.train.optim import Adam, apply_updates, value_and_grad

CELL = 8  # detector cell size (SuperPoint's /8 grid)
DUSTBIN = CELL * CELL


def _block_spec(width: int) -> List[Tuple[int, int]]:
    """(features, stride) of the encoder's seven blocks: /2 at 1, 3, 5."""
    w = width
    return [(w, 1), (w, 2), (2 * w, 1), (2 * w, 2), (4 * w, 1), (4 * w, 2), (4 * w, 1)]


class _Block(nn.Module):
    """3x3 SAME conv (no bias, ``dtype``) -> GroupNorm(min(8, C)) in f32 ->
    relu."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = Conv(c_in, features, 3, stride=stride)
        self.norm = GroupNorm(min(8, features), features)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return torch.relu(self.norm(self.conv(x, dtype)))


class KeypointNet(nn.Module):
    """Shared encoder (/8) + detector head (65 channels) + descriptor head
    (``desc_dim``)."""

    def __init__(self, desc_dim: int = 128, width: int = 32, dtype=torch.bfloat16):
        super().__init__()
        self.desc_dim, self.width, self.dtype = desc_dim, width, dtype
        blocks, c = [], 1
        for f, s in _block_spec(width):
            blocks.append(_Block(c, f, s))
            c = f
        self.blocks = nn.ModuleList(blocks)
        self.detector = Conv(c, DUSTBIN + 1, 1, bias=True)
        self.descriptor = Conv(c, desc_dim, 1, bias=True)

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """img (B, H, W, 1) in [-1, 1] -> (logits (B, H/8, W/8, 65), desc
        (B, H/8, W/8, D) L2-normalized), f32."""
        x = img.permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x, self.dtype)
        logits = self.detector(x, self.dtype).float()
        d = self.descriptor(x, self.dtype).float()
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-8)
        return logits.permute(0, 2, 3, 1), d.permute(0, 2, 3, 1)


def keypoint_layout(desc_dim: int = 128, width: int = 32) -> List[Tuple[tuple, str, tuple, str]]:
    """(flax path, PyTorch state name, flax shape, initializer) of every
    parameter, in flax's auto-names: ``_Block_0`` ... ``_Block_6``, each
    with ``Conv_0/kernel`` and ``GroupNorm_0/scale`` and ``bias``; the
    detector head ``Conv_0`` and the descriptor head ``Conv_1`` at the top,
    each with a kernel and a bias."""
    out, c = [], 1
    for i, (f, _) in enumerate(_block_spec(width)):
        b, n = (f"_Block_{i}",), f"blocks.{i}"
        out.append((b + ("Conv_0", "kernel"), n + ".conv.weight", (3, 3, c, f), "lecun"))
        out.append((b + ("GroupNorm_0", "scale"), n + ".norm.weight", (f,), "ones"))
        out.append((b + ("GroupNorm_0", "bias"), n + ".norm.bias", (f,), "zeros"))
        c = f
    for head, name, n_out in (("Conv_0", "detector", DUSTBIN + 1), ("Conv_1", "descriptor", desc_dim)):
        out.append(((head, "kernel"), name + ".weight", (1, 1, c, n_out), "lecun"))
        out.append(((head, "bias"), name + ".bias", (n_out,), "zeros"))
    return out


def convert_params(flax_params, desc_dim: int = 128, width: int = 32,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """flax params of ``KeypointNet(desc_dim, width)`` (numpy arrays, nested
    or flat ``"a/b/name"``) -> the PyTorch state on ``device``."""
    return state_from_layout(flax_params, keypoint_layout(desc_dim, width), device)


def create_keypoint_model(desc_dim: int = 128, width: int = 32, seed: int = 0,
                          device="cuda") -> Tuple[KeypointNet, Dict[str, torch.Tensor]]:
    """(bf16 net, params) with the params the JAX package's
    ``create_keypoint_model(desc_dim, width, seed)`` draws (its init input's
    size sets no shape)."""
    net = KeypointNet(desc_dim=desc_dim, width=width).to(device)
    layout = keypoint_layout(desc_dim, width)
    params = state_from_layout(init_from_layout(layout, seed), layout, device)
    net.load_state_dict(params)
    return net, params


def _apply(net: KeypointNet, params, x: torch.Tensor):
    if params is None:
        return net(x)
    return torch.func.functional_call(net, params, (x,))


def heatmap_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """(B, Hc, Wc, 65) cell logits -> (B, Hc*8, Wc*8) probability heatmap:
    softmax over the 65 bins, the dustbin dropped, 64 -> 8x8 pixels (row
    within the cell first)."""
    p = torch.softmax(logits, dim=-1)[..., :-1]
    B, Hc, Wc, _ = p.shape
    p = p.reshape(B, Hc, Wc, CELL, CELL).permute(0, 1, 3, 2, 4)  # (B, Hc, 8, Wc, 8)
    return p.reshape(B, Hc * CELL, Wc * CELL)


def detect_keypoints(
    net: KeypointNet,
    params,
    img: torch.Tensor,  # (H, W) float32 grayscale in [0, 1]
    max_kp: int = 512,
    nms_radius: int = 4,
    border: int = 16,
    min_prob: float = 0.015,
) -> Tuple[Keypoints, torch.Tensor]:
    """One image -> (Keypoints, descriptors (max_kp, D)): full-resolution
    heatmap -> max-pool NMS (-inf padding) -> the ``max_kp`` best, equal
    scores in ascending pixel index as ``lax.top_k`` orders them (the -inf
    tail of a frame with fewer maxima too); descriptors sampled bilinearly
    from the coarse map. ``params`` None: the net's own."""
    H, W = img.shape
    with torch.no_grad():
        logits, dmap = _apply(net, params, (img * 2.0 - 1.0)[None, :, :, None])
        heat = heatmap_from_logits(logits)[0][:H, :W]
        pooled = F.max_pool2d(heat[None, None], 2 * nms_radius + 1, stride=1,
                              padding=nms_radius)[0, 0]
        is_max = heat >= pooled
        row = torch.arange(H, device=img.device)[:, None]
        col = torch.arange(W, device=img.device)[None, :]
        inside = (row >= border) & (row < H - border) & (col >= border) & (col < W - border)
        masked = torch.where(is_max & inside, heat, torch.full_like(heat, -torch.inf))
        score, idx = topk_lowest_index(masked.reshape(-1), max_kp)
        xy = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
        kps = Keypoints(xy=xy, score=score, valid=score > min_prob)
        return kps, _sample_desc(dmap[0], kps.xy)


def _sample_desc(dmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the (Hc, Wc, D) coarse map at pixel coords (K, 2),
    renormalized. Cell-centre convention: pixel p lies in cell p / 8, the
    centres at + 0.5."""
    Hc, Wc, _ = dmap.shape
    cx = torch.clamp(xy[:, 0] / CELL - 0.5, 0.0, Wc - 1.0)
    cy = torch.clamp(xy[:, 1] / CELL - 0.5, 0.0, Hc - 1.0)
    x0 = torch.floor(cx).long()
    y0 = torch.floor(cy).long()
    x1 = torch.clamp(x0 + 1, max=Wc - 1)
    y1 = torch.clamp(y0 + 1, max=Hc - 1)
    fx = (cx - x0)[:, None]
    fy = (cy - y0)[:, None]
    d = (
        dmap[y0, x0] * (1 - fx) * (1 - fy)
        + dmap[y0, x1] * fx * (1 - fy)
        + dmap[y1, x0] * (1 - fx) * fy
        + dmap[y1, x1] * fx * fy
    )
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)


def match_image_pair_learned(
    net: KeypointNet,
    params,
    img_a: torch.Tensor,  # (H, W) float32 in [0, 1]
    img_b: torch.Tensor,
    max_kp: int = 512,
    gms_factor: float | None = None,
    min_score: float = 0.6,
):
    """Learned corners and descriptors -> mutual NN (-> optional GMS): the
    ``Matches`` contract of ``ops.features.match_image_pair``. GMS is off
    by default: it needs the dense thousands-of-ORB-matches regime to
    gather cell support, and learned descriptors leave the filtering to
    mutual NN and the downstream RANSAC (as the reference's SuperPoint
    experiment pairs its tracker with pose RANSAC,
    scripts/unittest/rtry_superpoint.py)."""
    ka, da = detect_keypoints(net, params, img_a, max_kp=max_kp)
    kb, db = detect_keypoints(net, params, img_b, max_kp=max_kp)
    m = mutual_nn_match(da, db, ka, kb, min_score=min_score)
    if gms_factor is not None:
        m = gms_filter(m, tuple(img_a.shape), factor=gms_factor)
    return m


# ---------------------------------------------------------------------------
# Self-supervised training: synthetic shapes and augmented twin views
# ---------------------------------------------------------------------------


def synthetic_corner_batch(rng: np.random.Generator, batch: int, hw: int = 64):
    """Random quads / checkers / line crossings with exact corner labels,
    drawn from ``rng`` in the JAX package's order (the same generator gives
    the same batch, bit for bit).

    Returns (images (B, hw, hw, 1) float32 [0, 1], cell labels (B, hw/8,
    hw/8) int32 in [0, 64], 64 = dustbin)."""
    B = batch
    imgs = np.full((B, hw, hw), 0.0, np.float32)
    Hc = hw // CELL
    labels = np.full((B, Hc, Hc), DUSTBIN, np.int32)

    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for b in range(B):
        bg = rng.uniform(0.1, 0.4)
        imgs[b] = bg
        corners = []
        kind = rng.integers(0, 3)
        if kind == 0:  # random convex quad
            c = rng.uniform(hw * 0.3, hw * 0.7, size=2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, size=4))
            rad = rng.uniform(hw * 0.12, hw * 0.32, size=4)
            pts = np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], -1)
            fg = rng.uniform(0.6, 0.95)
            # rasterized as the intersection of four half-planes
            inside = np.ones((hw, hw), bool)
            for i in range(4):
                p, q = pts[i], pts[(i + 1) % 4]
                nx, ny = q[1] - p[1], -(q[0] - p[0])
                inside &= (xx - p[0]) * nx + (yy - p[1]) * ny <= 0
            imgs[b] = np.where(inside, fg, imgs[b])
            corners = [tuple(p) for p in pts]
        elif kind == 1:  # checker patch (X-junctions)
            sq = int(rng.integers(8, 14))
            ox, oy = rng.uniform(2, hw - 3 * sq - 2, size=2)
            dark, light = rng.uniform(0.05, 0.25), rng.uniform(0.7, 0.95)
            cell_i = np.floor((xx - ox) / sq) + np.floor((yy - oy) / sq)
            reg = (xx >= ox) & (xx < ox + 3 * sq) & (yy >= oy) & (yy < oy + 3 * sq)
            imgs[b] = np.where(reg, np.where(cell_i % 2 == 0, light, dark), imgs[b])
            for i in range(1, 3):
                for j in range(1, 3):
                    corners.append((ox + i * sq, oy + j * sq))
        else:  # L / T line crossings
            fg = rng.uniform(0.6, 0.95)
            px, py = rng.uniform(hw * 0.25, hw * 0.75, size=2)
            w = rng.integers(2, 5)
            horiz = (np.abs(yy - py) < w) & (xx >= px)
            vert = (np.abs(xx - px) < w) & (yy >= py)
            imgs[b] = np.where(horiz | vert, fg, imgs[b])
            corners = [(px, py)]

        for (cx, cy) in corners:
            xi, yi = int(round(cx)), int(round(cy))
            if 2 <= xi < hw - 2 and 2 <= yi < hw - 2:
                labels[b, yi // CELL, xi // CELL] = (yi % CELL) * CELL + (xi % CELL)

        imgs[b] += rng.normal(0, 0.02, (hw, hw))
    return imgs[..., None].clip(0, 1), labels


def _detector_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cell-wise cross-entropy against (B, Hc, Wc) labels in [0, 64],
    corner cells weighted 20 (corners are rare)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    w = torch.where(labels == DUSTBIN, 1.0, 20.0)
    return -torch.sum(w * ll) / torch.sum(w)


def _descriptor_loss(da: torch.Tensor, db: torch.Tensor, temp: float = 0.1) -> torch.Tensor:
    """InfoNCE over corresponding cells of an identity-aligned pair; da, db
    (B, Hc, Wc, D) from two augmented views of the same images."""
    B, Hc, Wc, D = da.shape
    a = da.reshape(B, Hc * Wc, D)
    b = db.reshape(B, Hc * Wc, D)
    s = torch.einsum("bnd,bmd->bnm", a, b) / temp
    logp = torch.log_softmax(s, dim=-1)
    return -torch.diagonal(logp, dim1=1, dim2=2).mean()


def make_optimizer_state(params: Dict[str, torch.Tensor], lr: float = 1e-3):
    """The state of ``train_step``'s Adam (optax's ``adam(lr).init``)."""
    return Adam(lr).init(params)


def train_loss(net: KeypointNet, params: Dict[str, torch.Tensor], imgs: torch.Tensor,
               labels: torch.Tensor):
    """``train_step``'s loss: the detector cross-entropy of both views plus
    0.3 x the descriptor InfoNCE between them, the second view brightened
    (``clip(imgs * 1.1 + 0.05, 0, 1)``): (loss, (det, desc))."""
    logits, da = _apply(net, params, imgs * 2.0 - 1.0)
    aug = torch.clamp(imgs * 1.1 + 0.05, 0, 1)
    logits2, db = _apply(net, params, aug * 2.0 - 1.0)
    det = _detector_loss(logits, labels) + _detector_loss(logits2, labels)
    desc = _descriptor_loss(da, db)
    return det + 0.3 * desc, (det, desc)


def train_step(net: KeypointNet, params: Dict[str, torch.Tensor], opt_state,
               imgs: torch.Tensor, labels: torch.Tensor, lr: float = 1e-3):
    """One Adam step on ``train_loss``: (params, opt_state, loss, det,
    desc), the losses before the step. imgs (B, H, W, 1) f32 in [0, 1],
    labels (B, H/8, W/8) integer."""
    (loss, (det, desc)), grads = value_and_grad(lambda p: train_loss(net, p, imgs, labels), params)
    updates, opt_state = Adam(lr).update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss, det, desc
