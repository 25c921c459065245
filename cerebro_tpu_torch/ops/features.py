"""Point features and the tier-1 steerable matcher (counterpart of
cerebro_tpu/ops/features.py).

Behavioral equivalent of the reference's
``StaticPointFeatureMatching::gms_point_feature_matches``
(src/utils/PointFeatureMatching.cpp:5-72): keypoints on both images,
nearest-neighbour matching, then the GMS (grid motion statistics) spatial
consistency filter (src/utils/GMSMatcher/, THRESH_FACTOR 6). Output contract
preserved: matched pixel coordinates in both images plus a validity mask;
the downstream gates (>=150 attempt, >800 accept) read the match count.

  * corners — Harris response from Sobel gradients, max-pool NMS, top-K;
  * descriptors — steerable ring-Fourier coefficients (ops/steerable.py);
  * matching — cosine scores as (K x K) matmuls, best over rotation/scale
    banks, spatially mutual nearest neighbours;
  * GMS — scatter matches into a cell-pair count tensor, 3x3x3x3
    neighbourhood sums, support thresholded at ``factor * sqrt(mean)``.

Everything is fixed-shape: K corners, K matches, masks for validity.
Wherever keypoints are selected, ties break toward the lower flat index, as
``lax.top_k`` does (``torch.topk`` does not promise an order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from cerebro_tpu_torch.ops import steerable

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _conv2(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """'same' 2D cross-correlation of (H, W) with an odd (kh, kw) kernel."""
    kh, kw = kern.shape
    return F.conv2d(img[None, None], kern[None, None], padding=(kh // 2, kw // 2))[0, 0]


def _box_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    ones_v = torch.ones((1, 1, size, 1), dtype=img.dtype, device=img.device)
    ones_h = torch.ones((1, 1, 1, size), dtype=img.dtype, device=img.device)
    out = F.conv2d(img[None, None], ones_v, padding=(size // 2, 0))
    return F.conv2d(out, ones_h, padding=(0, size // 2))[0, 0]


def topk_lowest_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, ties
    broken toward the lower index (``lax.top_k`` order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


@dataclasses.dataclass(frozen=True)
class Keypoints:
    xy: torch.Tensor  # (K, 2) float32 pixel coords (x, y)
    score: torch.Tensor  # (K,) float32 corner response
    valid: torch.Tensor  # (K,) bool


def harris_corners(
    img: torch.Tensor,  # (H, W) float32 grayscale
    max_kp: int = 1024,
    nms_radius: int = 4,
    k: float = 0.04,
    border: int = 16,
) -> Keypoints:
    """Harris corner top-K with max-pool NMS. Plays the role of the
    reference's ORB/FAST detector (src/utils/PointFeatureMatching.cpp:21)."""
    H, W = img.shape
    sobel_x = torch.tensor(_SOBEL_X, dtype=torch.float32, device=img.device)
    gx = _conv2(img, sobel_x)
    gy = _conv2(img, sobel_x.T.contiguous())
    gxx = _box_filter(gx * gx, 5)
    gyy = _box_filter(gy * gy, 5)
    gxy = _box_filter(gx * gy, 5)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    resp = det - k * tr * tr

    # NMS: keep only local maxima in a (2r+1)^2 window (-inf padding)
    size = 2 * nms_radius + 1
    pooled = F.max_pool2d(resp[None, None], size, stride=1, padding=nms_radius)[0, 0]
    is_max = resp >= pooled

    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    inside = (row >= border) & (row < H - border) & (col >= border) & (col < W - border)

    masked = torch.where(is_max & inside, resp, torch.full_like(resp, -math.inf))
    scores, idx = topk_lowest_index(masked.reshape(-1), max_kp)
    ys = torch.div(idx, W, rounding_mode="floor").float()
    xs = (idx % W).float()
    return Keypoints(xy=torch.stack([xs, ys], dim=-1), score=scores, valid=scores > 0)


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool decimation (crops a trailing odd row/col)."""
    H, W = img.shape
    img = img[: H - (H % 2), : W - (W % 2)]
    return img.reshape(H // 2, 2, W // 2, 2).mean(dim=(1, 3))


@dataclasses.dataclass(frozen=True)
class Matches:
    """Fixed-shape match set between images a and b (K slots, masked)."""

    xy_a: torch.Tensor  # (K, 2)
    xy_b: torch.Tensor  # (K, 2)
    idx_b: torch.Tensor  # (K,) index into b's keypoints for each a keypoint
    valid: torch.Tensor  # (K,) bool

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


def _match_from_scores(
    s: torch.Tensor,  # (K, K) score matrix
    kps_a: Keypoints,
    kps_b: Keypoints,
    min_score: float,
    spatial_tol: float,
) -> Matches:
    """Mutual-NN decision from a prebuilt score matrix."""
    s = torch.where(
        kps_a.valid[:, None] & kps_b.valid[None, :], s, torch.full_like(s, -2.0)
    )
    best_b = s.argmax(dim=1)  # for each a (first maximum)
    best_a = s.argmax(dim=0)  # for each b
    score = s.amax(dim=1)
    if spatial_tol > 0.0:
        back = kps_a.xy[best_a[best_b]]  # where b's best points back in a
        mutual = ((back - kps_a.xy) ** 2).sum(-1) <= spatial_tol**2
    else:
        mutual = best_a[best_b] == torch.arange(s.shape[0], device=s.device)
    valid = mutual & (score > min_score) & kps_a.valid
    return Matches(xy_a=kps_a.xy, xy_b=kps_b.xy[best_b], idx_b=best_b, valid=valid)


def gms_filter(
    matches: Matches,
    image_hw: Tuple[int, int],
    grid: Tuple[int, int] = (16, 24),  # (rows, cols)
    factor: float = 6.0,  # ref GMSMatcher THRESH_FACTOR=6
) -> Matches:
    """Keep matches whose cell-pair neighbourhood has enough supporting
    matches: support_i > factor * sqrt(mean_support) — the GMS
    motion-statistics test (src/utils/GMSMatcher/gms_matcher.h) as a
    scatter + two 3x3 box sums over the 4D cell-pair tensor."""
    H, W = image_hw
    gr, gc = grid
    ch = H / gr
    cw = W / gc
    dev = matches.xy_a.device

    def cell(v, size, n):
        return torch.clamp((v / size).to(torch.int64), 0, n - 1)

    ra, ca = cell(matches.xy_a[:, 1], ch, gr), cell(matches.xy_a[:, 0], cw, gc)
    rb, cb = cell(matches.xy_b[:, 1], ch, gr), cell(matches.xy_b[:, 0], cw, gc)

    w = matches.valid.float()
    counts = torch.zeros((gr, gc, gr, gc), dtype=torch.float32, device=dev)
    counts.index_put_((ra, ca, rb, cb), w, accumulate=True)

    k3 = torch.ones((1, 1, 3, 3), dtype=torch.float32, device=dev)
    # 3x3 box over the (ra, ca) cell axes, then over the (rb, cb) axes
    x1 = counts.reshape(gr, gc, -1).permute(2, 0, 1)[:, None]
    x1 = F.conv2d(x1, k3, padding=1)[:, 0].permute(1, 2, 0).reshape(gr, gc, gr, gc)
    support = F.conv2d(x1.reshape(-1, 1, gr, gc), k3, padding=1).reshape(gr, gc, gr, gc)
    s_i = support[ra, ca, rb, cb] - 1.0  # exclude the match itself

    n_total = torch.clamp(w.sum(), min=1.0)
    src_occ = torch.zeros((gr, gc), dtype=torch.float32, device=dev)
    src_occ.index_put_((ra, ca), w, accumulate=True)
    n_occupied = torch.clamp((src_occ > 0).float().sum(), min=1.0)
    thresh = factor * torch.sqrt(n_total / n_occupied)

    keep = matches.valid & (s_i > thresh)
    return Matches(xy_a=matches.xy_a, xy_b=matches.xy_b, idx_b=matches.idx_b, valid=keep)


def match_image_pair_steerable(
    img_a: torch.Tensor,  # (H, W) float32
    img_b: torch.Tensor,
    max_kp: int = 1024,
    gms_factor: float = 6.0,
    oriented: bool = True,
    scales: Tuple[float, ...] = (0.5, 0.70710678, 1.0, 1.41421356),
    octaves: int = 3,
) -> Matches:
    """Scale/rotation-robust matching with steerable ring-Fourier
    descriptors: per decimated pyramid level one superpatch extraction per
    keypoint; fractional scale banks are alternate basis matmuls on the same
    superpatches; rotation normalization and the +-15 deg offset banks are
    coefficient phase multiplies. Then spatially mutual NN and GMS."""
    q0 = max_kp - (octaves - 1) * (max_kp // (2 * (octaves - 1))) if octaves > 1 else max_kp
    quotas = [q0] + [max_kp // (2 * (octaves - 1))] * (octaves - 1)

    def per_level(img):
        """detect + superpatches per decimated level; coords at full res."""
        kps_xy, kps_valid, patches = [], [], []
        level = img
        for lvl in range(octaves):
            if lvl > 0:
                level = _avg_pool2(level)
            kp = harris_corners(level, max_kp=quotas[lvl], border=8)
            patches.append(steerable.extract_superpatches(level, kp.xy))
            f = float(2**lvl)
            kps_xy.append(kp.xy * f + (f - 1.0) / 2.0)
            kps_valid.append(kp.valid)
        return torch.cat(kps_xy), torch.cat(kps_valid), patches

    axy, avalid, apatch = per_level(img_a)
    bxy, bvalid, bpatch = per_level(img_b)
    zeros = torch.zeros(max_kp, dtype=torch.float32, device=img_a.device)
    ka = Keypoints(xy=axy, score=zeros, valid=avalid)
    kb = Keypoints(xy=bxy, score=zeros, valid=bvalid)

    def feats(patch_list, spacing):
        return torch.cat(
            [steerable.features_from_superpatches(p, spacing) for p in patch_list]
        )

    ca = feats(apatch, 2.0)  # (K, R, M, 2)
    cb_banks = [feats(bpatch, 2.0 * f) for f in scales]

    # zero-rotation hypothesis: exact for the no-roll revisit
    s = steerable.score_matrix(ca, cb_banks[0])
    for cb in cb_banks[1:]:
        s = torch.maximum(s, steerable.score_matrix(ca, cb))
    if oriented:
        # canonicalize both sides by their dominant orientation, with
        # +-15 deg offsets absorbing orientation-estimate noise
        ca_n = steerable.steer(ca, steerable.dominant_orientation(ca))
        off = math.pi / 12
        for cb in cb_banks:
            cb_n = steerable.steer(cb, steerable.dominant_orientation(cb))
            for o in (-off, 0.0, off):
                s = torch.maximum(
                    s,
                    steerable.score_matrix(ca_n, steerable.steer(cb_n, o) if o != 0.0 else cb_n),
                )
    m = _match_from_scores(s, ka, kb, min_score=0.5, spatial_tol=4.0)
    H, W = img_a.shape
    grid = (max(4, H // 30), max(4, W // 27))
    return gms_filter(m, (H, W), grid=grid, factor=gms_factor)
