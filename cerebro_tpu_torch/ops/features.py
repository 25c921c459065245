"""Point features and the two point matchers (counterpart of
cerebro_tpu/ops/features.py).

Behavioral equivalent of the reference's
``StaticPointFeatureMatching::gms_point_feature_matches``
(src/utils/PointFeatureMatching.cpp:5-72): keypoints on both images,
nearest-neighbour matching, then the GMS (grid motion statistics) spatial
consistency filter (src/utils/GMSMatcher/, THRESH_FACTOR 6). Output contract
preserved: matched pixel coordinates in both images plus a validity mask;
the downstream gates (>=150 attempt, >800 accept) read the match count.

  * corners — Harris response from Sobel gradients, max-pool NMS, top-K,
    on one image or on a 3-octave pyramid;
  * descriptors — steerable ring-Fourier coefficients (ops/steerable.py,
    ``match_image_pair_steerable``, the default tier 1), or normalized
    bilinear patches projected by a fixed random matrix
    (``match_image_pair``, the gather matcher: tier 2 of the cascade);
  * matching — cosine scores as (K x K) matmuls, best over rotation/scale
    banks, mutual nearest neighbours (spatially mutual across octaves);
  * GMS — scatter matches into a cell-pair count tensor, 3x3x3x3
    neighbourhood sums, support thresholded at ``factor * sqrt(mean)``.

Everything is fixed-shape: K corners, K matches, masks for validity.
Wherever keypoints are selected, ties break toward the lower flat index, as
``lax.top_k`` does (``torch.topk`` does not promise an order). Score
matrices are f32 matmuls.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cerebro_tpu_torch.ops import steerable
from cerebro_tpu_torch.utils import jaxrand

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
PROJ_SEED = 42  # the JAX package's jax.random.PRNGKey(42) patch projection
PATCH, DIM = 16, 128  # gather descriptor: 16x16 samples projected to 128-d


def _conv2(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """'same' 2D cross-correlation of (H, W) with an odd (kh, kw) kernel."""
    kh, kw = kern.shape
    return F.conv2d(img[None, None], kern[None, None], padding=(kh // 2, kw // 2))[0, 0]


@functools.lru_cache(maxsize=8)
def _sobel_x(device: torch.device) -> torch.Tensor:
    """The Sobel x filter on ``device``, made once per process and device:
    nothing is copied from the host on later calls."""
    return torch.tensor(_SOBEL_X, dtype=torch.float32, device=device)


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
    sobel_x = _sobel_x(img.device)
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


def harris_corners_pyramid(
    img: torch.Tensor,  # (H, W) float32
    max_kp: int = 1024,
    octaves: int = 3,
    nms_radius: int = 4,
    border: int = 16,
) -> Tuple[Keypoints, torch.Tensor]:
    """Multi-octave Harris: detect on a 2x-decimated pyramid, map coords
    back to full resolution, tag each keypoint with its octave (the role of
    ORB's 8-level pyramid, ref src/utils/PointFeatureMatching.cpp:21).

    Returns (Keypoints at full-res coords, lvl (max_kp,) int64). Quota per
    octave is [1/2, 1/4, 1/4, ...] of ``max_kp``; the border at octave l is
    max(8, border >> l)."""
    q0 = max_kp - (octaves - 1) * (max_kp // (2 * (octaves - 1))) if octaves > 1 else max_kp
    quotas = [q0] + [max_kp // (2 * (octaves - 1))] * (octaves - 1)
    xy, score, valid, lvl = [], [], [], []
    level = img
    for octave in range(octaves):
        if octave > 0:
            level = _avg_pool2(level)
        kp = harris_corners(level, max_kp=quotas[octave], nms_radius=nms_radius,
                            border=max(8, border >> octave))
        # avg-pool pixel i covers full-res [i 2^l, (i+1) 2^l): its centre
        f = float(2**octave)
        xy.append(kp.xy * f + (f - 1.0) / 2.0)
        score.append(kp.score)
        valid.append(kp.valid)
        lvl.append(torch.full((quotas[octave],), octave, dtype=torch.int64, device=img.device))
    kps = Keypoints(xy=torch.cat(xy), score=torch.cat(score), valid=torch.cat(valid))
    return kps, torch.cat(lvl)


# ---------------------------------------------------------------------------
# Patch descriptors (the gather matcher)
# ---------------------------------------------------------------------------


def _extract_patches(img: torch.Tensor, xy: torch.Tensor, patch: int) -> torch.Tensor:
    """(K, patch*patch) patches at integer keypoint coords, clamped inside
    the image."""
    half = patch // 2
    H, W = img.shape
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - half, 0, W - patch)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - half, 0, H - patch)
    o = torch.arange(patch, device=img.device)
    rows = (y0[:, None] + o)[:, :, None]  # (K, p, 1)
    cols = (x0[:, None] + o)[:, None, :]  # (K, 1, p)
    return img[rows, cols].reshape(xy.shape[0], patch * patch)


def keypoint_orientations(
    img: torch.Tensor,
    xy: torch.Tensor,
    radius: int = 7,
    scale=1.0,
    lvl: torch.Tensor | None = None,
) -> torch.Tensor:
    """(K,) dominant orientation per keypoint by the intensity centroid
    (ORB's orientation): atan2(m01, m10) of the patch moments. ``scale``
    (scalar or (K,)) widens the moment window by bilinear sampling at that
    spacing; ``lvl`` picks each keypoint's level of an (L, H, W) stack."""
    p = 2 * radius + 1
    if isinstance(scale, (int, float)) and scale == 1.0 and lvl is None:
        patches = _extract_patches(img, xy, p).reshape(-1, p, p)
    else:
        zeros = torch.zeros(xy.shape[0], dtype=torch.float32, device=xy.device)
        patches = _extract_oriented_patches(img, xy, zeros, p, scale=scale, lvl=lvl)
        patches = patches.reshape(-1, p, p)
    offs = torch.arange(p, dtype=torch.float32, device=xy.device) - radius
    m10 = torch.einsum("kij,j->k", patches, offs)  # x moment
    m01 = torch.einsum("kij,i->k", patches, offs)  # y moment
    return torch.atan2(m01, m10)


def _extract_oriented_patches(
    img: torch.Tensor,
    xy: torch.Tensor,
    theta: torch.Tensor,
    patch: int,
    scale=2.0,
    lvl: torch.Tensor | None = None,
) -> torch.Tensor:
    """(K, patch*patch) bilinear patches sampled on a grid of spacing
    ``scale`` (scalar or (K,)) rotated by theta about each keypoint (ORB's
    steered BRIEF). With ``img`` of shape (L, H, W), keypoint k samples
    level ``lvl[k]`` (level 0 without ``lvl``): the per-keypoint-octave
    sampling of an image pyramid. Samples clamp to [0, W - 1.001] x [0, H -
    1.001]."""
    H, W = img.shape[-2:]
    dev = xy.device
    half = (patch - 1) / 2.0
    o = torch.arange(patch, dtype=torch.float32, device=dev) - half
    gy, gx = torch.meshgrid(o, o, indexing="ij")  # (p, p)
    if isinstance(scale, (int, float)):
        sc = float(scale)  # stays on the host: nothing copied to the device
    else:
        sc = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        sc = sc[:, None, None] if sc.ndim == 1 else sc
    gx = gx[None] * sc
    gy = gy[None] * sc
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    # rotate the sampling grid by +theta (the descriptor's keypoint frame)
    rx = c * gx - s * gy
    ry = s * gx + c * gy
    sx = torch.clamp(xy[:, 0, None, None] + rx, 0.0, W - 1.001)
    sy = torch.clamp(xy[:, 1, None, None] + ry, 0.0, H - 1.001)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0f, sy - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = img.reshape(-1)
    base = 0 if img.ndim == 2 or lvl is None else (lvl * (H * W))[:, None, None]
    r0, r1 = base + y0 * W, base + y1 * W
    p00, p01 = flat[r0 + x0], flat[r0 + x1]
    p10, p11 = flat[r1 + x0], flat[r1 + x1]
    vals = (
        p00 * (1 - wx) * (1 - wy)
        + p01 * wx * (1 - wy)
        + p10 * (1 - wx) * wy
        + p11 * wx * wy
    )
    return vals.reshape(xy.shape[0], patch * patch)


@functools.lru_cache(maxsize=8)
def _projection(patch: int, dim: int, device: torch.device) -> torch.Tensor:
    """The JAX package's ``jax.random.normal(PRNGKey(42), (patch*patch,
    dim)) / patch``, drawn in numpy (utils/jaxrand) once per process and
    device."""
    proj = jaxrand.normal(jaxrand.prng_key(PROJ_SEED), (patch * patch, dim))
    return torch.from_numpy(proj / np.float32(patch)).to(device)


def _describe(p: torch.Tensor, patch: int, dim: int) -> torch.Tensor:
    """(K, dim) unit descriptors of (K, patch*patch) patches: mean/std
    normalized, projected, normalized."""
    p = p - p.mean(dim=-1, keepdim=True)
    p = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-6)
    d = p @ _projection(patch, dim, p.device)
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-6)


def patch_descriptors(
    img: torch.Tensor,  # (H, W) float32, or (L, H, W) smoothing stack
    kps: Keypoints,
    patch: int = PATCH,
    dim: int = DIM,
    oriented: bool = False,
    theta: torch.Tensor | None = None,  # (K,) override orientations
    scale=2.0,  # sampling spacing, scalar or (K,)
    lvl: torch.Tensor | None = None,  # (K,) per-keypoint smoothing level
) -> torch.Tensor:
    """(K, dim) unit descriptors: normalized patches projected by a fixed
    random matrix (rBRIEF's role). With ``oriented`` the patch grid turns
    into the keypoint's dominant-orientation frame (steered BRIEF)."""
    if oriented:
        if theta is None:
            theta = keypoint_orientations(img, kps.xy, lvl=lvl)
        p = _extract_oriented_patches(img, kps.xy, theta, patch, scale, lvl=lvl)
    else:
        p = _extract_patches(img, kps.xy, patch)
    return _describe(p, patch, dim)


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


def mutual_nn_match(
    desc_a: torch.Tensor,  # (K, D)
    desc_b: torch.Tensor,  # (K, D), or (O, K, D) banks
    kps_a: Keypoints,
    kps_b: Keypoints,
    min_score: float = 0.5,
    spatial_tol: float = 0.0,
) -> Matches:
    """Cosine-similarity mutual nearest neighbours (the BFMatcher stand-in).
    With (O, K, D) banks for b the score is the best over banks. With
    ``spatial_tol`` > 0 the mutual check is spatial: b's best match must land
    within ``spatial_tol`` px of the forward keypoint (multi-octave sets hold
    the same corner at several levels)."""
    if desc_b.ndim == 3:
        s = torch.einsum("ad,obd->oab", desc_a, desc_b).amax(dim=0)
    else:
        s = desc_a @ desc_b.T
    return _match_from_scores(s, kps_a, kps_b, min_score, spatial_tol)


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
    return gms_filter(m, tuple(img_a.shape), grid=_gms_grid(tuple(img_a.shape)), factor=gms_factor)


def _gms_grid(image_hw: Tuple[int, int]) -> Tuple[int, int]:
    """GMS cells of ~30 px: at this keypoint density the support statistics
    need bigger neighbourhoods than the reference's 20x20 grid over 752x480
    with ORB x 5000."""
    H, W = image_hw
    return (max(4, H // 30), max(4, W // 27))


def match_image_pair(
    img_a: torch.Tensor,  # (H, W) float32
    img_b: torch.Tensor,  # (H, W) float32
    max_kp: int = 1024,
    gms_factor: float = 6.0,
    blur: int = 5,
    oriented: bool = False,
    scales: Tuple[float, ...] = (1.0,),
) -> Matches:
    """The gather matcher: corners -> patch descriptors -> mutual NN -> GMS.

    ``scales == (1.0,)``: single-scale Harris on the sharp images,
    descriptors from box-blurred copies; ``oriented`` steers each patch into
    its keypoint's orientation and scores b under 3 orientation offsets
    (+-15 deg), keeping the best (the role of GMS's rotation patterns,
    gms_matcher.h:9-46). Tier 1 of the cascade when ``matcher="gather"``.

    Otherwise (tier 2): multi-octave Harris on both images, each keypoint
    sampled at its octave's spacing from a smoothing stack whose blur grows
    with the octave, b scored under the fractional scale banks ``scales``
    (spacing x f) for an identity frame hypothesis and, with ``oriented``,
    3 orientation-offset hypotheses; the best over all banks, a spatially
    mutual NN (4 px) and GMS. A revisit at 1.5-2x the approach distance
    still matches (the reference's ORB pyramid and GMS scale sweep,
    src/utils/PointFeatureMatching.cpp:21, gms_matcher.h:9-46)."""
    off = math.pi / 12
    grid = _gms_grid(tuple(img_a.shape))
    if scales == (1.0,):
        ka = harris_corners(img_a, max_kp=max_kp)
        kb = harris_corners(img_b, max_kp=max_kp)
        sa = _box_filter(img_a, blur) / float(blur * blur)
        sb = _box_filter(img_b, blur) / float(blur * blur)
        if not oriented:
            da = patch_descriptors(sa, ka)
            db = patch_descriptors(sb, kb)
        else:
            da = patch_descriptors(sa, ka, oriented=True)
            theta_b = keypoint_orientations(sb, kb.xy)
            db = torch.stack(
                [patch_descriptors(sb, kb, oriented=True, theta=theta_b + o) for o in (-off, 0.0, off)]
            )
        m = mutual_nn_match(da, db, ka, kb)
        return gms_filter(m, tuple(img_a.shape), grid=grid, factor=gms_factor)

    octaves = 3
    ka, la = harris_corners_pyramid(img_a, max_kp=max_kp, octaves=octaves)
    kb, lb = harris_corners_pyramid(img_b, max_kp=max_kp, octaves=octaves)

    def smooth_stack(img):
        """Full-res smoothing levels: the blur tracks the octave's spacing."""
        sizes = [(blur << octave) | 1 for octave in range(octaves)]
        return torch.stack([_box_filter(img, b) / float(b * b) for b in sizes])

    pa, pb = smooth_stack(img_a), smooth_stack(img_b)
    sc_a = 2.0 ** la.to(torch.float32)
    sc_b = 2.0 ** lb.to(torch.float32)
    K = ka.xy.shape[0]
    zeros_a = torch.zeros(K, dtype=torch.float32, device=img_a.device)
    zeros_b = torch.zeros(kb.xy.shape[0], dtype=torch.float32, device=img_b.device)

    # Frame hypotheses: the identity (zero rotation: exact for the no-roll
    # revisit) and, with ``oriented``, the keypoint frames with +-15 deg
    # offsets on b. Orientation is estimated once per keypoint at its own
    # octave's support and shared across the fractional banks. Each side's
    # patches for every (hypothesis, bank) are one batched gather.
    thetas_a, thetas_b = [zeros_a], [zeros_b]
    if oriented:
        theta_b = keypoint_orientations(pb, kb.xy, scale=sc_b, lvl=lb)
        thetas_a.append(keypoint_orientations(pa, ka.xy, scale=sc_a, lvl=la))
        thetas_b += [theta_b + o for o in (-off, 0.0, off)]

    def banks(img, kps, lvl, thetas, spacings):
        """(len(thetas) * len(spacings), K, DIM) descriptors."""
        n = len(thetas) * len(spacings)
        xy = kps.xy.repeat(n, 1)
        theta = torch.cat([t for t in thetas for _ in spacings])
        scale = torch.cat([sp for _ in thetas for sp in spacings])
        p = _extract_oriented_patches(img, xy, theta, PATCH, scale, lvl=lvl.repeat(n))
        return _describe(p, PATCH, DIM).reshape(n, -1, DIM)

    d_a = banks(pa, ka, la, thetas_a, [2.0 * sc_a])  # (1 or 2, K, D)
    d_b = banks(pb, kb, lb, thetas_b, [2.0 * f * sc_b for f in scales])
    nf = len(scales)
    # hypothesis h scores a's frame h (identity, or the keypoint frame for
    # every offset) against b's banks of that hypothesis
    s = None
    for h, d_bh in enumerate((d_b[:nf], d_b[nf:]) if oriented else (d_b,)):
        sh = (d_a[h] @ d_bh.reshape(-1, d_bh.shape[-1]).T).reshape(K, d_bh.shape[0], -1).amax(dim=1)
        s = sh if s is None else torch.maximum(s, sh)
    # spatial mutual test: duplicate keypoints across octaves make the
    # exact-index test too strict
    m = _match_from_scores(s, ka, kb, min_score=0.5, spatial_tol=4.0)
    return gms_filter(m, tuple(img_a.shape), grid=grid, factor=gms_factor)
