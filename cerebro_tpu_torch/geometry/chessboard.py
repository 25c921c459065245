"""Chessboard corner detection, the calibration front end (counterpart of
cerebro_tpu/geometry/chessboard.py).

Capability parity with camodocal's Chessboard.cc (reference
src/utils/camodocal/src/chessboard/Chessboard.cc): from an image and the
inner-corner pattern size, the subpixel corner grid in row-major order,
ready for ``calibration.calibrate_planar``.

A chessboard corner is a saddle of intensity: on a small ring around it
the image alternates dark and light twice per revolution. The projection
of the ring's samples on the second angular harmonic measures that; the
first harmonic measures a straight edge. The response

    R = min over radii ( |2nd harmonic| - |1st harmonic| )

is high only at X-junctions, whatever the corner's orientation. The
per-pixel work (blur, response, non-maximum suppression, top-k, subpixel
fit) runs on tensors, on the CUDA device unless the caller passes
``device="cpu"`` or a CPU tensor; ordering the candidates into the grid is
host numpy (fit a homography from the unit grid to the 4 extremal
candidates, match, refit).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cerebro_tpu_torch.geometry.calibration import as_device_tensor, estimate_homography

# Ring radii (px). Two scales: a corner must look like a saddle on both.
RING_RADII = (3, 5)
N_RING = 16


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(img: torch.Tensor, sigma: float = 1.2) -> torch.Tensor:
    """Separable Gaussian blur, zero-padded to the same size (XLA's SAME)."""
    r = int(3 * sigma + 0.5)
    k = torch.from_numpy(_gaussian_kernel(sigma, r)).to(img.device)
    x = img[None, None]
    x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, r))
    x = F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(r, 0))
    return x[0, 0]


def _magnitude(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(a^2 + b^2) in float32, the root taken in float64 and rounded:
    a correctly rounded float32 square root on every device, as XLA's."""
    return torch.sqrt((a * a + b * b).double()).to(a.dtype)


def corner_response(img, device: Optional[str] = None) -> torch.Tensor:
    """(H, W) image -> (H, W) chessboard-corner response. The ring samples
    are cyclic shifts of the blurred image (``jnp.roll``'s wrap)."""
    g = _blur(as_device_tensor(img, device, "corner_response"))
    resp = None
    for radius in RING_RADII:
        ang = 2.0 * np.pi * np.arange(N_RING) / N_RING
        dy = np.round(radius * np.sin(ang)).astype(int)
        dx = np.round(radius * np.cos(ang)).astype(int)
        a1, b1, a2, b2 = (torch.zeros_like(g) for _ in range(4))
        for i in range(N_RING):
            s = torch.roll(g, (int(-dy[i]), int(-dx[i])), dims=(0, 1))
            a1 = a1 + s * float(np.float32(np.cos(ang[i])))
            b1 = b1 + s * float(np.float32(np.sin(ang[i])))
            a2 = a2 + s * float(np.float32(np.cos(2 * ang[i])))
            b2 = b2 + s * float(np.float32(np.sin(2 * ang[i])))
        r = _magnitude(a2, b2) - _magnitude(a1, b1)
        resp = r if resp is None else torch.minimum(resp, r)
    return resp


def find_corner_candidates(img, max_corners: int, nms_radius: int = 4,
                           device: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``max_corners`` saddle points: (uv (max_corners, 2) subpixel,
    score (max_corners,)), strongest first, ties to the lower pixel index
    (``lax.top_k``). Slots past the real detections carry score 0 and the
    pixel of their (clipped) index."""
    img = as_device_tensor(img, device, "find_corner_candidates")
    H, W = img.shape
    resp = corner_response(img)
    # exclude the image border (ring + blur support)
    m = max(RING_RADII) + 4
    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    border = (row < m) | (row >= H - m) | (col < m) | (col >= W - m)
    ninf = torch.tensor(-torch.inf, device=img.device)
    resp = torch.where(border, ninf, resp)
    # NMS: strict local maxima of a (2r+1)^2 window, padded with -inf
    k = 2 * nms_radius + 1
    pooled = F.max_pool2d(resp[None, None], k, stride=1, padding=nms_radius)[0, 0]
    is_peak = (resp >= pooled) & torch.isfinite(resp)
    flat = torch.where(is_peak, resp, ninf).reshape(-1)
    score, idx = torch.sort(flat, descending=True, stable=True)
    score, idx = score[:max_corners], idx[:max_corners]
    y = torch.clamp(idx // W, 1, H - 2)
    x = torch.clamp(idx % W, 1, W - 2)
    # subpixel: a quadratic fit of the response around each peak
    nb = lambda dy, dx: resp[y + dy, x + dx]  # noqa: E731
    gx = 0.5 * (nb(0, 1) - nb(0, -1))
    gy = 0.5 * (nb(1, 0) - nb(-1, 0))
    hxx = nb(0, 1) - 2.0 * nb(0, 0) + nb(0, -1)
    hyy = nb(1, 0) - 2.0 * nb(0, 0) + nb(-1, 0)
    hxy = 0.25 * (nb(1, 1) - nb(1, -1) - nb(-1, 1) + nb(-1, -1))
    det = hxx * hyy - hxy * hxy
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    ok = torch.isfinite(score)
    zero = torch.zeros_like(det)
    ox = torch.where(ok, torch.clamp(-(hyy * gx - hxy * gy) / det, -1.0, 1.0), zero)
    oy = torch.where(ok, torch.clamp(-(hxx * gy - hxy * gx) / det, -1.0, 1.0), zero)
    uv = torch.stack([x + ox, y + oy], dim=-1)
    return uv, torch.where(ok, score, zero)


# ---------------------------------------------------------------------------
# Grid ordering (host numpy: tiny geometry, data-dependent control flow)
# ---------------------------------------------------------------------------


def _homography_np(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``estimate_homography`` on the CPU in float32 (as the JAX package
    runs it here), returned as float64."""
    return estimate_homography(torch.as_tensor(src, dtype=torch.float32),
                               torch.as_tensor(dst, dtype=torch.float32)).numpy().astype(np.float64)


def _apply_h(Hm: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ Hm.T
    return p[:, :2] / p[:, 2:3]


def _greedy_match(pred: np.ndarray, cand: np.ndarray) -> Tuple[np.ndarray, float]:
    """Match each predicted grid node to a distinct candidate, greedily by
    global minimum distance. Returns (candidate index per node, total cost)."""
    n = len(pred)
    d = np.linalg.norm(pred[:, None, :] - cand[None, :, :], axis=-1)
    assign = np.full(n, -1, dtype=int)
    cost = 0.0
    dd = d.copy()
    for _ in range(n):
        i, j = np.unravel_index(np.argmin(dd), dd.shape)
        assign[i] = j
        cost += d[i, j]
        dd[i, :] = np.inf
        dd[:, j] = np.inf
    return assign, cost


def order_grid(cand_uv: np.ndarray, pattern_size: Tuple[int, int]) -> Tuple[np.ndarray, bool]:
    """Order candidates (M, 2), M >= rows * cols, into the (rows * cols, 2)
    row-major grid by iterated homography fits. Returns (corners, found)."""
    rows, cols = pattern_size
    n = rows * cols
    if len(cand_uv) < n:
        return np.zeros((n, 2), np.float32), False
    unit = np.stack(
        np.meshgrid(np.arange(cols, dtype=np.float64), np.arange(rows, dtype=np.float64)), axis=-1
    ).reshape(-1, 2)  # (n, 2) as (x = col, y = row), row-major
    # the 4 extremal candidates (+-x +-y) as the grid's outer corners
    s, dif = cand_uv.sum(axis=1), cand_uv[:, 0] - cand_uv[:, 1]
    quad = np.array([cand_uv[np.argmin(s)], cand_uv[np.argmax(dif)],
                     cand_uv[np.argmax(s)], cand_uv[np.argmin(dif)]])
    unit_quad = np.array([[0.0, 0.0], [cols - 1.0, 0.0], [cols - 1.0, rows - 1.0], [0.0, rows - 1.0]])
    best = None
    for rot in range(4):
        Hm = _homography_np(unit_quad, np.roll(quad, -rot, axis=0))
        if not np.isfinite(Hm).all():
            continue
        assign, cost = None, np.inf
        for _ in range(3):
            assign, cost = _greedy_match(_apply_h(Hm, unit), cand_uv)
            Hm2 = _homography_np(unit, cand_uv[assign])
            if not np.isfinite(Hm2).all():
                break
            Hm = Hm2
        if assign is not None and cost < (best[1] if best else np.inf):
            best = (assign, cost, Hm)
    if best is None:
        return np.zeros((n, 2), np.float32), False
    assign, _, Hm = best
    # valid when every node's residual is small against the grid pitch
    pred = _apply_h(Hm, unit)
    res = np.linalg.norm(pred - cand_uv[assign], axis=-1)
    pitch = np.median(np.linalg.norm(np.diff(pred.reshape(rows, cols, 2), axis=1), axis=-1))
    ok = bool(len(set(assign.tolist())) == n and (res < 0.3 * pitch).all())
    return cand_uv[assign].astype(np.float32), ok


def detect_chessboard(img, pattern_size: Tuple[int, int], candidate_slack: int = 8,
                      device: Optional[str] = None) -> Tuple[np.ndarray, bool]:
    """Image -> (the ordered subpixel inner-corner grid (rows * cols, 2)
    float32 row-major, found). Detection runs on the device, ordering on
    the host."""
    rows, cols = pattern_size
    uv, score = find_corner_candidates(img, rows * cols + candidate_slack, device=device)
    uv, score = uv.cpu().numpy(), score.cpu().numpy()
    # keep candidates within a factor 4 of the strongest
    keep = score > 0.25 * score.max() if score.max() > 0 else score > 0
    return order_grid(uv[keep], pattern_size)


def board_points(pattern_size: Tuple[int, int], square: float = 1.0) -> np.ndarray:
    """Board-plane coordinates in ``detect_chessboard``'s row-major order
    (x = col * square, y = row * square), for ``calibrate_planar``."""
    rows, cols = pattern_size
    g = np.stack(
        np.meshgrid(np.arange(cols, dtype=np.float32), np.arange(rows, dtype=np.float32)), axis=-1
    ).reshape(-1, 2)
    return g * square
