"""Observability renderers, plain numpy images (counterpart of
cerebro_tpu/utils/plot.py).

Parity targets:
  * ``plot_scores`` — Plot2Mat (src/utils/Plot2Mat.{h,cpp}): the live
    dot-product score curve with detection marks
    (used at src/Cerebro.cpp:950-955,1047-1052,1085-1088);
  * ``side_by_side_matches`` — MiscUtils::side_by_side + plot_point_sets
    (src/utils/MiscUtils.h:31-205) and the annotated candidate image pairs
    Visualization publishes (src/Visualization.cpp:75-225), including the
    accept/reject banner;
  * ``trajectory_topdown`` — the rviz marker trajectory as a plotted image.

All return (H, W, 3) uint8 arrays the caller can save or stream;
``encode_png`` writes one as a PNG file's bytes (no OpenCV or PIL needed).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

_BG = np.array([24, 24, 24], np.uint8)
_FG = np.array([80, 220, 120], np.uint8)
_MARK = np.array([240, 80, 80], np.uint8)
_GRID = np.array([60, 60, 60], np.uint8)


def plot_scores(
    scores: np.ndarray,  # (N,) score history
    marks: Sequence[int] = (),  # indices where detections fired
    threshold: Optional[float] = None,
    size: Tuple[int, int] = (240, 640),
) -> np.ndarray:
    """Score curve image (Plot2Mat::plot + mark equivalent)."""
    H, W = size
    img = np.tile(_BG, (H, W, 1))
    n = len(scores)
    if n == 0:
        return img
    lo, hi = -1.0, 1.0
    xs = (np.arange(n) * (W - 1) / max(n - 1, 1)).astype(int)
    ys = np.clip(((hi - np.asarray(scores)) / (hi - lo) * (H - 1)), 0, H - 1).astype(int)
    if threshold is not None:
        ty = int(np.clip((hi - threshold) / (hi - lo) * (H - 1), 0, H - 1))
        img[ty, :] = _GRID
    zero_y = int((hi - 0.0) / (hi - lo) * (H - 1))
    img[zero_y, :] = _GRID
    for i in range(1, n):
        x0, x1 = xs[i - 1], xs[i]
        y0, y1 = ys[i - 1], ys[i]
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        for t in range(steps + 1):
            x = x0 + (x1 - x0) * t // steps
            y = y0 + (y1 - y0) * t // steps
            img[y, x] = _FG
    for m in marks:
        if 0 <= m < n:
            img[:, xs[m]] = np.where(
                (np.arange(H) % 4 < 2)[:, None], _MARK, img[:, xs[m]]
            )
    return img


def _to_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.dtype != np.uint8:
        img = np.clip(img * 255 if img.max() <= 1.5 else img, 0, 255).astype(np.uint8)
    return img


def side_by_side_matches(
    img_a: np.ndarray,
    img_b: np.ndarray,
    xy_a: np.ndarray,  # (K, 2)
    xy_b: np.ndarray,  # (K, 2)
    valid: np.ndarray,  # (K,) bool
    accepted: Optional[bool] = None,
    banner: str = "",
) -> np.ndarray:
    """Annotated candidate pair (the debug images of
    ref src/Visualization.cpp:75-225): images side by side, match lines,
    green/red status strip."""
    a = _to_rgb(np.asarray(img_a))
    b = _to_rgb(np.asarray(img_b))
    H = max(a.shape[0], b.shape[0])
    strip = 18
    out = np.tile(_BG, (H + strip, a.shape[1] + b.shape[1], 1))
    out[strip : strip + a.shape[0], : a.shape[1]] = a
    out[strip : strip + b.shape[0], a.shape[1] :] = b
    if accepted is not None:
        out[:strip, :] = [40, 180, 60] if accepted else [200, 50, 50]
    if banner:
        # the reference stamps the accept/reject reason onto the debug image
        # (src/Visualization.cpp:75-225); do the same when cv2 is available
        try:
            import cv2

            out = np.ascontiguousarray(out)
            cv2.putText(
                out, banner, (4, strip - 5), cv2.FONT_HERSHEY_SIMPLEX,
                0.38, (255, 255, 255), 1, cv2.LINE_AA,
            )
        except ImportError:
            pass
    off = a.shape[1]
    for k in np.nonzero(np.asarray(valid))[0][:200]:
        x0, y0 = int(xy_a[k, 0]), int(xy_a[k, 1]) + strip
        x1, y1 = int(xy_b[k, 0]) + off, int(xy_b[k, 1]) + strip
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        for t in range(0, steps + 1, 2):
            x = x0 + (x1 - x0) * t // steps
            y = y0 + (y1 - y0) * t // steps
            if 0 <= y < out.shape[0] and 0 <= x < out.shape[1]:
                out[y, x] = _FG
    return out


def trajectory_topdown(
    poses: np.ndarray,  # (N, 4, 4)
    world_id: Optional[np.ndarray] = None,
    loop_pairs: Sequence[Tuple[int, int]] = (),
    size: Tuple[int, int] = (480, 480),
) -> np.ndarray:
    """Top-down (x, y) trajectory image with per-world colors and red loop
    chords (the rviz marker view, ref src/Visualization.cpp:230-379)."""
    H, W = size
    img = np.tile(_BG, (H, W, 1))
    if len(poses) == 0:
        return img
    xy = poses[:, :2, 3]
    lo = xy.min(axis=0) - 1.0
    hi = xy.max(axis=0) + 1.0
    scale = min((W - 20) / max(hi[0] - lo[0], 1e-6), (H - 20) / max(hi[1] - lo[1], 1e-6))

    def to_px(p):
        return (
            int(10 + (p[0] - lo[0]) * scale),
            int(H - 10 - (p[1] - lo[1]) * scale),
        )

    palette = np.array(
        [[80, 220, 120], [120, 160, 255], [250, 200, 80], [220, 120, 220]], np.uint8
    )
    for i in range(1, len(xy)):
        c = palette[int(world_id[i]) % len(palette)] if world_id is not None else _FG
        x0, y0 = to_px(xy[i - 1])
        x1, y1 = to_px(xy[i])
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        for t in range(steps + 1):
            x = x0 + (x1 - x0) * t // steps
            y = y0 + (y1 - y0) * t // steps
            if 0 <= y < H and 0 <= x < W:
                img[y, x] = c
    for i, j in loop_pairs:
        x0, y0 = to_px(xy[i])
        x1, y1 = to_px(xy[j])
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        for t in range(0, steps + 1, 3):
            x = x0 + (x1 - x0) * t // steps
            y = y0 + (y1 - y0) * t // steps
            if 0 <= y < H and 0 <= x < W:
                img[y, x] = _MARK
    return img


def encode_png(img: np.ndarray) -> bytes:
    """A PNG file of an (H, W, 3) uint8 RGB image: 8 bits per channel,
    every row filtered None (filter type 0), no interlace."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) RGB image, got shape {img.shape}")
    H, W, _ = img.shape
    rows = np.zeros((H, 3 * W + 1), np.uint8)
    rows[:, 1:] = img.reshape(H, 3 * W)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", zlib.crc32(ctype + data))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )
