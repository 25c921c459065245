"""EuRoC MAV dataset loader, ASL folder format (counterpart of
cerebro_tpu/io/euroc.py).

Replaces the reference's rosbag ingestion for offline runs (ref
launch/euroc_vinsfusion.launch:12-24). Reads the standard ASL layout:

    mav0/cam0/data.csv + data/<stamp>.png
    mav0/cam1/data.csv + data/
    mav0/state_groundtruth_estimate0/data.csv   (stamp, p, q, v, ...)

and yields time-aligned stereo frames with ground-truth poses associated by
nearest stamp: the right image within ±1 ms (the reference's range-search
rule, src/DataManager.cpp:924-928), the pose within 20 ms.

PNGs are decoded by ``decode_png_gray``, this module's own decoder (zlib
and numpy), on every machine: EuRoC ships 8-bit grayscale, non-interlaced
PNGs, and any other kind raises ``ValueError``. ``decode_png`` also reads
the 8-bit RGB PNGs of the pipeline's debug dump (``utils/plot.encode_png``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from cerebro_tpu_torch.geometry import se3

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(payload) != length or zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"corrupt PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG (no IEND chunk)")


def _unfilter_wavefront(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Unfilter an image whose rows use any of the five filters. Each byte
    depends on its left, up and up-left neighbours, so the bytes of one
    anti-diagonal (row + column = k) are independent: one vector step per
    diagonal, H + W - 1 steps. The diagonals are stored skewed, diagonal k
    as row k + 2 of ``T`` (``T[k + 2, i + 1]`` holds pixel (i, k - i)), so
    each step reads and writes contiguous slices; row and column padding
    stay zero, the bytes PNG defines outside the image."""
    H, W = raw.shape
    D = H + W - 1
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    R = np.zeros((D, H), np.int16)
    R[ii + jj, ii] = raw
    T = np.zeros((D + 2, H + 1), np.int16)
    zero = np.zeros(H, np.int16)
    ft = ftype.astype(np.intp)
    for k in range(D):
        lo, hi = max(0, k - W + 1), min(H - 1, k) + 1
        a = T[k + 1, lo + 1 : hi + 1]  # left: pixel (i, j - 1)
        b = T[k + 1, lo:hi]  # up: pixel (i - 1, j)
        c = T[k, lo:hi]  # up-left: pixel (i - 1, j - 1)
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ft[lo:hi], (zero[lo:hi], a, b, (a + b) >> 1, paeth))
        T[k + 2, lo + 1 : hi + 1] = (R[k, lo:hi] + pred) & 0xFF
    return T[ii + jj + 2, ii + 1].astype(np.uint8)


def _unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """(H, W) bytes of one channel with their rows' filters undone."""
    if ftype.max(initial=0) >= 3:  # Average or Paeth rows: the wavefront
        return _unfilter_wavefront(raw, ftype)
    H, W = raw.shape
    out = np.empty((H, W), np.uint8)
    prior = np.zeros(W, np.uint8)
    for r in range(H):
        if ftype[r] == 0:
            out[r] = raw[r]
        elif ftype[r] == 1:  # Sub: a running sum mod 256
            out[r] = np.cumsum(raw[r], dtype=np.uint8)
        else:  # Up
            out[r] = raw[r] + prior
        prior = out[r]
    return out


_CHANNELS = {0: 1, 2: 3}  # PNG colour type -> channels: grayscale, RGB


def decode_png(data: bytes, colour_types=(0, 2)) -> np.ndarray:
    """Pixels of an 8-bit, non-interlaced grayscale ((H, W) uint8) or RGB
    ((H, W, 3) uint8) PNG, all five row filters. Any other colour type,
    bit depth or interlace, or a colour type outside ``colour_types``,
    raises ``ValueError``."""
    ihdr, idat = None, []
    for ctype, payload in _png_chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    W, H, depth, color, compression, filt, interlace = ihdr
    kinds = " or ".join({0: "grayscale", 2: "RGB"}[c] for c in colour_types)
    if depth != 8 or color not in colour_types:
        raise ValueError(
            f"only 8-bit {kinds} PNGs are supported (bit depth {depth}, colour type {color})"
        )
    if interlace != 0 or compression != 0 or filt != 0:
        raise ValueError(
            f"unsupported PNG: interlace {interlace}, compression {compression}, filter method {filt}"
        )
    ch = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != H * (W * ch + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {H * (W * ch + 1)}")
    rows = rows.reshape(H, W * ch + 1)
    ftype, raw = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    if ch == 1:
        return _unfilter(raw, ftype)
    # each filter predicts a byte from the same channel of the pixels left,
    # up and up-left: the channels unfilter as independent images
    raw = raw.reshape(H, W, ch)
    return np.stack([_unfilter(np.ascontiguousarray(raw[..., c]), ftype) for c in range(ch)], -1)


def decode_png_gray(data: bytes) -> np.ndarray:
    """(H, W) uint8 pixels of an 8-bit grayscale, non-interlaced PNG (all
    five row filters). Any other colour type, bit depth or interlace
    raises ``ValueError``."""
    return decode_png(data, colour_types=(0,))


def read_png_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_gray(f.read())


@dataclasses.dataclass
class EurocFrame:
    stamp: float  # seconds
    left_path: str
    right_path: Optional[str]
    pose: Optional[np.ndarray]  # (4,4) w_T_b ground truth if available

    def left(self) -> np.ndarray:
        return read_png_gray(self.left_path)

    def right(self) -> Optional[np.ndarray]:
        return read_png_gray(self.right_path) if self.right_path else None


def _read_cam_csv(cam_dir: str) -> List[Tuple[float, str]]:
    out = []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ns = int(row[0])
            out.append((ns * 1e-9, os.path.join(cam_dir, "data", row[1].strip())))
    out.sort()
    return out


def _read_groundtruth(gt_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (stamps (N,), poses (N,4,4) float32); the quaternion columns
    are w, x, y, z."""
    stamps, p, q = [], [], []
    with open(os.path.join(gt_dir, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            stamps.append(int(row[0]) * 1e-9)
            p.append([float(v) for v in row[1:4]])
            q.append([float(v) for v in row[4:8]])
    if not stamps:
        return np.zeros(0), np.zeros((0, 4, 4), np.float32)
    R = se3.quat_to_rot(torch.tensor(q, dtype=torch.float32))
    poses = se3.make_pose(R, torch.tensor(p, dtype=torch.float32))
    return np.asarray(stamps), poses.numpy()


class EurocSequence:
    """One EuRoC sequence (e.g. MH_01_easy/mav0)."""

    def __init__(self, mav0_dir: str, stamp_tol: float = 1e-3):
        self.root = mav0_dir
        self.cam0 = _read_cam_csv(os.path.join(mav0_dir, "cam0"))
        cam1_dir = os.path.join(mav0_dir, "cam1")
        self.cam1 = _read_cam_csv(cam1_dir) if os.path.isdir(cam1_dir) else []
        gt_dir = os.path.join(mav0_dir, "state_groundtruth_estimate0")
        if os.path.isdir(gt_dir):
            self.gt_stamps, self.gt_poses = _read_groundtruth(gt_dir)
        else:
            self.gt_stamps, self.gt_poses = np.zeros(0), np.zeros((0, 4, 4), np.float32)
        self.stamp_tol = stamp_tol
        self._cam1_stamps = np.asarray([s for s, _ in self.cam1])

    def __len__(self) -> int:
        return len(self.cam0)

    def _nearest_right(self, stamp: float) -> Optional[str]:
        if len(self.cam1) == 0:
            return None
        i = int(np.searchsorted(self._cam1_stamps, stamp))
        best, best_d = None, self.stamp_tol
        for j in (i - 1, i):
            if 0 <= j < len(self.cam1):
                d = abs(self.cam1[j][0] - stamp)
                if d <= best_d:
                    best, best_d = self.cam1[j][1], d
        return best

    def _nearest_pose(self, stamp: float, tol: float = 0.02) -> Optional[np.ndarray]:
        if len(self.gt_stamps) == 0:
            return None
        i = int(np.searchsorted(self.gt_stamps, stamp))
        best, best_d = None, tol
        for j in (i - 1, i):
            if 0 <= j < len(self.gt_stamps):
                d = abs(self.gt_stamps[j] - stamp)
                if d <= best_d:
                    best, best_d = self.gt_poses[j], d
        return best

    def frames(self, stride: int = 1) -> Iterator[EurocFrame]:
        for stamp, left_path in self.cam0[::stride]:
            yield EurocFrame(
                stamp=stamp,
                left_path=left_path,
                right_path=self._nearest_right(stamp),
                pose=self._nearest_pose(stamp),
            )
