"""ctypes bindings for the native ingest engine (counterpart of
cerebro_tpu/native).

``src/ingest.cpp`` is the port's own copy of the timestamp-association
engine. It is compiled with ``g++ -O2 -std=c++17 -shared -fPIC`` on first
use into ``cerebro_tpu_torch/_build/``, under a file name that carries a
hash of the source (an edited source is rebuilt), and bound with ctypes
(plain C ABI, no pybind11). Nothing is built or loaded at import time.

One difference from the JAX package, by design: there is no silent
fallback. ``make_ingest`` builds and returns the native engine or raises
with the compiler's output; it never hands back the pure-Python model.
``PyIngest`` stays as the reference model the tests hold the native engine
against, and no entry point takes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

FLAG_LEFT = 1
FLAG_RIGHT = 2
FLAG_POSE = 4
FLAG_TRACKING = 8
FLAG_KEYFRAME = 16

_LOCK = threading.Lock()
_lib_handle = None


def library_path() -> Path:
    """Where the built engine lives: ``_build/`` under a hash of the source."""
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcerebro_ingest-{digest}.so"


def build() -> Path:
    """Compile the engine unless it is already built; returns the library.
    Raises ``RuntimeError`` with the compiler's output when the build fails
    (a missing compiler included)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build the native ingest engine: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native ingest engine failed ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load():
    global _lib_handle
    with _LOCK:
        if _lib_handle is not None:
            return _lib_handle
        lib = ctypes.CDLL(str(build()))
        lib.ingest_create.restype = ctypes.c_void_p
        lib.ingest_create.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ]
        lib.ingest_destroy.argtypes = [ctypes.c_void_p]
        lib.ingest_push_image.restype = ctypes.c_int
        lib.ingest_push_image.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.ingest_push_pose.restype = ctypes.c_int
        lib.ingest_push_pose.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.ingest_push_tracking.restype = ctypes.c_int
        lib.ingest_push_tracking.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.ingest_drain.restype = ctypes.c_int
        lib.ingest_drain.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        for name in (
            "ingest_gap_count",
            "ingest_pending",
            "ingest_dropped",
            "ingest_emit_horizon",
            "ingest_oldest_pending",
        ):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        _lib_handle = lib
        return lib


class NativeIngest:
    """Timestamp-association engine (C++). See src/ingest.cpp."""

    def __init__(
        self,
        tol_s: float = 1e-3,  # ref ±1 ms (src/DataManager.cpp:924-928)
        hold_s: float = 0.2,
        gap_s: float = 1.0,  # ref >1 s image gap (src/DataManager.cpp:263-291)
        capacity: int = 4096,
    ):
        self._lib = _load()
        self._ctx = self._lib.ingest_create(tol_s, hold_s, gap_s, capacity)

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.ingest_destroy(self._ctx)
            self._ctx = None

    def push_image(self, stamp_ns: int, is_right: bool = False) -> bool:
        return self._lib.ingest_push_image(self._ctx, stamp_ns, int(is_right)) == 0

    def push_pose(self, stamp_ns: int, T: np.ndarray) -> bool:
        T = np.ascontiguousarray(T, np.float64).reshape(16)
        return (
            self._lib.ingest_push_pose(
                self._ctx, stamp_ns, T.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            )
            == 0
        )

    def push_tracking(self, stamp_ns: int, n_tracked: int, is_keyframe: bool) -> bool:
        return (
            self._lib.ingest_push_tracking(self._ctx, stamp_ns, n_tracked, int(is_keyframe))
            == 0
        )

    def drain(self, max_out: int = 256) -> List[dict]:
        stamps = np.zeros(max_out, np.int64)
        poses = np.zeros((max_out, 16), np.float64)
        ns = np.zeros(max_out, np.int32)
        flags = np.zeros(max_out, np.int32)
        n = self._lib.ingest_drain(
            self._ctx,
            stamps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            poses.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_out,
        )
        out = []
        for i in range(n):
            f = int(flags[i])
            out.append(
                {
                    "stamp": stamps[i] * 1e-9,
                    "stamp_ns": int(stamps[i]),
                    "pose": poses[i].reshape(4, 4) if f & FLAG_POSE else None,
                    "n_tracked": int(ns[i]),
                    "has_left": bool(f & FLAG_LEFT),
                    "has_right": bool(f & FLAG_RIGHT),
                    "is_keyframe": bool(f & FLAG_KEYFRAME),
                    "has_tracking": bool(f & FLAG_TRACKING),
                }
            )
        return out

    @property
    def gap_count(self) -> int:
        return int(self._lib.ingest_gap_count(self._ctx))

    @property
    def pending(self) -> int:
        return int(self._lib.ingest_pending(self._ctx))

    @property
    def dropped(self) -> int:
        return int(self._lib.ingest_dropped(self._ctx))

    @property
    def emit_horizon(self) -> int:
        """Frames with stamp <= this are emitted (or will be on the next
        drain); older side-channel payloads are reclaimable."""
        return int(self._lib.ingest_emit_horizon(self._ctx))

    @property
    def oldest_pending(self) -> int:
        """Stamp of the oldest pending frame; int64 max when empty."""
        return int(self._lib.ingest_oldest_pending(self._ctx))


class PyIngest:
    """Pure-Python model with the native engine's semantics: the reference
    the tests hold ``NativeIngest`` against. No entry point uses it."""

    def __init__(
        self, tol_s: float = 1e-3, hold_s: float = 0.2, gap_s: float = 1.0,
        capacity: int = 4096,
    ):
        self.tol = int(tol_s * 1e9)
        self.hold = int(hold_s * 1e9)
        self.gap = int(gap_s * 1e9)
        self.capacity = capacity
        self.frames: dict = {}
        self.poses: List[Tuple[int, np.ndarray]] = []
        self.tracking: List[Tuple[int, int, bool]] = []
        self.newest = 0
        self.gap_count = 0
        self.dropped = 0

    def _nearest_frame(self, stamp: int):
        best, best_d = None, self.tol + 1
        for s in self.frames:
            d = abs(s - stamp)
            if d <= self.tol and d < best_d:
                best, best_d = s, d
        return best

    def push_image(self, stamp_ns: int, is_right: bool = False) -> bool:
        if len(self.frames) >= self.capacity:
            self.dropped += 1
            return False
        if self.newest and stamp_ns - self.newest > self.gap:
            self.gap_count += 1
        self.newest = max(self.newest, stamp_ns)
        key = self._nearest_frame(stamp_ns)
        if key is None:
            key = stamp_ns
            self.frames[key] = {
                "stamp_ns": stamp_ns, "left": False, "right": False,
                "pose": None, "tracking": None,
            }
        self.frames[key]["right" if is_right else "left"] = True
        self._assoc(self.frames[key])
        return True

    def _assoc(self, r):
        if r["pose"] is None:
            for k, (s, T) in enumerate(self.poses):
                if abs(s - r["stamp_ns"]) <= self.tol:
                    r["pose"] = T
                    del self.poses[k]
                    break
        if r["tracking"] is None:
            for k, (s, n, kf) in enumerate(self.tracking):
                if abs(s - r["stamp_ns"]) <= self.tol:
                    r["tracking"] = (n, kf)
                    del self.tracking[k]
                    break

    def push_pose(self, stamp_ns: int, T: np.ndarray) -> bool:
        key = self._nearest_frame(stamp_ns)
        if key is not None and self.frames[key]["pose"] is None:
            self.frames[key]["pose"] = np.asarray(T, np.float64).reshape(4, 4)
            return True
        self.poses.append((stamp_ns, np.asarray(T, np.float64).reshape(4, 4)))
        return True

    def push_tracking(self, stamp_ns: int, n_tracked: int, is_keyframe: bool) -> bool:
        key = self._nearest_frame(stamp_ns)
        if key is not None and self.frames[key]["tracking"] is None:
            self.frames[key]["tracking"] = (n_tracked, is_keyframe)
            return True
        self.tracking.append((stamp_ns, n_tracked, is_keyframe))
        return True

    def drain(self, max_out: int = 256) -> List[dict]:
        horizon = self.newest - self.hold
        out = []
        for key in sorted(self.frames):
            if len(out) >= max_out or key > horizon:
                break
            r = self.frames.pop(key)
            self._assoc(r)
            trk = r["tracking"]
            out.append(
                {
                    "stamp": r["stamp_ns"] * 1e-9,
                    "stamp_ns": r["stamp_ns"],
                    "pose": r["pose"],
                    "n_tracked": trk[0] if trk else 0,
                    "has_left": r["left"],
                    "has_right": r["right"],
                    "is_keyframe": bool(trk[1]) if trk else False,
                    "has_tracking": trk is not None,
                }
            )
        self.poses = [(s, T) for s, T in self.poses if s >= horizon - self.tol]
        self.tracking = [t for t in self.tracking if t[0] >= horizon - self.tol]
        return out

    @property
    def pending(self) -> int:
        return len(self.frames)

    @property
    def emit_horizon(self) -> int:
        return self.newest - self.hold

    @property
    def oldest_pending(self) -> int:
        return min(self.frames) if self.frames else np.iinfo(np.int64).max


def make_ingest(**kw) -> NativeIngest:
    """The native engine, built on first use; raises when it cannot be
    built (no fallback to ``PyIngest``)."""
    return NativeIngest(**kw)
