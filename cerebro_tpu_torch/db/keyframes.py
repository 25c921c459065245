"""Host-side keyframe store — the run's in-memory database.

Functional/columnar replacement for the reference's DataManager +
DataNode (src/DataManager.{h,cpp}, src/DataNode.{h,cpp}): instead of a
mutex-guarded ``map<ros::Time, DataNode*>`` mutated by 8 threads, a single-
writer columnar store (numpy arrays, amortized growth) written only by the
ingest loop. Device code consumes contiguous column slices directly
(``torch.from_numpy``), so there is no per-node pointer chasing on the hot
path.

Semantics preserved from the reference:
  * per-timestamp record: pose ``w_T_c`` (+ optional covariance), keyframe
    flag, tracked-feature count, descriptor-computed flag, world id
    (DataNode fields, src/DataNode.h:49-190);
  * nearest-timestamp association with tolerance (DataManager's ±1 ms
    range-search, src/DataManager.cpp:924-928) via ``index_of_stamp``;
  * JSON state export (DataManager::saveStateToDisk, :1098-1205) via
    ``to_state_dict``/``from_state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

_GROW = 4096


@dataclasses.dataclass
class KeyframeStore:
    """Columnar store; rows are frames in arrival order (global index).

    Per-keyframe tracked-feature slots mirror DataNode's point storage —
    the reference keeps each keyframe's VINS point cloud + uv tracks +
    feature ids and serializes them (src/DataNode.h:49-190, save path
    src/DataManager.cpp:1127-1180). Fixed ``feature_slots`` per row keep
    the columns rectangular (device-friendly); unused slots hold id -1."""

    capacity: int = _GROW
    size: int = 0
    feature_slots: int = 128  # fixed uv/id/xyz slots per keyframe
    # columns
    stamps: np.ndarray = None  # (N,) float64 seconds
    poses: np.ndarray = None  # (N, 4, 4) float32 w_T_c
    pose_valid: np.ndarray = None  # (N,) bool
    is_keyframe: np.ndarray = None  # (N,) bool
    n_tracked: np.ndarray = None  # (N,) int32 tracked-feature count
    has_descriptor: np.ndarray = None  # (N,) bool
    world_id: np.ndarray = None  # (N,) int32 — multi-world (kidnap) segment
    feat_uv: np.ndarray = None  # (N, F, 2) float32 pixel tracks
    feat_ids: np.ndarray = None  # (N, F) int32 VINS feature ids (-1 empty)
    feat_xyz: np.ndarray = None  # (N, F, 3) float32 world points (0 if n/a)
    n_feat: np.ndarray = None  # (N,) int32 filled slots

    def __post_init__(self):
        if self.stamps is None:
            c, f = self.capacity, self.feature_slots
            self.stamps = np.zeros(c, np.float64)
            self.poses = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
            self.pose_valid = np.zeros(c, bool)
            self.is_keyframe = np.zeros(c, bool)
            self.n_tracked = np.zeros(c, np.int32)
            self.has_descriptor = np.zeros(c, bool)
            self.world_id = np.zeros(c, np.int32)
            self.feat_uv = np.zeros((c, f, 2), np.float32)
            self.feat_ids = np.full((c, f), -1, np.int32)
            self.feat_xyz = np.zeros((c, f, 3), np.float32)
            self.n_feat = np.zeros(c, np.int32)

    # -- growth --------------------------------------------------------

    def _ensure(self, n: int):
        if self.size + n <= self.capacity:
            return
        new_cap = max(self.capacity * 2, self.size + n)
        for name in (
            "stamps",
            "poses",
            "pose_valid",
            "is_keyframe",
            "n_tracked",
            "has_descriptor",
            "world_id",
            "feat_uv",
            "feat_ids",
            "feat_xyz",
            "n_feat",
        ):
            old = getattr(self, name)
            grown = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            grown[: self.size] = old[: self.size]
            setattr(self, name, grown)
        self.poses[self.size :] = np.eye(4, dtype=np.float32)
        self.feat_ids[self.size :] = -1
        self.capacity = new_cap

    # -- writes (single-writer ingest loop) ----------------------------

    def add_frame(
        self,
        stamp: float,
        pose: Optional[np.ndarray] = None,
        is_keyframe: bool = False,
        n_tracked: int = 0,
        world_id: int = 0,
    ) -> int:
        """Append a frame record; returns its global index."""
        self._ensure(1)
        i = self.size
        self.stamps[i] = stamp
        if pose is not None:
            self.poses[i] = pose
            self.pose_valid[i] = True
        self.is_keyframe[i] = is_keyframe
        self.n_tracked[i] = n_tracked
        self.world_id[i] = world_id
        self.size += 1
        return i

    def set_pose(self, i: int, pose: np.ndarray):
        self.poses[i] = pose
        self.pose_valid[i] = True

    def set_point_features(
        self,
        i: int,
        uv: np.ndarray,  # (K, 2) pixel coordinates
        ids: np.ndarray,  # (K,) tracker feature ids
        xyz: Optional[np.ndarray] = None,  # (K, 3) world points
    ):
        """Attach the frame's tracked-feature snapshot (DataNode's
        uv/unvn/point-cloud setters, src/DataNode.h:49-190). Truncates to
        ``feature_slots``."""
        k = min(len(ids), self.feature_slots)
        self.feat_uv[i, :k] = np.asarray(uv, np.float32)[:k]
        self.feat_ids[i, :k] = np.asarray(ids, np.int32)[:k]
        self.feat_ids[i, k:] = -1
        if xyz is not None:
            self.feat_xyz[i, :k] = np.asarray(xyz, np.float32)[:k]
        self.n_feat[i] = k

    def shared_track_count(self, i: int, j: int) -> int:
        """Number of tracker feature ids frames i and j have in common.
        Nonzero means the VINS tracker held features CONTINUOUSLY between
        the frames — they are odometrically connected, so a similarity
        hit between them is re-observation by tracking, not a loop
        closure (the temporal analog of the reference's Δt>10 s gate,
        src/ProcessedLoopCandidate.cpp:49-56, robust to stamp games)."""
        a = self.feat_ids[i, : self.n_feat[i]]
        b = self.feat_ids[j, : self.n_feat[j]]
        if len(a) == 0 or len(b) == 0:
            return 0
        return int(np.isin(a, b).sum())

    def mark_described(self, idx: np.ndarray):
        self.has_descriptor[idx] = True

    # -- reads ----------------------------------------------------------

    def index_of_stamp(self, stamp: float, tol: float = 1e-3) -> Optional[int]:
        """Nearest-timestamp association within ``tol`` seconds (the
        reference's ±1 ms range-search, src/DataManager.cpp:924-928)."""
        if self.size == 0:
            return None
        s = self.stamps[: self.size]
        i = int(np.searchsorted(s, stamp))
        best, best_d = None, tol
        for j in (i - 1, i):
            if 0 <= j < self.size:
                d = abs(s[j] - stamp)
                if d <= best_d:
                    best, best_d = j, d
        return best

    def keyframe_indices(self) -> np.ndarray:
        return np.nonzero(self.is_keyframe[: self.size])[0]

    def pending_description(self, min_tracked: int) -> np.ndarray:
        """Keyframes not yet described with enough tracked features —
        the descriptor thread's scan predicate (ref src/Cerebro.cpp:189-210:
        skip described / non-keyframe / kidnapped <20-feature frames)."""
        m = (
            self.is_keyframe[: self.size]
            & ~self.has_descriptor[: self.size]
            & (self.n_tracked[: self.size] >= min_tracked)
        )
        return np.nonzero(m)[0]

    # -- checkpoint ------------------------------------------------------

    def to_state_dict(self) -> Dict[str, np.ndarray]:
        n = self.size
        return {
            "stamps": self.stamps[:n].copy(),
            "poses": self.poses[:n].copy(),
            "pose_valid": self.pose_valid[:n].copy(),
            "is_keyframe": self.is_keyframe[:n].copy(),
            "n_tracked": self.n_tracked[:n].copy(),
            "has_descriptor": self.has_descriptor[:n].copy(),
            "world_id": self.world_id[:n].copy(),
            "feat_uv": self.feat_uv[:n].copy(),
            "feat_ids": self.feat_ids[:n].copy(),
            "feat_xyz": self.feat_xyz[:n].copy(),
            "n_feat": self.n_feat[:n].copy(),
        }

    @classmethod
    def from_state_dict(cls, d: Dict[str, np.ndarray]) -> "KeyframeStore":
        n = len(d["stamps"])
        slots = d["feat_ids"].shape[1] if "feat_ids" in d else 128
        store = cls(capacity=max(n, _GROW), feature_slots=slots)
        for name, col in d.items():
            # pre-feature checkpoints (r3 and earlier) simply lack the
            # feature columns — loading them stays valid
            getattr(store, name)[:n] = col
        store.size = n
        return store
