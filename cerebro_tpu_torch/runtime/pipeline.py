"""Host-side orchestration of the Method-A live loop (counterpart of
cerebro_tpu/runtime/pipeline.py).

    ingest_frame()            <- per camera frame (the ROS callbacks)
      kidnap monitor          (ref kidnaped_thread, 5 Hz polling -> fold)
      keyframe store          (ref DataManager data_association_thread)
      image store RAM window  (ref clean_up_useless_images_thread)
      descriptor batch queue  (ref descriptor_computer_thread @20 Hz + RPC)
    -- when a batch fills (or flush_descriptors()):
      describe -> DB append -> detect (kernel K1)     on the device
      candidate gates (Δt, shared tracks)             (ref dot-product thread)
    verify_pending()          (ref loopcandiate_consumer_thread @1 Hz)
      tier-1 verification (kernel K3 for depth) -> LoopEdge

Detection results stay on the device until a consumer needs them
(``candidates``, ``verify_pending``, ``status``), so ingest never waits for
the device per batch.

Settings this slice does not run raise ``NotImplementedError`` naming the
ROADMAP item that covers them; none is approximated.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from cerebro_tpu_torch.config import CerebroConfig
from cerebro_tpu_torch.db import descriptors as ddb
from cerebro_tpu_torch.db.images import ImageStore
from cerebro_tpu_torch.db.keyframes import KeyframeStore
from cerebro_tpu_torch.geometry import stereo
from cerebro_tpu_torch.kidnap import KidnapMonitor
from cerebro_tpu_torch.loop import detector
from cerebro_tpu_torch.utils.timing import StageTimer
from cerebro_tpu_torch.verify.geometric import verify_pair_batch

_Q1 = "ROADMAP Queue 1"


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({_Q1}: {item})")


@dataclasses.dataclass(frozen=True)
class LoopEdge:
    """The engine's output (parity: msg/LoopEdge.msg — timestamp0,
    timestamp1, pose_1T0, weight, description)."""

    stamp_curr: float
    stamp_prev: float
    idx_curr: int  # keyframe-store index
    idx_prev: int
    T_prev_curr: np.ndarray  # (4,4) pose of curr in prev's frame
    weight: float  # confidence (max RANSAC goodness)
    n_matches: int
    description: str = ""

    def as_json(self) -> dict:
        """ProcessedLoopCandidate::asJson parity
        (src/ProcessedLoopCandidate.cpp:128-172)."""
        return {
            "timestamp0": self.stamp_prev,
            "timestamp1": self.stamp_curr,
            "idx0": self.idx_prev,
            "idx1": self.idx_curr,
            "pose_1T0": self.T_prev_curr.tolist(),
            "weight": self.weight,
            "n_matches": self.n_matches,
            "description": self.description,
        }


@dataclasses.dataclass
class RawCandidate:
    """Output of detection, input to verification (the foundLoops entries,
    ref src/Cerebro.cpp:1078-1081)."""

    idx_curr: int
    idx_prev: int
    score: float


@dataclasses.dataclass
class RejectedCandidate:
    """A candidate that failed geometric verification, with the failing gate
    (the payload of the reference's reject debug images,
    src/Visualization.cpp:75-225)."""

    idx_curr: int
    idx_prev: int
    score: float
    reason: str
    n_matches: int


class CerebroPipeline:
    def __init__(
        self,
        cfg: Optional[CerebroConfig] = None,
        rig: Optional[stereo.RectifiedRig] = None,
        describe_fn=None,  # optional override: (B,H,W,C) uint8 tensor -> (B,D)
        describe_dim: Optional[int] = None,  # D of describe_fn's output
        mesh=None,
        seed: int = 0,
        device: Optional[str] = None,
    ):
        """``device`` defaults to the CUDA device; without CUDA the caller
        must pass ``device="cpu"`` explicitly (there is no silent fallback)."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CerebroPipeline runs on the CUDA device and none is "
                    "available; pass device='cpu' to run on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg or CerebroConfig()
        self._check_supported(mesh, describe_fn)
        self.rig = rig
        self.store = KeyframeStore()
        self.images = ImageStore(
            stash_dir=self.cfg.runtime.stash_dir,
            cache_ttl=self.cfg.runtime.image_cache_ttl,
        )
        self.kidnap = KidnapMonitor(self.cfg.kidnap)
        dcfg = self.cfg.descriptor
        if describe_fn is not None:
            self.describe_fn = describe_fn
            dim = describe_dim or dcfg.num_clusters * dcfg.trunk_dim
        else:
            # the reference's trained flagship weights (models/mobilenet.py)
            from cerebro_tpu_torch.models.mobilenet import load_ported_params, ported_forward

            kw = {"directory": dcfg.artifact_dir} if dcfg.artifact_dir else {}
            self.params, pmeta = load_ported_params(device=self.device, **kw)
            dim = int(pmeta["descriptor_dim"])
            scale = pmeta.get("input_scale", "raw")
            pdtype = getattr(torch, dcfg.dtype)
            self.describe_fn = lambda imgs: ported_forward(
                self.params, imgs, dtype=pdtype, input_scale=scale
            )
        self.db = ddb.create(self.cfg.loop.db_capacity, dim, device=self.device)
        self.det_state = detector.init_state(self.device)
        # global id -> keyframe-store index (only described keyframes enter
        # the DB; the DB is a ring, so searches return GLOBAL ids and this
        # append-only map stays valid after eviction)
        self.db_gid_to_store: List[int] = []

        self._pending_desc: List[int] = []  # store indices awaiting description
        self.shed_descriptors = 0
        self._candidates: List[RawCandidate] = []  # awaiting verification
        self.rejected_candidates: List[RejectedCandidate] = []
        self._max_rejected = 256
        # detection results still on the device, read lazily by consumers
        self._deferred_det: List[tuple] = []
        self.loop_edges: List[LoopEdge] = []
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed + 1)
        # guards the deferred-detection drain + candidate queue when a
        # verifier thread consumes what the ingest thread detects
        self._det_lock = threading.RLock()
        self.timer = StageTimer()
        self._score_history: List[float] = []
        self._detection_marks: List[int] = []

    def _check_supported(self, mesh, describe_fn):
        cfg = self.cfg
        if describe_fn is None and cfg.descriptor.kind != "ported":
            _not_ported(
                f"descriptor kind {cfg.descriptor.kind!r}",
                "item 2, models/gist.py and models/wpca.py",
            )
        if cfg.descriptor.wpca_artifact:
            _not_ported("the WPCA descriptor stage", "item 2, models/wpca.py")
        if cfg.loop.method != "A" or cfg.loop.candidates_per_query > 1:
            _not_ported(
                f"loop method {cfg.loop.method!r} with candidates_per_query="
                f"{cfg.loop.candidates_per_query}",
                "item 7, loop/topk_methods.py and loop/hypothesis.py",
            )
        if cfg.loop.quantized:
            _not_ported("the int8-quantized DB", "item 7, the int8 DB")
        if mesh is not None:
            _not_ported("a multi-device mesh", "item 7, parallel/")

    def close(self):
        """Release the image store (and its private stash directory)."""
        self.images.close()

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------

    def ingest_frame(
        self,
        stamp: float,
        left_img: np.ndarray,  # (H, W) uint8/float rectified left
        n_tracked: int,
        pose: Optional[np.ndarray] = None,  # (4,4) VINS w_T_c
        right_img: Optional[np.ndarray] = None,
        depth_img: Optional[np.ndarray] = None,
        is_keyframe: bool = True,
        describe_eligible: bool = True,  # False = shed under load
        feat_uv: Optional[np.ndarray] = None,  # (K, 2) tracked-feature pixels
        feat_ids: Optional[np.ndarray] = None,  # (K,) tracker feature ids
        feat_xyz: Optional[np.ndarray] = None,  # (K, 3) world points
    ):
        """One camera frame. Returns kidnap events fired by this frame."""
        if depth_img is not None:
            _not_ported("the depth-camera rig", "item 4, verify_pair_depth")
        events = self.kidnap.feed(stamp, n_tracked)
        idx = self.store.add_frame(
            stamp, pose=pose, is_keyframe=is_keyframe, n_tracked=n_tracked,
            world_id=self.kidnap.world_id,
        )
        if feat_ids is not None:
            self.store.set_point_features(idx, feat_uv, feat_ids, feat_xyz)
        if is_keyframe:
            self.images.put("left", idx, np.asarray(left_img))
            if right_img is not None:
                self.images.put("right", idx, np.asarray(right_img))
            # descriptor eligibility (ref skips kidnapped <20-feat frames,
            # src/Cerebro.cpp:206-210)
            if n_tracked >= self.cfg.descriptor.min_tracked_features:
                if describe_eligible:
                    self._pending_desc.append(idx)
                else:
                    self.shed_descriptors += 1
        self._maintain_ram_window(stamp)
        if len(self._pending_desc) >= self.cfg.runtime.descriptor_batch:
            self.flush_descriptors()
        return events

    def _maintain_ram_window(self, now: float):
        """Stash keyframe images older than the RAM window; drop
        non-keyframes (ref clean_up_useless_images_thread,
        src/DataManager.cpp:704-763)."""
        window = self.cfg.runtime.image_ram_window_s
        for ns, idx in self.images.ram_keys():
            if self.images.state_of(ns, idx) != "ram":
                continue
            if now - self.store.stamps[idx] > window:
                if self.store.is_keyframe[idx]:
                    self.images.stash(ns, idx)
                else:
                    self.images.remove(ns, idx)

    # ------------------------------------------------------------------
    # Descriptor + detection stage (device)
    # ------------------------------------------------------------------

    def flush_descriptors(self):
        """Describe queued keyframes (one batched call per descriptor_batch)
        and run loop detection on the new rows."""
        B = self.cfg.runtime.descriptor_batch
        h, w = self.cfg.descriptor.image_hw
        C = self.cfg.descriptor.num_channels
        while self._pending_desc:
            chunk = self._pending_desc[:B]
            self._pending_desc = self._pending_desc[B:]
            with self.timer.stage("assemble"):
                imgs = np.zeros((B, h, w, C), np.uint8)
                for k, idx in enumerate(chunk):
                    img = _fit_image(self.images.get("left", idx), (h, w))
                    if img.ndim == 2:
                        img = img[..., None]
                    if img.shape[-1] != C:  # gray<->color lift to the configured C
                        img = (
                            np.repeat(img, C, axis=-1)
                            if img.shape[-1] == 1
                            else img.mean(-1, keepdims=True).astype(np.uint8)
                        )
                    imgs[k] = img
                imgs_dev = torch.from_numpy(imgs).to(self.device)
            with self.timer.stage("describe"):
                descs = self.timer.sync_point(self.describe_fn(imgs_dev))
            with self.timer.stage("detect"):
                self._detect(descs, chunk, len(chunk))

    def _detect(self, descs: torch.Tensor, store_idx: List[int], n_valid: int):
        B = descs.shape[0]
        row0 = len(self.db_gid_to_store)
        gidx = torch.arange(row0, row0 + B, dtype=torch.int32, device=self.device)
        qvalid = torch.arange(B, device=self.device) < n_valid
        ddb.append(self.db, descs, n_valid)  # in place: the ring head advances
        cands, self.det_state = detector.detect_batch(
            self.cfg.loop, self.db, self.det_state, descs, gidx, qvalid
        )
        self.db_gid_to_store.extend(store_idx[:n_valid])
        self.store.mark_described(np.asarray(store_idx[:n_valid]))
        self._deferred_det.append((cands, n_valid))
        self.timer.sync_point(cands)

    # ------------------------------------------------------------------
    # Deferred-detection drain (the host reads detection results here)
    # ------------------------------------------------------------------

    def _drain_detections(self):
        with self._det_lock:
            if self._deferred_det:
                with self.timer.stage("drain"):
                    self._drain_detections_locked()

    def _drain_detections_locked(self):
        pending, self._deferred_det = self._deferred_det, []
        min_dt = self.cfg.verify.min_pair_dt_s
        for cands, n_valid in pending:
            valid = cands.valid.cpu().numpy()
            scores = cands.score.cpu().numpy()
            curr_g = cands.curr_idx.cpu().numpy()
            prev_g = cands.prev_idx.cpu().numpy()
            for k in range(n_valid):
                if valid[k]:
                    self._detection_marks.append(len(self._score_history))
                self._score_history.append(float(np.clip(scores[k], -1.0, 1.0)))
            for k in range(n_valid):
                if not valid[k]:
                    continue
                curr = self.db_gid_to_store[int(curr_g[k])]
                prev = self.db_gid_to_store[int(prev_g[k])]
                # Δt gate (ref src/ProcessedLoopCandidate.cpp:49-56)
                if self.store.stamps[curr] - self.store.stamps[prev] < min_dt:
                    continue
                # shared-track gate, within one world only: tracker ids
                # reset across kidnap sessions
                if (
                    self.cfg.loop.reject_shared_tracks
                    and self.store.world_id[curr] == self.store.world_id[prev]
                    and self.store.shared_track_count(curr, prev) > 0
                ):
                    continue
                self._candidates.append(
                    RawCandidate(idx_curr=curr, idx_prev=prev, score=float(scores[k]))
                )

    @property
    def candidates(self) -> List[RawCandidate]:
        """Loop candidates awaiting verification (drains the device queue)."""
        self._drain_detections()
        return self._candidates

    @property
    def score_history(self) -> List[float]:
        self._drain_detections()
        return self._score_history

    @property
    def detection_marks(self) -> List[int]:
        self._drain_detections()
        return self._detection_marks

    # ------------------------------------------------------------------
    # Verification stage
    # ------------------------------------------------------------------

    def verify_pending(
        self, max_pairs: Optional[int] = None, device_batch: int = 4,
        drain: bool = True, cascade: Optional[bool] = None,
    ) -> int:
        """Geometrically verify queued candidates with the tier-1 matcher;
        accepted ones become LoopEdges. Returns the number accepted.

        Candidates go in ``device_batch``-sized groups: each group's stereo
        depth is one K3 launch over all its frames. The tier-2 escalation
        (``cascade``, on by default in VerifyConfig) is not ported: pass
        ``cascade=False`` or configure it off; with it on this raises rather
        than skip the escalation."""
        if self.rig is None:
            raise RuntimeError("verification needs a RectifiedRig (stereo)")
        use_cascade = self.cfg.verify.cascade if cascade is None else cascade
        if use_cascade:
            _not_ported(
                "verify_pending(cascade=True)",
                "item 3, the tier-2 gather matcher and the cascade",
            )
        with self._det_lock:
            if drain and self._deferred_det:
                with self.timer.stage("drain"):
                    self._drain_detections_locked()
            todo = self._candidates if max_pairs is None else self._candidates[:max_pairs]
            self._candidates = [] if max_pairs is None else self._candidates[max_pairs:]

        with self.timer.stage("verify_load"):
            loadable = [(c, p) for c in todo if (p := self._load_pair(c)) is not None]
        return self._verify_chunks(loadable, device_batch)

    def _verify_chunks(self, loadable, device_batch: int) -> int:
        """Run (cand, (la, ra, lb, rb)) pairs through tier-1 verification in
        groups of ``device_batch``."""
        n_accepted = 0
        for i in range(0, len(loadable), device_batch):
            chunk = loadable[i : i + device_batch]
            with self.timer.stage("verify_h2d"):
                la, ra, lb, rb = (
                    torch.from_numpy(np.stack([p[j] for _, p in chunk])).to(self.device)
                    for j in range(4)
                )
            with self.timer.stage("verify"):
                res = verify_pair_batch(
                    self.cfg.verify, self._generator,
                    lb, rb,  # frame a := prev
                    la, ra,  # frame b := curr
                    self.rig,
                )
                self.timer.sync_point(res)
            n_accepted += self._emit_edges([c for c, _ in chunk], res)
        return n_accepted

    def _emit_edges(self, cands: List[RawCandidate], res) -> int:
        """Turn accepted VerifiedLoop entries into LoopEdges. With a := prev,
        b := curr, res.T_b_a[p] = curr_T_prev; the edge stores prev_T_curr.
        Rejections are recorded with the failing gate."""
        with self.timer.stage("verify_fetch"):
            accepted = res.accepted.cpu().numpy()
            T_all = res.T_b_a.cpu().numpy()
            conf = res.confidences.amax(dim=-1).cpu().numpy()
            nm = res.n_matches.cpu().numpy()
            consistent = res.consistent.cpu().numpy()
            opt_ok = res.option_success.cpu().numpy()
        vcfg = self.cfg.verify
        n = 0
        for p, cand in enumerate(cands):
            if not accepted[p]:
                if int(nm[p]) < vcfg.min_matches_attempt:
                    reason = (
                        f"too few matches ({int(nm[p])} < "
                        f"{vcfg.min_matches_attempt} attempt gate)"
                    )
                elif not opt_ok[p].all():
                    failed = [name for name, ok in zip("ABC", opt_ok[p]) if not ok]
                    reason = f"RANSAC failure (option {'/'.join(failed)})"
                elif not consistent[p]:
                    reason = (
                        f"pose consistency ({vcfg.consistency_deg:g} deg / "
                        f"{vcfg.consistency_m:g} m 3-way gate)"
                    )
                else:
                    reason = (
                        f"match count {int(nm[p])} <= "
                        f"{vcfg.min_matches_accept} accept gate"
                    )
                self.rejected_candidates.append(
                    RejectedCandidate(
                        idx_curr=cand.idx_curr, idx_prev=cand.idx_prev,
                        score=cand.score, reason=reason, n_matches=int(nm[p]),
                    )
                )
                del self.rejected_candidates[: -self._max_rejected]
                continue
            self.loop_edges.append(
                LoopEdge(
                    stamp_curr=float(self.store.stamps[cand.idx_curr]),
                    stamp_prev=float(self.store.stamps[cand.idx_prev]),
                    idx_curr=cand.idx_curr,
                    idx_prev=cand.idx_prev,
                    T_prev_curr=np.linalg.inv(T_all[p]),
                    weight=float(conf[p]),
                    n_matches=int(nm[p]),
                )
            )
            n += 1
        return n

    def _load_pair(self, cand: RawCandidate):
        """(la, ra, lb, rb) float32 images when both frames have stereo
        images, else None."""
        imgs = [
            self.images.get(ns, i)
            for ns, i in (
                ("left", cand.idx_curr), ("right", cand.idx_curr),
                ("left", cand.idx_prev), ("right", cand.idx_prev),
            )
        ]
        if any(im is None for im in imgs):
            return None
        return tuple(np.asarray(im, np.float32) for im in imgs)

    def optimize_trajectory(self):
        _not_ported("optimize_trajectory", "item 1, posegraph/optimizer.py")

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def found_loops_json(self) -> list:
        """foundLoops_as_JSON parity (ref src/Cerebro.cpp:1127-1164)."""
        return [
            {
                "global_a": c.idx_curr,
                "global_b": c.idx_prev,
                "score": c.score,
                "stamp_a": float(self.store.stamps[c.idx_curr]),
                "stamp_b": float(self.store.stamps[c.idx_prev]),
            }
            for c in self.candidates
        ]

    def status(self) -> dict:
        return {
            "frames": self.store.size,
            "keyframes": int(self.store.is_keyframe[: self.store.size].sum()),
            "described": len(self.db_gid_to_store),
            "shed_descriptors": self.shed_descriptors,
            "pending_descriptors": len(self._pending_desc),
            "pending_candidates": len(self.candidates),
            "loop_edges": len(self.loop_edges),
            "rejected_candidates": len(self.rejected_candidates),
            "kidnap": self.kidnap.info(),
            "timings_ms": self.timer.stats(),
        }


def _fit_image(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Resize (nearest/strided) to the descriptor input size; images are
    expected uint8 grayscale."""
    h, w = hw
    if img.shape[:2] == (h, w):
        out = img
    else:
        ys = (np.linspace(0, img.shape[0] - 1, h)).astype(np.int32)
        xs = (np.linspace(0, img.shape[1] - 1, w)).astype(np.int32)
        out = img[ys][:, xs]
    if out.dtype != np.uint8:
        out = np.clip(out * 255.0 if out.max() <= 1.5 else out, 0, 255).astype(np.uint8)
    return out
