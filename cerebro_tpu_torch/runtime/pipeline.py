"""Host-side orchestration of the live loop (counterpart of
cerebro_tpu/runtime/pipeline.py).

    ingest_frame()            <- per camera frame (the ROS callbacks)
      kidnap monitor          (ref kidnaped_thread, 5 Hz polling -> fold)
      keyframe store          (ref DataManager data_association_thread)
      image store RAM window  (ref clean_up_useless_images_thread)
      descriptor batch queue  (ref descriptor_computer_thread @20 Hz + RPC)
    -- when a batch fills (or flush_descriptors()):
      describe -> DB append -> detect                 on the device
        Method A top-1: kernel K1; Method A top-k and Methods B, C, D:
        k passes of kernel K2 (ops/similarity.search_topk)
      candidate gates (Δt, shared tracks)             (ref dot-product thread)
    verify_pending()          (ref loopcandiate_consumer_thread @1 Hz)
      tier-1 verification (kernel K3 for depth) -> LoopEdge
    optimize_trajectory()     (ref external solve_keyframe_pose_graph)
      4-DOF switch-constrained pose graph over the keyframes

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
from cerebro_tpu_torch.loop import detector, hypothesis, topk_methods
from cerebro_tpu_torch.ops import similarity
from cerebro_tpu_torch.posegraph import (
    PoseGraph,
    initialize_worlds,
    optimize,
    poses_from_xyzyaw,
    relative_yaw_t_np,
)
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
        body_T_cam: Optional[np.ndarray] = None,  # camera mount on the body/IMU
        device: Optional[str] = None,
    ):
        """``device`` defaults to the CUDA device; without CUDA the caller
        must pass ``device="cpu"`` explicitly (there is no silent fallback).

        ``body_T_cam``: poses arrive as w_T_cam, but the 4-DOF pose graph
        reasons in a gravity-aligned body frame (the reference's external
        solver likewise consumes imu_T_cam, README.md:176-194). None means
        the camera is the body frame."""
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
        self.body_T_cam = None if body_T_cam is None else np.asarray(body_T_cam, np.float32)
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
        lcfg = self.cfg.loop
        self.det_state = detector.init_state(self.device)
        # Method-B carry (Method A's 2-entry state on the rank-0 hit)
        self.det_state_b = detector.init_state(self.device)
        # Method-C carry: hits of the last W-1 queries
        self.clique_state = topk_methods.init_clique_state(lcfg.top_k, device=self.device)
        # Method-A top-k carry (candidates_per_query > 1)
        self.topk_state = detector.init_topk_state(
            max(lcfg.candidates_per_query, 1), device=self.device
        )
        # Method-D table; its digest counter and emitted latch live on the
        # device, so Method D's detect path reads nothing back
        self.hyp_table = hypothesis.create_table(64, device=self.device)
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
        # optional per-query detection log for offline precision/recall
        # sweeps: (curr_gid, prev_gid, score, agree) per query
        self.log_queries = False
        self.query_log: List[tuple] = []

    def _check_supported(self, mesh, describe_fn):
        cfg = self.cfg
        if describe_fn is None and cfg.descriptor.kind != "ported":
            _not_ported(
                f"descriptor kind {cfg.descriptor.kind!r}",
                "item 2, models/gist.py and models/wpca.py",
            )
        if cfg.descriptor.wpca_artifact:
            _not_ported("the WPCA descriptor stage", "item 2, models/wpca.py")
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
        deferred = self._run_method(descs, gidx, qvalid, n_valid)
        self.db_gid_to_store.extend(store_idx[:n_valid])
        self.store.mark_described(np.asarray(store_idx[:n_valid]))
        self._deferred_det.append(deferred)
        self.timer.sync_point(deferred[1])

    def _run_method(self, descs, gidx, qvalid, n_valid):
        """Candidate generation per configured method (ref Cerebro::run
        dispatch, src/Cerebro.cpp:350-357). Returns a record of device
        tensors, read on the host by ``_drain_detections``."""
        cfg = self.cfg.loop
        method = cfg.method
        if method == "A" and cfg.candidates_per_query <= 1:
            cands, self.det_state = detector.detect_batch(
                cfg, self.db, self.det_state, descs, gidx, qvalid
            )
            return ("A", cands, n_valid)
        if method not in ("A", "B", "C", "D"):
            raise ValueError(f"unknown loop method {method!r}")

        # top-k retrieval: on CUDA tensors k launches of K2
        k = cfg.candidates_per_query if method == "A" else cfg.top_k
        limits = ddb.query_limits(self.db, gidx, cfg.exclusion_window)
        vals, idx = similarity.search_topk(descs, self.db.vectors, limits, self.db.global_ids, k=k)
        searchable = (limits > 0) & qvalid

        if method == "A":
            # top-k Method A: k distinct locality-consistent hits per query
            # go to the verifier (geometry decides, not the argmax)
            cands, self.topk_state = detector.temporal_consistency_topk(
                cfg, self.topk_state, vals, idx, gidx, searchable, qvalid
            )
            return ("A+", cands, n_valid, k)
        if method == "B":
            # Method A's 3-consecutive rule and carry on the rank-0 hit
            # (ref src/Cerebro.cpp:366-492)
            cands, self.det_state_b = topk_methods.naive_topk_candidates(
                cfg, self.det_state_b, vals, idx, gidx, qvalid, limits > 0
            )
            return ("B", cands, n_valid)
        if method == "C":
            curr, prev, score, ok, self.clique_state = topk_methods.clique_topk_candidates(
                cfg, self.clique_state, vals, idx, gidx, qvalid
            )
            return ("C", (curr, prev, score, ok))
        # Method D: ALL top-k hits feed the manager, as the reference pushes
        # every faiss 5-NN hit into HypothesisManager (src/Cerebro.cpp:
        # 731-885). Exactly one flattened slot per query advances the digest
        # clock, so batched and streamed feeds emit the same candidates.
        B, K = vals.shape
        a_flat = gidx.repeat_interleave(K)
        qv_rep = qvalid.repeat_interleave(K)
        last_of_query = (torch.arange(B * K, device=self.device) % K) == (K - 1)
        self.hyp_table, emits, a_t, b_t, mean_s = hypothesis.update(
            cfg, self.hyp_table, a_flat, idx.reshape(-1), vals.reshape(-1), qv_rep,
            query_valid=last_of_query & qv_rep,
            promote_support=cfg.hypothesis_promote,
        )
        return ("D", (a_t, b_t, mean_s, emits))

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
        for rec in pending:
            tag = rec[0]
            if tag in ("A", "B", "A+"):
                cands, n_valid = rec[1], rec[2]
                valid, scores, curr_g, prev_g, agree = (
                    getattr(cands, f).cpu().numpy()
                    for f in ("valid", "score", "curr_idx", "prev_idx", "agree")
                )
                K = rec[3] if tag == "A+" else 1
                if tag != "B":
                    # per query: the rank-0 hit is the argmax Method A logs
                    for q in range(n_valid):
                        if valid[q * K : (q + 1) * K].any():
                            self._detection_marks.append(len(self._score_history))
                        self._score_history.append(float(np.clip(scores[q * K], -1.0, 1.0)))
                    if self.log_queries:
                        self.query_log.extend(
                            (int(curr_g[j]), int(prev_g[j]), float(scores[j]), bool(agree[j]))
                            for j in range(n_valid * K)
                            # top-k: skip masked hit slots
                            if K == 1 or scores[j] > -1.0
                        )
                pairs = [
                    (int(curr_g[j]), int(prev_g[j]), float(scores[j]))
                    for j in range(n_valid * K)
                    if valid[j]
                ]
            elif tag == "C":
                curr, prev, score, ok = (x.cpu().numpy() for x in rec[1])
                pairs = [
                    (int(curr[k]), int(prev[k]), float(score[k]))
                    for k in range(len(ok))
                    if ok[k]
                ]
            else:  # "D": (B*K, H) emit events per flattened hit
                a_t, b_t, mean_s, emits = (x.cpu().numpy() for x in rec[1])
                pairs = [
                    (int(a_t[q, h]), int(b_t[q, h]), float(mean_s[q, h]))
                    for q, h in zip(*np.nonzero(emits))
                ]
            for curr_g_, prev_g_, score in pairs:
                curr = self.db_gid_to_store[curr_g_]
                prev = self.db_gid_to_store[prev_g_]
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
                self._candidates.append(RawCandidate(idx_curr=curr, idx_prev=prev, score=score))

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

    # ------------------------------------------------------------------
    # Trajectory optimization (pose graph over keyframes)
    # ------------------------------------------------------------------

    def optimize_trajectory(self) -> Optional[np.ndarray]:
        """Build and solve the pose graph over the keyframes with valid
        poses. Returns corrected (N, 4, 4) w_T_cam poses aligned into world
        0, or None when the graph is trivial (the reference's external
        solve_keyframe_pose_graph, in the engine)."""
        kf = np.nonzero(self.store.pose_valid[: self.store.size])[0]
        if len(kf) < 2:
            return None
        idx_of = {int(s): i for i, s in enumerate(kf)}
        T = self.store.poses[kf]  # w_T_cam
        if self.body_T_cam is not None:
            # the graph's states live in the gravity-aligned body frame:
            # w_T_body = w_T_cam @ cam_T_body
            T = T @ np.linalg.inv(self.body_T_cam)[None]
        world = self.store.world_id[kf]

        # assembly is host numpy, as in the JAX package
        x0 = np.zeros((len(kf), 4), np.float32)
        x0[:, :3] = T[:, :3, 3]
        x0[:, 3] = np.arctan2(T[:, 1, 0], T[:, 0, 0])  # rot_to_ypr yaw
        # odometry edges between consecutive keyframes of the same world
        oi = np.arange(len(kf) - 1, dtype=np.int32)
        om = relative_yaw_t_np(T[:-1], T[1:])
        ov = world[:-1] == world[1:]
        # loop edges from the verified LoopEdges
        li, lj, lm = [], [], []
        for e in self.loop_edges:
            if e.idx_prev not in idx_of or e.idx_curr not in idx_of:
                continue
            li.append(idx_of[e.idx_prev])
            lj.append(idx_of[e.idx_curr])
            T_rel = e.T_prev_curr.astype(np.float32)  # cam_prev_T_cam_curr
            if self.body_T_cam is not None:
                # conjugate the camera-frame loop edge into the body frame
                T_rel = self.body_T_cam @ T_rel @ np.linalg.inv(self.body_T_cam)
            lm.append(relative_yaw_t_np(np.eye(4, dtype=np.float32), T_rel))
        lv = [True] * len(li)
        if not li:
            li, lj, lm, lv = [0], [0], [np.zeros(4, np.float32)], [False]
        x_init = initialize_worlds(
            x0, world, np.asarray(li), np.asarray(lj), np.asarray(lm), np.asarray(lv)
        )

        # Power-of-two buckets with masked padding, as the JAX package pads
        # (it must, to reuse compiled shapes): padded edges are invalid,
        # padded nodes are free states held by the damping and sliced off,
        # so the port solves the same padded problem.
        def bucket(n, lo):
            b = lo
            while b < n:
                b *= 2
            return b

        pcfg = self.cfg.posegraph
        N = len(kf)
        Bn = bucket(N, pcfg.node_bucket_floor)
        Bl = bucket(len(li), pcfg.loop_bucket_floor)

        def padded(arr, B, dtype):
            a = np.asarray(arr, dtype)
            out = np.zeros((B,) + a.shape[1:], dtype)
            out[: len(a)] = a
            return torch.from_numpy(out).to(self.device)

        graph = PoseGraph(
            xyzyaw=padded(x_init, Bn, np.float32),
            node_valid=padded(np.ones(N, bool), Bn, bool),
            odo_i=padded(oi, Bn, np.int64),
            odo_j=padded(oi + 1, Bn, np.int64),
            odo_meas=padded(om, Bn, np.float32),
            odo_valid=padded(ov, Bn, bool),
            loop_i=padded(li, Bl, np.int64),
            loop_j=padded(lj, Bl, np.int64),
            loop_meas=padded(lm, Bl, np.float32),
            loop_valid=padded(lv, Bl, bool),
        )
        with self.timer.stage("optimize"):
            x_opt, _, _ = optimize(graph, pcfg)
            out = poses_from_xyzyaw(x_opt)[:N].cpu().numpy()  # w_T_body
        if self.body_T_cam is not None:
            out = out @ self.body_T_cam[None]  # back to w_T_cam
        return out

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
