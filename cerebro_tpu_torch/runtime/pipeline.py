"""Host-side orchestration of the live loop (counterpart of
cerebro_tpu/runtime/pipeline.py).

    ingest_frame()            <- per camera frame (the ROS callbacks)
      kidnap monitor          (ref kidnaped_thread, 5 Hz polling -> fold)
      keyframe store          (ref DataManager data_association_thread)
      image store RAM window  (ref clean_up_useless_images_thread)
      descriptor batch queue  (ref descriptor_computer_thread @20 Hz + RPC)
    -- when a batch fills (or flush_descriptors()):
      describe -> DB append -> detect                 on the device
        Method A top-1: kernel K1 (an int8 DB: one torch._int_mm);
        Method A top-k and Methods B, C, D: one launch of kernel K2
        (ops/similarity.search_topk)
      candidate gates (Δt, shared tracks)             (ref dot-product thread)
    verify_pending()          (ref loopcandiate_consumer_thread @1 Hz)
      tier-1 verification (kernel K3 for depth) -> LoopEdge; pairs that
      fail for lack of matches escalate to the tier-2 gather matcher;
      a depth camera's pairs verify from their depth images (no K3); on
      the card each pair's body replays as a CUDA graph (VerifyGraphs)
    optimize_trajectory()     (ref external solve_keyframe_pose_graph)
      4-DOF switch-constrained pose graph over the keyframes

Detection results stay on the device until a consumer needs them
(``candidates``, ``verify_pending``, ``status``), so ingest never waits for
the device per batch. ``StreamIngestor`` feeds ``ingest_frame`` from
producer threads through the native association engine
(``cerebro_tpu_torch/native``); ``runtime/service.py`` runs the whole node.

The descriptor is the in-framework NetVLAD / GhostVLAD net (the default
kind, ``models/descriptor.py``), the reference's ported MobileNet or gist;
the DB is bf16 or, with ``loop.quantized``, int8 (searched by an int8
product). With ``mesh=`` (``parallel.make_mesh``), the DB's ring is
sharded over the mesh's ``db`` axis, one block per rank, and every search
runs on the rank's block and merges over the ranks
(``parallel/sharded_search.py``); each rank runs the rest of the pipeline
on the same data, so every rank ends with the same candidates and edges.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import itertools
import json
import os
import threading
import time
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
from cerebro_tpu_torch.models.descriptor import (
    convert_params,
    create_descriptor_model,
    describe_batch,
)
from cerebro_tpu_torch.models.gist import gist_descriptors
from cerebro_tpu_torch.models.wpca import load_wpca, whitened_describe_fn
from cerebro_tpu_torch.ops import similarity
from cerebro_tpu_torch.parallel import sharded_search
from cerebro_tpu_torch.posegraph import (
    PoseGraph,
    initialize_worlds,
    optimize,
    poses_from_xyzyaw,
    relative_yaw_t_np,
)
from cerebro_tpu_torch.utils import timing
from cerebro_tpu_torch.utils.timing import StageTimer
from cerebro_tpu_torch.verify.geometric import (
    GRAPH_COUNTERS, VerifiedLoop, VerifyGraphs, verify_pair_batch, verify_pair_depth,
)

def _descriptor_state(params, dcfg, device) -> dict:
    """A DescriptorNet state on ``device`` from a PyTorch state (tensors
    under the net's names) or from flax params as numpy arrays."""
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        return {k: v.to(device) for k, v in params.items()}
    return convert_params(params, dcfg, device)


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
    # the candidate's id in the pipeline's trace: assigned at raise, in order
    cid: int = dataclasses.field(default=-1, compare=False)


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
        params=None,  # netvlad kind: a DescriptorNet state, or flax-shaped numpy params
        describe_fn=None,  # optional override: (B,H,W,C) uint8 tensor -> (B,D)
        describe_dim: Optional[int] = None,  # D of describe_fn's output
        mesh=None,  # parallel.Mesh: shard the DB and its searches over the ranks
        seed: int = 0,
        body_T_cam: Optional[np.ndarray] = None,  # camera mount on the body/IMU
        device: Optional[str] = None,
    ):
        """``device`` defaults to the CUDA device; without CUDA the caller
        must pass ``device="cpu"`` explicitly (there is no silent fallback).

        ``body_T_cam``: poses arrive as w_T_cam, but the 4-DOF pose graph
        reasons in a gravity-aligned body frame (the reference's external
        solver likewise consumes imu_T_cam, README.md:176-194). None means
        the camera is the body frame.

        ``params`` (kind "netvlad"): the net's weights, either a PyTorch
        state of ``models.descriptor.DescriptorNet`` or the JAX package's
        flax params as numpy arrays; None draws the JAX package's seeded
        initialization (``seed``)."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CerebroPipeline runs on the CUDA device and none is "
                    "available; pass device='cpu' to run on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg or CerebroConfig()
        self.mesh = mesh
        self._check_supported(mesh)
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
        elif dcfg.kind == "gist":
            dim = dcfg.num_clusters * dcfg.trunk_dim
            self.describe_fn = lambda imgs, _d=dim: gist_descriptors(imgs, dim=_d)
        elif dcfg.kind == "ported":
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
        elif dcfg.kind == "netvlad":
            # the in-framework NetVLAD / GhostVLAD net (models/descriptor.py)
            self.net, self.params = create_descriptor_model(dcfg, seed=seed, device=self.device)
            if params is not None:
                self.params = _descriptor_state(params, dcfg, self.device)
            self.describe_fn = lambda imgs: describe_batch(self.net, self.params, imgs)
            dim = self.net.descriptor_dim
        else:
            raise ValueError(f"unknown descriptor kind {dcfg.kind!r}")
        if dcfg.wpca_artifact:
            # the ReljaNetVLAD shape: net -> WPCA whitening -> L2
            # (ref scripts/whole_image_desc_compute_server.py:62-165)
            wp = load_wpca(dcfg.wpca_artifact)
            self.describe_fn = whitened_describe_fn(self.describe_fn, wp)
            dim = wp.out_dim
        lcfg = self.cfg.loop
        if lcfg.quantized:
            self.db = ddb.create_quantized(lcfg.db_capacity, dim, device=self.device)
        else:
            self.db = ddb.create(lcfg.db_capacity, dim, device=self.device)
        self.db = self._shard(self.db)
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
        self._cids = itertools.count()
        self.rejected_candidates: List[RejectedCandidate] = []
        self._max_rejected = 256
        # detection results still on the device, read lazily by consumers:
        # (record, store indices of its queries)
        self._deferred_det: List[tuple] = []
        self.loop_edges: List[LoopEdge] = []
        # cascade counts: pairs tier 1 passed on to tier 2, and its accepts
        self.escalated_to_tier2 = 0
        self.tier2_accepted = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed + 1)
        # each verified pair's body as a CUDA graph, replayed on the card
        self._verify_graphs = VerifyGraphs(self._generator)
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

    def _shard(self, db):
        """This rank's block of ``db`` on a mesh pipeline, else ``db``."""
        if self.mesh is None:
            return db
        shard = (sharded_search.shard_db_quantized if isinstance(db, ddb.QuantizedDB)
                 else sharded_search.shard_db)
        return shard(db, self.mesh, self.cfg.mesh.axis_db)

    def _check_supported(self, mesh):
        cfg = self.cfg
        if cfg.loop.quantized:
            if cfg.loop.method != "A":
                raise ValueError("the quantized DB supports method A")
            if cfg.loop.candidates_per_query > 1:
                raise ValueError("the quantized DB supports single-argmax Method A")
            # torch._int_mm takes the DB's rows as its N, a multiple of 8;
            # fail here rather than at the first detect batch
            if self.device.type == "cuda" and cfg.loop.db_capacity % 8:
                raise ValueError(
                    "the quantized DB on CUDA needs loop.db_capacity divisible by 8 "
                    f"(the int8 product's row count), got {cfg.loop.db_capacity}"
                )
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's ranks run on {mesh.device}, the pipeline on {self.device}")
            n = mesh.shape[cfg.mesh.axis_db]
            if cfg.loop.db_capacity % n:
                raise ValueError(
                    f"loop.db_capacity {cfg.loop.db_capacity} must divide over the mesh's {n} ranks"
                )
            if cfg.loop.quantized and self.device.type == "cuda" and (cfg.loop.db_capacity // n) % 8:
                raise ValueError(
                    "the quantized DB on CUDA needs each rank's block of loop.db_capacity "
                    f"divisible by 8, got {cfg.loop.db_capacity} over {n} ranks"
                )
        # K2 holds each query's top-k in registers, so its list size is
        # bounded; fail here rather than at the first detect batch
        k = cfg.loop.candidates_per_query if cfg.loop.method == "A" else cfg.loop.top_k
        if self.device.type == "cuda" and k > similarity.MAX_TOPK:
            raise ValueError(
                f"top-k of {k} candidates per query is above the CUDA kernel's "
                f"largest top-k size, {similarity.MAX_TOPK}"
            )

    def close(self):
        """Release the image store (and its private stash directory)."""
        self.images.close()

    # ------------------------------------------------------------------
    # Warm-up (first-call costs, from the caller's thread)
    # ------------------------------------------------------------------

    def warmup(
        self,
        verify_device_batches: tuple = (),
        optimize_node_buckets: tuple = (),
        optimize_loop_buckets: tuple = (32,),
    ) -> dict:
        """Pay every first-call cost the live loop would otherwise pay
        mid-stream, without mutating engine state: the nvcc builds of the
        kernels (``csrc/*.cu``), cuDNN's first convolutions, verification's
        first call, the native ingest engine's g++ build. Call it before
        ``CerebroService.start()``.

        ``verify_device_batches``: group sizes to verify a zero-image pair
        group at, in both cascade tiers, plus the single pair (needs a
        rig). ``optimize_node_buckets`` x ``optimize_loop_buckets``: pose
        graphs of those padded sizes to solve once.

        The keys of the returned dict are the JAX package's (``describe``,
        ``detect``, ``verify_tier{1,2}_{single,batchN}``,
        ``optimize_n{bn}_l{bl}``, ``total``); each value is the seconds
        from the start of warmup to that step's completion.

        Every warm call runs on throwaway state, and everything a warm call
        could touch is restored. Detection searches a throwaway DB (float
        or int8, as the live one) of ``descriptor_batch`` rows (or a top-k's
        size, if larger), rounded up to a multiple of 8: the port's appends
        work in place, so the live ring is never appended to. The detection
        carries, the verification generator's state, the edge and rejection
        lists, the cascade counters and the stage timer are put back, but
        for the count of verification graphs captured, which serve the live
        calls after warmup (on the card, each tier's warm pair captures its
        graph). (The JAX package's warmup advances its verification
        key; the port keeps the contract that a warmed engine and a cold
        one give the same results.)"""
        from cerebro_tpu_torch import native

        h, w = self.cfg.descriptor.image_hw
        C = self.cfg.descriptor.num_channels
        B = self.cfg.runtime.descriptor_batch
        out = {}
        t_start = time.perf_counter()

        def done(name):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            out[name] = time.perf_counter() - t_start

        native.build()
        saved = (
            self.db, self.timer, self._generator.get_state(),
            copy.deepcopy((self.det_state, self.det_state_b, self.clique_state,
                           self.topk_state, self.hyp_table)),
            list(self.loop_edges), list(self.rejected_candidates),
            self.escalated_to_tier2, self.tier2_accepted,
        )
        warm_timer = self.timer = StageTimer(
            window=saved[1].window, sync=saved[1].sync, trace=saved[1].trace
        )
        try:
            with self.timer.bind():
                descs = self.describe_fn(
                    torch.zeros((B, h, w, C), dtype=torch.uint8, device=self.device)
                )
                done("describe")

                # at least as many rows as a top-k search asks for
                rows = max(B, self.cfg.loop.top_k, self.cfg.loop.candidates_per_query)
                # the int8 product takes N % 8 == 0, on every rank's block
                n = 1 if self.mesh is None else self.mesh.shape[self.cfg.mesh.axis_db]
                rows = -(-rows // 8) * 8 * n
                if isinstance(saved[0], ddb.QuantizedDB):
                    self.db = self._shard(ddb.create_quantized(rows, saved[0].dim, device=self.device))
                    ddb.append_quantized(self.db, descs, 0)
                else:
                    self.db = self._shard(ddb.create(rows, saved[0].dim, dtype=saved[0].vectors.dtype,
                                                     device=self.device))
                    ddb.append(self.db, descs, 0)
                gidx = torch.arange(B, dtype=torch.int32, device=self.device)
                qvalid = torch.ones(B, dtype=torch.bool, device=self.device)
                self._run_method(ddb.pad_queries(self.db, descs), gidx, qvalid, 0)
                done("detect")

                def z(n, *shape, dtype=torch.float32):
                    return torch.zeros((n, *shape), dtype=dtype, device=self.device)

                for bn in optimize_node_buckets:
                    for bl in optimize_loop_buckets:
                        node_valid = z(bn, dtype=torch.bool)
                        node_valid[0] = True
                        g = PoseGraph(
                            xyzyaw=z(bn, 4), node_valid=node_valid,
                            odo_i=z(bn, dtype=torch.int64), odo_j=z(bn, dtype=torch.int64),
                            odo_meas=z(bn, 4), odo_valid=z(bn, dtype=torch.bool),
                            loop_i=z(bl, dtype=torch.int64), loop_j=z(bl, dtype=torch.int64),
                            loop_meas=z(bl, 4), loop_valid=z(bl, dtype=torch.bool),
                        )
                        x, _, _ = optimize(g, self.cfg.posegraph)
                        poses_from_xyzyaw(x).cpu()
                        done(f"optimize_n{bn}_l{bl}")

                if verify_device_batches and self.rig is not None:
                    # through the live dispatch path (_verify_chunks and
                    # _emit_edges), both cascade tiers
                    vcfg = self.cfg.verify
                    tiers = {"tier1": vcfg, "tier2": dataclasses.replace(vcfg, matcher="gather")}
                    zero = np.zeros((h, w), np.float32)
                    for tier, (tag, cfg_t) in enumerate(tiers.items(), 1):
                        for vb in (1,) + tuple(verify_device_batches):
                            fake = [
                                (RawCandidate(idx_curr=0, idx_prev=0, score=0.0), (zero,) * 4)
                                for _ in range(vb)
                            ]
                            self._verify_chunks(fake, cfg_t, max(vb, 1), tier=tier)
                            done(f"verify_{tag}_{'single' if vb == 1 else f'batch{vb}'}")
        finally:
            (self.db, self.timer, gen_state, carries, edges, rejected,
             self.escalated_to_tier2, self.tier2_accepted) = saved
            self._generator.set_state(gen_state)
            (self.det_state, self.det_state_b, self.clique_state,
             self.topk_state, self.hyp_table) = carries
            self.loop_edges[:] = edges
            self.rejected_candidates[:] = rejected
        # the graphs captured here outlive the warm calls: they serve the
        # live pairs, so their count carries over
        self.timer.count("verify.graph.captured",
                         warm_timer.counters().get("verify.graph.captured", 0))
        out["total"] = time.perf_counter() - t_start
        return out

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------

    @timing.entry
    def ingest_frame(
        self,
        stamp: float,
        left_img: np.ndarray,  # (H, W) uint8/float rectified left
        n_tracked: int,
        pose: Optional[np.ndarray] = None,  # (4,4) VINS w_T_c
        right_img: Optional[np.ndarray] = None,
        depth_img: Optional[np.ndarray] = None,  # (H, W) metres (depth camera)
        is_keyframe: bool = True,
        describe_eligible: bool = True,  # False = shed under load
        feat_uv: Optional[np.ndarray] = None,  # (K, 2) tracked-feature pixels
        feat_ids: Optional[np.ndarray] = None,  # (K,) tracker feature ids
        feat_xyz: Optional[np.ndarray] = None,  # (K, 3) world points
    ):
        """One camera frame. Returns kidnap events fired by this frame."""
        events = self.kidnap.feed(stamp, n_tracked)
        idx = self.store.add_frame(
            stamp, pose=pose, is_keyframe=is_keyframe, n_tracked=n_tracked,
            world_id=self.kidnap.world_id,
        )
        if feat_ids is not None:
            self.store.set_point_features(idx, feat_uv, feat_ids, feat_xyz)
        if is_keyframe:
            self.timer.count("keyframes.ingested")
            self.images.put("left", idx, np.asarray(left_img))
            if right_img is not None:
                self.images.put("right", idx, np.asarray(right_img))
            if depth_img is not None:
                self.images.put("depth", idx, np.asarray(depth_img))
            # descriptor eligibility (ref skips kidnapped <20-feat frames,
            # src/Cerebro.cpp:206-210)
            if n_tracked >= self.cfg.descriptor.min_tracked_features:
                if describe_eligible:
                    self._pending_desc.append(idx)
                    self.timer.event("kf.queued", kf=idx)
                    self.timer.event("describe_queue", value=len(self._pending_desc))
                else:
                    self.shed_descriptors += 1
                    self.timer.count("keyframes.shed")
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

    @timing.entry
    def flush_descriptors(self):
        """Describe queued keyframes (one batched call per descriptor_batch)
        and run loop detection on the new rows."""
        B = self.cfg.runtime.descriptor_batch
        h, w = self.cfg.descriptor.image_hw
        C = self.cfg.descriptor.num_channels
        while self._pending_desc:
            chunk = self._pending_desc[:B]
            self._pending_desc = self._pending_desc[B:]
            self.timer.event("describe_queue", value=len(self._pending_desc))
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
            with self.timer.stage("describe") as batch:
                descs = self.timer.sync_point(self.describe_fn(imgs_dev))
            with self.timer.stage("detect") as sp:
                self._detect(descs, chunk, len(chunk))
                sp.set(rows=self.db.count)  # the DB rows filled when it searched
            self.timer.count("keyframes.described", len(chunk))
            for idx in chunk:
                self.timer.event("kf.described", kf=idx, batch=batch.id)

    def _detect(self, descs: torch.Tensor, store_idx: List[int], n_valid: int):
        B = descs.shape[0]
        row0 = len(self.db_gid_to_store)
        gidx = torch.arange(row0, row0 + B, dtype=torch.int32, device=self.device)
        qvalid = torch.arange(B, device=self.device) < n_valid
        # in place: the ring head advances
        if isinstance(self.db, ddb.QuantizedDB):
            ddb.append_quantized(self.db, descs, n_valid)
        else:
            ddb.append(self.db, descs, n_valid)
        # queries padded as the DB's rows are (a CUDA DB of width % 8 != 0)
        deferred = self._run_method(ddb.pad_queries(self.db, descs), gidx, qvalid, n_valid)
        self.db_gid_to_store.extend(store_idx[:n_valid])
        self.store.mark_described(np.asarray(store_idx[:n_valid]))
        self._deferred_det.append((deferred, list(store_idx[:n_valid])))
        self.timer.count("detections.queued")
        self.timer.sync_point(deferred[1])

    def _run_method(self, descs, gidx, qvalid, n_valid):
        """Candidate generation per configured method (ref Cerebro::run
        dispatch, src/Cerebro.cpp:350-357). Returns a record of device
        tensors, read on the host by ``_drain_detections``."""
        cfg = self.cfg.loop
        method = cfg.method
        mesh, axis = self.mesh, self.cfg.mesh.axis_db
        if method == "A" and cfg.candidates_per_query <= 1:
            if mesh is None:
                detect = detector.detect_batch_quantized if cfg.quantized else detector.detect_batch
                cands, self.det_state = detect(cfg, self.db, self.det_state, descs, gidx, qvalid)
            else:
                detect = (sharded_search.detect_batch_quantized_sharded if cfg.quantized
                          else sharded_search.detect_batch_sharded)
                cands, self.det_state = detect(cfg, self.db, self.det_state, descs, gidx, qvalid,
                                               mesh, axis)
            return ("A", cands, n_valid)
        if method not in ("A", "B", "C", "D"):
            raise ValueError(f"unknown loop method {method!r}")

        # top-k retrieval: on CUDA tensors one launch of K2 (per rank)
        k = cfg.candidates_per_query if method == "A" else cfg.top_k
        limits = ddb.query_limits(self.db, gidx, cfg.exclusion_window)
        if mesh is None:
            vals, idx = similarity.search_topk(descs, self.db.vectors, limits, self.db.global_ids, k=k)
        else:
            vals, idx = sharded_search.sharded_topk(
                descs, self.db.vectors, limits, self.db.global_ids, mesh, axis, k=k
            )
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
        # the reads wait for the queued device work; the gates are host work
        with self.timer.stage("drain.readback"):
            found = [self._read_detections(rec) for rec, _ in pending]
        self.timer.count("detections.read_back", len(pending))
        min_dt = self.cfg.verify.min_pair_dt_s
        with self.timer.stage("drain.gate"):
            n_raised = len(self._candidates)
            for (_, kfs), pairs in zip(pending, found):
                for kf in kfs:
                    self.timer.event("kf.drained", kf=kf)
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
                    cand = RawCandidate(idx_curr=curr, idx_prev=prev, score=score,
                                        cid=next(self._cids))
                    self._candidates.append(cand)
                    self.timer.event("cand.raised", cid=cand.cid, curr=curr, prev=prev)
            n_raised = len(self._candidates) - n_raised
            if n_raised:
                self.timer.count("candidates.raised", n_raised)
                if self.timer.trace:
                    self.timer.event("verify_queue", value=self._verify_queue())

    def _read_detections(self, rec) -> List[tuple]:
        """The (curr gid, prev gid, score) hits of one detection record,
        read back from the device; logs each query's rank-0 score."""
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
            return [
                (int(curr_g[j]), int(prev_g[j]), float(scores[j]))
                for j in range(n_valid * K)
                if valid[j]
            ]
        if tag == "C":
            curr, prev, score, ok = (x.cpu().numpy() for x in rec[1])
            return [
                (int(curr[k]), int(prev[k]), float(score[k]))
                for k in range(len(ok))
                if ok[k]
            ]
        # "D": (B*K, H) emit events per flattened hit
        a_t, b_t, mean_s, emits = (x.cpu().numpy() for x in rec[1])
        return [
            (int(a_t[q, h]), int(b_t[q, h]), float(mean_s[q, h]))
            for q, h in zip(*np.nonzero(emits))
        ]

    def _verify_queue(self) -> int:
        """Candidates raised and not yet decided (accepted, rejected at a
        gate, or dropped: their images no longer held), from the counters."""
        c = self.timer.counters()
        decided = c.get("edges.accepted", 0) + c.get("candidates.dropped", 0) + sum(
            v for k, v in c.items() if k.startswith("rejected.")
        )
        return c.get("candidates.raised", 0) - decided

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

    @timing.entry
    def verify_pending(
        self, max_pairs: Optional[int] = None, device_batch: int = 4,
        drain: bool = True, cascade: Optional[bool] = None,
    ) -> int:
        """Geometrically verify queued candidates; accepted ones become
        LoopEdges. Returns the number accepted.

        Candidates go in ``device_batch``-sized groups: each group's stereo
        depth is one K3 launch over all its frames. A depth-camera rig's
        pairs verify one call each from their depth images (no K3, no
        cascade).

        ``cascade`` overrides VerifyConfig.cascade for this call: a live 1 Hz
        consumer passes False so a match-count failure rejects at once
        instead of paying the gather-bank escalation while the camera
        streams; the end-of-run drain escalates as configured. The timer's
        ``verify_tier1`` and ``verify_tier2`` stages hold each tier's
        pass; ``status()`` counts the escalated pairs and tier 2's accepts."""
        if self.rig is None:
            raise RuntimeError("verification needs a RectifiedRig (stereo)")
        with self._det_lock:
            if drain and self._deferred_det:
                with self.timer.stage("drain"):
                    self._drain_detections_locked()
            todo = self._candidates if max_pairs is None else self._candidates[:max_pairs]
            self._candidates = [] if max_pairs is None else self._candidates[max_pairs:]

        loadable, depth_pairs = [], []
        with self.timer.stage("verify_load"):
            for cand in todo:
                pair = self._load_pair(cand)
                if pair is not None:
                    (depth_pairs if pair[0] == "depth" else loadable).append((cand, pair[1:]))
                else:
                    self.timer.count("candidates.dropped")
                    self.timer.event("cand.decided", cid=cand.cid, outcome="dropped",
                                     reason="images not held")

        # depth-camera pairs: one call each, no cascade (a depth rig has
        # no stereo matcher escalation path), no K3: the depth is measured
        n_accepted = 0
        for cand, pair in depth_pairs:
            la, da, lb, db_ = (torch.from_numpy(x).to(self.device) for x in pair)
            with self.timer.stage("verify") as group:
                res = verify_pair_depth(
                    self.cfg.verify, self._generator,
                    lb, db_,  # frame a := prev
                    la, da,  # frame b := curr
                    self.rig, graphs=self._verify_graphs,
                )
            self.timer.count("pairs.verified.depth")
            self.timer.event("cand.verified", cid=cand.cid, group=group.id, tier="depth")
            n_accepted += self._emit_edges(
                [cand], VerifiedLoop(**{f.name: getattr(res, f.name)[None] for f in dataclasses.fields(res)})
            )

        # Cascade: verify every pair with the cheap tier first; only pairs
        # that fail for lack of matches (the failure an extreme scale change
        # causes) escalate to the full gather-bank matcher. An escalated
        # pair runs its stereo depth (K3) again, as in the JAX package:
        # tier 2 is the same verification from the images, with another
        # matcher. Each tier's pass is timed whole as its own stage.
        vcfg = self.cfg.verify
        use_cascade = vcfg.cascade if cascade is None else cascade
        tier1 = tier2 = vcfg
        if use_cascade:
            if vcfg.matcher != "steerable":  # the steerable one is already robust
                tier1 = dataclasses.replace(vcfg, scale_banks=(1.0,))
            tier2 = dataclasses.replace(vcfg, matcher="gather")
        escalate: Optional[List] = None if tier1 == tier2 else []
        with self.timer.stage("verify_tier1"):
            n_accepted += self._verify_chunks(loadable, tier1, device_batch, escalate=escalate)
        if escalate:
            self.escalated_to_tier2 += len(escalate)
            self.timer.count("pairs.escalated", len(escalate))
            with self.timer.stage("verify_tier2"):
                n_tier2 = self._verify_chunks(escalate, tier2, device_batch, tier=2)
            self.tier2_accepted += n_tier2
            n_accepted += n_tier2
        return n_accepted

    def _verify_chunks(
        self, loadable, vcfg, device_batch: int, escalate: Optional[List] = None,
        tier: int = 1,
    ) -> int:
        """Run (cand, (la, ra, lb, rb)) pairs through verification under
        ``vcfg`` in groups of ``device_batch``. With ``escalate`` given,
        match-count failures are appended there (for a second pass with a
        stronger matcher) instead of recorded. ``tier``: the cascade tier,
        for the counters and the spans."""
        n_accepted = 0
        for i in range(0, len(loadable), device_batch):
            chunk = loadable[i : i + device_batch]
            with self.timer.stage("verify_h2d"):
                la, ra, lb, rb = (
                    torch.from_numpy(np.stack([p[j] for _, p in chunk])).to(self.device)
                    for j in range(4)
                )
            with self.timer.stage("verify", pairs=len(chunk), tier=tier) as group:
                res = verify_pair_batch(
                    vcfg, self._generator,
                    lb, rb,  # frame a := prev
                    la, ra,  # frame b := curr
                    self.rig, graphs=self._verify_graphs,
                )
                self.timer.sync_point(res)
            self.timer.count(f"pairs.verified.tier{tier}", len(chunk))
            for c, _ in chunk:
                self.timer.event("cand.verified", cid=c.cid, group=group.id, tier=tier)
            n_accepted += self._emit_edges(
                [c for c, _ in chunk], res, escalate=escalate,
                pairs_by_cand={id(c): p for c, p in chunk},
            )
        return n_accepted

    def _emit_edges(
        self, cands: List[RawCandidate], res,
        escalate: Optional[List] = None,
        pairs_by_cand: Optional[dict] = None,
    ) -> int:
        """Turn accepted VerifiedLoop entries into LoopEdges. With a := prev,
        b := curr, res.T_b_a[p] = curr_T_prev; the edge stores prev_T_curr.
        Rejections are recorded with the failing gate. With ``escalate``
        given (cascade pass 1), match-count failures are queued there for
        the scale-robust matcher instead of being recorded as final."""
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
                low_matches = int(nm[p]) <= max(vcfg.min_matches_attempt, vcfg.min_matches_accept)
                if escalate is not None and low_matches:
                    escalate.append((cand, pairs_by_cand[id(cand)]))
                    self.timer.event("cand.escalated", cid=cand.cid)
                    continue
                if int(nm[p]) < vcfg.min_matches_attempt:
                    gate, reason = "too_few_matches", (
                        f"too few matches ({int(nm[p])} < "
                        f"{vcfg.min_matches_attempt} attempt gate)"
                    )
                elif not opt_ok[p].all():
                    failed = [name for name, ok in zip("ABC", opt_ok[p]) if not ok]
                    gate, reason = "ransac", f"RANSAC failure (option {'/'.join(failed)})"
                elif not consistent[p]:
                    gate, reason = "consistency", (
                        f"pose consistency ({vcfg.consistency_deg:g} deg / "
                        f"{vcfg.consistency_m:g} m 3-way gate)"
                    )
                else:
                    gate, reason = "accept_gate", (
                        f"match count {int(nm[p])} <= "
                        f"{vcfg.min_matches_accept} accept gate"
                    )
                self.timer.count("rejected." + gate)
                self.timer.event("cand.decided", cid=cand.cid, outcome="rejected", reason=reason)
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
            self.timer.count("edges.accepted")
            self.timer.event("cand.decided", cid=cand.cid, outcome="accepted")
            n += 1
        if self.timer.trace:
            self.timer.event("verify_queue", value=self._verify_queue())
        return n

    def _load_pair(self, cand: RawCandidate):
        """("stereo", la, ra, lb, rb) float32 images when both frames have
        stereo images, else ("depth", la, da, lb, db) when both have depth
        images (a depth-camera rig), else None."""
        la = self.images.get("left", cand.idx_curr)
        lb = self.images.get("left", cand.idx_prev)
        if la is None or lb is None:
            return None
        for kind, ns in (("stereo", "right"), ("depth", "depth")):
            xa = self.images.get(ns, cand.idx_curr)
            xb = self.images.get(ns, cand.idx_prev)
            if xa is not None and xb is not None:
                return (kind,) + tuple(np.asarray(im, np.float32) for im in (la, xa, lb, xb))
        return None

    # ------------------------------------------------------------------
    # Trajectory optimization (pose graph over keyframes)
    # ------------------------------------------------------------------

    @timing.entry
    def optimize_trajectory(self) -> Optional[np.ndarray]:
        """Build and solve the pose graph over the keyframes with valid
        poses. Returns corrected (N, 4, 4) w_T_cam poses aligned into world
        0, or None when the graph is trivial (the reference's external
        solve_keyframe_pose_graph, in the engine)."""
        with self.timer.stage("solve"):
            with self.timer.stage("solve.assemble"):
                built = self.pose_graph()
            if built is None:
                return None
            graph, N = built
            with self.timer.stage("optimize"):
                x_opt, _, _ = optimize(graph, self.cfg.posegraph)
                out = poses_from_xyzyaw(x_opt)[:N].cpu().numpy()  # w_T_body
            if self.body_T_cam is not None:
                out = out @ self.body_T_cam[None]  # back to w_T_cam
            return out

    def pose_graph(self) -> Optional[Tuple[PoseGraph, int]]:
        """(the padded pose graph ``optimize_trajectory`` solves, its number
        of real nodes), or None when there are fewer than 2 posed
        keyframes."""
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
        return graph, N

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

    def render_scores(self):
        """(H, W, 3) image of the running max-score curve with detection
        marks and the acceptance threshold (Plot2Mat parity)."""
        from cerebro_tpu_torch.utils.plot import plot_scores

        return plot_scores(
            np.asarray(self.score_history, np.float32),
            marks=self.detection_marks,
            threshold=self.cfg.loop.dot_threshold,
        )

    def dump_debug(self, directory: str, max_rejected: int = 32) -> None:
        """End-of-run debug dump (parity: the reference's __LOGGING__ block,
        src/cerebro_node.cpp:613-839): status.json, loop_edges.json,
        rejections.json, the score curve, the trajectory render, and a
        side-by-side match image per accepted loop edge and per rejected
        candidate, with the failing gate in the banner when OpenCV is
        there to draw text (ref src/Visualization.cpp:75-225). Each image
        is written as ``.npy`` and as a PNG (``utils/plot.encode_png``)."""
        from cerebro_tpu_torch.ops import features
        from cerebro_tpu_torch.utils.plot import (
            encode_png,
            side_by_side_matches,
            trajectory_topdown,
        )

        os.makedirs(directory, exist_ok=True)

        def save_img(name, img):
            np.save(os.path.join(directory, name + ".npy"), img)
            with open(os.path.join(directory, name + ".png"), "wb") as f:
                f.write(encode_png(img))

        def save_json(name, obj):
            with open(os.path.join(directory, name), "w") as f:
                json.dump(obj, f, indent=2)

        save_json("status.json", self.status())
        save_json("loop_edges.json", [e.as_json() for e in self.loop_edges])
        save_json("rejections.json", [dataclasses.asdict(r) for r in self.rejected_candidates])

        if self.score_history:
            save_img("score_curve", self.render_scores())
        traj = self.optimize_trajectory()
        if traj is not None:
            img = trajectory_topdown(
                traj,
                world_id=self.store.world_id[: self.store.size],
                loop_pairs=[(e.idx_prev, e.idx_curr) for e in self.loop_edges],
            )
            np.save(os.path.join(directory, "trajectory.npy"), traj)
            save_img("trajectory_render", img)

        vcfg = self.cfg.verify
        matcher = (
            features.match_image_pair_steerable
            if vcfg.matcher == "steerable"
            else features.match_image_pair
        )

        def render_pair(name, idx_curr, idx_prev, accepted, banner):
            la = self.images.get("left", idx_curr)
            lb = self.images.get("left", idx_prev)
            if la is None or lb is None:
                return
            m = matcher(
                torch.from_numpy(np.asarray(la, np.float32)).to(self.device),
                torch.from_numpy(np.asarray(lb, np.float32)).to(self.device),
                max_kp=vcfg.max_features,
                gms_factor=vcfg.gms_factor,
                oriented=vcfg.oriented_matching,
                scales=vcfg.scale_banks,
            )
            save_img(
                name,
                side_by_side_matches(
                    la, lb, m.xy_a.cpu().numpy(), m.xy_b.cpu().numpy(), m.valid.cpu().numpy(),
                    accepted=accepted, banner=banner,
                ),
            )

        for k, e in enumerate(self.loop_edges):
            render_pair(
                f"pair_{k:04d}", e.idx_curr, e.idx_prev, True,
                f"ACCEPT edge {e.idx_prev}->{e.idx_curr}  n={e.n_matches}",
            )
        for k, r in enumerate(self.rejected_candidates[-max_rejected:]):
            render_pair(
                f"reject_{k:04d}", r.idx_curr, r.idx_prev, False,
                f"REJECT {r.idx_prev}->{r.idx_curr}: {r.reason}",
            )

    def status(self) -> dict:
        """Host counters only: safe from a monitoring thread, it waits on no
        device work. Detection results still on the device are counted in
        ``undrained_batches``; ``pending_candidates`` holds those read back
        (``candidates`` reads the rest). ``counters`` always holds the three
        ``verify.graph.*`` counts, 0 until counted."""
        counters = {**dict.fromkeys(GRAPH_COUNTERS, 0), **self.timer.counters()}
        return {
            "frames": self.store.size,
            "keyframes": int(self.store.is_keyframe[: self.store.size].sum()),
            "described": len(self.db_gid_to_store),
            "shed_descriptors": self.shed_descriptors,
            "pending_descriptors": len(self._pending_desc),
            "pending_candidates": len(self._candidates),
            "verify_queue": self._verify_queue(),
            "undrained_batches": (counters.get("detections.queued", 0)
                                  - counters.get("detections.read_back", 0)),
            "loop_edges": len(self.loop_edges),
            "rejected_candidates": len(self.rejected_candidates),
            "escalated_to_tier2": self.escalated_to_tier2,
            "tier2_accepted": self.tier2_accepted,
            "kidnap": self.kidnap.info(),
            "timings_ms": self.timer.stats(),
            "counters": counters,
        }


class _StampedPixels:
    """Stamp-indexed pixel buffers with O(log n) nearest-stamp lookup: a
    bisected sorted-key list makes both the tolerance lookup and the stale
    prune logarithmic in the search; pushes arrive in near-stamp order, so
    the insort shift is almost always an append.

    Producer threads call add() while the worker calls pop_near and
    prune_older; the compound list+dict updates are not GIL-atomic, so a
    lock serializes them."""

    def __init__(self):
        self._d: dict = {}
        self._keys: list = []  # sorted stamps, guarded by _mu with _d
        self._mu = threading.Lock()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, stamp_ns: int) -> bool:
        return stamp_ns in self._d

    def add(self, stamp_ns: int, img) -> None:
        with self._mu:
            if stamp_ns not in self._d:
                bisect.insort(self._keys, stamp_ns)
            self._d[stamp_ns] = img

    def pop_near(self, stamp_ns: int, tol_ns: int = 1_000_000):
        """Pop the entry closest to ``stamp_ns`` within tolerance, or None."""
        with self._mu:
            keys = self._keys
            if not keys:
                return None
            i = bisect.bisect_left(keys, stamp_ns)
            best, best_err = -1, tol_ns + 1
            for j in (i - 1, i):
                if 0 <= j < len(keys):
                    err = abs(keys[j] - stamp_ns)
                    if err < best_err:
                        best, best_err = j, err
            if best < 0:
                return None
            s = keys.pop(best)
            return self._d.pop(s)

    def prune_older(self, cutoff_ns: int) -> int:
        """Drop all entries with stamp < cutoff; returns how many."""
        with self._mu:
            i = bisect.bisect_left(self._keys, cutoff_ns)
            stale = self._keys[:i]
            del self._keys[:i]
            for s in stale:
                del self._d[s]
            return len(stale)


class StreamIngestor:
    """Asynchronous front end: capture/VIO threads push raw feeds (images,
    poses, tracking counts) with nanosecond stamps; the native C++ engine
    (cerebro_tpu_torch/native) associates them off the GIL; ``pump()``
    drains assembled frames into the pipeline on the consumer thread.

    The replacement for the reference's ROS subscriber callbacks and
    DataManager::data_association_thread (src/DataManager.cpp:769-1091).
    Pixels stay numpy arrays on the host until ``ingest_frame``."""

    def __init__(
        self, pipeline: CerebroPipeline, hold_s: float = 0.2, capacity: int = 4096
    ):
        from cerebro_tpu_torch.native import make_ingest

        self.pipeline = pipeline
        self.engine = make_ingest(
            tol_s=1e-3, hold_s=hold_s, gap_s=pipeline.cfg.kidnap.stream_gap_s,
            capacity=capacity,
        )
        self._left = _StampedPixels()  # each internally locked (producer
        self._right = _StampedPixels()  # threads add, the worker pops/prunes)
        self.pixels_dropped = 0  # images rejected at capacity or pruned stale
        self._shed_phase = 0  # deterministic decimation counter
        # while the pipeline traces: stamp -> perf_counter_ns of its left
        # image's push, the start of its keyframe's "kf.ingested" span
        self._pushed_at: dict = {}

    # -- producer side (any thread) ------------------------------------

    def push_image(self, stamp_ns: int, img: np.ndarray, is_right: bool = False):
        # engine first: if the ring is at capacity the frame will never be
        # emitted, so keeping its pixels would leak
        if self.engine.push_image(stamp_ns, is_right):
            if not is_right and self.pipeline.timer.trace:
                self._pushed_at.setdefault(stamp_ns, time.perf_counter_ns())
            (self._right if is_right else self._left).add(stamp_ns, img)
        else:
            self.pixels_dropped += 1

    def push_pose(self, stamp_ns: int, w_T_c: np.ndarray):
        self.engine.push_pose(stamp_ns, w_T_c)

    def push_tracking(self, stamp_ns: int, n_tracked: int, is_keyframe: bool):
        self.engine.push_tracking(stamp_ns, n_tracked, is_keyframe)

    # -- consumer side (pipeline thread) --------------------------------

    def pump(self, max_frames: int = 256) -> int:
        """Drain assembled frames into the pipeline. Returns frames fed.

        Backpressure: when the engine backlog exceeds
        ``RuntimeConfig.shed_backlog``, description is decimated: only every
        stride-th eligible keyframe is queued, stride = ceil(backlog/limit)
        (the deterministic equivalent of the reference's probabilistic skip
        P=1-Δt/est_ms, src/Cerebro.cpp:193-203). Frames are always stored;
        only descriptor work is shed."""
        backlog = int(self.engine.pending)
        limit = self.pipeline.cfg.runtime.shed_backlog
        stride = max(1, -(-backlog // limit)) if limit > 0 else 1

        frames = self.engine.drain(max_out=max_frames)
        timer = self.pipeline.timer
        for f in frames:
            left = self._left.pop_near(f["stamp_ns"])
            right = self._right.pop_near(f["stamp_ns"])
            pushed = self._pushed_at.pop(f["stamp_ns"], None)
            if left is None:
                continue
            self._shed_phase += 1
            self.pipeline.ingest_frame(
                f["stamp"],
                left,
                n_tracked=f["n_tracked"],
                pose=f["pose"].astype(np.float32) if f["pose"] is not None else None,
                right_img=right,
                is_keyframe=f["is_keyframe"],
                describe_eligible=(self._shed_phase % stride == 0),
            )
            if f["is_keyframe"]:
                # the store index of the frame just ingested (this thread
                # is the store's one writer)
                timer.event("kf.ingested", t0_ns=pushed, kf=self.pipeline.store.size - 1)
        # Reclaim pixels for frames the engine will never emit (dropped at
        # capacity under a stale stamp, or emitted with a slightly different
        # associated stamp): anything older than both the emit horizon and
        # the oldest still-pending frame is unreachable.
        cutoff = min(self.engine.emit_horizon, self.engine.oldest_pending) - 1_000_000
        self.pixels_dropped += self._left.prune_older(cutoff)
        self.pixels_dropped += self._right.prune_older(cutoff)
        for s in [s for s in list(self._pushed_at) if s < cutoff]:
            self._pushed_at.pop(s, None)
        return len(frames)


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
