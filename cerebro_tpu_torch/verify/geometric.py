"""Geometric verification of loop candidates (counterpart of
cerebro_tpu/verify/geometric.py for stereo pairs).

Re-implements the reference's ``loopcandiate_consumer_thread`` +
``process_loop_candidate_imagepair_consistent_pose_compute``
(src/Cerebro.cpp:1185-2213) and
``ProcessedLoopCandidate::makeLoopEdgeMsgWithConsistencyCheck``
(src/ProcessedLoopCandidate.cpp:40-116):

  stereo depth for both frames         (geometry/stereo.py, kernel K3;
                                        a depth camera's images instead
                                        in verify_pair_depth, no K3)
  point matches between the two lefts  (ops/features.py: the steerable or
                                        the gather matcher, + GMS)
  reject if matches < min_matches_attempt            (ref :1487  >=150)
  pose three independent ways, all RANSAC:
    Option A:  PnP( 3D of a -> 2D of b )             (ref :1509-1529)
    Option B:  PnP( 3D of b -> 2D of a ), inverted   (ref :1563-1586)
    Option C:  3D-3D Umeyama ICP                     (ref :1620-1643)
  consistency: pairwise delta-poses within 5 deg / 0.2 m   (ref :77-87)
  accept iff consistent AND matches > min_matches_accept   (ref :112 >800)
  final pose := Option A, confidence := max goodness       (ref :114-116)

While the pipeline's timer traces, each group's depth, each pair's
matching, each RANSAC option and the gates are spans of their own
(``verify.depth``, ``verify.match``, ``verify.ransac``, ``verify.gates``).

On the card the per-pair body (``verify_from_points``) is a few thousand
small launches and reads nothing back, so ``VerifyGraphs`` captures it once
per tier and frame shape as a CUDA graph and replays it for every later
pair; a replayed pair records none of the inner spans. The counters
``verify.graph.captured``, ``verify.graph.replayed`` and
``verify.graph.eager`` (pairs on CUDA tensors verified eagerly; CPU pairs
count under none) say how often the graph serves.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from cerebro_tpu_torch.config import VerifyConfig
from cerebro_tpu_torch.geometry import se3, stereo
from cerebro_tpu_torch.ops import _cuda, features, ransac
from cerebro_tpu_torch.utils import timing


GRAPH_COUNTERS = ("verify.graph.captured", "verify.graph.replayed", "verify.graph.eager")


@dataclasses.dataclass(frozen=True)
class VerifiedLoop:
    """ProcessedLoopCandidate equivalent (src/ProcessedLoopCandidate.h).
    ``verify_pair_batch`` returns every field with a leading pair axis."""

    T_b_a: torch.Tensor  # (4,4) final relative pose (Option A)
    poses: torch.Tensor  # (3,4,4) options A, B(inverted), C
    option_success: torch.Tensor  # (3,) bool per-option RANSAC success
    confidences: torch.Tensor  # (3,) float32 inlier ratios ("goodness")
    n_matches: torch.Tensor  # () int32 GMS match count
    consistent: torch.Tensor  # () bool 3-way pose agreement
    accepted: torch.Tensor  # () bool final gate

    @property
    def confidence(self) -> torch.Tensor:
        return self.confidences.amax(dim=-1)


def _match(cfg: VerifyConfig, left_a: torch.Tensor, left_b: torch.Tensor) -> features.Matches:
    """Point matches between the two left images (ref :1484-1493) by the
    configured matcher."""
    if cfg.matcher == "steerable":
        return features.match_image_pair_steerable(
            left_a, left_b, max_kp=cfg.max_features, gms_factor=cfg.gms_factor,
            oriented=cfg.oriented_matching, scales=cfg.scale_banks,
        )
    return features.match_image_pair(
        left_a, left_b, max_kp=cfg.max_features, gms_factor=cfg.gms_factor,
        oriented=cfg.oriented_matching, scales=cfg.scale_banks,
    )


def _gather_3d(pts: torch.Tensor, ok: torch.Tensor, xy: torch.Tensor):
    """3D point + validity at (rounded) pixel coords."""
    x = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, pts.shape[1] - 1)
    y = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, pts.shape[0] - 1)
    return pts[y, x], ok[y, x]


def _normalized(xy: torch.Tensor, rig: stereo.RectifiedRig) -> torch.Tensor:
    """Pixel -> ideal coords in the rectified pinhole (the K^-1
    normalization of ref src/utils/PointFeatureMatching.cpp:95-153)."""
    return torch.stack(
        [(xy[:, 0] - rig.cx) / rig.fx, (xy[:, 1] - rig.cy) / rig.fy], dim=-1
    )


def verify_from_points(
    cfg: VerifyConfig,
    generator: Optional[torch.Generator],
    left_a: torch.Tensor,
    pts_a: torch.Tensor,
    ok_a: torch.Tensor,
    left_b: torch.Tensor,
    pts_b: torch.Tensor,
    ok_b: torch.Tensor,
    rig: stereo.RectifiedRig,
    sample_idx=(None, None, None),  # per option A/B/C: (H, S) or None
) -> VerifiedLoop:
    """Matching, three RANSAC poses and the gates for one pair whose 3D
    point maps are already computed."""
    with timing.span("verify.match"):
        m = _match(cfg, left_a, left_b)
        n_matches = m.count()
        attempt = n_matches >= cfg.min_matches_attempt

        X_a, d_ok_a = _gather_3d(pts_a, ok_a, m.xy_a)
        X_b, d_ok_b = _gather_3d(pts_b, ok_b, m.xy_b)
        x_a = _normalized(m.xy_a, rig)
        x_b = _normalized(m.xy_b, rig)
        depth_ok_a = d_ok_a & (X_a[:, 2] > cfg.min_depth) & (X_a[:, 2] < cfg.max_depth)
        depth_ok_b = d_ok_b & (X_b[:, 2] > cfg.min_depth) & (X_b[:, 2] < cfg.max_depth)

    common = dict(
        n_hyp=cfg.ransac_hypotheses,
        min_inlier_ratio=cfg.min_inlier_ratio,
        min_points=cfg.min_points_for_solve,
    )
    # Option A: 3D(a) -> 2D(b): returns b_T_a (ref :1509-1529)
    with timing.span("verify.ransac", option="A"):
        res_a = ransac.ransac_pnp(
            generator, X_a, x_b, m.valid & depth_ok_a, sample_size=cfg.pnp_sample_size,
            inlier_thresh=cfg.pnp_inlier_error, sample_idx=sample_idx[0], **common,
        )
    # Option B: 3D(b) -> 2D(a): returns a_T_b, inverted (ref :1563-1586)
    with timing.span("verify.ransac", option="B"):
        res_b = ransac.ransac_pnp(
            generator, X_b, x_a, m.valid & depth_ok_b, sample_size=cfg.pnp_sample_size,
            inlier_thresh=cfg.pnp_inlier_error, sample_idx=sample_idx[1], **common,
        )
    # Option C: 3D-3D (ref :1620-1643), with a depth-adaptive per-point
    # inlier threshold (stereo depth noise grows as Z^2)
    with timing.span("verify.ransac", option="C"):
        icp_thresh = torch.clamp(
            cfg.icp_depth_relative * torch.maximum(X_a[:, 2], X_b[:, 2]),
            min=cfg.icp_inlier_error,
        )
        res_c = ransac.ransac_icp(
            generator, X_a, X_b, m.valid & depth_ok_a & depth_ok_b,
            sample_size=cfg.icp_sample_size, inlier_thresh=icp_thresh,
            sample_idx=sample_idx[2], **common,
        )

    with timing.span("verify.gates"):
        poses = torch.stack([res_a.T, se3.pose_inverse(res_b.T), res_c.T])
        successes = torch.stack([res_a.success, res_b.success, res_c.success])
        confs = torch.stack([res_a.confidence, res_b.confidence, res_c.confidence])

        # 3-way consistency (ref ProcessedLoopCandidate.cpp:63-87)
        ang_ab, t_ab = se3.pose_delta_metrics(poses[0], poses[1])
        ang_ac, t_ac = se3.pose_delta_metrics(poses[0], poses[2])
        ang_bc, t_bc = se3.pose_delta_metrics(poses[1], poses[2])
        ang_ok = torch.stack([ang_ab, ang_ac, ang_bc]).amax() < cfg.consistency_deg
        t_ok = torch.stack([t_ab, t_ac, t_bc]).amax() < cfg.consistency_m
        nan_free = torch.isfinite(poses).all()  # ref NaN guard :1678-1681
        consistent = ang_ok & t_ok & nan_free & successes.all()
        accepted = attempt & consistent & (n_matches > cfg.min_matches_accept)
    return VerifiedLoop(
        T_b_a=poses[0],
        poses=poses,
        option_success=successes,
        confidences=confs,
        n_matches=n_matches,
        consistent=consistent,
        accepted=accepted,
    )


class VerifyGraphs:
    """``verify_from_points`` captured as one CUDA graph per (tier config,
    rig, frame shapes and dtypes) and replayed for each later pair: the
    inputs are copied into the graph's static buffers, the graph replays,
    and the outputs are copied out. A pair then costs a few host dispatches
    in place of thousands of eager launches.

    Bound to one generator, which each graph registers: a replay draws
    RANSAC's samples from the generator's current offset and advances it
    exactly as an eager call does, so replayed and eager pairs give the same
    results from the same generator state. The graphs share one memory pool
    (tiers never replay at once). The first pair of a key is verified
    eagerly on a side stream, the warm-up PyTorch asks for before a capture,
    and is that pair's result; the capture follows (``thread_local``: other
    threads may allocate meanwhile). ``run`` is serialised: the static
    buffers hold one pair at a time. Each replay adds the hand-written
    kernels' launches recorded at the capture to their ``Kernel.replayed``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._graphs: dict = {}
        self._pool = None
        self._lock = threading.Lock()

    def engages(self, generator, left: torch.Tensor, sample_idx) -> bool:
        """Whether ``run`` serves a pair: CUDA tensors, sampled from this
        object's generator (not from caller-supplied samples)."""
        return left.is_cuda and generator is self.generator and all(i is None for i in sample_idx)

    def run(self, cfg: VerifyConfig, rig: stereo.RectifiedRig, *points) -> VerifiedLoop:
        """``verify_from_points(cfg, generator, *points, rig)`` for
        ``points`` = (left_a, pts_a, ok_a, left_b, pts_b, ok_b): replayed, or
        eager and captured at a key's first pair."""
        key = (cfg, rig.fx, rig.fy, rig.cx, rig.cy, points[0].device,
               tuple((tuple(x.shape), x.dtype) for x in points))
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                out = self._capture(key, cfg, rig, points)
                timing.count("verify.graph.eager")
                timing.count("verify.graph.captured")
                return out
            static_in, graph, static_out, tally = entry
            for buf, x in zip(static_in, points):
                buf.copy_(x)
            graph.replay()
            _cuda.replay_launches(tally)
            timing.count("verify.graph.replayed")
            return VerifiedLoop(**{f.name: getattr(static_out, f.name).clone()
                                   for f in dataclasses.fields(VerifiedLoop)})

    def _capture(self, key, cfg, rig, points) -> VerifiedLoop:
        dev = points[0].device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = verify_from_points(cfg, self.generator, *points, rig)
        main.wait_stream(side)
        for f in dataclasses.fields(VerifiedLoop):
            getattr(out, f.name).record_stream(main)
        static_in = [x.clone() for x in points]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with _cuda.captured_launches() as tally, \
                torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            static_out = verify_from_points(cfg, self.generator, *static_in, rig)
        self._graphs[key] = (static_in, graph, static_out, tally)
        return out


def _verify_one(cfg, generator, rig, points, sample_idx, graphs: Optional[VerifyGraphs]):
    """One pair's body: replayed by ``graphs`` where it engages, else
    eager."""
    if graphs is not None and graphs.engages(generator, points[0], sample_idx):
        return graphs.run(cfg, rig, *points)
    if points[0].is_cuda:
        timing.count("verify.graph.eager")
    return verify_from_points(cfg, generator, *points, rig, sample_idx=sample_idx)


def verify_pair(
    cfg: VerifyConfig,
    generator: Optional[torch.Generator],
    left_a: torch.Tensor,  # (H, W) rectified grayscale float32
    right_a: torch.Tensor,
    left_b: torch.Tensor,
    right_b: torch.Tensor,
    rig: stereo.RectifiedRig,
    sample_idx=(None, None, None),
) -> VerifiedLoop:
    """Verify one stereo pair (a := earlier frame, b := later frame).
    Depth for both frames is one K3 launch on CUDA tensors."""
    res = verify_pair_batch(
        cfg, generator, left_a[None], right_a[None], left_b[None], right_b[None],
        rig, sample_idx=[sample_idx],
    )
    return VerifiedLoop(**{f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})


def verify_pair_depth(
    cfg: VerifyConfig,
    generator: Optional[torch.Generator],
    left_a: torch.Tensor,  # (H, W) grayscale float32
    depth_a: torch.Tensor,  # (H, W) metres
    left_b: torch.Tensor,
    depth_b: torch.Tensor,
    rig: stereo.RectifiedRig,
    sample_idx=(None, None, None),
    graphs: Optional[VerifyGraphs] = None,
) -> VerifiedLoop:
    """Depth-camera variant: 3D structure from the depth images directly
    (the reference's realsense/depth-topic rigs): the same matching, the
    same three-way pose and the same gates as a stereo pair (and, through
    ``graphs``, the same graph as a stereo pair of the tier and shape)."""
    pts_a, ok_a = stereo.depth_to_points(depth_a, rig, cfg.min_depth, cfg.max_depth)
    pts_b, ok_b = stereo.depth_to_points(depth_b, rig, cfg.min_depth, cfg.max_depth)
    return _verify_one(cfg, generator, rig, (left_a, pts_a, ok_a, left_b, pts_b, ok_b),
                       sample_idx, graphs)


def verify_pair_batch(
    cfg: VerifyConfig,
    generator: Optional[torch.Generator],
    left_a: torch.Tensor,  # (P, H, W)
    right_a: torch.Tensor,
    left_b: torch.Tensor,
    right_b: torch.Tensor,
    rig: stereo.RectifiedRig,
    sample_idx=None,  # per pair, a (A, B, C) triple of (H, S) or None
    graphs: Optional[VerifyGraphs] = None,
) -> VerifiedLoop:
    """P candidate pairs: stereo depth of all 2P frames in ONE K3 launch
    (on CUDA tensors), then matching and the three RANSAC poses per pair,
    replayed by ``graphs`` where it engages. Every VerifiedLoop field gains
    a leading P axis."""
    P = left_a.shape[0]
    with timing.span("verify.depth", frames=2 * P):
        pts, ok, _ = stereo.depth_pipeline_rectified(
            torch.cat([left_a, left_b]), torch.cat([right_a, right_b]), rig,
            num_disp=cfg.num_disparities, block=cfg.block_size,
        )
    results = [
        _verify_one(
            cfg, generator, rig, (left_a[p], pts[p], ok[p], left_b[p], pts[P + p], ok[P + p]),
            (None, None, None) if sample_idx is None else sample_idx[p], graphs,
        )
        for p in range(P)
    ]
    return VerifiedLoop(
        **{
            f.name: torch.stack([getattr(r, f.name) for r in results])
            for f in dataclasses.fields(VerifiedLoop)
        }
    )
