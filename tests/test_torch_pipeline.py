"""The slices as a whole: the JAX CerebroPipeline and the port's, fed the
same stereo stream (tests/test_pipeline.py's scene: 14 distinct frames, then
frames 2..5 revisited).

- Method A, ported descriptor and the default verification (steerable tier
  1, then the gather-bank tier 2 for match-count failures): the same
  candidates, the same pairs escalated, the same accepted edges, with edge
  poses within 0.5 deg and 2 cm, and the same rejection gates.
- The seeded in-framework net (mobile and VGG16 trunks, f32) and the int8
  DB: the same candidates, score history and edges.
- The cascade on an approach-distance (1.54x) pair with the gather tier 1:
  escalated and accepted by tier 2 in both packages, rejected on matches
  without the scale banks.
- Method A top-3 and Methods B, C and D, on the same descriptors: the same
  candidates, score history and detection marks.
- optimize_trajectory after the same LoopEdges are put into both, over a
  synthworld survey with a kidnap and the camera mounted nadir
  (body_T_cam): the same trajectory."""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.config import CerebroConfig as JCerebroConfig
from cerebro_tpu.config import DescriptorConfig as JDescriptorConfig
from cerebro_tpu.geometry import se3 as jse3
from cerebro_tpu.runtime import CerebroPipeline as JPipeline
from cerebro_tpu.runtime.pipeline import LoopEdge as JLoopEdge
from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch import synthworld as sw
from cerebro_tpu_torch.eval import ate_rmse
from cerebro_tpu_torch.geometry.stereo import RectifiedRig
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline, LoopEdge

from test_pipeline import camera_pose, small_config, stereo_images
from test_verify import BASELINE, CX, CY, FX, FY, H, W, big_texture, make_rig

TRIG = RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=FX, fy=FY, cx=CX, cy=CY, baseline=BASELINE)


def _jax_config(tmp_path):
    cfg = small_config(tmp_path)
    # f32 descriptor: the point here is the algorithm, and bf16 rounds at
    # different places in the two frameworks
    return dataclasses.replace(
        cfg, descriptor=JDescriptorConfig(kind="ported", image_hw=(H, W), dtype="float32")
    )


def _port_config(jcfg):
    """The same settings as the port's own dataclasses."""
    return tcfg.CerebroConfig(
        **{
            f.name: getattr(tcfg, type(getattr(jcfg, f.name)).__name__)(
                **dataclasses.asdict(getattr(jcfg, f.name))
            )
            for f in dataclasses.fields(jcfg)
        }
    )


@pytest.fixture(scope="module")
def stream():
    tex = big_texture(np.random.default_rng(11), n=4096)
    frames = [stereo_images(tex, camera_pose(i)) for i in range(14)]
    out = [(float(i), frames[i], camera_pose(i)) for i in range(14)]
    out += [(20.0 + k, frames[i], camera_pose(14 + k)) for k, i in enumerate(range(2, 6))]
    return out


def _feed(pipe, stream):
    for t, (la, ra), pose in stream:
        pipe.ingest_frame(t, la, n_tracked=100, pose=pose, right_img=ra)
    pipe.flush_descriptors()


def _spy_passes(pipe):
    """One entry per verification pass the pipeline runs: (matcher, scale
    banks, whether failures may escalate, the (curr, prev) pairs)."""
    seen, real = [], pipe._verify_chunks

    def chunks(loadable, vcfg, device_batch, escalate=None, **kw):  # the port's tier=
        pairs = [(c.idx_curr, c.idx_prev) for c, _ in loadable]
        seen.append((vcfg.matcher, tuple(vcfg.scale_banks), escalate is not None, pairs))
        return real(loadable, vcfg, device_batch, escalate=escalate, **kw)

    pipe._verify_chunks = chunks
    return seen


def _escalated(passes):
    """The pairs of the tier-2 pass, the one after an escalating pass."""
    return passes[1][3] if len(passes) == 2 and passes[0][2] else []


def test_pipeline_matches_jax(tmp_path, stream):
    jcfg = _jax_config(tmp_path / "j")
    assert jcfg.verify.cascade and jcfg.verify.matcher == "steerable"  # the defaults
    jp = JPipeline(jcfg, rig=make_rig())
    _feed(jp, stream)
    tp = CerebroPipeline(_port_config(jcfg), rig=TRIG, device="cpu")
    _feed(tp, stream)

    jc = [(c.idx_curr, c.idx_prev) for c in jp.candidates]
    tc = [(c.idx_curr, c.idx_prev) for c in tp.candidates]
    assert tc == jc and len(tc) >= 1
    np.testing.assert_allclose(
        [c.score for c in tp.candidates], [c.score for c in jp.candidates], atol=1e-4
    )
    np.testing.assert_allclose(tp.score_history, jp.score_history, atol=1e-4)
    assert tp.detection_marks == jp.detection_marks

    passes_j, passes_t = _spy_passes(jp), _spy_passes(tp)
    n_j = jp.verify_pending()
    n_t = tp.verify_pending()
    assert n_t == n_j and n_t >= 1
    assert passes_t == passes_j
    assert passes_t[1][0] == "gather" and len(_escalated(passes_t)) >= 1  # tier 2 ran
    status = tp.status()
    assert status["escalated_to_tier2"] == len(_escalated(passes_t))
    tier2_edges = [e for e in tp.loop_edges if (e.idx_curr, e.idx_prev) in _escalated(passes_t)]
    assert status["tier2_accepted"] == len(tier2_edges)
    assert status["timings_ms"]["verify_tier1"]["count"] == status["timings_ms"]["verify_tier2"]["count"] == 1
    je = {(e.idx_curr, e.idx_prev): e for e in jp.loop_edges}
    te = {(e.idx_curr, e.idx_prev): e for e in tp.loop_edges}
    assert te.keys() == je.keys()
    for k, e in te.items():
        ang, tr = jse3.pose_delta_metrics(
            jnp.asarray(je[k].T_prev_curr, jnp.float32), jnp.asarray(e.T_prev_curr, jnp.float32)
        )
        assert float(ang) < 0.5 and float(tr) < 0.02, (k, float(ang), float(tr))
        assert e.n_matches == je[k].n_matches
    # the same pairs fail at the same gate; which RANSAC options fail
    # depends on each side's own random samples
    def gates(pipe):
        return [(r.idx_curr, r.idx_prev, r.reason.split(" (")[0]) for r in pipe.rejected_candidates]

    assert gates(tp) == gates(jp)

    st = tp.status()
    assert st["described"] == len(stream) and st["loop_edges"] == n_t
    tp.close()


def _base_cfg(tmp_path):
    return _port_config(_jax_config(tmp_path))


@pytest.mark.parametrize(
    "change",
    [
        {"descriptor": {"kind": "netvlad"}},
        {"descriptor": {"kind": "netvlad", "backbone": "vgg16", "image_hw": (120, 160)}},
        {"loop": {"quantized": True}},
    ],
    ids=["netvlad", "netvlad_vgg16", "quantized"],
)
def test_settings_not_ported_raise(tmp_path, stream, change):
    """Three settings that raised NotImplementedError until they were
    ported, each now run by both packages on the same stream: the seeded
    in-framework net (the default kind: mobile trunk, 16 x 256; and the
    VGG16 trunk, described at 120x160), and the int8 DB under the ported
    descriptor. The same candidates (scores within 1e-4), score history and
    edges (poses within 0.5 deg and 2 cm). The nets are untrained, so most
    candidates are wrong and fail verification: the same ones in both."""
    jcfg = _jax_config(tmp_path / "j")
    for section, kw in change.items():
        jcfg = dataclasses.replace(jcfg, **{section: dataclasses.replace(getattr(jcfg, section), **kw)})
    jp = JPipeline(jcfg, rig=make_rig())
    _feed(jp, stream)
    tp = CerebroPipeline(_port_config(jcfg), rig=TRIG, device="cpu")
    _feed(tp, stream)
    assert [(c.idx_curr, c.idx_prev) for c in tp.candidates] == [
        (c.idx_curr, c.idx_prev) for c in jp.candidates
    ]
    assert any(c.idx_curr >= 14 for c in tp.candidates)  # the revisits
    np.testing.assert_allclose(
        [c.score for c in tp.candidates], [c.score for c in jp.candidates], atol=1e-4
    )
    np.testing.assert_allclose(tp.score_history, jp.score_history, atol=1e-4)
    assert tp.detection_marks == jp.detection_marks
    assert tp.verify_pending() == jp.verify_pending() >= 1
    je = {(e.idx_curr, e.idx_prev): e for e in jp.loop_edges}
    te = {(e.idx_curr, e.idx_prev): e for e in tp.loop_edges}
    assert te.keys() == je.keys()
    for k, e in te.items():
        ang, tr = jse3.pose_delta_metrics(
            jnp.asarray(je[k].T_prev_curr, jnp.float32), jnp.asarray(e.T_prev_curr, jnp.float32)
        )
        assert float(ang) < 0.5 and float(tr) < 0.02, (k, float(ang), float(tr))
    tp.close()


def test_runtime_paths_not_ported_raise(tmp_path, stream):
    """Every runtime setting runs (the name is kept from when a mesh
    raised): a mesh of one rank gives the unsharded pipeline's candidates
    and score history (gist, tests/test_pipeline.py's config), and a depth
    image is stored (tests/test_torch_depth.py covers its verification)."""
    from test_torch_parallel import one_rank_mesh

    runs = []
    for use_mesh in (False, True):
        with one_rank_mesh() if use_mesh else contextlib.nullcontext() as mesh:
            cfg = _port_config(small_config(tmp_path))
            pipe = CerebroPipeline(cfg, rig=TRIG, mesh=mesh, device="cpu")
            assert (pipe.mesh is None) == (not use_mesh)
            _feed(pipe, stream)
            runs.append((sorted((c.idx_curr, c.idx_prev) for c in pipe.candidates),
                         list(pipe.score_history)))
            pipe.close()
    assert runs[0] == runs[1] and len(runs[0][0]) >= 1
    pipe = CerebroPipeline(_base_cfg(tmp_path), rig=TRIG, device="cpu")
    img = np.zeros((H, W), np.uint8)
    pipe.ingest_frame(0.0, img, n_tracked=100, depth_img=np.ones((H, W), np.float32))
    assert pipe.images.get("depth", 0) is not None
    pipe.close()


@pytest.mark.parametrize(
    "loop", [{"method": "A", "candidates_per_query": 33}, {"method": "B", "top_k": 33}],
    ids=["A", "B"],
)
def test_cuda_topk_above_kernel_size_raises_at_build(tmp_path, loop):
    """A top-k the CUDA kernel cannot hold fails when a CUDA pipeline is
    built, before any device work; the CPU path runs it."""
    cfg = _base_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, **loop))
    with pytest.raises(ValueError, match="largest top-k size, 32"):
        CerebroPipeline(cfg, rig=TRIG, device="cuda")
    CerebroPipeline(cfg, rig=TRIG, device="cpu").close()


def test_cuda_quantized_capacity_not_multiple_of_8_raises_at_build(tmp_path):
    """The int8 product on CUDA takes the DB's rows in multiples of 8: a
    quantized capacity that is not one fails when a CUDA pipeline is built,
    before any device work, naming the setting; the CPU path runs it, and a
    multiple of 8 passes the check."""
    cfg = _base_cfg(tmp_path)
    cfg = dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, quantized=True, db_capacity=1001)
    )
    with pytest.raises(ValueError, match="loop.db_capacity divisible by 8.*got 1001"):
        CerebroPipeline(cfg, rig=TRIG, device="cuda")
    CerebroPipeline(cfg, rig=TRIG, device="cpu").close()
    # the check alone, on a CUDA device, at 1,008 rows
    pipe = CerebroPipeline.__new__(CerebroPipeline)
    pipe.device = torch.device("cuda")
    pipe.cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, db_capacity=1008))
    pipe._check_supported(None)


def test_default_device_is_cuda(tmp_path, monkeypatch):
    """Without a device argument the pipeline runs on CUDA, and raises
    rather than fall back to the CPU when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CerebroPipeline(_base_cfg(tmp_path), rig=TRIG)


def test_image_store_removes_its_stash_dir(tmp_path):
    import os

    from cerebro_tpu_torch.db.images import ImageStore

    store = ImageStore(async_writes=True)
    d = store.stash_dir
    store.put("left", 0, np.ones((4, 4), np.uint8))
    store.stash("left", 0)
    np.testing.assert_array_equal(store.get("left", 0), np.ones((4, 4), np.uint8))
    store.flush_writes()
    assert os.path.isdir(d) and os.listdir(d)
    store.close()
    assert not os.path.exists(d)
    own = tmp_path / "mine"
    store = ImageStore(stash_dir=str(own))
    store.close()
    assert own.exists()  # a caller's directory is never removed


@pytest.fixture(scope="module")
def descriptor_batches(stream, tmp_path_factory):
    """The port's ported-descriptor batches for the stream, as the pipeline
    makes them (4 frames a batch, the last one padded)."""
    pipe = CerebroPipeline(_base_cfg(tmp_path_factory.mktemp("d")), rig=TRIG, device="cpu")
    real, out = pipe.describe_fn, []
    pipe.describe_fn = lambda imgs: out.append(real(imgs)) or out[-1]
    _feed(pipe, stream)
    pipe.close()
    return [d.numpy() for d in out]


@pytest.mark.parametrize(
    "loop",
    [{"candidates_per_query": 3}, {"method": "B"}, {"method": "C"}, {"method": "D"}],
    ids=["A_top3", "B", "C", "D"],
)
def test_topk_methods_match_jax(tmp_path, stream, descriptor_batches, loop):
    """Both pipelines replay the same descriptors: detection alone differs
    between them. Candidates exact, scores within 1e-4 (f32 sums of bf16
    products in another order), score history and marks likewise, and the
    per-query log of top-k hits."""
    jcfg = _jax_config(tmp_path / "j")
    jcfg = dataclasses.replace(jcfg, loop=dataclasses.replace(jcfg.loop, **loop))
    dim = descriptor_batches[0].shape[1]
    jb, tb = iter(descriptor_batches), iter(descriptor_batches)
    jp = JPipeline(jcfg, rig=make_rig(), describe_fn=lambda _: jnp.asarray(next(jb)), describe_dim=dim)
    tp = CerebroPipeline(
        _port_config(jcfg), rig=TRIG, describe_fn=lambda _: torch.from_numpy(next(tb)),
        describe_dim=dim, device="cpu",
    )
    jp.log_queries = tp.log_queries = True
    _feed(jp, stream)
    _feed(tp, stream)

    jc = [(c.idx_curr, c.idx_prev) for c in jp.candidates]
    tc = [(c.idx_curr, c.idx_prev) for c in tp.candidates]
    assert tc == jc
    np.testing.assert_allclose(
        [c.score for c in tp.candidates], [c.score for c in jp.candidates], atol=1e-4
    )
    np.testing.assert_allclose(tp.score_history, jp.score_history, atol=1e-4)
    assert tp.detection_marks == jp.detection_marks
    assert [q[:2] + q[3:] for q in tp.query_log] == [q[:2] + q[3:] for q in jp.query_log]
    np.testing.assert_allclose(
        [q[2] for q in tp.query_log], [q[2] for q in jp.query_log], atol=1e-4
    )
    assert len(tc) >= 1  # the revisit fired
    assert bool(tp.query_log) == ("candidates_per_query" in loop)  # Method A logs
    tp.close()


def _kidnap_survey():
    """A 160-frame synthworld survey of 2 laps with the default kidnap:
    drifting odometry, poses withheld inside the kidnap span, world 1
    restarting in its own frame."""
    return sw.make_sequence(n_frames=160, laps=2.0)


def _survey_edges(seq, make_edge):
    """Ground-truth loop edges between frames 60+ apart within 0.6 m,
    within and across the two worlds (camera frames: prev_T_curr)."""
    k0, k1 = seq.kidnap_span
    posed = [i for i in range(len(seq.xy)) if not k0 <= i < k1]
    edges = []
    for c in posed:
        for p in posed:
            if p + 60 <= c and np.linalg.norm(seq.xy[c] - seq.xy[p]) < 0.6:
                T = np.linalg.inv(seq.gt_poses[p]) @ seq.gt_poses[c]
                edges.append(
                    make_edge(
                        stamp_curr=float(seq.stamps[c]), stamp_prev=float(seq.stamps[p]),
                        idx_curr=c, idx_prev=p, T_prev_curr=T.astype(np.float64),
                        weight=1.0, n_matches=300,
                    )
                )
                break
    return edges[::3]


@pytest.mark.parametrize(
    "posegraph,atol",
    # 5 GN steps of 8 CG iterations: the solve is a smooth function of its
    # inputs there (tests/test_torch_posegraph.py); at small_config's 10 x
    # 60 the CG stopping test can decide between large steps, so the two
    # packages are held to the same basin only
    [({"max_gn_iters": 5, "cg_iters": 8}, 1e-3), ({}, 0.15)],
    ids=["parity", "small_config"],
)
def test_optimize_trajectory_matches_jax(tmp_path, posegraph, atol):
    seq = _kidnap_survey()
    jcfg = _jax_config(tmp_path / "j")
    jcfg = dataclasses.replace(jcfg, posegraph=dataclasses.replace(jcfg.posegraph, **posegraph))
    b_T_c = sw.body_T_cam()
    jp = JPipeline(jcfg, rig=make_rig(), body_T_cam=b_T_c)
    tp = CerebroPipeline(_port_config(jcfg), rig=TRIG, body_T_cam=b_T_c, device="cpu")
    k0, k1 = seq.kidnap_span
    img = np.zeros((4, 4), np.uint8)
    for pipe in (jp, tp):
        for i in range(len(seq.xy)):
            pipe.ingest_frame(
                float(seq.stamps[i]), img, n_tracked=int(seq.n_tracked[i]),
                pose=None if k0 <= i < k1 else seq.odom_poses[i],
                is_keyframe=bool(seq.is_keyframe[i]), describe_eligible=False,
            )
    assert tp.kidnap.world_id == jp.kidnap.world_id == 1
    jp.loop_edges = _survey_edges(seq, JLoopEdge)
    tp.loop_edges = _survey_edges(seq, LoopEdge)
    worlds = tp.store.world_id
    assert any(worlds[e.idx_curr] != worlds[e.idx_prev] for e in tp.loop_edges)

    want = jp.optimize_trajectory()
    got = tp.optimize_trajectory()
    assert got.shape == want.shape == (int(tp.store.pose_valid.sum()), 4, 4)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=atol, rtol=0)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=atol, rtol=0)
    # and the solve did its work: both worlds merged near ground truth
    kf = np.nonzero(tp.store.pose_valid[: tp.store.size])[0]
    gt = seq.gt_poses[kf][:, :3, 3]
    assert ate_rmse(got[:, :3, 3], gt) < 0.5 * ate_rmse(tp.store.poses[kf][:, :3, 3], gt)
    tp.close()


def _approach_pair():
    """tests/test_pipeline.py's approach-distance pair: frame b 1.4 m
    closer along z (1.54x the scale of the near plane), as uint8 images."""
    from test_verify import stereo_pair

    tex = big_texture(np.random.default_rng(5))
    Ta = np.eye(4, dtype=np.float32)
    Tb = np.eye(4, dtype=np.float32)
    Tb[2, 3] = 1.4
    to8 = lambda x: np.clip(np.asarray(x) * 255, 0, 255).astype(np.uint8)
    return (Ta, *(to8(x) for x in stereo_pair(tex, Ta))), (Tb, *(to8(x) for x in stereo_pair(tex, Tb)))


def _verify_injected(pipe, pair_a, pair_b, raw_candidate):
    """Ingest the two frames, then verify the one injected candidate (this
    drives verification, not detection). Returns (accepted, tier-2 pairs)."""
    for t, (T, left, right) in ((0.0, pair_a), (30.0, pair_b)):
        pipe.ingest_frame(t, left, n_tracked=100, pose=T, right_img=right)
    pipe.flush_descriptors()
    pipe._drain_detections()
    pipe._candidates = [raw_candidate(idx_curr=1, idx_prev=0, score=0.9)]
    passes = _spy_passes(pipe)
    return pipe.verify_pending(), passes


@pytest.mark.parametrize("cascade", [True, False], ids=["cascade", "single_scale"])
def test_verify_cascade_escalates_scale_change(tmp_path, cascade):
    """tests/test_pipeline.py::test_verify_cascade_escalates_scale_change in
    both packages: with the gather tier 1 the 1.54x approach pair fails on
    match count, escalates, and tier 2 accepts it with t_z within 0.15 of
    1.4; with cascade=False and scale_banks=(1.0,) it is rejected on
    matches. The packages accept the same pairs."""
    from cerebro_tpu.runtime.pipeline import RawCandidate as JRawCandidate
    from cerebro_tpu_torch.runtime.pipeline import RawCandidate

    jcfg = small_config(tmp_path / "j")
    verify = dict(min_matches_attempt=110, min_matches_accept=120, icp_inlier_error=0.2,
                  matcher="gather")
    if not cascade:
        verify.update(scale_banks=(1.0,), cascade=False)
    jcfg = dataclasses.replace(jcfg, verify=dataclasses.replace(jcfg.verify, **verify))
    assert jcfg.verify.cascade == cascade
    dim = 16
    unit = np.full((4, dim), 0.25, np.float32)  # the candidate is injected
    jp = JPipeline(jcfg, rig=make_rig(), describe_fn=lambda _: jnp.asarray(unit), describe_dim=dim)
    tp = CerebroPipeline(
        _port_config(jcfg), rig=TRIG, describe_fn=lambda _: torch.from_numpy(unit),
        describe_dim=dim, device="cpu",
    )
    pair_a, pair_b = _approach_pair()
    n_j, passes_j = _verify_injected(jp, pair_a, pair_b, JRawCandidate)
    n_t, passes_t = _verify_injected(tp, pair_a, pair_b, RawCandidate)
    assert passes_t == passes_j
    assert _escalated(passes_t) == ([(1, 0)] if cascade else [])
    assert n_t == n_j == int(cascade)
    assert tp.status()["escalated_to_tier2"] == tp.status()["tier2_accepted"] == int(cascade)
    assert ("verify_tier2" in tp.timer.stats()) == cascade
    if cascade:
        T = tp.loop_edges[0].T_prev_curr
        assert abs(T[2, 3] - 1.4) < 0.15, T
    else:
        assert len(tp.rejected_candidates) == 1
        assert "matches" in tp.rejected_candidates[0].reason
        assert tp.rejected_candidates[0].reason == jp.rejected_candidates[0].reason
    tp.close()


def test_run_sequence_verifies_at_the_default_config(tmp_path, stream):
    """eval.run_sequence(verify=True) drives verify_pending with the
    default VerifyConfig (the cascade on) to the same edges as JAX's."""
    from cerebro_tpu import eval as jeval
    from cerebro_tpu_torch import eval as teval

    class Frame:
        def __init__(self, t, la, ra, pose):
            self.stamp, self._l, self._r, self.pose = t, la, ra, pose

        def left(self):
            return self._l

        def right(self):
            return self._r

    frames = [Frame(t, la, ra, pose) for t, (la, ra), pose in stream]
    jcfg = _jax_config(tmp_path / "j")
    assert jcfg.verify.cascade
    jp = JPipeline(jcfg, rig=make_rig())
    tp = CerebroPipeline(_port_config(jcfg), rig=TRIG, device="cpu")
    rj = jeval.run_sequence(jp, frames, verify=True)
    rt = teval.run_sequence(tp, frames, verify=True)
    assert rt.n_loop_edges == rj.n_loop_edges >= 1
    assert rt.n_candidates == rj.n_candidates == 0  # all verified
    assert {(e.idx_curr, e.idx_prev) for e in tp.loop_edges} == {
        (e.idx_curr, e.idx_prev) for e in jp.loop_edges
    }
    tp.close()


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------


def _gist_cfg(tmp_path, **loop):
    cfg = _port_config(small_config(tmp_path))
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, **loop)) if loop else cfg


def test_warmed_pipeline_equals_cold(tmp_path, stream):
    """tests/test_pipeline.py:642-675 and more: a pipeline warmed with every
    kind of warm call (detect, verify in both tiers, a pose-graph solve)
    gives the same candidates and the same edges, bit for bit, as a cold
    one, and warmup leaves the verification generator where it was."""

    def run(warm: bool):
        pipe = CerebroPipeline(_gist_cfg(tmp_path), rig=TRIG, device="cpu")
        state = pipe._generator.get_state().clone()
        if warm:
            detail = pipe.warmup(verify_device_batches=(2,), optimize_node_buckets=(32,))
            assert set(detail) >= {"describe", "detect", "optimize_n32_l32", "verify_tier2_batch2"}
            assert torch.equal(pipe._generator.get_state(), state)
            assert pipe.store.size == 0 and not pipe.db_gid_to_store
            assert pipe.db.count == pipe.db.total == 0
            assert not pipe.loop_edges and not pipe.rejected_candidates
            assert pipe.escalated_to_tier2 == pipe.tier2_accepted == 0
            assert pipe.timer.stats() == {}
        _feed(pipe, stream)
        cands = [(c.idx_curr, c.idx_prev, c.score) for c in pipe.candidates]
        pipe.verify_pending()
        edges = [(e.idx_curr, e.idx_prev, e.T_prev_curr, e.n_matches) for e in pipe.loop_edges]
        rejected = [(r.idx_curr, r.idx_prev, r.reason) for r in pipe.rejected_candidates]
        pipe.close()
        return cands, edges, rejected

    (cw, ew, rw), (cc, ec, rc) = run(warm=True), run(warm=False)
    assert cw == cc and len(cw) >= 1
    assert rw == rc
    assert len(ew) == len(ec) >= 1
    for a, b in zip(ew, ec):
        assert a[:2] == b[:2] and a[3] == b[3]
        np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("loop", [{}, {"candidates_per_query": 3}, {"method": "D"}], ids=["A", "A_top3", "D"])
def test_warmup_leaves_a_wrapped_ring_untouched(tmp_path, loop):
    """More rows appended than the DB holds: the ring has wrapped, and its
    oldest rows sit where warmup's zero-valid append would land (the port's
    append writes in place). Every DB field and detection carry is
    bit-equal after warmup."""
    import copy

    pipe = CerebroPipeline(_gist_cfg(tmp_path, db_capacity=8, **loop), rig=TRIG, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(13):
        pipe.ingest_frame(float(i), rng.integers(0, 255, (H, W)).astype(np.uint8), n_tracked=100)
    pipe.flush_descriptors()
    assert pipe.db.total == 13 > pipe.db.capacity == pipe.db.count == 8
    db = (pipe.db.vectors.clone(), pipe.db.global_ids.clone(), pipe.db.total, pipe.db.count)
    carries = copy.deepcopy((pipe.det_state, pipe.det_state_b, pipe.clique_state,
                             pipe.topk_state, pipe.hyp_table))
    live_db = pipe.db
    pipe.warmup()
    assert pipe.db is live_db
    assert torch.equal(pipe.db.vectors, db[0]) and torch.equal(pipe.db.global_ids, db[1])
    assert (pipe.db.total, pipe.db.count) == db[2:]
    after = (pipe.det_state, pipe.det_state_b, pipe.clique_state, pipe.topk_state, pipe.hyp_table)
    for a, b in zip(after, carries):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    pipe.close()


def test_warmup_keys_match_jax(tmp_path):
    """The same arguments give the JAX package's keys, and the same verify
    warm calls (tier, group size) through the live dispatch path."""
    kw = dict(verify_device_batches=(2, 8), optimize_node_buckets=(16,), optimize_loop_buckets=(16, 32))
    jcfg = small_config(tmp_path / "j")
    jp = JPipeline(jcfg, rig=make_rig())
    tp = CerebroPipeline(_port_config(jcfg), rig=TRIG, device="cpu")
    calls, tiers = {}, []
    for name, pipe in (("jax", jp), ("torch", tp)):
        seen = calls[name] = []
        pipe._verify_chunks = (
            lambda loadable, vcfg, device_batch, escalate=None, seen=seen, **t:
            seen.append((vcfg.matcher, len(loadable), device_batch)) or tiers.append(t) or 0
        )
    want, got = jp.warmup(**kw), tp.warmup(**kw)
    assert set(got) == set(want)
    assert calls["torch"] == calls["jax"] == [
        (m, n, n) for m in ("steerable", "gather") for n in (1, 2, 8)
    ]
    # the port's warm calls carry their cascade tier (the JAX package's none)
    assert tiers == [{}] * 6 + [{"tier": t} for t in (1, 2) for _ in range(3)]
    assert got["total"] >= max(v for k, v in got.items() if k != "total")
    tp.close()
