"""The slices as a whole: the JAX CerebroPipeline and the port's, fed the
same stereo stream (tests/test_pipeline.py's scene: 14 distinct frames, then
frames 2..5 revisited).

- Method A, ported descriptor and tier-1 verification: the same candidates
  and the same accepted edges, with edge poses within 0.5 deg and 2 cm.
- Method A top-3 and Methods B, C and D, on the same descriptors: the same
  candidates, score history and detection marks.
- optimize_trajectory after the same LoopEdges are put into both, over a
  synthworld survey with a kidnap and the camera mounted nadir
  (body_T_cam): the same trajectory."""

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
        cfg,
        descriptor=JDescriptorConfig(kind="ported", image_hw=(H, W), dtype="float32"),
        verify=dataclasses.replace(cfg.verify, cascade=False),
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


def test_pipeline_matches_jax(tmp_path, stream):
    jcfg = _jax_config(tmp_path / "j")
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

    n_j = jp.verify_pending(cascade=False)
    n_t = tp.verify_pending(cascade=False)
    assert n_t == n_j and n_t >= 1
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
        {"descriptor": {"kind": "gist"}},
        {"descriptor": {"wpca_artifact": "x.npz"}},
        {"loop": {"quantized": True}},
    ],
    ids=["gist", "wpca", "quantized"],
)
def test_settings_not_ported_raise(tmp_path, change):
    cfg = _base_cfg(tmp_path)
    for section, kw in change.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})
    with pytest.raises(NotImplementedError):
        CerebroPipeline(cfg, rig=TRIG, device="cpu")


def test_runtime_paths_not_ported_raise(tmp_path):
    cfg = _base_cfg(tmp_path)
    with pytest.raises(NotImplementedError):
        CerebroPipeline(cfg, rig=TRIG, mesh=object(), device="cpu")
    pipe = CerebroPipeline(cfg, rig=TRIG, device="cpu")
    img = np.zeros((H, W), np.uint8)
    with pytest.raises(NotImplementedError):
        pipe.ingest_frame(0.0, img, n_tracked=100, depth_img=np.ones((H, W), np.float32))
    with pytest.raises(NotImplementedError):
        pipe.verify_pending(cascade=True)
    cascading = dataclasses.replace(cfg, verify=dataclasses.replace(cfg.verify, cascade=True))
    with pytest.raises(NotImplementedError):
        CerebroPipeline(cascading, rig=TRIG, device="cpu").verify_pending()
    pipe.close()


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
