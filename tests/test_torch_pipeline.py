"""The slice as a whole: the JAX CerebroPipeline and the port's, both with
the ported descriptor and tier-1 verification, fed the same stereo stream
(tests/test_pipeline.py's scene: 14 distinct frames, then frames 2..5
revisited). They must produce the same candidates and the same accepted
edges, with edge poses within 0.5 deg and 2 cm."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.config import CerebroConfig as JCerebroConfig
from cerebro_tpu.config import DescriptorConfig as JDescriptorConfig
from cerebro_tpu.geometry import se3 as jse3
from cerebro_tpu.runtime import CerebroPipeline as JPipeline
from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch.geometry.stereo import RectifiedRig
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

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
        {"loop": {"method": "C"}},
        {"loop": {"candidates_per_query": 3}},
        {"loop": {"quantized": True}},
    ],
    ids=["gist", "wpca", "method_c", "topk", "quantized"],
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
        pipe.optimize_trajectory()
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
