"""Teach and repeat through the port's checkpoint (cerebro_tpu_torch/io/
state.py) beside the JAX package's, on tests/test_checkpoint.py's scene.

Both packages teach 10 frames, save, load into a fresh pipeline and
relocalize 3 revisiting frames against the loaded map:

- the same candidates into the taught map and the same relocalization
  edges (index pairs) and rejection gates after verify_pending;
- the loaded keyframe store and DB equal the saved ones;
- the manifests have the same keys and values;
- a quantized manifest raises NotImplementedError naming Queue 1 item 7,
  and a checkpoint of another descriptor width raises ValueError."""

import json
import os

import numpy as np
import pytest
import torch

from cerebro_tpu.io import load_pipeline_state as jload
from cerebro_tpu.io import save_pipeline_state as jsave
from cerebro_tpu.runtime import CerebroPipeline as JPipeline
from cerebro_tpu_torch.io import load_pipeline_state, save_pipeline_state
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

from test_pipeline import camera_pose, scene, small_config  # noqa: F401
from test_torch_pipeline import TRIG, _port_config
from test_verify import make_rig


def _teach(pipe, scene):  # noqa: F811
    for i in range(10):
        la, ra = scene[i]
        pipe.ingest_frame(float(i), la, n_tracked=100, pose=camera_pose(i), right_img=ra)
    pipe.flush_descriptors()


def _repeat(pipe, scene):  # noqa: F811
    for k, i in enumerate(range(3, 6)):
        la, ra = scene[i]
        pipe.ingest_frame(100.0 + k, la, n_tracked=100, pose=None, right_img=ra)
    pipe.flush_descriptors()


def _gates(pipe):
    return [(r.idx_curr, r.idx_prev, r.reason.split(" (")[0]) for r in pipe.rejected_candidates]


@pytest.fixture(scope="module")
def taught(tmp_path_factory, scene):  # noqa: F811
    tmp = tmp_path_factory.mktemp("state")
    jcfg, tcfg = small_config(tmp / "j"), _port_config(small_config(tmp / "t"))
    jp = JPipeline(jcfg, rig=make_rig())
    _teach(jp, scene)
    jsave(jp, str(tmp / "jax_ckpt"))
    tp = CerebroPipeline(tcfg, rig=TRIG, device="cpu")
    _teach(tp, scene)
    save_pipeline_state(tp, str(tmp / "port_ckpt"))
    yield tmp, jcfg, tcfg, jp, tp
    tp.close()


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_manifest_matches_jax(taught):
    tmp, _, _, _, _ = taught
    jm, tm = _manifest(tmp / "jax_ckpt"), _manifest(tmp / "port_ckpt")
    assert tm == jm
    assert tm["format_version"] == 2 and tm["descriptor_dim"] == 256
    for name in ("keyframes.npz", "descriptor_db.npz", "images"):
        assert os.path.exists(tmp / "port_ckpt" / name), name


def test_teach_and_repeat_matches_jax(taught, scene):  # noqa: F811
    tmp, jcfg, tcfg, _, teach = taught
    jr = jload(str(tmp / "jax_ckpt"), cfg=jcfg, rig=make_rig(), stash_dir=str(tmp / "js2"))
    tr = load_pipeline_state(
        str(tmp / "port_ckpt"), cfg=tcfg, rig=TRIG, stash_dir=str(tmp / "ts2"), device="cpu"
    )
    assert tr.status()["described"] == 10 and tr.db.count == 10 and tr.store.size == 10

    # the loaded map equals the saved one
    saved, loaded = teach.store.to_state_dict(), tr.store.to_state_dict()
    assert saved.keys() == loaded.keys()
    for k in saved:
        np.testing.assert_array_equal(loaded[k], saved[k], err_msg=k)
    assert torch.equal(tr.db.vectors, teach.db.vectors)
    assert torch.equal(tr.db.global_ids, teach.db.global_ids)
    assert (tr.db.total, tr.db_gid_to_store) == (teach.db.total, teach.db_gid_to_store)
    assert tr.kidnap.info() == teach.kidnap.info()

    _repeat(jr, scene)
    _repeat(tr, scene)
    jc = [(c.idx_curr, c.idx_prev) for c in jr.candidates]
    tc = [(c.idx_curr, c.idx_prev) for c in tr.candidates]
    assert tc == jc and len(tc) >= 1
    assert all(c >= 10 > p for c, p in tc)  # new session -> taught map
    np.testing.assert_allclose(
        [c.score for c in tr.candidates], [c.score for c in jr.candidates], atol=1e-4
    )
    n_j, n_t = jr.verify_pending(), tr.verify_pending()
    assert n_t == n_j and n_t >= 1
    assert [(e.idx_curr, e.idx_prev) for e in tr.loop_edges] == [
        (e.idx_curr, e.idx_prev) for e in jr.loop_edges
    ]
    assert _gates(tr) == _gates(jr)
    tr.close()


def test_quantized_checkpoint_raises(taught, tmp_path):
    tmp, _, tcfg, _, _ = taught
    m = _manifest(tmp / "port_ckpt")
    m["db_quantized"] = True
    d = tmp_path / "q"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(NotImplementedError, match="item 7"):
        load_pipeline_state(str(d), cfg=tcfg, rig=TRIG, device="cpu")


def test_descriptor_width_mismatch_raises(taught, tmp_path):
    import dataclasses

    tmp, _, tcfg, _, _ = taught
    narrow = dataclasses.replace(tcfg, descriptor=dataclasses.replace(tcfg.descriptor, trunk_dim=32))
    with pytest.raises(ValueError, match="descriptor dim mismatch"):
        load_pipeline_state(str(tmp / "port_ckpt"), cfg=narrow, rig=TRIG, device="cpu")
