"""Teach and repeat through the port's checkpoint (cerebro_tpu_torch/io/
state.py) beside the JAX package's, on tests/test_checkpoint.py's scene.

Both packages teach 10 frames, save, load into a fresh pipeline and
relocalize 3 revisiting frames against the loaded map:

- the same candidates into the taught map and the same relocalization
  edges (index pairs) and rejection gates after verify_pending;
- the loaded keyframe store and DB equal the saved ones;
- the manifests have the same keys and values;
- the int8 DB's teach and repeat: the same DB, manifest, candidates and
  edges as JAX's;
- the trained synth net's teach and repeat, its weights passed to the
  load as ``params=``: the same candidates as JAX's;
- a quantized checkpoint under a float config raises ValueError, and so
  does the reverse and a checkpoint of another descriptor width."""

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

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "artifacts")


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


def _quantized(cfg):
    import dataclasses

    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, quantized=True))


def test_quantized_teach_and_repeat_matches_jax(tmp_path, scene):  # noqa: F811
    """tests/test_checkpoint.py's quantized teach and repeat in both
    packages: the taught int8 DB (values and ids identical, scales within
    1e-5) JAX's,
    the manifests equal, the loaded DB equal to the saved one, and the
    relocalization's candidates and edges JAX's."""
    jcfg = _quantized(small_config(tmp_path / "j"))
    tcfg = _port_config(jcfg)
    jp = JPipeline(jcfg, rig=make_rig())
    _teach(jp, scene)
    jsave(jp, str(tmp_path / "jax_q"))
    tp = CerebroPipeline(tcfg, rig=TRIG, device="cpu")
    _teach(tp, scene)
    save_pipeline_state(tp, str(tmp_path / "port_q"))
    np.testing.assert_array_equal(tp.db.global_ids.numpy(), np.asarray(jp.db.global_ids))
    # the taught rows (the last batch's unmatchable tail holds gist of the
    # zero padding images, which is noise in both packages). The two
    # packages' gist descriptors differ in their last bits, so the scales
    # agree to 1e-5 relative; on the same rows they are the same bits
    # (tests/test_torch_int8.py)
    n = 10
    np.testing.assert_array_equal(tp.db.values[:n].numpy(), np.asarray(jp.db.values)[:n])
    np.testing.assert_allclose(tp.db.scales[:n].numpy(), np.asarray(jp.db.scales)[:n], rtol=1e-5)
    assert _manifest(tmp_path / "port_q") == _manifest(tmp_path / "jax_q")
    assert _manifest(tmp_path / "port_q")["db_quantized"] is True

    jr = jload(str(tmp_path / "jax_q"), cfg=jcfg, rig=make_rig(), stash_dir=str(tmp_path / "js"))
    tr = load_pipeline_state(
        str(tmp_path / "port_q"), cfg=tcfg, rig=TRIG, stash_dir=str(tmp_path / "ts"), device="cpu"
    )
    assert tr.db.count == 10 and tr.db.total == 10
    for f in ("values", "scales", "global_ids"):
        assert torch.equal(getattr(tr.db, f), getattr(tp.db, f)), f
    _repeat(jr, scene)
    _repeat(tr, scene)
    tc = [(c.idx_curr, c.idx_prev) for c in tr.candidates]
    assert tc == [(c.idx_curr, c.idx_prev) for c in jr.candidates]
    assert any(p < 10 <= c for c, p in tc)
    np.testing.assert_allclose(
        [c.score for c in tr.candidates], [c.score for c in jr.candidates], atol=1e-4
    )
    assert tr.verify_pending() == jr.verify_pending()
    assert [(e.idx_curr, e.idx_prev) for e in tr.loop_edges] == [
        (e.idx_curr, e.idx_prev) for e in jr.loop_edges
    ]
    tp.close()
    tr.close()


def test_trained_netvlad_teach_and_repeat_matches_jax(tmp_path, scene):  # noqa: F811
    """The trained synth net (flax checkpoint in JAX, its npz in the port)
    through teach, save, and a load that takes the weights as ``params=``,
    as the JAX package's load_pipeline_state does: the same candidates into
    the taught map."""
    import dataclasses

    from cerebro_tpu.models.descriptor import load_descriptor_params as jload_params
    from cerebro_tpu_torch.models.descriptor import load_descriptor_params

    base = small_config(tmp_path / "j")
    jcfg = dataclasses.replace(base, descriptor=dataclasses.replace(
        base.descriptor, kind="netvlad", trunk_dim=64, num_clusters=4, dtype="float32"))
    tcfg = _port_config(jcfg)
    _, jparams = jload_params(os.path.join(ARTIFACTS, "descriptor_synth"), jcfg.descriptor)
    _, tparams = load_descriptor_params(
        os.path.join(ARTIFACTS, "descriptor_synth_npz"), tcfg.descriptor, device="cpu"
    )
    jp = JPipeline(jcfg, rig=make_rig(), params=jparams)
    _teach(jp, scene)
    jsave(jp, str(tmp_path / "jax_n"))
    tp = CerebroPipeline(tcfg, rig=TRIG, params=tparams, device="cpu")
    _teach(tp, scene)
    save_pipeline_state(tp, str(tmp_path / "port_n"))
    jr = jload(str(tmp_path / "jax_n"), cfg=jcfg, rig=make_rig(), params=jparams,
               stash_dir=str(tmp_path / "js"))
    tr = load_pipeline_state(str(tmp_path / "port_n"), cfg=tcfg, rig=TRIG, params=tparams,
                             stash_dir=str(tmp_path / "ts"), device="cpu")
    assert all(torch.equal(tr.params[k], tparams[k]) for k in tparams)
    _repeat(jr, scene)
    _repeat(tr, scene)
    tc = [(c.idx_curr, c.idx_prev) for c in tr.candidates]
    assert tc == [(c.idx_curr, c.idx_prev) for c in jr.candidates]
    assert any(p < 10 <= c for c, p in tc)
    tp.close()
    tr.close()


def test_quantized_checkpoint_raises(taught, tmp_path):
    """A quantized checkpoint loaded under a float config raises, as the
    JAX package's assert does."""
    tmp, _, tcfg, _, _ = taught
    m = _manifest(tmp / "port_ckpt")
    m["db_quantized"] = True
    d = tmp_path / "q"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="checkpoint is quantized"):
        load_pipeline_state(str(d), cfg=tcfg, rig=TRIG, device="cpu")


def test_float_checkpoint_raises_under_quantized_config(taught):
    tmp, _, tcfg, _, _ = taught
    with pytest.raises(ValueError, match="checkpoint is not quantized"):
        load_pipeline_state(str(tmp / "port_ckpt"), cfg=_quantized(tcfg), rig=TRIG, device="cpu")


def test_descriptor_width_mismatch_raises(taught, tmp_path):
    import dataclasses

    tmp, _, tcfg, _, _ = taught
    narrow = dataclasses.replace(tcfg, descriptor=dataclasses.replace(tcfg.descriptor, trunk_dim=32))
    with pytest.raises(ValueError, match="descriptor dim mismatch"):
        load_pipeline_state(str(tmp / "port_ckpt"), cfg=narrow, rig=TRIG, device="cpu")
