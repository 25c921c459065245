"""The port's gist descriptor and WPCA stage against the JAX package's
(cerebro_tpu_torch/models/gist.py, models/wpca.py), and their wiring into
the pipeline.

- gist_descriptors within 1e-5 at (4, 32, 64) and (2, 240, 320), 3-d and
  4-d input;
- fit_wpca within 1e-6 at tests/test_wpca.py's settings, the rank cap to
  15 included; apply_wpca within 1e-5; a JAX-saved npz loads in the port
  and gives the same output, and a port-saved one loads in JAX;
- a pipeline with kind="gist" and a WPCA artifact of out_dim 16 and of the
  unaligned 15: the DB's logical dim is out_dim, ingest and detect run;
- a DB whose rows are stored zero-padded to a multiple of 8 (as a CUDA DB
  of width 15 stores them) gives the plain search's exact matches;
- a gist pipeline over tests/test_pipeline.py's scene: the same candidates
  and scores as the JAX pipeline's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.models import gist as jgist
from cerebro_tpu.models import wpca as jwpca
from cerebro_tpu.runtime import CerebroPipeline as JPipeline
from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch.db import descriptors as ddb
from cerebro_tpu_torch.models import gist as tgist
from cerebro_tpu_torch.models import wpca as twpca
from cerebro_tpu_torch.ops import similarity as sim
from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

from test_pipeline import camera_pose, scene, small_config  # noqa: F401
from test_torch_pipeline import _port_config


@pytest.mark.parametrize("shape,dim,four_d", [((4, 32, 64), 64, False), ((2, 240, 320), 256, True)])
def test_gist_matches_jax(shape, dim, four_d, rng):
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    if four_d:
        imgs = imgs[..., None]
    j = np.asarray(jgist.gist_descriptors(jnp.asarray(imgs), dim=dim))
    t = tgist.gist_descriptors(torch.from_numpy(imgs), dim=dim)
    assert t.dtype == torch.float32 and t.shape == (shape[0], dim)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=0)


def _bank(rng, n=96, d=256):
    basis = rng.normal(size=(8, d))
    return rng.normal(size=(n, 8)) @ basis * 5.0 + rng.normal(size=(n, d))


@pytest.mark.parametrize(
    "n,kw", [(96, dict(out_dim=32, power=0.5, shrinkage=0.0)), (16, dict(out_dim=32)), (96, dict(out_dim=32))],
    ids=["whitened", "rank_capped", "default"],
)
def test_wpca_fit_apply_match_jax(n, kw, rng):
    bank = _bank(rng)[:n]
    jw, tw = jwpca.fit_wpca(bank, **kw), twpca.fit_wpca(bank, **kw)
    assert tw.out_dim == jw.out_dim == (15 if n == 16 else 32)
    np.testing.assert_allclose(tw.mean, np.asarray(jw.mean), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tw.proj, np.asarray(jw.proj), atol=1e-6, rtol=0)
    x = bank[:5].astype(np.float32)
    ja = np.asarray(jwpca.apply_wpca(jw, jnp.asarray(x)))
    ta = twpca.apply_wpca(tw, torch.from_numpy(x))
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ta.numpy(), axis=1), 1.0, atol=1e-5)


def test_wpca_npz_crosses_packages(tmp_path, rng):
    bank = _bank(rng)
    x = bank[:6].astype(np.float32)
    jw = jwpca.fit_wpca(bank, out_dim=24)
    jwpca.save_wpca(jw, str(tmp_path / "jax.npz"))
    tw = twpca.load_wpca(str(tmp_path / "jax.npz"))
    want = np.asarray(jwpca.apply_wpca(jw, jnp.asarray(x)))
    np.testing.assert_allclose(twpca.apply_wpca(tw, torch.from_numpy(x)).numpy(), want, atol=1e-5, rtol=0)
    fn = twpca.whitened_describe_fn(lambda imgs: torch.from_numpy(x), tw)
    np.testing.assert_allclose(fn(None).numpy(), want, atol=1e-5, rtol=0)

    twpca.save_wpca(twpca.fit_wpca(bank, out_dim=24), str(tmp_path / "port.npz"))
    back = jwpca.load_wpca(str(tmp_path / "port.npz"))
    np.testing.assert_allclose(np.asarray(jwpca.apply_wpca(back, jnp.asarray(x))), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("out_dim", [16, 15])
def test_pipeline_wpca_wiring(tmp_path, rng, out_dim):
    imgs = rng.integers(0, 255, (40, 32, 64, 1), dtype=np.uint8)
    bank = tgist.gist_descriptors(torch.from_numpy(imgs), dim=128).numpy()
    wp = twpca.fit_wpca(bank, out_dim=out_dim)
    path = str(tmp_path / "wpca.npz")
    twpca.save_wpca(wp, path)
    cfg = tcfg.CerebroConfig(
        descriptor=tcfg.DescriptorConfig(
            image_hw=(32, 64), kind="gist", num_clusters=1, trunk_dim=128, wpca_artifact=path,
        ),
        loop=tcfg.LoopConfig(db_capacity=128, exclusion_window=2),
        runtime=tcfg.RuntimeConfig(descriptor_batch=4, stash_dir=str(tmp_path / "stash")),
    )
    pipe = CerebroPipeline(cfg, device="cpu")
    assert pipe.db.dim == out_dim
    for t in range(12):
        pipe.ingest_frame(float(t), imgs[t % 6, :, :, 0], n_tracked=50)
    pipe.flush_descriptors()
    assert len(pipe.db_gid_to_store) == 12
    assert pipe.timer.stats()["detect"]["count"] == 3
    rows = pipe.db.vectors[:12].float()
    np.testing.assert_allclose(rows.norm(dim=1).numpy(), 1.0, atol=5e-3)
    pipe.close()


@pytest.mark.parametrize("dim", [15, 191, 200])
def test_padded_db_gives_the_plain_matches(dim, rng):
    """A DB of width ``dim`` stored as a CUDA DB stores it (rows
    zero-padded to a multiple of 8), searched with queries padded by
    ``pad_queries``: the same gids and scores as the unpadded DB."""
    assert ddb.row_width(dim, "cuda") == -(-dim // 8) * 8 and ddb.row_width(dim, "cpu") == dim
    N, Q = 300, 9
    flat = ddb.create(N, dim, device="cpu")
    padded = ddb.DescriptorDB(
        vectors=torch.zeros((N, ddb.row_width(dim, "cuda")), dtype=torch.bfloat16),
        global_ids=torch.full((N,), ddb.GID_INVALID, dtype=torch.int32),
        logical_dim=dim,
    )
    assert padded.dim == dim and flat.dim == dim
    descs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(N, dim))).float(), dim=1)
    for db in (flat, padded):
        for i in range(0, N, 60):
            ddb.append(db, descs[i : i + 60], 60)
    assert torch.equal(padded.vectors[:, dim:], torch.zeros_like(padded.vectors[:, dim:]))
    q = descs[rng.choice(N, Q, replace=False)]
    lim = torch.full((Q,), N, dtype=torch.int32)
    lim[3] = 40
    a = sim.max_and_argmax(q, flat.vectors, lim, flat.global_ids)
    b = sim.max_and_argmax(ddb.pad_queries(padded, q), padded.vectors, lim, padded.global_ids)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    a = sim.search_topk(q, flat.vectors, lim, flat.global_ids, k=3)
    b = sim.search_topk(ddb.pad_queries(padded, q), padded.vectors, lim, padded.global_ids, k=3)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    with pytest.raises(ValueError):
        ddb.pad_queries(padded, q[:, :-1])


def test_gist_pipeline_matches_jax(tmp_path, scene):  # noqa: F811
    jcfg = small_config(tmp_path / "j")
    assert jcfg.descriptor.kind == "gist"
    tcfg_ = _port_config(small_config(tmp_path / "t"))

    def feed(pipe):
        t = 0.0
        for i in range(14):
            pipe.ingest_frame(t, scene[i][0], n_tracked=100, pose=camera_pose(i))
            t += 1.0
        for i in range(2, 6):  # revisits, beyond the exclusion window and the Δt gate
            pipe.ingest_frame(t, scene[i][0], n_tracked=100, pose=camera_pose(14 + i))
            t += 1.0
        pipe.flush_descriptors()
        return pipe

    jp = feed(JPipeline(jcfg))
    tp = feed(CerebroPipeline(tcfg_, device="cpu"))
    jc = [(c.idx_curr, c.idx_prev) for c in jp.candidates]
    tc = [(c.idx_curr, c.idx_prev) for c in tp.candidates]
    assert tc == jc and len(tc) >= 1
    np.testing.assert_allclose(
        [c.score for c in tp.candidates], [c.score for c in jp.candidates], atol=1e-4
    )
    np.testing.assert_allclose(tp.score_history, jp.score_history, atol=1e-4)
    tp.close()
