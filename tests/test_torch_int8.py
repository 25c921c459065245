"""The port's int8-quantized DB (cerebro_tpu_torch/ops/similarity.py
``quantize_rows`` and ``max_and_argmax_int8``, db/descriptors.py
``QuantizedDB``, loop/detector.py ``detect_batch_quantized``) against the
JAX package's, on the CPU (the plain int8 product):

- ``quantize_rows``: int8 values and scales identical to JAX's;
- ``max_and_argmax_int8``: gids identical, maxima within 1e-6, on a
  wrapped ring with planted rows, masked rows and an all-masked query;
- ``append_quantized`` across a ring wrap, with a partial batch: the same
  values, scales, ids, count and total as JAX's;
- ``detect_batch_quantized`` over consecutive batches: the same
  candidates and carry as JAX's;
- the CUDA product refuses CPU tensors (no fallback)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.config import LoopConfig as JLoopConfig
from cerebro_tpu.db import descriptors as jdb
from cerebro_tpu.loop import detector as jdet
from cerebro_tpu.ops import similarity as jsim
from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch.db import descriptors as tdb
from cerebro_tpu_torch.loop import detector as tdet
from cerebro_tpu_torch.ops import similarity as tsim


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("d", [8, 64, 256, 4096])
def test_quantize_rows_matches_jax(d):
    rng = np.random.default_rng(d)
    x = _unit(rng, 200, d)
    x[0] = 0.0  # an all-zero row: scale 1e-12 / 127
    x[1, :] = 0.5  # equal magnitudes
    x[2, : d // 2] = np.float32(127 / 254) * x[2, 0]  # values at k + 0.5 steps
    jq, js = jsim.quantize_rows(jnp.asarray(x))
    tq, ts = tsim.quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_product_is_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (9, 512)).astype(np.int8)
    b = rng.integers(-127, 128, (33, 512)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = tsim.int8_scores_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _ring_case(Q, N, D, seed):
    """Queries planted on DB rows of a wrapped ring (gid != row), one
    query's copy also at a masked newer gid, one all-masked query."""
    rng = np.random.default_rng(seed)
    db = _unit(rng, N, D)
    total = N + 37
    first = total - N
    gids = (first + (np.arange(N) - first) % N).astype(np.int32)
    rows = np.r_[[0, N - 1, N // 2], rng.choice(np.arange(1, N - 1), Q - 3, replace=False)]
    q = db[rows] + 0.01 * rng.standard_normal((Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    limits = np.full(Q, total, np.int32)
    newest = int(np.argmax(gids))
    db[newest] = db[rows[3]]
    limits[3] = gids[rows[3]] + 1 if gids[rows[3]] < gids[newest] else limits[3]
    limits[Q - 1] = first  # sees no row
    return q, db, limits, gids


@pytest.mark.parametrize("Q,N,D", [(8, 1024, 256), (64, 2048, 64), (5, 96, 4096)])
def test_max_and_argmax_int8_matches_jax(Q, N, D):
    q, db, limits, gids = _ring_case(Q, N, D, seed=Q + N)
    dq, ds = jsim.quantize_rows(jnp.asarray(db))
    jm, jg = jsim.max_and_argmax_int8(jnp.asarray(q), dq, ds, jnp.asarray(limits), jnp.asarray(gids))
    tdq, tds = tsim.quantize_rows(torch.from_numpy(db))
    tm, tg = tsim.max_and_argmax_int8(
        torch.from_numpy(q), tdq, tds, torch.from_numpy(limits), torch.from_numpy(gids)
    )
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    assert float(tm[-1]) == np.float32(tsim.NEG_INF) and int(tg[-1]) == int(gids[0])


def test_append_quantized_across_a_ring_wrap_matches_jax():
    """tests/test_descriptor_db.py's ring, quantized in both packages, then
    a partial batch: the same rows, scales, ids, count and total, and the
    ids those of the float ring."""
    vecs = _unit(np.random.default_rng(1), 28, 16)
    jq, tq = jdb.create_quantized(16, 16), tdb.create_quantized(16, 16, device="cpu")
    tf = tdb.create(16, 16, dtype=torch.float32, device="cpu")
    for start, n_new in ((0, 8), (8, 8), (16, 8), (24, 3)):
        b = vecs[start : start + 8] if start + 8 <= 28 else np.pad(vecs[start:], ((0, 4), (0, 0)))
        jq = jdb.append_quantized(jq, jnp.asarray(b), jnp.asarray(n_new))
        assert tdb.append_quantized(tq, torch.from_numpy(b), n_new) is tq  # in place
        tdb.append(tf, torch.from_numpy(b), n_new)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.global_ids.numpy(), np.asarray(jq.global_ids))
    assert torch.equal(tq.global_ids, tf.global_ids)
    assert (tq.count, tq.total) == (int(jq.count), int(jq.total)) == (16, 27)
    with pytest.raises(ValueError, match="wide"):
        tdb.append_quantized(tq, torch.zeros(2, 8), 2)


def test_detect_batch_quantized_matches_jax():
    """Consecutive batches of 8 over a 256-row int8 DB holding a revisit
    (queries 100.. repeat rows 20..): the candidates and the carry of every
    batch equal JAX's."""
    rng = np.random.default_rng(3)
    D, n = 64, 160
    vecs = _unit(rng, n, D)
    vecs[100:124] = vecs[20:44] + 0.02 * _unit(rng, 24, D)
    vecs[100:124] /= np.linalg.norm(vecs[100:124], axis=1, keepdims=True)
    jcfg = JLoopConfig(db_capacity=256, exclusion_window=6, dot_threshold=0.85, quantized=True)
    tcfg_ = tcfg.LoopConfig(db_capacity=256, exclusion_window=6, dot_threshold=0.85, quantized=True)
    jd, td = jdb.create_quantized(256, D), tdb.create_quantized(256, D, device="cpu")
    js, ts = jdet.init_state(), tdet.init_state("cpu")
    found = 0
    for b0 in range(0, n, 8):
        n_valid = min(8, n - b0 - 3) if b0 + 8 > n - 3 else 8  # a partial last batch
        q = vecs[b0 : b0 + 8]
        gidx = np.arange(b0, b0 + 8, dtype=np.int32)
        qvalid = np.arange(8) < n_valid
        jd = jdb.append_quantized(jd, jnp.asarray(q), jnp.asarray(n_valid))
        tdb.append_quantized(td, torch.from_numpy(q), n_valid)
        jc, js = jdet.detect_batch_quantized(
            jcfg, jd, js, jnp.asarray(q), jnp.asarray(gidx), jnp.asarray(qvalid)
        )
        tc, ts = tdet.detect_batch_quantized(
            tcfg_, td, ts, torch.from_numpy(q), torch.from_numpy(gidx), torch.from_numpy(qvalid)
        )
        for f in ("valid", "curr_idx", "prev_idx", "agree"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
        np.testing.assert_allclose(tc.score.numpy(), np.asarray(jc.score), atol=1e-6, rtol=0)
        for f in ("prev_arg", "prev_max", "prev_valid"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
        found += int(tc.valid.sum())
    assert found >= 10  # the revisit is detected


def test_int8_cuda_product_refuses_cpu_tensors():
    a = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tsim.int8_scores_cuda(a, a)
