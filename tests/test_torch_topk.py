"""Exact top-k retrieval: the port's ``search_topk``, ``search_topk_streaming``
and banned argmax (K2's plain version) against the JAX package on the same
numpy inputs.

On the CPU both packages take their plain paths: JAX's dense ``search_topk``
(``lax.top_k`` over the XLA score matrix) and its XLA banned argmax; the
port's stable sort of the score matrix and its plain banned argmax. The CUDA
route of ``search_topk`` (k K2 passes, then the dense filler order) is run
here with the plain banned argmax standing in for the kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.ops import similarity as jsim
from cerebro_tpu_torch.db.descriptors import GID_INVALID
from cerebro_tpu_torch.ops import similarity as tsim


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _case(layout: str, n_rows: int = 96, dim: int = 32, n_queries: int = 9, seed: int = 0):
    """A DB of ``n_rows`` and its per-row gids, queries and limits.

    ``wrapped``: a ring after n_rows + 37 appends (row != gid). ``partial``:
    a ring filled to 60 rows, the rest empty (GID_INVALID, unmatchable by
    every limit). Limits give full windows, short windows of 0..4
    matchable rows (fewer than k: the filler slots) and an empty window.
    Rows 10 and 50 hold the same vector, so one query sees an exact tie."""
    rng = np.random.default_rng(seed)
    db = _unit(rng, n_rows, dim)
    if layout == "wrapped":
        total = n_rows + 37
        first = total - n_rows
        gids = (first + (np.arange(n_rows) - first) % n_rows).astype(np.int64)
    else:
        total = 60
        gids = np.where(np.arange(n_rows) < total, np.arange(n_rows), GID_INVALID)
    gids = gids.astype(np.int32)
    db[50] = db[10]
    q = _unit(rng, n_queries, dim)
    q[0] = db[10]  # the tie: both copies matchable under a full window
    q[1] = 0.9 * db[33] + 0.1 * q[1]
    lo = int(gids[gids != GID_INVALID].min())
    lim = np.array(
        [total, total, total - 5, lo + 1, lo + 2, lo + 4, lo, total - 40, lo + 3],
        np.int32,
    )[:n_queries]
    return q, db, lim, gids


def _jax(fn, *arrays, **kw):
    return tuple(np.asarray(x) for x in fn(*(jnp.asarray(a) for a in arrays), **kw))


def _torch(fn, *arrays, **kw):
    return tuple(x.numpy() for x in fn(*(torch.from_numpy(a) for a in arrays), **kw))


def _assert_topk_equal(got, want):
    """Gids exact on every slot, fillers included; real scores within 1e-4
    (f32 sums of bf16 products in another order), filler scores exact."""
    (tv, ti), (jv, ji) = got, want
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv <= tsim.NEG_INF / 2, jv <= jsim.NEG_INF / 2)
    np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", ["wrapped", "partial"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_search_topk_matches_jax_dense_on_every_slot(layout, k):
    q, db, lim, gids = _case(layout)
    want = _jax(jsim.search_topk, q, db, lim, gids, k=k)
    got = _torch(tsim.search_topk, q, db, lim, gids, k=k)
    _assert_topk_equal(got, want)
    # the short windows really leave filler slots, and the tie is kept in
    # row order (row 10 before row 50)
    assert (got[0] <= tsim.NEG_INF / 2).any()
    if k > 1:
        assert list(got[1][0, :2]) == [gids[10], gids[50]]


@pytest.mark.parametrize("layout", ["wrapped", "partial"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_cuda_route_fills_dense_order(monkeypatch, layout, k):
    """search_topk_cuda's k banned-argmax passes and filler fill, with the
    plain banned argmax standing in for K2: every slot equals JAX's dense
    top-k."""
    monkeypatch.setattr(tsim, "max_and_argmax_banned_cuda", tsim.max_and_argmax_banned_plain)
    q, db, lim, gids = _case(layout, seed=1)
    want = _jax(jsim.search_topk, q, db, lim, gids, k=k)
    got = _torch(tsim.search_topk_cuda, q, db, lim, gids, k=k)
    _assert_topk_equal(got, want)


@pytest.mark.parametrize("layout", ["wrapped", "partial"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_search_topk_streaming_matches_jax(layout, k):
    """The streaming top-k keeps JAX's filler behaviour: slots past a
    query's last real hit repeat (NEG_INF, gids[0])."""
    q, db, lim, gids = _case(layout, seed=2)
    want = _jax(jsim.search_topk_streaming, q, db, lim, gids, k=k, use_pallas=False)
    got = _torch(tsim.search_topk_streaming, q, db, lim, gids, k=k)
    _assert_topk_equal(got, want)


@pytest.mark.parametrize("kb", [1, 4])
def test_banned_argmax_matches_jax(kb):
    """Banned gids (a planted winner, gids absent from the DB, the empty
    rows' GID_INVALID) and inert -1 slots: gids exact, max within 1e-4."""
    q, db, lim, gids = _case("partial", seed=3)
    Q = len(q)
    banned = np.full((Q, kb), -1, np.int32)
    banned[0, 0] = gids[10]  # the tie's first copy: the twin must win
    banned[1, 0] = gids[33]  # the planted near-copy
    banned[2, 0] = 10**6  # absent from the DB
    banned[3, 0] = GID_INVALID
    if kb > 1:
        banned[0, 1] = gids[50]
        banned[4, 1:] = [gids[0], gids[1], 12345]
    want = _jax(jsim._max_and_argmax_banned, q, db, lim, gids, banned, use_pallas=False)
    got = _torch(tsim.max_and_argmax_banned, q, db, lim, gids, banned)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    if kb == 1:
        assert got[1][0] == gids[50]


def test_search_topk_rejects_k_outside_db():
    q, db, lim, gids = _case("wrapped")
    for fn in (tsim.search_topk_plain, tsim.search_topk_cuda):
        with pytest.raises(ValueError, match="k="):
            fn(*(torch.from_numpy(a) for a in (q, db, lim, gids)), k=len(db) + 1)
