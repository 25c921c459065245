"""Top-k candidate generators: Method A top-k (``temporal_consistency_topk``),
Method B (``naive_topk_candidates``), Method C (``clique_topk_candidates``)
and Method D (``hypothesis.update``), the port against the JAX package.

Both sides run the same detection chain on the same numpy descriptor
stream: ring DB append, per-query limits, dense top-k (on the CPU the JAX
package's ``lax.top_k`` and the port's plain ``search_topk``), then the
method with its carry across batches, in batches of 8 and of 1. The stream
wraps the ring and starts with empty windows, so the top-k holds filler
slots that the locality rule reads. Candidates, flags, tails and emits must
match exactly; scores within 1e-4 (f32 sums of bf16 products in another
order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.config import LoopConfig as JLoopConfig
from cerebro_tpu.db import descriptors as jdb
from cerebro_tpu.loop import detector as jdet
from cerebro_tpu.loop import hypothesis as jhyp
from cerebro_tpu.loop import topk_methods as jtm
from cerebro_tpu.ops import similarity as jsim
from cerebro_tpu_torch.config import LoopConfig
from cerebro_tpu_torch.db import descriptors as tdb
from cerebro_tpu_torch.loop import detector as tdet
from cerebro_tpu_torch.loop import hypothesis as thyp
from cerebro_tpu_torch.loop import topk_methods as ttm
from cerebro_tpu_torch.ops import similarity as tsim

CAP, DIM = 64, 32


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _stream(seed=3, n=96):
    """n unit descriptors; frames 60..83 revisit frames 5..28 with small
    noise, so every method fires on the revisit."""
    rng = np.random.default_rng(seed)
    x = _unit(rng, n, DIM)
    for k in range(24):
        v = x[5 + k] + 0.05 * rng.normal(size=DIM).astype(np.float32)
        x[60 + k] = v / np.linalg.norm(v)
    return x


class _Jax:
    """The JAX package's detection chain."""

    def __init__(self, cfg, k):
        self.cfg, self.k = cfg, k
        self.db = jdb.create(CAP, DIM)

    def search(self, pad, gidx, n):
        self.db = jdb.append(self.db, jnp.asarray(pad), jnp.asarray(n))
        limits = jdb.query_limits(self.db, gidx, self.cfg.exclusion_window)
        vals, idx = jsim.search_topk(pad, self.db.vectors, limits, self.db.global_ids, k=self.k)
        return vals, idx, limits

    @staticmethod
    def arange(a, b):
        return jnp.arange(a, b, dtype=jnp.int32)

    @staticmethod
    def mask(B, n):
        return jnp.arange(B) < n

    det, tm, hyp = jdet, jtm, jhyp

    @staticmethod
    def repeat(x, K):
        return jnp.repeat(x, K)


class _Torch:
    """The port's detection chain, on CPU tensors."""

    def __init__(self, cfg, k):
        self.cfg, self.k = cfg, k
        self.db = tdb.create(CAP, DIM, device="cpu")

    def search(self, pad, gidx, n):
        pad = torch.from_numpy(pad)
        tdb.append(self.db, pad, n)
        limits = tdb.query_limits(self.db, gidx, self.cfg.exclusion_window)
        vals, idx = tsim.search_topk(pad, self.db.vectors, limits, self.db.global_ids, k=self.k)
        return vals, idx, limits

    @staticmethod
    def arange(a, b):
        return torch.arange(a, b, dtype=torch.int32)

    @staticmethod
    def mask(B, n):
        return torch.arange(B) < n

    det, tm, hyp = tdet, ttm, thyp

    @staticmethod
    def repeat(x, K):
        return x.repeat_interleave(K)


def _init(side, method, cfg, k):
    if method == "A+":
        return side.det.init_topk_state(k) if side is _Jax else tdet.init_topk_state(k, "cpu")
    if method == "B":
        return side.det.init_state() if side is _Jax else tdet.init_state("cpu")
    if method == "C":
        return side.tm.init_clique_state(k) if side is _Jax else ttm.init_clique_state(k, device="cpu")
    return side.hyp.create_table(16) if side is _Jax else thyp.create_table(16, device="cpu")


def _run(side, method, cfg, descs, B, k):
    """Feed ``descs`` in batches of B through ``method``; returns the real
    rows of every output as numpy arrays, concatenated over batches."""
    chain = side(cfg, k)
    state = _init(side, method, cfg, k)
    out = {}
    for s in range(0, len(descs), B):
        n = min(B, len(descs) - s)
        pad = np.zeros((B, DIM), np.float32)
        pad[:n] = descs[s : s + n]
        gidx = side.arange(s, s + B)
        qvalid = side.mask(B, n)
        vals, idx, limits = chain.search(pad, gidx, n)
        searchable = (limits > 0) & qvalid
        if method == "A+":
            c, state = side.det.temporal_consistency_topk(
                cfg, state, vals, idx, gidx, searchable, qvalid
            )
            rows = {f: getattr(c, f) for f in ("curr_idx", "prev_idx", "valid", "agree", "score")}
            n_rows = n * k
        elif method == "B":
            c, state = side.tm.naive_topk_candidates(cfg, state, vals, idx, gidx, qvalid, limits > 0)
            rows = {f: getattr(c, f) for f in ("curr_idx", "prev_idx", "valid", "agree", "score")}
            n_rows = n
        elif method == "C":
            curr, prev, score, ok, state = side.tm.clique_topk_candidates(
                cfg, state, vals, idx, gidx, qvalid
            )
            rows = {"curr_idx": curr, "prev_idx": prev, "valid": ok, "score": score}
            n_rows = n
        else:  # "D": the pipeline's flattened feed, one clock tick per query
            qv_rep = side.repeat(qvalid, k)
            last = side.mask(B * k, B * k) & ((side.arange(0, B * k) % k) == (k - 1))
            state, emits, a_t, b_t, mean_s = side.hyp.update(
                cfg, state, side.repeat(gidx, k), idx.reshape(-1), vals.reshape(-1), qv_rep,
                query_valid=last & qv_rep, promote_support=cfg.hypothesis_promote,
            )
            rows = {"emits": emits, "a_tail": a_t, "b_tail": b_t, "score": mean_s}
            n_rows = n * k
        for f, v in rows.items():
            out.setdefault(f, []).append(np.asarray(v)[:n_rows])
    return {f: np.concatenate(v) for f, v in out.items()}


def _compare(method, jcfg, tcfg, k, fired_key):
    """Port against JAX at batch sizes 8 and 1. (Filler gids depend on which
    rows the DB holds when a query runs, so batch 1 and batch 8 can differ
    in filler slots, in both packages; each is held against its own.)"""
    descs = _stream()
    for B in (8, 1):
        ref = _run(_Jax, method, jcfg, descs, B, k)
        got = _run(_Torch, method, tcfg, descs, B, k)
        for f in ref:
            if f != "score":
                np.testing.assert_array_equal(got[f], ref[f], err_msg=f"{f}, batch {B}")
        np.testing.assert_allclose(got["score"], ref["score"], atol=1e-4, rtol=0)
        assert got[fired_key].any(), f"method {method} never fired"
    return got


def _cfgs(**kw):
    kw = dict(db_capacity=CAP, exclusion_window=10, **kw)
    return JLoopConfig(**kw), LoopConfig(**kw)


@pytest.mark.parametrize("consistency_frames", [3, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_temporal_consistency_topk_matches_jax(consistency_frames, k):
    jcfg, tcfg = _cfgs(consistency_frames=consistency_frames, candidates_per_query=k)
    got = _compare("A+", jcfg, tcfg, k, "valid")
    # the locality rule read filler slots: queries at the stream's start
    # have fewer than k matchable rows
    assert (got["score"] <= tsim.NEG_INF / 2).any()


def test_naive_topk_candidates_matches_jax():
    jcfg, tcfg = _cfgs()
    _compare("B", jcfg, tcfg, 5, "valid")


@pytest.mark.parametrize("min_support", [None, 2])
def test_clique_topk_candidates_matches_jax(min_support):
    jcfg, tcfg = _cfgs()
    if min_support is not None:
        jcfg = dataclasses.replace(jcfg, hypothesis_promote=min_support)
        tcfg = dataclasses.replace(tcfg, hypothesis_promote=min_support)
    _compare("C", jcfg, tcfg, 5, "valid")


@pytest.mark.parametrize("digest_every", [1, 3])
def test_hypothesis_update_matches_jax(digest_every):
    jcfg, tcfg = _cfgs(hypothesis_digest_every=digest_every)
    _compare("D", jcfg, tcfg, 5, "emits")


def test_hypothesis_slot_recycling_matches_jax():
    """A full table recycles the lowest-TTL slot (first on ties) and resets
    its emitted latch: more distinct tracks than slots, fed pair by pair."""
    rng = np.random.default_rng(5)
    n = 60
    a = np.arange(300, 300 + n, dtype=np.int32)
    b = np.where(np.arange(n) % 2 == 0, 40 + np.arange(n) // 2, rng.integers(500, 5000, n)).astype(np.int32)
    d = rng.uniform(0.86, 0.99, n).astype(np.float32)
    v = np.ones(n, bool)
    cfg_kw = dict(hypothesis_digest_every=2)
    jt, jem, ja, jb, js = jhyp.update(
        JLoopConfig(**cfg_kw), jhyp.create_table(4), *(jnp.asarray(x) for x in (a, b, d, v)),
        promote_support=3,
    )
    tt, tem, ta, tb, ts = thyp.update(
        LoopConfig(**cfg_kw), thyp.create_table(4, device="cpu"),
        *(torch.from_numpy(x) for x in (a, b, d, v)), promote_support=3,
    )
    for x, y in ((tem, jem), (ta, ja), (tb, jb)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    for f in dataclasses.fields(thyp.HypothesisTable):
        np.testing.assert_allclose(
            getattr(tt, f.name).numpy(), np.asarray(getattr(jt, f.name)), atol=1e-6, err_msg=f.name
        )
    assert tem.numpy().any()
