"""Descriptor DB, masked max/argmax (K1's plain version) and Method-A
detection: the port against the JAX package on the same numpy inputs.

On the CPU, max_and_argmax takes its plain version in both packages (JAX's
XLA path; the port's f32 product of bf16-rounded inputs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.config import LoopConfig as JLoopConfig
from cerebro_tpu.db import descriptors as jdb
from cerebro_tpu.loop import detector as jdet
from cerebro_tpu.ops import similarity as jsim
from cerebro_tpu_torch.config import LoopConfig
from cerebro_tpu_torch.db import descriptors as tdb
from cerebro_tpu_torch.loop import detector as tdet
from cerebro_tpu_torch.ops import similarity as tsim


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_db_ring_append_and_limits_match_jax():
    """create/append/query_limits through a ring wrap and partial batches:
    exact, rows, ids and counters."""
    rng = np.random.default_rng(0)
    cap, dim, B = 24, 16, 8
    jd = jdb.create(cap, dim)
    td = tdb.create(cap, dim, device="cpu")
    for n_new in (8, 8, 5, 8, 3, 8, 0, 8):
        descs = _unit(rng, B, dim)
        jd = jdb.append(jd, jnp.asarray(descs), jnp.asarray(n_new))
        tdb.append(td, torch.from_numpy(descs), n_new)
        np.testing.assert_array_equal(
            td.vectors.float().numpy(), np.asarray(jd.vectors.astype(jnp.float32))
        )
        np.testing.assert_array_equal(td.global_ids.numpy(), np.asarray(jd.global_ids))
        assert (td.count, td.total) == (int(jd.count), int(jd.total))
        g = np.arange(td.total - 4, td.total + 12, dtype=np.int32)
        np.testing.assert_array_equal(
            tdb.query_limits(td, torch.from_numpy(g), 6).numpy(),
            np.asarray(jdb.query_limits(jd, jnp.asarray(g), 6)),
        )
    assert td.total > cap  # the ring wrapped


def test_from_rows_matches_jax():
    v = _unit(np.random.default_rng(1), 10, 8)
    jd = jdb.from_rows(jnp.asarray(v), n_valid=7)
    td = tdb.from_rows(torch.from_numpy(v), n_valid=7)
    np.testing.assert_array_equal(td.global_ids.numpy(), np.asarray(jd.global_ids))
    assert (td.count, td.total) == (int(jd.count), int(jd.total))


@pytest.mark.parametrize("n_rows", [2048, 700])
def test_max_and_argmax_plain_matches_jax(n_rows):
    """Planted rows (0, 511, 512, N/2, N-1 as bench.py plants them),
    ring-wrapped gids (row != gid) and an all-masked query: gids exact,
    max within 1e-4 (f32 sums of bf16 products in another order)."""
    rng = np.random.default_rng(2)
    dim = 64
    db = _unit(rng, n_rows, dim)
    planted = [0, 511, 512, n_rows // 2, n_rows - 1]
    planted = [p for p in planted if p < n_rows]
    q = _unit(rng, len(planted) + 2, dim)
    for i, p in enumerate(planted):
        db[p] = q[i]
    gids = ((np.arange(n_rows) + 137) % n_rows).astype(np.int32)
    lim = np.full(len(q), n_rows, np.int32)
    lim[-1] = 0  # all rows masked
    lim[-2] = 100  # only low gids
    mj, aj = jsim.max_and_argmax(jnp.asarray(q), jnp.asarray(db), jnp.asarray(lim), jnp.asarray(gids))
    mt, at = tsim.max_and_argmax(
        torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(lim), torch.from_numpy(gids)
    )
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-4, rtol=0)
    for i, p in enumerate(planted):
        assert at[i].item() == gids[p]
    assert mt[-1].item() == np.float32(tsim.NEG_INF) and at[-1].item() == gids[0]


def _stream(rng, n, dim, revisit_from, revisit_to, length):
    """n unit descriptors; frames revisit_to.. repeat revisit_from.. with
    small noise, so Method A fires on the revisit."""
    x = _unit(rng, n, dim)
    for k in range(length):
        v = x[revisit_from + k] + 0.05 * rng.normal(size=dim).astype(np.float32)
        x[revisit_to + k] = v / np.linalg.norm(v)
    return x


def _run_jax(cfg, descs, cap, B):
    db = jdb.create(cap, descs.shape[1])
    st = jdet.init_state()
    out = []
    for s in range(0, len(descs), B):
        chunk = descs[s : s + B]
        n = len(chunk)
        pad = np.zeros((B, descs.shape[1]), np.float32)
        pad[:n] = chunk
        db = jdb.append(db, jnp.asarray(pad), jnp.asarray(n))
        gidx = jnp.arange(s, s + B, dtype=jnp.int32)
        c, st = jdet.detect_batch(cfg, db, st, jnp.asarray(pad), gidx, jnp.arange(B) < n)
        out.append((c, n))
    return out


def _run_torch(cfg, descs, cap, B):
    db = tdb.create(cap, descs.shape[1], device="cpu")
    st = tdet.init_state("cpu")
    out = []
    for s in range(0, len(descs), B):
        chunk = descs[s : s + B]
        n = len(chunk)
        pad = np.zeros((B, descs.shape[1]), np.float32)
        pad[:n] = chunk
        tdb.append(db, torch.from_numpy(pad), n)
        gidx = torch.arange(s, s + B, dtype=torch.int32)
        c, st = tdet.detect_batch(cfg, db, st, torch.from_numpy(pad), gidx, torch.arange(B) < n)
        out.append((c, n))
    return out


def _flat(out, fields=("curr_idx", "prev_idx", "valid", "agree", "score")):
    res = {f: [] for f in fields}
    for c, n in out:
        for f in fields:
            res[f].extend(np.asarray(getattr(c, f))[:n].tolist())
    return {f: np.asarray(v) for f, v in res.items()}


@pytest.mark.parametrize("consistency_frames", [3, 2])
def test_detect_stream_matches_jax_and_is_batch_invariant(consistency_frames):
    """Candidates exact (curr, prev, valid, agree), score within 1e-4, over
    a stream that wraps the ring; the same stream fed in batches of 8 and
    one query at a time gives identical candidates."""
    rng = np.random.default_rng(3)
    descs = _stream(rng, 90, 32, revisit_from=5, revisit_to=60, length=20)
    kw = dict(db_capacity=64, exclusion_window=10, consistency_frames=consistency_frames)
    jcfg, tcfg = JLoopConfig(**kw), LoopConfig(**kw)
    ref = _flat(_run_jax(jcfg, descs, 64, 8))
    got = _flat(_run_torch(tcfg, descs, 64, 8))
    one = _flat(_run_torch(tcfg, descs, 64, 1))
    for f in ("curr_idx", "prev_idx", "valid", "agree"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
        np.testing.assert_array_equal(one[f], got[f], err_msg=f)
    np.testing.assert_allclose(got["score"], ref["score"], atol=1e-4, rtol=0)
    # one query at a time changes the product's blocking: f32 rounding only
    np.testing.assert_allclose(one["score"], got["score"], atol=1e-6, rtol=0)
    assert got["valid"].sum() >= 5  # the revisit fired
