"""The port's mesh (cerebro_tpu_torch/parallel/, posegraph/distributed.py,
``mesh=`` in the pipeline and the train step) against the JAX package's.

The JAX package checks its sharded code on one process driving the
conftest's 8 virtual CPU devices. The port runs one process per device, so
this file is also the port's worker: run as a script, it is one rank of a
gloo process group on localhost. The test process computes the JAX answers
on the 8-device mesh (and the unsharded port's where a check needs them),
writes the inputs and the answers to a directory, and launches the ranks,
once with 2 and once with 4; each rank runs every check and prints
``ok <check>``. Every launch is killed after ``LAUNCH_TIMEOUT_S``, so a
rank stuck in a collective fails its checks, not the suite. The checks:

- ``search``: ``sharded_max_and_argmax`` and ``sharded_topk`` (k = 1, 3, 5)
  on a pre-wrap 4,096 x 256 DB, with an all-masked query and a query tied
  between rows on two ranks: gids equal to JAX's, scores within 1e-5;
- ``wrapped``: a 1,024-row ring filled through the sharded append in
  batches of 96 (batches straddle blocks and wrap; the last is partial),
  the gathered ring equal to JAX's, and a tie between gid 1100 (ring row
  76, rank 0) and gid 700 (a higher rank) going to gid 1100 as in JAX;
- ``payload``: the bytes each rank receives from ``all_gather`` in one
  search equal ``merge_payload_bytes``;
- ``int8``: ``sharded_max_and_argmax_int8`` and
  ``detect_batch_quantized_sharded`` (gids and candidates exact, scores
  and the carry within 1e-5);
- ``detect``: ``detect_batch_sharded`` over two batches with the carry:
  candidates exact, scores within 1e-5;
- ``posegraph``: ``optimize_sharded`` at 5 GN x 8 CG (the smooth regime of
  test_torch_posegraph.py) within 1e-3 of JAX's, every rank with the same
  bits;
- ``train``: the data-parallel ``train_step`` (test_training.py's 64x64
  net, batch 8, f32): the loss within 1e-5 of the unsharded port step's and
  1e-4 of JAX's (the same seeded params, ``init_flax_params``), Adam's first moment (0.1 x the gradient) per tensor within
  1e-4 of its norm plus 1e-6 of the whole's, every rank with the same
  parameters;
- ``pipeline`` (2 ranks): ``CerebroPipeline(mesh=)`` on the run_synthetic
  stream with the same candidates as the unsharded port pipeline and the
  JAX mesh pipeline, and the same verified edges as the unsharded port's;
  then ``save_pipeline_state`` from the 2 ranks;
- ``restore`` (4 ranks): that state loaded into 4 ranks: the gathered ring
  equals the saved one, and a top-3 search of every saved row returns
  what an unsharded search of the saved ring returns.

In this process: the merge functions against ``jnp.argmax`` and
``lax.top_k`` on planted ties, ``optimize_sharded`` at one rank bit-equal
to ``optimize``, ``make_mesh`` without a process group, the 2-D mesh's
axis groups, and a pipeline refused for a ring that does not divide over
the ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
LAUNCH_TIMEOUT_S = 180
WORLDS = (2, 4)
CHECKS = {
    2: ["search", "wrapped", "payload", "int8", "detect", "posegraph", "train", "pipeline"],
    4: ["search", "wrapped", "payload", "int8", "detect", "posegraph", "train", "restore"],
}
D, N, Q = 256, 4096, 8
SEARCH_LIMITS = [0, 100, 511, 512, 513, 1024, 2999, 3000]
RING_CAP, RING_BATCH, RING_ROWS, RING_LAST = 1024, 96, 1536, 50
TIE_NEW, TIE_OLD = 1100, 700  # ring rows 76 and 700 of the wrapped ring
TOPK = (1, 3, 5)
GN = dict(max_gn_iters=5, cg_iters=8)
TRAIN = dict(image_hw=(64, 64), num_channels=1, trunk_dim=64, num_clusters=4, dtype="float32")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_inputs() -> dict:
    """Every check's inputs, from seeded numpy."""
    rng = np.random.default_rng(0)
    vecs = _unit(rng.normal(size=(N, D)))
    vecs[2900] = vecs[100]  # a tie between ranks (rank 0 and a higher one)
    queries = _unit(rng.normal(size=(Q, D)))
    queries[6] = vecs[100]
    ring = _unit(rng.normal(size=(RING_ROWS, D)))
    ring[TIE_NEW] = ring[TIE_OLD]
    q8 = vecs[rng.integers(0, N, Q)] + 0.01 * rng.normal(size=(Q, D))
    det = _unit(rng.normal(size=(N, D)))
    det[120:128] = det[10:18]  # a loop: rows 120..127 revisit 10..17
    imgs = rng.integers(0, 255, size=(8, 64, 64, 1)).astype(np.uint8)
    labels = rng.integers(0, 3, size=(8,)).astype(np.int32)
    return dict(vecs=vecs, queries=queries, ring=ring, q8=_unit(q8), det=det,
                imgs=imgs, labels=labels)


# ---------------------------------------------------------------------------
# The rank (run as a script)
# ---------------------------------------------------------------------------


def _ring_batches():
    starts = list(range(0, RING_ROWS, RING_BATCH))
    return [(s, RING_BATCH if s + RING_BATCH < RING_ROWS else RING_LAST) for s in starts]


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol, rtol=0)


def _port_config(out: str, **loop):
    from cerebro_tpu_torch import run_synthetic

    cfg = run_synthetic.make_config(out)
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, **loop))


def _pipeline_rig():
    from cerebro_tpu_torch import run_synthetic as rs
    from cerebro_tpu_torch.geometry.stereo import RectifiedRig

    return RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=rs.FX, fy=rs.FX, cx=rs.CX, cy=rs.CY,
                        baseline=rs.BASE)


def feed_stream(pipe, frames, poses):
    """The stream of tests/test_pipeline.py's mesh test: 14 frames, then
    frames 2..5 revisited 6 s later, each with its own pose."""
    for i in range(14):
        pipe.ingest_frame(float(i), frames[i, 0], n_tracked=100, pose=poses[i], right_img=frames[i, 1])
    for k, i in enumerate(range(2, 6)):
        pipe.ingest_frame(20.0 + k, frames[i, 0], n_tracked=100, pose=poses[14 + k],
                          right_img=frames[i, 1])
    pipe.flush_descriptors()


def _flat_params(params) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in params.values()])


class _Rank:
    def __init__(self, world: int, rank: int, directory: Path):
        from cerebro_tpu_torch.parallel import make_mesh

        self.world, self.rank, self.dir = world, rank, directory
        self.mesh = make_mesh()
        with np.load(directory / "inputs.npz") as z:
            self.x = {k: z[k] for k in z.files}
        with np.load(directory / "expect.npz") as z:
            self.want = {k: z[k] for k in z.files}

    def t(self, name, dtype=None):
        return torch.from_numpy(self.x[name]) if dtype is None else torch.from_numpy(self.x[name]).to(dtype)

    def check_search(self):
        from cerebro_tpu_torch.db import descriptors as ddb
        from cerebro_tpu_torch.parallel import shard_db, sharded_max_and_argmax, sharded_topk

        sdb = shard_db(ddb.from_rows(self.t("vecs"), n_valid=3000), self.mesh)
        assert sdb.local_rows == N // self.world and sdb.row0 == self.rank * N // self.world
        lim = torch.tensor(SEARCH_LIMITS, dtype=torch.int32)
        mx, ar = sharded_max_and_argmax(self.t("queries"), sdb.vectors, lim, sdb.global_ids, self.mesh)
        np.testing.assert_array_equal(ar.numpy(), self.want["search_ar"])
        assert ar[0] == 0 and mx[0] <= -1e29  # all masked: rank 0's first row
        assert ar[6] == 100  # the tie goes to rank 0
        _close(mx[1:], self.want["search_mx"][1:])
        for k in TOPK:
            v, g = sharded_topk(self.t("queries"), sdb.vectors, lim, sdb.global_ids, self.mesh, k=k)
            np.testing.assert_array_equal(g.numpy(), self.want[f"topk{k}_g"])
            _close(v, self.want[f"topk{k}_v"])

    def _ring(self):
        from cerebro_tpu_torch.db import descriptors as ddb
        from cerebro_tpu_torch.parallel import shard_db

        db = shard_db(ddb.create(RING_CAP, D, dtype=torch.float32, device="cpu"), self.mesh)
        ring = self.t("ring")
        for s, n_new in _ring_batches():
            ddb.append(db, ring[s : s + RING_BATCH], n_new)
        return db

    def check_wrapped(self):
        from cerebro_tpu_torch.parallel import gather_db, sharded_max_and_argmax, sharded_topk

        db = self._ring()
        whole = gather_db(db, self.mesh)
        assert whole.total == db.total == int(self.want["ring_total"])
        np.testing.assert_array_equal(whole.global_ids.numpy(), self.want["ring_gids"])
        np.testing.assert_array_equal(whole.vectors.numpy(), self.want["ring_vectors"])
        q = self.t("ring")[[TIE_OLD, 1400]]
        lim = torch.full((2,), db.total, dtype=torch.int32)
        mx, ar = sharded_max_and_argmax(q, db.vectors, lim, db.global_ids, self.mesh)
        assert ar.tolist() == self.want["ring_ar"].tolist() == [TIE_NEW, 1400]
        _close(mx, self.want["ring_mx"])
        v, g = sharded_topk(q, db.vectors, lim, db.global_ids, self.mesh, k=3)
        np.testing.assert_array_equal(g.numpy(), self.want["ring_topk_g"])
        assert g[0, :2].tolist() == [TIE_NEW, TIE_OLD]
        _close(v, self.want["ring_topk_v"])

    def check_payload(self):
        import torch.distributed as dist

        from cerebro_tpu_torch.db import descriptors as ddb
        from cerebro_tpu_torch.parallel import (
            merge_payload_bytes, shard_db, sharded_max_and_argmax, sharded_topk,
        )

        sdb = shard_db(ddb.from_rows(self.t("vecs")), self.mesh)
        lim = torch.full((Q,), N, dtype=torch.int32)
        received = []
        real = dist.all_gather

        def counting(out, t, group=None):
            received.append(sum(o.numel() * o.element_size() for o in out))
            return real(out, t, group=group)

        dist.all_gather = counting
        try:
            sharded_max_and_argmax(self.t("queries"), sdb.vectors, lim, sdb.global_ids, self.mesh)
            sharded_topk(self.t("queries"), sdb.vectors, lim, sdb.global_ids, self.mesh, k=5)
        finally:
            dist.all_gather = real
        assert received == [merge_payload_bytes(Q, self.world), merge_payload_bytes(Q, self.world, 5)]

    def check_int8(self):
        from cerebro_tpu_torch.config import LoopConfig
        from cerebro_tpu_torch.db import descriptors as ddb
        from cerebro_tpu_torch.loop import detector
        from cerebro_tpu_torch.parallel import (
            detect_batch_quantized_sharded, shard_db_quantized, sharded_max_and_argmax_int8,
        )

        db = shard_db_quantized(ddb.create_quantized(N, D, device="cpu"), self.mesh)
        for i in range(0, N, 512):
            ddb.append_quantized(db, self.t("vecs")[i : i + 512], 512)
        q = self.t("q8")
        lim = torch.full((Q,), N, dtype=torch.int32)
        mx, ar = sharded_max_and_argmax_int8(q, db.values, db.scales, lim, db.global_ids, self.mesh)
        np.testing.assert_array_equal(ar.numpy(), self.want["int8_ar"])
        _close(mx, self.want["int8_mx"])
        cfg = LoopConfig(db_capacity=N, quantized=True, dot_threshold=0.2, exclusion_window=4)
        gidx = torch.arange(N, N + Q, dtype=torch.int32)
        c, st = detect_batch_quantized_sharded(cfg, db, detector.init_state("cpu"), q, gidx,
                                               torch.ones(Q, dtype=torch.bool), self.mesh)
        np.testing.assert_array_equal(c.valid.numpy(), self.want["int8_valid"])
        np.testing.assert_array_equal(c.prev_idx.numpy(), self.want["int8_prev"])
        _close(c.score, self.want["int8_score"])
        _close(st.prev_max, self.want["int8_prev_max"])

    def check_detect(self):
        from cerebro_tpu_torch.config import LoopConfig
        from cerebro_tpu_torch.db import descriptors as ddb
        from cerebro_tpu_torch.loop import detector
        from cerebro_tpu_torch.parallel import detect_batch_sharded, shard_db

        det = self.t("det")
        sdb = shard_db(ddb.from_rows(det, n_valid=128), self.mesh)
        state = detector.init_state("cpu")
        for b, lo in enumerate((120, 124)):
            gidx = torch.arange(lo, lo + 4, dtype=torch.int32)
            c, state = detect_batch_sharded(LoopConfig(), sdb, state, det[lo : lo + 4], gidx,
                                            torch.ones(4, dtype=torch.bool), self.mesh)
            np.testing.assert_array_equal(c.valid.numpy(), self.want[f"det{b}_valid"])
            np.testing.assert_array_equal(c.prev_idx.numpy(), self.want[f"det{b}_prev"])
            _close(c.score, self.want[f"det{b}_score"])
        assert bool(c.valid.all())  # the second batch carries the first's triple

    def _same_on_every_rank(self, t: torch.Tensor):
        from cerebro_tpu_torch.parallel.mesh import all_gather

        every = all_gather(t.contiguous(), self.mesh, "db")
        for other in every:
            assert torch.equal(other, t)

    def check_posegraph(self):
        from cerebro_tpu_torch.config import PoseGraphConfig
        from cerebro_tpu_torch.posegraph import PoseGraph, optimize_sharded, pad_graph

        names = [f.name for f in dataclasses.fields(PoseGraph)]
        g = PoseGraph(**{k: torch.from_numpy(self.x[f"pg_{k}"]) for k in names})
        x, s, cost = optimize_sharded(pad_graph(g, self.world), PoseGraphConfig(**GN), self.mesh)
        el = g.loop_i.shape[0]  # the switches past it belong to padding edges
        _close(x, self.want["pg_x"], atol=1e-3)
        _close(s[:el], self.want["pg_s"][:el], atol=1e-3)
        np.testing.assert_allclose(float(cost), float(self.want["pg_cost"]), rtol=1e-3, atol=1e-6)
        self._same_on_every_rank(torch.cat([x.reshape(-1), s, cost.reshape(1)]))

    def check_train(self):
        from cerebro_tpu_torch.config import DescriptorConfig
        from cerebro_tpu_torch.models.descriptor import create_descriptor_model
        from cerebro_tpu_torch.train import create_train_state, train_step

        net, params = create_descriptor_model(DescriptorConfig(**TRAIN), seed=0, device="cpu")
        state, tx = create_train_state(params, lr=1e-3)
        new, loss = train_step(net, tx, state, self.t("imgs"), self.t("labels", torch.int64),
                               mesh=self.mesh)
        np.testing.assert_allclose(float(loss), float(self.want["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(self.want["train_loss_jax"]), rtol=1e-4)
        mu = new.opt_state.mu
        whole = float(np.sqrt(sum(float((self.want[f"mu:{k}"] ** 2).sum()) for k in mu)))
        for k, v in mu.items():
            want = self.want[f"mu:{k}"]
            err = float(np.abs(v.numpy() - want).max())
            assert err <= 1e-4 * float(np.linalg.norm(want)) + 1e-6 * whole, (k, err)
        self._same_on_every_rank(_flat_params(new.params))

    def check_pipeline(self):
        from cerebro_tpu_torch.io import save_pipeline_state
        from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

        cfg = _port_config(str(self.dir / f"stash{self.rank}"))
        pipe = CerebroPipeline(cfg, rig=_pipeline_rig(), mesh=self.mesh, device="cpu")
        assert pipe.db.local_rows == cfg.loop.db_capacity // self.world
        feed_stream(pipe, self.x["frames"], self.x["poses"])
        cands = sorted((c.idx_curr, c.idx_prev) for c in pipe.candidates)
        assert [list(c) for c in cands] == self.want["pipe_cands"].tolist()
        assert [list(c) for c in cands] == self.want["pipe_cands_jax"].tolist()
        assert len(cands) >= 1
        pipe.verify_pending()
        edges = sorted((e.idx_curr, e.idx_prev) for e in pipe.loop_edges)
        assert [list(e) for e in edges] == self.want["pipe_edges"].tolist()
        save_pipeline_state(pipe, str(self.dir / "state"))
        pipe.close()

    def check_restore(self):
        from cerebro_tpu_torch.io import load_pipeline_state
        from cerebro_tpu_torch.ops.similarity import search_topk
        from cerebro_tpu_torch.parallel import gather_db, sharded_topk

        cfg = _port_config(str(self.dir / f"stash4_{self.rank}"))
        pipe = load_pipeline_state(str(self.dir / "state"), cfg=cfg, rig=_pipeline_rig(),
                                   device="cpu", mesh=self.mesh)
        db = pipe.db
        assert db.local_rows == cfg.loop.db_capacity // self.world
        whole = gather_db(db, self.mesh)
        with np.load(self.dir / "state" / "descriptor_db.npz") as z:
            saved_gids, total = z["global_ids"], int(z["total"])
            saved = torch.from_numpy(z["vectors"].view(np.int16)).view(torch.bfloat16)
        np.testing.assert_array_equal(whole.global_ids.numpy(), saved_gids)
        assert torch.equal(whole.vectors[:, : db.dim], saved) and db.total == total
        # the revisits' rows tie with the first visits': ties go to the
        # lowest row, sharded or not
        q = saved[:total].float()
        lim = torch.full((total,), total, dtype=torch.int32)
        v, g = sharded_topk(q, db.vectors, lim, db.global_ids, self.mesh, k=3)
        wv, wg = search_topk(q, saved, lim, torch.from_numpy(saved_gids), k=3)
        assert torch.equal(g, wg) and torch.equal(v, wv)
        assert (v[:, 0] > 0.999).all()  # every saved row finds itself or its twin
        pipe.close()


def worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One gloo rank of tests/test_torch_parallel.py.")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    # few threads a rank, idle ones asleep (OMP_WAIT_POLICY, set by the
    # launch): the ranks share the CPU with each other and with the other
    # test workers, and intra-op threads that spin waiting for a core
    # slow every process on it
    torch.set_num_threads(max(1, 4 // args.world))
    from cerebro_tpu_torch.parallel.multihost import host_info, init_multihost

    init_multihost(f"127.0.0.1:{args.port}", args.world, args.rank, device="cpu")
    info = host_info()
    assert info == {"process_index": args.rank, "process_count": args.world,
                    "local_devices": 1, "global_devices": args.world}, info
    r = _Rank(args.world, args.rank, Path(args.dir))
    for name in CHECKS[args.world]:
        getattr(r, f"check_{name}")()
        print(f"ok {name}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(worker_main())


# ---------------------------------------------------------------------------
# The tests (the JAX answers, the launches)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from cerebro_tpu_torch.parallel import merge_argmax, merge_topk  # noqa: E402
from cerebro_tpu_torch.parallel.multihost import init_multihost  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_mesh():
    """A gloo process group of this process alone, and its 1-D mesh; the
    group is destroyed on exit."""
    from cerebro_tpu_torch.parallel import make_mesh

    init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def _jax_db(vecs, n_valid):
    from cerebro_tpu.db import descriptors as jddb

    n = vecs.shape[0]
    gids = np.where(np.arange(n) < n_valid, np.arange(n), int(jddb.GID_INVALID))
    return jddb.DescriptorDB(
        vectors=jnp.asarray(vecs), global_ids=jnp.asarray(gids, jnp.int32),
        count=jnp.asarray(n_valid, jnp.int32), total=jnp.asarray(n_valid, jnp.int32),
    )


def _render_stream():
    from cerebro_tpu_torch import run_synthetic as rs
    from cerebro_tpu_torch.pretrain_synthetic import fractal_texture

    tex = fractal_texture(np.random.default_rng(rs.TEXTURE_SEED))
    frames = np.stack([np.stack(rs.stereo_pair(tex, rs.cam_pose(i))) for i in range(14)])
    poses = np.stack([rs.cam_pose(i) for i in range(18)])
    return frames, poses


def expected(x: dict, directory: Path) -> dict:
    """The JAX answers on the conftest's 8-device mesh, and the unsharded
    port's where a check compares with it."""
    from cerebro_tpu import parallel as jpar
    from cerebro_tpu.config import DescriptorConfig as JDescriptorConfig
    from cerebro_tpu.config import LoopConfig as JLoopConfig
    from cerebro_tpu.config import PoseGraphConfig as JPoseGraphConfig
    from cerebro_tpu.db import descriptors as jddb
    from cerebro_tpu.loop import detector as jdet
    from cerebro_tpu.models.backbones import normalize_image as jnormalize
    from cerebro_tpu.models.descriptor import DescriptorNet as JDescriptorNet
    from cerebro_tpu.posegraph import optimize_sharded as j_optimize_sharded
    from cerebro_tpu.posegraph import pad_graph as j_pad_graph
    from cerebro_tpu.runtime import CerebroPipeline as JPipeline
    from cerebro_tpu.train import allpair_loss as jallpair_loss
    from cerebro_tpu_torch.config import DescriptorConfig
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model, init_flax_params
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline
    from cerebro_tpu_torch.train import create_train_state, train_step

    import test_pipeline as tpl
    import test_torch_posegraph as ttp
    import test_torch_train as ttr

    mesh = jpar.make_mesh()
    assert mesh.shape["db"] == 8
    w = {}
    sdb = jpar.shard_db(_jax_db(x["vecs"], 3000), mesh)
    lim = jnp.asarray(SEARCH_LIMITS, jnp.int32)
    q = jnp.asarray(x["queries"])
    mx, ar = jpar.sharded_max_and_argmax(q, sdb.vectors, lim, sdb.global_ids, mesh, use_pallas=False)
    w["search_mx"], w["search_ar"] = np.asarray(mx), np.asarray(ar)
    for k in TOPK:
        v, g = jpar.sharded_topk(q, sdb.vectors, lim, sdb.global_ids, mesh, k=k)
        w[f"topk{k}_v"], w[f"topk{k}_g"] = np.asarray(v), np.asarray(g)

    db = jddb.create(RING_CAP, D, dtype=jnp.float32)
    for s, n_new in _ring_batches():
        db = jddb.append(db, jnp.asarray(x["ring"][s : s + RING_BATCH]), jnp.asarray(n_new))
    w["ring_total"] = np.asarray(db.total)
    w["ring_gids"], w["ring_vectors"] = np.asarray(db.global_ids), np.asarray(db.vectors)
    rq = jnp.asarray(x["ring"][[TIE_OLD, 1400]])
    rl = jnp.full((2,), int(db.total), jnp.int32)
    rdb = jpar.shard_db(db, mesh)
    mx, ar = jpar.sharded_max_and_argmax(rq, rdb.vectors, rl, rdb.global_ids, mesh, use_pallas=False)
    w["ring_mx"], w["ring_ar"] = np.asarray(mx), np.asarray(ar)
    v, g = jpar.sharded_topk(rq, rdb.vectors, rl, rdb.global_ids, mesh, k=3)
    w["ring_topk_v"], w["ring_topk_g"] = np.asarray(v), np.asarray(g)

    qdb = jddb.create_quantized(N, D)
    for i in range(0, N, 512):
        qdb = jddb.append_quantized(qdb, jnp.asarray(x["vecs"][i : i + 512]), jnp.asarray(512))
    sq = jpar.shard_db_quantized(qdb, mesh)
    q8 = jnp.asarray(x["q8"])
    mx, ar = jpar.sharded_max_and_argmax_int8(q8, sq.values, sq.scales, jnp.full((Q,), N, jnp.int32),
                                              sq.global_ids, mesh)
    w["int8_mx"], w["int8_ar"] = np.asarray(mx), np.asarray(ar)
    cfg8 = JLoopConfig(db_capacity=N, quantized=True, dot_threshold=0.2, exclusion_window=4)
    c, st = jpar.detect_batch_quantized_sharded(cfg8, sq, jdet.init_state(), q8,
                                                jnp.arange(N, N + Q, dtype=jnp.int32),
                                                jnp.ones((Q,), bool), mesh)
    w["int8_valid"], w["int8_prev"] = np.asarray(c.valid), np.asarray(c.prev_idx)
    w["int8_score"], w["int8_prev_max"] = np.asarray(c.score), np.asarray(st.prev_max)

    ddb_ = jpar.shard_db(_jax_db(x["det"], 128), mesh)
    state = jdet.init_state()
    for b, lo in enumerate((120, 124)):
        c, state = jpar.detect_batch_sharded(
            JLoopConfig(), ddb_, state, jnp.asarray(x["det"][lo : lo + 4]),
            jnp.arange(lo, lo + 4, dtype=jnp.int32), jnp.ones((4,), bool), mesh, use_pallas=False,
        )
        w[f"det{b}_valid"], w[f"det{b}_prev"] = np.asarray(c.valid), np.asarray(c.prev_idx)
        w[f"det{b}_score"] = np.asarray(c.score)

    g, _, _ = ttp._drift()
    for f in dataclasses.fields(g):
        x[f"pg_{f.name}"] = np.asarray(getattr(g, f.name))
    xs, ss, cs = j_optimize_sharded(j_pad_graph(g, 8), JPoseGraphConfig(**GN), mesh)
    w["pg_x"], w["pg_s"], w["pg_cost"] = np.asarray(xs), np.asarray(ss), np.asarray(cs)

    # JAX's loss on the seeded params, drawn by the port's init_flax_params
    # (flax's net.init within 4 ulps, tests/test_torch_netvlad.py), as the
    # port's create_descriptor_model draws them
    jc = JDescriptorConfig(**TRAIN)
    jnet = JDescriptorNet(num_clusters=jc.num_clusters, trunk_dim=jc.trunk_dim, num_ghost=jc.num_ghost,
                          backbone=jc.backbone, dtype=jnp.dtype(jc.dtype))
    jparams = ttr._nest(init_flax_params(DescriptorConfig(**TRAIN), seed=0))
    jloss = jax.jit(lambda p: jallpair_loss(jnet.apply(p, jnormalize(jnp.asarray(x["imgs"]))),
                                            jnp.asarray(x["labels"])))(jparams)
    w["train_loss_jax"] = np.asarray(jloss)
    net, params = create_descriptor_model(DescriptorConfig(**TRAIN), seed=0, device="cpu")
    state, tx = create_train_state(params, lr=1e-3)
    new, loss = train_step(net, tx, state, torch.from_numpy(x["imgs"]),
                           torch.from_numpy(x["labels"]).long())
    w["train_loss"] = loss.numpy()
    for k, v in new.opt_state.mu.items():
        w[f"mu:{k}"] = v.numpy()

    x["frames"], x["poses"] = _render_stream()
    jcfg = dataclasses.replace(tpl.small_config(directory), loop=dataclasses.replace(
        tpl.small_config(directory).loop, db_capacity=1024))
    jpipe = JPipeline(jcfg, rig=_jax_rig(), mesh=mesh)
    feed_stream(jpipe, x["frames"], x["poses"])
    w["pipe_cands_jax"] = np.asarray(sorted((c.idx_curr, c.idx_prev) for c in jpipe.candidates))
    pipe = CerebroPipeline(_port_config(str(directory / "stash_plain")), rig=_pipeline_rig(),
                           device="cpu")
    feed_stream(pipe, x["frames"], x["poses"])
    w["pipe_cands"] = np.asarray(sorted((c.idx_curr, c.idx_prev) for c in pipe.candidates))
    pipe.verify_pending()
    w["pipe_edges"] = np.asarray(sorted((e.idx_curr, e.idx_prev) for e in pipe.loop_edges))
    pipe.close()
    return w


def _jax_rig():
    from cerebro_tpu.geometry import stereo as jstereo
    from cerebro_tpu_torch import run_synthetic as rs

    return jstereo.RectifiedRig(
        R0=jnp.eye(3), R1=jnp.eye(3), fx=jnp.asarray(rs.FX), fy=jnp.asarray(rs.FX),
        cx=jnp.asarray(rs.CX), cy=jnp.asarray(rs.CY), baseline=jnp.asarray(rs.BASE),
    )


def launch(world: int, directory: Path):
    """Run ``world`` ranks of this file; returns (return codes, outputs)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO), OMP_WAIT_POLICY="PASSIVE")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--world", str(world), "--rank", str(r),
             "--port", str(port), "--dir", str(directory)],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] + "\n[killed at the launch's time limit]" for p in procs]
    return [p.returncode for p in procs], outs


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    directory = tmp_path_factory.mktemp("mesh")
    x = make_inputs()
    w = expected(x, directory)
    np.savez(directory / "inputs.npz", **x)
    np.savez(directory / "expect.npz", **w)
    # in order: the 4-rank launch restores the state the 2-rank one saved
    return {world: launch(world, directory) for world in WORLDS}


@pytest.mark.parametrize("world,check", [(n, c) for n in WORLDS for c in CHECKS[n]])
def test_mesh_ranks(launches, world, check):
    rcs, outs = launches[world]
    for rank, out in enumerate(outs):
        assert f"ok {check}" in out.splitlines(), f"rank {rank} of {world} (rc {rcs[rank]}):\n{out}"


def test_merges_follow_jax_tie_order():
    """``merge_argmax`` is ``jnp.argmax`` over ranks (ties to the lowest
    rank, all-masked to rank 0); ``merge_topk`` is ``lax.top_k`` over the
    rank-major concatenation (ties to the lower position), whatever the
    gids' order."""
    rng = np.random.default_rng(5)
    n, q, k = 4, 6, 3
    v = rng.choice(np.asarray([-1e30, 0.1, 0.5, 0.9], np.float32), size=(n, q, k))
    v = -np.sort(-v, axis=-1)  # each rank's list is sorted, as a top-k is
    g = rng.permutation(n * q * k).reshape(n, q, k).astype(np.int32)
    mx, ar = merge_argmax(torch.from_numpy(v[..., 0]), torch.from_numpy(g[..., 0]))
    best = np.asarray(jnp.argmax(jnp.asarray(v[..., 0]), axis=0))
    np.testing.assert_array_equal(ar.numpy(), g[best, np.arange(q), 0])
    np.testing.assert_array_equal(mx.numpy(), v[best, np.arange(q), 0])
    tv, tg = merge_topk(torch.from_numpy(v), torch.from_numpy(g), k)
    flat_v = v.transpose(1, 0, 2).reshape(q, n * k)
    flat_g = g.transpose(1, 0, 2).reshape(q, n * k)
    jv, ji = jax.lax.top_k(jnp.asarray(flat_v), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tg.numpy(), np.take_along_axis(flat_g, np.asarray(ji), 1))
    # all masked: rank 0's answer
    mx, ar = merge_argmax(torch.full((n, 2), -1e30), torch.arange(2 * n).reshape(n, 2).int())
    assert ar.tolist() == [0, 1]


def test_optimize_sharded_one_rank_is_optimize():
    import test_torch_posegraph as ttp
    from cerebro_tpu_torch.config import PoseGraphConfig
    from cerebro_tpu_torch.posegraph import optimize, optimize_sharded, pad_graph

    g = ttp._to_torch(ttp._drift()[0])
    cfg = PoseGraphConfig(**GN)
    with one_rank_mesh() as mesh:
        got = optimize_sharded(pad_graph(g, 1), cfg, mesh)
    for a, b in zip(got, optimize(g, cfg)):
        assert torch.equal(a, b)


def test_make_mesh_needs_a_process_group():
    from cerebro_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_multihost"):
        make_mesh()


def test_mesh_2d_axis_groups_and_one_rank_mesh():
    from cerebro_tpu_torch.parallel import make_mesh, make_mesh_2d

    with one_rank_mesh() as mesh:
        assert mesh.shape == {"db": 1} and mesh.rank("db") == 0
        with pytest.raises(ValueError):
            make_mesh(num_devices=2)
        m2 = make_mesh_2d((1, 1))
        assert m2.shape == {"dp": 1, "db": 1} and m2.coords == (0, 0)
        with pytest.raises(ValueError):
            m2.rank("x")


def test_pipeline_mesh_must_divide_the_db():
    """A mesh pipeline is refused at build when the ring does not divide
    over the ranks (JAX asserts it), or when the mesh runs elsewhere."""
    from cerebro_tpu_torch.parallel.mesh import Mesh
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    cfg = _port_config("unused")
    three = Mesh(("db",), (3,), (None,), (0,), torch.device("cpu"))
    with pytest.raises(ValueError, match="divide over the mesh's 3 ranks"):
        CerebroPipeline(cfg, rig=_pipeline_rig(), mesh=three, device="cpu")
    card = Mesh(("db",), (1,), (None,), (0,), torch.device("cuda", 0))
    with pytest.raises(ValueError, match="the mesh's ranks run on cuda"):
        CerebroPipeline(cfg, rig=_pipeline_rig(), mesh=card, device="cpu")
