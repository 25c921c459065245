"""Descriptor-DB search sharded over a mesh's ranks (counterpart of
cerebro_tpu/parallel/sharded_search.py).

The ever-growing descriptor history (the reference's single 29,000-column
CPU matrix, src/Cerebro.cpp:946) is split row-wise over the ranks of the
``db`` axis: rank r holds the contiguous block ``[r C/n, (r+1) C/n)`` of
the C-row ring (``shard_db``), and writes there only the rows of each
appended batch that land in it (``db.descriptors.append``). A search runs
the single-device call on the rank's block (on CUDA tensors kernel K1,
kernel K2 or the int8 product), then one ``all_gather`` of the (Q, k)
partial scores and global ids, then a merge every rank computes alike. The
full (Q, N) score matrix never exists anywhere; the merge payload is
``merge_payload_bytes``.

The merges (``merge_argmax``, ``merge_topk``) are plain functions of the
gathered partials, in the JAX package's order: the argmax over ranks
takes the lowest rank on a tie (``jnp.argmax``), and the top-k over the
rank-major (Q, n k) concatenation the lower position (``lax.top_k``). A
query with no matchable row anywhere gets rank 0's answer. Global ids are
not an order here: once the ring wraps, a lower rank may hold newer ids.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cerebro_tpu_torch.config import LoopConfig
from cerebro_tpu_torch.db import descriptors as ddb
from cerebro_tpu_torch.loop import detector
from cerebro_tpu_torch.ops import similarity
from cerebro_tpu_torch.parallel.mesh import Mesh, all_gather


def merge_payload_bytes(n_queries: int, n_devices: int, k: int = 1) -> int:
    """Bytes each rank receives from the merge's ``all_gather`` in one
    search: the (Q, k) f32 partial scores and (Q, k) int32 global ids of
    every rank, n * Q * k * (4 + 4). It is all the traffic between ranks of
    a sharded search."""
    return n_queries * n_devices * k * (4 + 4)


def _block(n_rows: int, mesh: Mesh, axis: str) -> Tuple[int, int]:
    n = mesh.shape[axis]
    if n_rows % n:
        raise ValueError(f"the DB's {n_rows} rows do not divide over the mesh's {n} ranks")
    rows = n_rows // n
    return mesh.rank(axis) * rows, rows


def shard_db(db: ddb.DescriptorDB, mesh: Mesh, axis: str = "db") -> ddb.DescriptorDB:
    """This rank's block of an unsharded DB, on the mesh's device: rows
    ``[r C/n, (r+1) C/n)`` and their global ids; ``count`` and ``total``
    replicated. Raises unless the capacity divides over the ranks."""
    if db.ring_capacity is not None:
        raise ValueError("the DB is sharded already")
    r0, rows = _block(db.capacity, mesh, axis)
    return dataclasses.replace(
        db,
        vectors=db.vectors[r0 : r0 + rows].to(mesh.device, copy=True),
        global_ids=db.global_ids[r0 : r0 + rows].to(mesh.device, copy=True),
        row0=r0, ring_capacity=db.capacity,
    )


def shard_db_quantized(db: ddb.QuantizedDB, mesh: Mesh, axis: str = "db") -> ddb.QuantizedDB:
    """``shard_db`` for the int8 DB."""
    if db.ring_capacity is not None:
        raise ValueError("the DB is sharded already")
    r0, rows = _block(db.capacity, mesh, axis)
    return dataclasses.replace(
        db,
        values=db.values[r0 : r0 + rows].to(mesh.device, copy=True),
        scales=db.scales[r0 : r0 + rows].to(mesh.device, copy=True),
        global_ids=db.global_ids[r0 : r0 + rows].to(mesh.device, copy=True),
        row0=r0, ring_capacity=db.capacity,
    )


def _gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "db") -> torch.Tensor:
    """Every rank's row block of ``t`` concatenated in rank order."""
    g = all_gather(t, mesh, axis)
    return g.reshape(-1, *t.shape[1:])


def gather_db(db, mesh: Mesh, axis: str = "db"):
    """The whole ring of a sharded DB (float or int8) on every rank, as an
    unsharded DB."""
    if isinstance(db, ddb.QuantizedDB):
        return dataclasses.replace(
            db, values=_gather_rows(db.values, mesh, axis), scales=_gather_rows(db.scales, mesh, axis),
            global_ids=_gather_rows(db.global_ids, mesh, axis), row0=0, ring_capacity=None,
        )
    return dataclasses.replace(
        db, vectors=_gather_rows(db.vectors, mesh, axis),
        global_ids=_gather_rows(db.global_ids, mesh, axis), row0=0, ring_capacity=None,
    )


def gather_partials(vals: torch.Tensor, gids: torch.Tensor, mesh: Mesh, axis: str = "db"):
    """One ``all_gather`` of this rank's (Q, k) f32 scores and int32 global
    ids (packed side by side): (n, Q, k) of each, rank-major."""
    k = vals.shape[-1]
    packed = torch.cat([vals.float().contiguous().view(torch.int32), gids.to(torch.int32)], dim=-1)
    both = all_gather(packed, mesh, axis)
    return both[..., :k].contiguous().view(torch.float32), both[..., k:].contiguous()


def merge_argmax(all_mx: torch.Tensor, all_ar: torch.Tensor):
    """(n, Q) partial maxima and their global ids, rank-major -> (Q,) global
    (max, gid): the first rank holding the largest (``jnp.argmax``)."""
    best = torch.argmax(all_mx, dim=0)[None]
    return all_mx.gather(0, best)[0], all_ar.gather(0, best)[0]


def merge_topk(all_v: torch.Tensor, all_g: torch.Tensor, k: int):
    """(n, Q, kk) partial top-k lists, rank-major -> (Q, k): the k best of
    each query's (n kk,) concatenation, ties to the lower position
    (``lax.top_k``)."""
    n, Q, kk = all_v.shape
    v = all_v.permute(1, 0, 2).reshape(Q, n * kk)
    g = all_g.permute(1, 0, 2).reshape(Q, n * kk)
    top, order = torch.sort(v, dim=1, descending=True, stable=True)
    return top[:, :k], g.gather(1, order[:, :k])


def sharded_max_and_argmax(
    queries: torch.Tensor,  # (Q, D) replicated
    db_vectors: torch.Tensor,  # (C/n, D) this rank's rows
    limits: torch.Tensor,  # (Q,) int32 global exclusive gid bounds
    gids: torch.Tensor,  # (C/n,) int32 global ids of those rows
    mesh: Mesh,
    axis: str = "db",
):
    """Global (max (Q,), matched gid (Q,)) over the row-sharded DB: K1 on
    this rank's rows, then the merge. Masking by global id needs no offset
    and no wrap case: every rank masks ``gid < limit`` itself."""
    mx, ar = similarity.max_and_argmax(queries, db_vectors, limits, gids)
    all_mx, all_ar = gather_partials(mx[:, None], ar[:, None], mesh, axis)
    return merge_argmax(all_mx[..., 0], all_ar[..., 0])


def sharded_topk(
    queries: torch.Tensor,  # (Q, D) replicated
    db_vectors: torch.Tensor,  # (C/n, D)
    limits: torch.Tensor,  # (Q,) int32
    gids: torch.Tensor,  # (C/n,) int32
    mesh: Mesh,
    axis: str = "db",
    k: int = 5,
):
    """Distributed top-k: ``search_topk`` (K2) on this rank's rows, gather
    the n k partials per query, merge. Exact for k <= C/n; returns
    (values (Q, k), global ids (Q, k))."""
    v, g = similarity.search_topk(queries, db_vectors, limits, gids, k=k)
    all_v, all_g = gather_partials(v, g, mesh, axis)
    return merge_topk(all_v, all_g, k)


def detect_batch_sharded(
    cfg: LoopConfig,
    db: ddb.DescriptorDB,
    state: detector.DetectorState,
    queries: torch.Tensor,
    global_idx: torch.Tensor,
    query_valid: torch.Tensor,
    mesh: Mesh,
    axis: str = "db",
):
    """``loop.detector.detect_batch`` over a sharded DB: the sharded search,
    the same temporal consistency on every rank."""
    limits = ddb.query_limits(db, global_idx, cfg.exclusion_window)
    mx, ar = sharded_max_and_argmax(queries, db.vectors, limits, db.global_ids, mesh, axis)
    searchable = (limits > 0) & query_valid
    return detector.temporal_consistency(cfg, state, mx, ar, global_idx, searchable, query_valid)


def sharded_max_and_argmax_int8(
    queries: torch.Tensor,  # (Q, D) replicated float
    db_values: torch.Tensor,  # (C/n, D) int8
    db_scales: torch.Tensor,  # (C/n,) f32
    limits: torch.Tensor,  # (Q,) int32
    gids: torch.Tensor,  # (C/n,) int32
    mesh: Mesh,
    axis: str = "db",
):
    """Global (max, matched gid) per query over the row-sharded int8 DB:
    ``max_and_argmax_int8`` (one ``torch._int_mm`` on CUDA) per rank, then
    the merge."""
    mx, ar = similarity.max_and_argmax_int8(queries, db_values, db_scales, limits, gids)
    all_mx, all_ar = gather_partials(mx[:, None], ar[:, None], mesh, axis)
    return merge_argmax(all_mx[..., 0], all_ar[..., 0])


def detect_batch_quantized_sharded(
    cfg: LoopConfig,
    db: ddb.QuantizedDB,
    state: detector.DetectorState,
    queries: torch.Tensor,
    global_idx: torch.Tensor,
    query_valid: torch.Tensor,
    mesh: Mesh,
    axis: str = "db",
):
    """``detect_batch_quantized`` over a sharded int8 DB."""
    limits = ddb.query_limits(db, global_idx, cfg.exclusion_window)
    mx, ar = sharded_max_and_argmax_int8(
        queries, db.values, db.scales, limits, db.global_ids, mesh, axis
    )
    searchable = (limits > 0) & query_valid
    return detector.temporal_consistency(cfg, state, mx, ar, global_idx, searchable, query_valid)
