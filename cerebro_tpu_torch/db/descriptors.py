"""Device-resident descriptor database as a true ring (counterpart of
cerebro_tpu/db/descriptors.py).

The reference's equivalent is a statically preallocated Eigen matrix of
29 000 descriptor columns guarded by a mutex, appended on each tick and
hard-capped (src/Cerebro.cpp:946,1002-1013). Here the DB holds a
fixed-capacity ``(N, D)`` device tensor plus per-row **global ids** and a
cumulative ``total``; past capacity the buffer wraps: the oldest rows are
evicted, never the newest.

Masking model: every search masks by ``global_ids[row] < limit`` instead of
``row < limit``. Pre-wrap the two are identical (gid == row); post-wrap the
gid comparison stays correct because ids are monotone in time regardless of
where the ring put them. Rows never written (or written by the invalid tail
of a partial batch) carry ``GID_INVALID`` = int32 max, which no limit ever
exceeds.

Unlike the JAX version, which returns a new pytree per append, ``append``
writes the ring in place. ``count`` and ``total`` are host integers: the
host decides how many rows each batch holds, so reading them never waits on
the device.

On CUDA the search kernels load rows in 16-byte pieces, so a CUDA DB whose
descriptor width ``dim`` is not a multiple of 8 stores each row
zero-padded to the next multiple of 8 (``vectors`` is (N, width)), and
queries enter detection padded the same way (``pad_queries``). Zeros add
nothing to a dot product: scores and matches are those of the unpadded
rows. ``dim`` stays the logical width.

A DB may hold one rank's block of a ring sharded over a mesh
(``parallel.shard_db``): ``row0`` is the first ring row it holds and
``ring_capacity`` the ring's rows over all ranks, so ``capacity`` is the
ring's and the tensors hold ``local_rows`` of it. ``append`` then writes
only the batch rows that fall in the block.
"""

from __future__ import annotations

import dataclasses

import torch

# Rows carrying this id are unmatchable: limits are at most `total`, which
# is always far below int32 max.
GID_INVALID = 2**31 - 1


@dataclasses.dataclass
class DescriptorDB:
    vectors: torch.Tensor  # (capacity, width) bf16 or f32 unit descriptors
    global_ids: torch.Tensor  # (capacity,) int32, GID_INVALID if empty
    count: int = 0  # number of valid rows (= min(total, capacity))
    total: int = 0  # cumulative appended entries (monotone)
    logical_dim: int | None = None  # the descriptor width; None: width
    row0: int = 0  # first ring row held here (a shard's block)
    ring_capacity: int | None = None  # the ring's rows on all ranks; None: local_rows

    @property
    def local_rows(self) -> int:
        return self.vectors.shape[0]

    @property
    def capacity(self) -> int:
        return self.local_rows if self.ring_capacity is None else self.ring_capacity

    @property
    def dim(self) -> int:
        """The descriptor width (columns past it are zero padding)."""
        return self.vectors.shape[1] if self.logical_dim is None else self.logical_dim

    @property
    def width(self) -> int:
        """The stored row width."""
        return self.vectors.shape[1]


def row_width(dim: int, device) -> int:
    """Stored row width of a ``dim``-wide DB on ``device``: ``dim`` rounded
    up to a multiple of 8 on CUDA (16-byte rows for the kernels), else
    ``dim``."""
    return -(-dim // 8) * 8 if torch.device(device).type == "cuda" else dim


def create(
    capacity: int, dim: int, dtype=torch.bfloat16, device="cuda"
) -> DescriptorDB:
    return DescriptorDB(
        vectors=torch.zeros((capacity, row_width(dim, device)), dtype=dtype, device=device),
        global_ids=torch.full(
            (capacity,), GID_INVALID, dtype=torch.int32, device=device
        ),
        logical_dim=dim,
    )


def pad_queries(db: DescriptorDB, queries: torch.Tensor) -> torch.Tensor:
    """(Q, dim) queries zero-padded to the DB's row width (a no-op when the
    rows are not padded)."""
    if queries.shape[1] != db.dim:
        raise ValueError(f"queries are {queries.shape[1]} wide, the DB holds {db.dim}")
    pad = db.width - db.dim
    return torch.nn.functional.pad(queries, (0, pad)) if pad else queries


def append(db: DescriptorDB, descs: torch.Tensor, n_new: int) -> DescriptorDB:
    """Append the first ``n_new`` rows of ``descs`` (B, D) at the ring head,
    in place; returns ``db``.

    Rows of the batch past ``n_new`` are written with GID_INVALID so they
    stay unmatchable until real entries overwrite them.
    """
    if descs.shape[1] != db.dim:
        raise ValueError(f"descriptors are {descs.shape[1]} wide, the DB holds {db.dim}")
    # in place: the ring rows and their ids are overwritten at the head
    # (padding columns, if any, stay zero)
    descs = descs.to(device=db.vectors.device, dtype=db.vectors.dtype)
    for j, r, n, gids in _ring_runs(db, descs.shape[0], n_new):
        db.vectors[r : r + n, : db.dim] = descs[j : j + n]
        db.global_ids[r : r + n] = gids
    db.total += int(n_new)
    db.count = min(db.total, db.capacity)
    return db


def _ring_runs(db, B: int, n_new: int):
    """The runs of a B-row batch at the ring head (its first ``n_new`` rows
    real) that land in the rows held here: (first batch row, first local
    row, length, their global ids (length,) int32) each. A batch spans at
    most two runs of the ring (it may wrap once); a shard keeps the parts
    inside its block. Slices, not index tensors, so nothing is read back."""
    cap = db.capacity
    if B > cap:
        raise ValueError(f"batch {B} exceeds DB capacity {cap}")
    if not 0 <= n_new <= B:
        raise ValueError(f"n_new={n_new} outside [0, {B}]")
    j = torch.arange(B, dtype=torch.int64, device=db.global_ids.device)
    gids = torch.where(j < n_new, db.total + j, torch.full_like(j, GID_INVALID)).to(torch.int32)
    runs, j0 = [], 0
    while j0 < B:
        g = (db.total + j0) % cap  # ring row of batch row j0
        n = min(B - j0, cap - g)  # up to the ring's end
        lo, hi = max(g, db.row0), min(g + n, db.row0 + db.local_rows)
        if lo < hi:
            first = j0 + lo - g
            runs.append((first, lo - db.row0, hi - lo, gids[first : first + hi - lo]))
        j0 += n
    return runs


def query_limits(
    db: DescriptorDB, global_idx: torch.Tensor, exclusion: int
) -> torch.Tensor:
    """Per-query exclusive bound on matchable GLOBAL ids: query with global
    index g may match entries with id < g - exclusion (ref src/Cerebro.cpp:914
    ``l - 50``), clipped to what has actually been appended."""
    return torch.clamp(global_idx.to(torch.int32) - exclusion, 0, db.total).to(
        torch.int32
    )


# ---------------------------------------------------------------------------
# Int8-quantized DB: the same contract, half the memory per row of the
# bf16 DB, searched by an int8 product (ops/similarity.max_and_argmax_int8).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantizedDB:
    values: torch.Tensor  # (capacity, width) int8
    scales: torch.Tensor  # (capacity,) f32 per-row dequantization scale
    global_ids: torch.Tensor  # (capacity,) int32, GID_INVALID if empty
    count: int = 0
    total: int = 0
    logical_dim: int | None = None
    row0: int = 0
    ring_capacity: int | None = None

    @property
    def local_rows(self) -> int:
        return self.values.shape[0]

    @property
    def capacity(self) -> int:
        return self.local_rows if self.ring_capacity is None else self.ring_capacity

    @property
    def dim(self) -> int:
        return self.values.shape[1] if self.logical_dim is None else self.logical_dim

    @property
    def width(self) -> int:
        return self.values.shape[1]


def create_quantized(capacity: int, dim: int, device="cuda") -> QuantizedDB:
    """An empty int8 DB; on CUDA its rows are padded as ``create``'s are."""
    return QuantizedDB(
        values=torch.zeros((capacity, row_width(dim, device)), dtype=torch.int8, device=device),
        scales=torch.zeros((capacity,), dtype=torch.float32, device=device),
        global_ids=torch.full((capacity,), GID_INVALID, dtype=torch.int32, device=device),
        logical_dim=dim,
    )


def append_quantized(db: QuantizedDB, descs: torch.Tensor, n_new: int) -> QuantizedDB:
    """Quantize the batch per row (``quantize_rows``) and append it at the
    ring head, in place, with ``append``'s ring semantics; returns ``db``."""
    from cerebro_tpu_torch.ops.similarity import quantize_rows

    if descs.shape[1] != db.dim:
        raise ValueError(f"descriptors are {descs.shape[1]} wide, the DB holds {db.dim}")
    q, s = quantize_rows(descs.to(db.values.device))
    for j, r, n, gids in _ring_runs(db, descs.shape[0], n_new):
        db.values[r : r + n, : db.dim] = q[j : j + n]
        db.scales[r : r + n] = s[j : j + n]
        db.global_ids[r : r + n] = gids
    db.total += int(n_new)
    db.count = min(db.total, db.capacity)
    return db


def from_rows(vectors: torch.Tensor, n_valid: int | None = None) -> DescriptorDB:
    """Build a pre-wrap DB directly from a row matrix: row i is entry i.
    Rows >= n_valid are unmatchable. Convenience for benches/tests."""
    n = vectors.shape[0]
    if n_valid is None:
        n_valid = n
    ar = torch.arange(n, dtype=torch.int32, device=vectors.device)
    gids = torch.where(ar < n_valid, ar, torch.full_like(ar, GID_INVALID))
    return DescriptorDB(
        vectors=vectors, global_ids=gids, count=min(n_valid, n), total=n_valid
    )
