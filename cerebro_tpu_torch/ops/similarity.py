"""Descriptor similarity search: masked scores, max/argmax and exact top-k
(counterpart of cerebro_tpu/ops/similarity.py).

The hot loop of the reference's candidate generator is three sequential
Eigen GEMVs per 10 Hz tick against the full descriptor history
(``u = v^T M[:, 0:l-50]``, src/Cerebro.cpp:1019-1032) on CPU. Here a batch of
query descriptors is scored against the device-resident DB in one call,
fused with masking and the max/argmax.

Two implementations of ``max_and_argmax``:
  * ``max_and_argmax_plain`` — f32 matmul of the bf16-rounded inputs, then
    ``where``, ``max`` and ``argmax``. The CPU path and the tests' oracle.
  * kernel K1 (``csrc/score_argmax.cu``) for CUDA tensors. Unlike the JAX
    package, which sends score matrices up to 256 MB to XLA (a v5e routing
    measurement), every CUDA call goes to the kernel; a routing threshold
    needs H100 measurements first.

Top-k (``search_topk``) returns exactly what the JAX package's dense
``search_topk`` (``lax.top_k`` over the masked score matrix) returns, on every
slot: on CPU tensors by a stable sort of that matrix, on CUDA tensors by k
passes of kernel K2 (``csrc/score_argmax_banned.cu``, a masked max/argmax
that skips a per-query list of banned gids), as JAX's
``search_topk_streaming`` runs them, followed by a fill of the slots past a
query's last real hit in dense order. The same routing note as K1 holds.

Masking model: query q may match rows whose global id is below
``limits[q]`` (the reference's 50-frame exclusion window, src/Cerebro.cpp:
914,1026). Matches come back as GLOBAL ids (``gids[row]``), so they stay
valid after the ring wraps.
"""

from __future__ import annotations

import ctypes

import torch

from cerebro_tpu_torch.ops._cuda import Kernel

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
K1 = Kernel(
    "score_argmax.cu",
    {"score_argmax_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
)

K2 = Kernel(
    "score_argmax_banned.cu",
    {"banned_argmax_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
)

# Shared memory a block may use on Hopper; K1 and K2 hold an 8-query group
# of D bf16 values (16 * D bytes) in it, K2 also 8 banned lists of KB int32.
_SMEM_BYTES = 227 * 1024


def _row_gids(gids: torch.Tensor | None, db: torch.Tensor) -> torch.Tensor:
    """Per-row global ids as int32 on the DB's device; None means rows are
    their own ids."""
    if gids is None:
        return torch.arange(db.shape[0], dtype=torch.int32, device=db.device)
    return gids.to(device=db.device, dtype=torch.int32)


def scores(
    queries: torch.Tensor,  # (Q, D) unit descriptors
    db: torch.Tensor,  # (N, D) descriptor DB (rows may be invalid)
    limits: torch.Tensor,  # (Q,) int32 — query q may match gid < limits[q]
    gids: torch.Tensor | None = None,  # (N,) int32 per-row global ids
) -> torch.Tensor:
    """(Q, N) dot-product scores with masked entries at NEG_INF: f32
    products of the bf16-rounded inputs (``scores_xla`` of the JAX package)."""
    s = queries.to(torch.bfloat16).float() @ db.to(torch.bfloat16).float().T
    g = _row_gids(gids, db)
    return torch.where(
        g[None, :] < limits[:, None].to(torch.int32),
        s,
        torch.full_like(s, NEG_INF),
    )


def max_and_argmax_plain(queries, db, limits, gids=None):
    """Plain PyTorch version of K1: (max score (Q,), matched gid (Q,))."""
    g = _row_gids(gids, db)
    s = scores(queries, db, limits, g)
    return s.max(dim=1).values, g[s.argmax(dim=1)]


def _kernel_operands(name, queries, db, limits, gids, smem_bytes):
    """Check and convert the operands K1 and K2 share: (q16, db16, lim, g,
    rows_per_block, nblocks). ``smem_bytes`` is the block's shared memory."""
    Q, D = queries.shape
    N = db.shape[0]
    for arg, t in (("queries", queries), ("db", db), ("limits", limits)):
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors; {arg} is on {t.device}")
    if D % 8 != 0:
        raise ValueError(f"{name} needs D % 8 == 0 (16-byte rows), got D={D}")
    if smem_bytes > _SMEM_BYTES:
        raise ValueError(
            f"{name} holds 8 queries of D={D} in shared memory: {smem_bytes} bytes "
            f"> {_SMEM_BYTES}"
        )
    if db.shape[1] != D or N == 0 or Q == 0:
        raise ValueError(f"bad shapes: queries {tuple(queries.shape)}, db {tuple(db.shape)}")
    dev = db.device
    g = _row_gids(gids, db)
    q16 = queries.to(device=dev, dtype=torch.bfloat16).contiguous()
    db16 = db.to(torch.bfloat16).contiguous()
    lim = limits.to(device=dev, dtype=torch.int32).contiguous()
    g = g.contiguous()
    if g.shape != (N,) or lim.shape != (Q,):
        raise ValueError(f"bad shapes: gids {tuple(g.shape)}, limits {tuple(lim.shape)}")
    # one block per SM: the 128 KB query group leaves room for one resident block
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_per_block = max(64, -(-N // sms))
    nblocks = -(-N // rows_per_block)
    return q16, db16, lim, g, rows_per_block, nblocks


def max_and_argmax_cuda(queries, db, limits, gids=None):
    """K1 on CUDA tensors: (max score (Q,), matched gid (Q,))."""
    Q, D = queries.shape
    N = db.shape[0]
    q16, db16, lim, g, rows_per_block, nblocks = _kernel_operands(
        "K1", queries, db, limits, gids, 16 * D
    )
    dev = db.device
    part_max = torch.empty((Q, nblocks), dtype=torch.float32, device=dev)
    part_row = torch.empty((Q, nblocks), dtype=torch.int32, device=dev)
    out_max = torch.empty((Q,), dtype=torch.float32, device=dev)
    out_row = torch.empty((Q,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        K1.launch(
            "score_argmax_launch",
            q16.data_ptr(), db16.data_ptr(), lim.data_ptr(), g.data_ptr(),
            part_max.data_ptr(), part_row.data_ptr(),
            out_max.data_ptr(), out_row.data_ptr(),
            Q, N, D, rows_per_block,
        )
    # the kernel tracks winners as ROW indices; translate to global ids here
    return out_max, g[out_row.long()]


def max_and_argmax(
    queries: torch.Tensor,  # (Q, D)
    db: torch.Tensor,  # (N, D)
    limits: torch.Tensor,  # (Q,) int32 exclusive gid bound per query
    gids: torch.Tensor | None = None,  # (N,) int32; None -> rows are their own ids
):
    """Per-query (max score, matched gid) over the DB — the quantity the
    reference's detector needs per tick (argmax of u/um/umm plus the max
    value, src/Cerebro.cpp:1019-1056). Ties go to the lowest row; an
    all-masked query returns (NEG_INF, gids[0]).

    CPU tensors take the plain version; CUDA tensors launch K1."""
    if db.is_cuda:
        return max_and_argmax_cuda(queries, db, limits, gids)
    return max_and_argmax_plain(queries, db, limits, gids)


# ---------------------------------------------------------------------------
# Exact top-k: k banned-argmax passes (K2), dense filler order
# ---------------------------------------------------------------------------


def max_and_argmax_banned_plain(queries, db, limits, gids, banned):
    """Plain PyTorch version of K2: (max score (Q,), matched gid (Q,)) with
    rows whose gid equals one of ``banned[q]`` ((Q, KB) int32, -1 slots
    inert) scored NEG_INF like masked rows."""
    g = _row_gids(gids, db)
    s = scores(queries, db, limits, g)
    ban = (g[None, :, None] == banned.to(torch.int32)[:, None, :]).any(dim=-1)
    s = torch.where(ban, torch.full_like(s, NEG_INF), s)
    return s.max(dim=1).values, g[s.argmax(dim=1)]


def max_and_argmax_banned_cuda(queries, db, limits, gids, banned):
    """K2 on CUDA tensors: (max score (Q,), matched gid (Q,))."""
    Q, D = queries.shape
    N = db.shape[0]
    if banned.dim() != 2 or banned.shape[0] != Q or banned.shape[1] == 0:
        raise ValueError(f"banned must be (Q={Q}, KB>=1), got {tuple(banned.shape)}")
    KB = banned.shape[1]
    q16, db16, lim, g, rows_per_block, nblocks = _kernel_operands(
        "K2", queries, db, limits, gids, 16 * D + 32 * KB
    )
    dev = db.device
    ban = banned.to(device=dev, dtype=torch.int32).contiguous()
    part_max = torch.empty((Q, nblocks), dtype=torch.float32, device=dev)
    part_row = torch.empty((Q, nblocks), dtype=torch.int32, device=dev)
    out_max = torch.empty((Q,), dtype=torch.float32, device=dev)
    out_gid = torch.empty((Q,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        K2.launch(
            "banned_argmax_launch",
            q16.data_ptr(), db16.data_ptr(), lim.data_ptr(), g.data_ptr(), ban.data_ptr(),
            part_max.data_ptr(), part_row.data_ptr(),
            out_max.data_ptr(), out_gid.data_ptr(),
            Q, N, D, KB, rows_per_block,
        )
    return out_max, out_gid


def max_and_argmax_banned(queries, db, limits, gids, banned):
    """Per-query (max score, matched gid) over the DB, skipping each query's
    banned gids. Ties go to the lowest row; a query with no matchable,
    unbanned row returns (NEG_INF, gids[0]).

    CPU tensors take the plain version; CUDA tensors launch K2."""
    if db.is_cuda:
        return max_and_argmax_banned_cuda(queries, db, limits, gids, banned)
    return max_and_argmax_banned_plain(queries, db, limits, gids, banned)


def _streaming(queries, db, limits, gids, k, banned_argmax):
    Q = queries.shape[0]
    banned = torch.full((Q, max(k, 1)), -1, dtype=torch.int32, device=db.device)
    vals, idxs = [], []
    for j in range(k):
        mx, ar = banned_argmax(queries, db, limits, gids, banned)
        vals.append(mx)
        idxs.append(ar)
        # in place on the device between passes: no host round trip
        banned[:, j] = torch.where(mx > NEG_INF / 2, ar, torch.full_like(ar, -1))
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def search_topk_streaming(
    queries: torch.Tensor,  # (Q, D)
    db: torch.Tensor,  # (N, D)
    limits: torch.Tensor,  # (Q,) int32
    gids: torch.Tensor | None = None,  # (N,) int32
    k: int = 5,
):
    """Exact top-k by k banned-argmax passes (K2 on CUDA tensors), each
    banning the gids found so far, as the JAX package's
    ``search_topk_streaming``. Returns (values (Q, k), gids (Q, k)). A slot
    past a query's last real hit holds (NEG_INF, gids[0]): fillers are never
    banned, so every later pass finds the same all-masked answer."""
    return _streaming(queries, db, limits, gids, k, max_and_argmax_banned)


def search_topk_plain(queries, db, limits, gids=None, k: int = 5):
    """Plain version of ``search_topk``: the masked score matrix sorted by
    (-score, row), so ties go to the lower row as in ``lax.top_k``."""
    if not 0 < k <= db.shape[0]:
        raise ValueError(f"k={k} outside [1, N={db.shape[0]}]")
    g = _row_gids(gids, db)
    s = scores(queries, db, limits, g)
    v, rows = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], g[rows[:, :k]]


def fill_dense_order(vals, idx, limits, gids):
    """Rewrite the filler slots of a streaming top-k in the order of the
    dense top-k, on the device.

    A query with n < k real hits (values above NEG_INF / 2) has used up all
    of its matchable rows. The dense top-k then continues, at NEG_INF, with
    the query's unmatchable rows (gid >= limit) in row order; streaming
    instead repeats gids[0]. Banning cannot repair that: every empty ring
    row carries the same GID_INVALID, so banning one bans them all."""
    Q, k = vals.shape
    N = gids.shape[0]
    dev = vals.device
    rows = torch.arange(N, dtype=torch.int64, device=dev)
    unmatchable = gids[None, :] >= limits.to(torch.int32)[:, None]  # (Q, N)
    # the k lowest unmatchable rows per query, ascending (keys are distinct)
    key = torch.where(unmatchable, rows[None, :], torch.full_like(rows, N)[None, :])
    first = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    n_real = (vals > NEG_INF / 2).sum(dim=1, keepdim=True)  # (Q, 1)
    slot = torch.arange(k, device=dev)[None, :]
    fill_row = first.gather(1, (slot - n_real).clamp(0, k - 1)).clamp(max=N - 1)
    return vals, torch.where(slot >= n_real, gids[fill_row], idx)


def search_topk_cuda(queries, db, limits, gids=None, k: int = 5):
    """``search_topk`` on CUDA tensors: k K2 passes, then the dense filler
    order."""
    if not 0 < k <= db.shape[0]:
        raise ValueError(f"k={k} outside [1, N={db.shape[0]}]")
    g = _row_gids(gids, db)
    vals, idx = _streaming(queries, db, limits, g, k, max_and_argmax_banned_cuda)
    return fill_dense_order(vals, idx, limits, g)


def search_topk(
    queries: torch.Tensor,  # (Q, D)
    db: torch.Tensor,  # (N, D)
    limits: torch.Tensor,  # (Q,) int32
    gids: torch.Tensor | None = None,  # (N,) int32
    k: int = 5,
):
    """Full top-k retrieval (the faiss IndexFlatIP k-NN equivalent, ref
    src/Cerebro.cpp:460): (values (Q, k), gids (Q, k)), equal on every slot
    to the JAX package's dense ``search_topk``, filler slots included.

    CPU tensors take the plain version; CUDA tensors run k K2 passes."""
    if db.is_cuda:
        return search_topk_cuda(queries, db, limits, gids, k)
    return search_topk_plain(queries, db, limits, gids, k)
