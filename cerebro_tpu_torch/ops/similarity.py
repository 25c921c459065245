"""Descriptor similarity search: masked scores, max/argmax and exact top-k
(counterpart of cerebro_tpu/ops/similarity.py).

The hot loop of the reference's candidate generator is three sequential
Eigen GEMVs per 10 Hz tick against the full descriptor history
(``u = v^T M[:, 0:l-50]``, src/Cerebro.cpp:1019-1032) on CPU. Here a batch of
query descriptors is scored against the device-resident DB in one call,
fused with masking and the selection.

Each function has a plain version (f32 products of the bf16-rounded inputs,
then ``where`` and ``max``/``argmax`` or a stable sort: the CPU path and the
tests' oracle) and, for CUDA tensors, one kernel, ``csrc/score_topk.cu``: a
single tensor-core pass over the DB that keeps each query's K best
(score, row) pairs, then a merge that writes (score, gid). It serves

  * K1, ``max_and_argmax`` (K=1);
  * K2, ``max_and_argmax_banned`` (K=1 with a banned-gid list per query) and
    ``search_topk`` (K=k: one partial launch and one merge per call).

``K1`` and ``K2`` below are two handles on that one library, so a run can
count the two kinds of launch apart. Unlike the JAX package, which sends
score matrices up to 256 MB to XLA (a v5e routing measurement), every CUDA
call goes to the kernel; a routing threshold needs H100 measurements first.

The int8 DB's search (``max_and_argmax_int8``) is no Pallas kernel in the
JAX package either (an int8 ``dot_general`` in XLA): on CUDA it is one
``torch._int_mm`` (int8 x int8 -> int32 on the tensor cores), then the
scales, the mask and the argmax in PyTorch; ``INT8_MM.launches`` counts
those products.

``search_topk`` returns exactly what the JAX package's dense ``search_topk``
(``lax.top_k`` over the masked score matrix) returns, on every slot: masked
rows take part in the selection at NEG_INF, so the slots past a query's last
real hit hold its lowest unmatchable rows, in row order.

Masking model: query q may match rows whose global id is below
``limits[q]`` (the reference's 50-frame exclusion window, src/Cerebro.cpp:
914,1026). Matches come back as GLOBAL ids (``gids[row]``), so they stay
valid after the ring wraps.
"""

from __future__ import annotations

import ctypes
import types

import torch

from cerebro_tpu_torch.ops._cuda import Kernel

NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_TOPK_ARGS = {"score_topk_launch": [_P] * 9 + [_I] * 6 + [_P]}
K1 = Kernel("score_topk.cu", _TOPK_ARGS)  # max_and_argmax
K2 = Kernel("score_topk.cu", _TOPK_ARGS)  # max_and_argmax_banned, search_topk
INT8_MM = types.SimpleNamespace(launches=0)  # torch._int_mm calls of the int8 search

# The kernel's instantiated list sizes: k is rounded up to the next one
# (callers use k = 1, 3, 5: the pipeline's top-3 runs the K = 4 list).
TOPK_SIZES = (1, 2, 4, 8, 16, 32)
MAX_TOPK = TOPK_SIZES[-1]
TILE_ROWS = 128  # DB rows per tile of the kernel (csrc/score_topk.cu)


def _row_gids(gids: torch.Tensor | None, db: torch.Tensor) -> torch.Tensor:
    """Per-row global ids as int32 on the DB's device; None means rows are
    their own ids."""
    if gids is None:
        return torch.arange(db.shape[0], dtype=torch.int32, device=db.device)
    return gids.to(device=db.device, dtype=torch.int32)


def row_blocks(n_rows: int, device) -> tuple:
    """(rows_per_block, nblocks) of the kernel's row split: one block per
    SM, each owning a contiguous range of a multiple of 32 rows (its TMA
    box)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows_per_block = 32 * -(-n_rows // (32 * sms))
    return rows_per_block, -(-n_rows // rows_per_block)


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


def _score_topk(kernel, name, queries, db, limits, gids, banned, k):
    """Launch the kernel through ``kernel``: the k best (score, gid) per
    query, (Q, k) each, rows whose gid is in ``banned[q]`` ((Q, KB) int32 or
    None) scored NEG_INF."""
    Q, D = queries.shape
    N = db.shape[0]
    for arg, t in (("queries", queries), ("db", db), ("limits", limits)):
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors; {arg} is on {t.device}")
    if D % 8 != 0:
        raise ValueError(f"{name} needs D % 8 == 0 (16-byte rows), got D={D}")
    if db.shape[1] != D or N == 0 or Q == 0:
        raise ValueError(f"bad shapes: queries {tuple(queries.shape)}, db {tuple(db.shape)}")
    K = next(s for s in TOPK_SIZES if s >= k)
    dev = db.device
    g = _row_gids(gids, db).contiguous()
    q16 = queries.to(device=dev, dtype=torch.bfloat16).contiguous()
    db16 = db.to(torch.bfloat16).contiguous()
    lim = limits.to(device=dev, dtype=torch.int32).contiguous()
    if g.shape != (N,) or lim.shape != (Q,):
        raise ValueError(f"bad shapes: gids {tuple(g.shape)}, limits {tuple(lim.shape)}")
    for arg, t in (("queries", q16), ("db", db16)):
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} needs a 16-byte-aligned {arg} (TMA)")
    KB, ban_ptr = 0, None
    if banned is not None:
        ban = banned.to(device=dev, dtype=torch.int32).contiguous()
        KB, ban_ptr = ban.shape[1], ban.data_ptr()
    rows_per_block, nblocks = row_blocks(N, dev)
    part_val = torch.empty((Q, nblocks, K), dtype=torch.float32, device=dev)
    part_row = torch.empty((Q, nblocks, K), dtype=torch.int32, device=dev)
    out_val = torch.empty((Q, K), dtype=torch.float32, device=dev)
    out_gid = torch.empty((Q, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernel.launch(
            "score_topk_launch",
            q16.data_ptr(), db16.data_ptr(), lim.data_ptr(), g.data_ptr(), ban_ptr,
            part_val.data_ptr(), part_row.data_ptr(), out_val.data_ptr(), out_gid.data_ptr(),
            Q, N, D, KB, K, rows_per_block,
        )
    return out_val[:, :k], out_gid[:, :k]


def max_and_argmax_plain(queries, db, limits, gids=None):
    """Plain PyTorch version of K1: (max score (Q,), matched gid (Q,))."""
    g = _row_gids(gids, db)
    s = scores(queries, db, limits, g)
    return s.max(dim=1).values, g[s.argmax(dim=1)]


def max_and_argmax_cuda(queries, db, limits, gids=None):
    """K1 on CUDA tensors: (max score (Q,), matched gid (Q,))."""
    v, g = _score_topk(K1, "K1", queries, db, limits, gids, None, 1)
    return v[:, 0], g[:, 0]


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
# Banned argmax and exact top-k (K2)
# ---------------------------------------------------------------------------


def max_and_argmax_banned_plain(queries, db, limits, gids, banned):
    """Plain PyTorch version of K2's banned argmax: (max score (Q,), matched
    gid (Q,)) with rows whose gid equals one of ``banned[q]`` ((Q, KB)
    int32, -1 slots inert) scored NEG_INF like masked rows."""
    g = _row_gids(gids, db)
    s = scores(queries, db, limits, g)
    ban = (g[None, :, None] == banned.to(torch.int32)[:, None, :]).any(dim=-1)
    s = torch.where(ban, torch.full_like(s, NEG_INF), s)
    return s.max(dim=1).values, g[s.argmax(dim=1)]


def max_and_argmax_banned_cuda(queries, db, limits, gids, banned):
    """K2's banned argmax on CUDA tensors: (max score (Q,), matched gid (Q,))."""
    Q = queries.shape[0]
    if banned.dim() != 2 or banned.shape[0] != Q or banned.shape[1] == 0:
        raise ValueError(f"banned must be (Q={Q}, KB>=1), got {tuple(banned.shape)}")
    v, g = _score_topk(K2, "K2", queries, db, limits, gids, banned, 1)
    return v[:, 0], g[:, 0]


def max_and_argmax_banned(queries, db, limits, gids, banned):
    """Per-query (max score, matched gid) over the DB, skipping each query's
    banned gids. Ties go to the lowest row; a query with no matchable,
    unbanned row returns (NEG_INF, gids[0]).

    CPU tensors take the plain version; CUDA tensors launch K2."""
    if db.is_cuda:
        return max_and_argmax_banned_cuda(queries, db, limits, gids, banned)
    return max_and_argmax_banned_plain(queries, db, limits, gids, banned)


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
    Q = queries.shape[0]
    banned = torch.full((Q, max(k, 1)), -1, dtype=torch.int32, device=db.device)
    vals, idxs = [], []
    for j in range(k):
        mx, ar = max_and_argmax_banned(queries, db, limits, gids, banned)
        vals.append(mx)
        idxs.append(ar)
        # in place on the device between passes: no host round trip
        banned[:, j] = torch.where(mx > NEG_INF / 2, ar, torch.full_like(ar, -1))
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _check_k(k: int, n_rows: int):
    if not 0 < k <= n_rows:
        raise ValueError(f"k={k} outside [1, N={n_rows}]")


def search_topk_plain(queries, db, limits, gids=None, k: int = 5):
    """Plain version of ``search_topk``: the masked score matrix sorted by
    (-score, row), so ties go to the lower row as in ``lax.top_k``."""
    _check_k(k, db.shape[0])
    g = _row_gids(gids, db)
    s = scores(queries, db, limits, g)
    v, rows = torch.sort(s, dim=1, descending=True, stable=True)
    return v[:, :k], g[rows[:, :k]]


def search_topk_cuda(queries, db, limits, gids=None, k: int = 5):
    """``search_topk`` on CUDA tensors: one pass of K2 with K = k rounded up
    to an instantiated size, at most ``MAX_TOPK``."""
    _check_k(k, db.shape[0])
    if k > MAX_TOPK:
        raise ValueError(f"k={k} above the kernel's largest top-k size, {MAX_TOPK}")
    return _score_topk(K2, "K2", queries, db, limits, gids, None, k)


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

    CPU tensors take the plain version; CUDA tensors launch K2 once."""
    if db.is_cuda:
        return search_topk_cuda(queries, db, limits, gids, k)
    return search_topk_plain(queries, db, limits, gids, k)


# ---------------------------------------------------------------------------
# Int8-quantized search: half the HBM per row of the bf16 DB. Descriptors
# are unit-norm, so symmetric per-row scaling loses ~1e-2 in the dot
# product, far inside the 0.85 detection threshold's margin.
# ---------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor):
    """(N, D) float -> (values int8 (N, D), scales f32 (N,)): symmetric per
    row, round half to even, as the JAX package's ``quantize_rows`` (whose
    ``/ 127.0`` XLA compiles to a product with the f32 reciprocal)."""
    x = x.float()
    scale = torch.clamp(x.abs().max(dim=-1).values, min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def int8_scores_plain(q_q: torch.Tensor, db_q: torch.Tensor) -> torch.Tensor:
    """(Q, N) int32 products of int8 rows, exact on any device: the f64
    product of integers below 2^7 sums exactly for D up to 2^39, and the
    sums (at most 127^2 * D) fit int32 for D up to 133,000."""
    return (q_q.double() @ db_q.double().T).to(torch.int32)


def int8_scores_cuda(q_q: torch.Tensor, db_q: torch.Tensor) -> torch.Tensor:
    """(Q, N) int32 products of int8 rows on CUDA tensors: one
    ``torch._int_mm``. Its int8 GEMM takes more than 16 rows and widths that
    are multiples of 8, so the queries are padded with zero rows; the
    (N, D) row-major DB, transposed, is the column-major second operand."""
    Q, D = q_q.shape
    N = db_q.shape[0]
    if not (q_q.is_cuda and db_q.is_cuda):
        raise ValueError("int8_scores_cuda needs CUDA tensors")
    if D % 8 != 0 or N % 8 != 0:
        raise ValueError(f"the int8 product needs D and N divisible by 8, got D={D}, N={N}")
    rows = max(24, -(-Q // 8) * 8)
    a = torch.nn.functional.pad(q_q, (0, 0, 0, rows - Q)) if rows != Q else q_q
    INT8_MM.launches += 1
    return torch._int_mm(a.contiguous(), db_q.T)[:Q]


def _int8_select(scores_fn, queries, db_q, db_scale, limits, gids):
    q_q, q_scale = quantize_rows(queries)
    s = scores_fn(q_q.to(db_q.device), db_q)
    # JAX's order: the scales, then the mask, then the first-max argmax
    s = s.float() * q_scale.to(s.device)[:, None] * db_scale.float()[None, :]
    g = _row_gids(gids, db_q)
    s = torch.where(g[None, :] < limits[:, None].to(torch.int32), s, torch.full_like(s, NEG_INF))
    return s.max(dim=1).values, g[s.argmax(dim=1)]


def max_and_argmax_int8_plain(queries, db_q, db_scale, limits, gids=None):
    """``max_and_argmax_int8`` through the plain exact product."""
    return _int8_select(int8_scores_plain, queries, db_q, db_scale, limits, gids)


def max_and_argmax_int8_cuda(queries, db_q, db_scale, limits, gids=None):
    """``max_and_argmax_int8`` on CUDA tensors: one ``torch._int_mm``."""
    return _int8_select(int8_scores_cuda, queries, db_q, db_scale, limits, gids)


def max_and_argmax_int8(
    queries: torch.Tensor,  # (Q, D) float
    db_q: torch.Tensor,  # (N, D) int8
    db_scale: torch.Tensor,  # (N,) f32
    limits: torch.Tensor,  # (Q,) int32
    gids: torch.Tensor | None = None,  # (N,) int32
):
    """Per-query (max, matched gid) over an int8-quantized DB: the queries
    quantized per row, the exact int8 x int8 -> int32 product, then, in the
    JAX package's order, ``s * q_scale * db_scale``, the mask and the
    first-max argmax, so gids and maxima equal JAX's.

    CPU tensors take the plain product; CUDA tensors one ``torch._int_mm``."""
    if db_q.is_cuda:
        return max_and_argmax_int8_cuda(queries, db_q, db_scale, limits, gids)
    return max_and_argmax_int8_plain(queries, db_q, db_scale, limits, gids)
