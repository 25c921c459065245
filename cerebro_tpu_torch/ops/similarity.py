"""Descriptor similarity search: masked scores and max/argmax (counterpart of
cerebro_tpu/ops/similarity.py).

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

# Largest D whose 8-query group fits the 227 KB of shared memory a block may use.
_K1_MAX_DIM = (227 * 1024) // 16


def _row_gids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def scores(
    queries: torch.Tensor,  # (Q, D) unit descriptors
    db: torch.Tensor,  # (N, D) descriptor DB (rows may be invalid)
    limits: torch.Tensor,  # (Q,) int32 — query q may match gid < limits[q]
    gids: torch.Tensor | None = None,  # (N,) int32 per-row global ids
) -> torch.Tensor:
    """(Q, N) dot-product scores with masked entries at NEG_INF: f32
    products of the bf16-rounded inputs (``scores_xla`` of the JAX package)."""
    n = db.shape[0]
    s = queries.to(torch.bfloat16).float() @ db.to(torch.bfloat16).float().T
    g = _row_gids(n, db.device) if gids is None else gids.to(torch.int32)
    return torch.where(
        g[None, :] < limits[:, None].to(torch.int32),
        s,
        torch.full_like(s, NEG_INF),
    )


def max_and_argmax_plain(queries, db, limits, gids=None):
    """Plain PyTorch version of K1: (max score (Q,), matched gid (Q,))."""
    g = _row_gids(db.shape[0], db.device) if gids is None else gids.to(torch.int32)
    s = scores(queries, db, limits, g)
    return s.max(dim=1).values, g[s.argmax(dim=1)]


def max_and_argmax_cuda(queries, db, limits, gids=None):
    """K1 on CUDA tensors: (max score (Q,), matched gid (Q,))."""
    Q, D = queries.shape
    N = db.shape[0]
    for name, t in (("queries", queries), ("db", db), ("limits", limits)):
        if not t.is_cuda:
            raise ValueError(f"K1 needs CUDA tensors; {name} is on {t.device}")
    if D % 8 != 0:
        raise ValueError(f"K1 needs D % 8 == 0 (16-byte rows), got D={D}")
    if D > _K1_MAX_DIM:
        raise ValueError(f"K1 holds 8 queries of D <= {_K1_MAX_DIM} in shared memory, got {D}")
    if db.shape[1] != D or N == 0 or Q == 0:
        raise ValueError(f"bad shapes: queries {tuple(queries.shape)}, db {tuple(db.shape)}")
    dev = db.device
    g = _row_gids(N, dev) if gids is None else gids.to(device=dev, dtype=torch.int32)
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
