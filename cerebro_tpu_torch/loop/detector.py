"""Loop-candidate generation: batched similarity + temporal consistency
(counterpart of cerebro_tpu/loop/detector.py: Method A, top-1 and top-k).

Re-implements the behavior of the reference's default candidate generator
``Cerebro::descrip_N__dot__descrip_0_N`` (src/Cerebro.cpp:903-1103):

  per new descriptor v at global index g, score u = v . M[:, 0:g-50];
  a loop is declared at g when the argmaxes of the scores of the 3 newest
  consecutive descriptors (g, g-1, g-2) agree within LOCALITY_THRESH=12
  frames and max(u) > DOT_PROD_THRESH=0.85 (thresholds at
  src/Cerebro.cpp:912-914, decision at :1056-1081); the emitted candidate
  is (t_curr=g, t_prev=argmax, score).

A batch of new descriptors is scored in one masked max/argmax call, and the
3-way agreement is computed across the batch with a 2-entry carry (argmax
and max of the previous two queries), so batch boundaries behave exactly
like the streaming original. Everything stays on the tensors' device; the
host reads candidates when it needs them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cerebro_tpu_torch.config import LoopConfig
from cerebro_tpu_torch.db.descriptors import DescriptorDB, QuantizedDB, query_limits
from cerebro_tpu_torch.ops import similarity


@dataclasses.dataclass(frozen=True)
class DetectorState:
    """Carry across batches: scores of the 2 most recent queries."""

    prev_arg: torch.Tensor  # (2,) int32 — argmax of queries g-2 (slot 0), g-1 (slot 1)
    prev_max: torch.Tensor  # (2,) float32
    prev_valid: torch.Tensor  # (2,) bool — those queries existed (stream warm-up)


def init_state(device="cuda") -> DetectorState:
    return DetectorState(
        prev_arg=torch.zeros((2,), dtype=torch.int32, device=device),
        prev_max=torch.full((2,), similarity.NEG_INF, dtype=torch.float32, device=device),
        prev_valid=torch.zeros((2,), dtype=torch.bool, device=device),
    )


@dataclasses.dataclass(frozen=True)
class LoopCandidates:
    """Dense fixed-shape candidate batch (one slot per query)."""

    curr_idx: torch.Tensor  # (B,) int32 global frame index of the query
    prev_idx: torch.Tensor  # (B,) int32 matched history frame index
    score: torch.Tensor  # (B,) float32 max dot product
    valid: torch.Tensor  # (B,) bool — passed threshold + 3-way locality test
    agree: torch.Tensor  # (B,) bool — locality agreement alone (pre-threshold)


def temporal_consistency(
    cfg: LoopConfig,
    state: DetectorState,
    mx: torch.Tensor,  # (B,) max score per query
    ar: torch.Tensor,  # (B,) argmax global id per query
    global_idx: torch.Tensor,  # (B,)
    searchable: torch.Tensor,  # (B,) bool
    query_valid: torch.Tensor,  # (B,) bool
) -> Tuple[LoopCandidates, DetectorState]:
    """The 3-way argmax-locality + threshold rule applied over a batch with
    a 2-entry carry."""
    B = mx.shape[0]
    mx = torch.where(searchable, mx, torch.full_like(mx, similarity.NEG_INF))

    # Stack the carry in front: position i of the stacked arrays is query
    # i - 2 of the batch, so slot j's triple is (j+2, j+1, j) = (g, g-1, g-2).
    args = torch.cat([state.prev_arg, ar.to(torch.int32)])  # (B+2,)
    maxs = torch.cat([state.prev_max, mx.float()])
    valids = torch.cat([state.prev_valid, searchable])

    a0, a1, a2 = args[2:], args[1:-1], args[:-2]
    loc = cfg.locality_threshold
    if cfg.consistency_frames <= 2:
        v_all = valids[2:] & valids[1:-1]
        agree = (a0 - a1).abs() < loc
    else:
        v_all = valids[2:] & valids[1:-1] & valids[:-2]
        agree = ((a0 - a1).abs() < loc) & ((a0 - a2).abs() < loc) & ((a1 - a2).abs() < loc)
    strong = maxs[2:] > cfg.dot_threshold

    cands = LoopCandidates(
        curr_idx=global_idx.to(torch.int32),
        prev_idx=a0,
        score=maxs[2:],
        valid=v_all & agree & strong,
        agree=v_all & agree,
    )

    # New carry: the last two REAL queries of this batch (partial batches
    # have query_valid False at the tail).
    n_valid = query_valid.to(torch.int64).sum()
    new_state = DetectorState(
        prev_arg=_carry_rows(args, state.prev_arg, n_valid, B),
        prev_max=_carry_rows(maxs, state.prev_max, n_valid, B),
        prev_valid=_carry_rows(valids, state.prev_valid, n_valid, B),
    )
    return cands, new_state


def _carry_rows(arr, old, n_valid, B):
    """The carry of the last two REAL queries of a batch, from ``arr``
    (the (B+2, ...) carry-stacked rows) and the old carry ``old`` (2, ...):
    n_valid == 0 keeps [old0, old1]; == 1 shifts to [old1, new]; >= 2 takes
    the last two new queries. index_select keeps the indexing on the
    device."""
    idx_last = (torch.clamp(n_valid - 1, 0, B - 1) + 2).reshape(1)
    idx_prev = (torch.clamp(n_valid - 2, -1, B - 1) + 2).reshape(1)
    slot0 = torch.where(
        n_valid >= 2, arr.index_select(0, idx_prev)[0],
        torch.where(n_valid == 1, old[1], old[0]),
    )
    slot1 = torch.where(n_valid > 0, arr.index_select(0, idx_last)[0], old[1])
    return torch.stack([slot0, slot1])


@dataclasses.dataclass(frozen=True)
class TopKState:
    """Carry for the top-k detector: the top-k hit ids of the 2 newest
    queries (the locality rule needs the neighbours' hit sets)."""

    prev_idx: torch.Tensor  # (2, K) int32 global ids
    prev_ok: torch.Tensor  # (2,) bool — those queries existed and were searchable


def init_topk_state(k: int, device="cuda") -> TopKState:
    return TopKState(
        prev_idx=torch.zeros((2, k), dtype=torch.int32, device=device),
        prev_ok=torch.zeros((2,), dtype=torch.bool, device=device),
    )


def temporal_consistency_topk(
    cfg: LoopConfig,
    state: TopKState,
    vals: torch.Tensor,  # (B, K) top-k scores per query, queries consecutive
    idx: torch.Tensor,  # (B, K) top-k history global ids
    global_idx: torch.Tensor,  # (B,)
    searchable: torch.Tensor,  # (B,) bool
    query_valid: torch.Tensor,  # (B,) bool
) -> Tuple[LoopCandidates, TopKState]:
    """Method A's locality rule generalized to k hits per query: hit (q, r)
    agrees when ANY hit of query q-1 (and q-2 for consistency_frames=3)
    lies within locality_threshold on the history axis. A hit dominated by
    a better hit of the same query within ±locality (higher score, or equal
    score at a lower rank) is dropped, so the verifier sees k DISTINCT
    revisit hypotheses (the widened frontier of the reference's faiss
    methods, src/Cerebro.cpp:366-722). Flattened (B*K,) candidates,
    row-major by query; the 2-entry carry makes streamed and batched feeds
    emit the same candidates."""
    B, K = vals.shape
    loc = cfg.locality_threshold
    idx = idx.to(torch.int32)
    vals = torch.where(searchable[:, None], vals.float(), torch.full_like(vals.float(), similarity.NEG_INF))

    all_idx = torch.cat([state.prev_idx, idx])  # (B+2, K)
    all_ok = torch.cat([state.prev_ok, searchable])  # (B+2,)
    p1, p2 = all_idx[1:-1], all_idx[:-2]  # (B, K) neighbours' hit sets
    ok1, ok2 = all_ok[1:-1], all_ok[:-2]

    def any_near(a, b):  # (B, K) x (B, K) -> (B, K): any of b's hits near
        return ((a[:, :, None] - b[:, None, :]).abs() < loc).any(dim=-1)

    if cfg.consistency_frames <= 2:
        agree = any_near(idx, p1) & ok1[:, None]
        v_all = ok1
    else:
        agree = any_near(idx, p1) & any_near(idx, p2)
        v_all = ok1 & ok2
    agree = agree & v_all[:, None]

    near = (idx[:, :, None] - idx[:, None, :]).abs() <= loc  # (B, K, K)
    r = torch.arange(K, device=vals.device)
    better = (vals[:, None, :] > vals[:, :, None]) | (
        (vals[:, None, :] == vals[:, :, None]) & (r[None, None, :] < r[None, :, None])
    )
    dominated = (near & better).any(dim=-1)  # (B, K)
    keep = ~dominated & searchable[:, None]

    strong = vals > cfg.dot_threshold
    cands = LoopCandidates(
        curr_idx=global_idx.to(torch.int32).repeat_interleave(K),
        prev_idx=idx.reshape(-1),
        score=vals.reshape(-1),
        valid=(agree & keep & strong).reshape(-1),
        agree=(agree & keep).reshape(-1),
    )
    n_valid = query_valid.to(torch.int64).sum()
    new_state = TopKState(
        prev_idx=_carry_rows(all_idx, state.prev_idx, n_valid, B),
        prev_ok=_carry_rows(all_ok, state.prev_ok, n_valid, B),
    )
    return cands, new_state


def detect_batch(
    cfg: LoopConfig,
    db: DescriptorDB,
    state: DetectorState,
    queries: torch.Tensor,  # (B, D) newest descriptors, consecutive
    global_idx: torch.Tensor,  # (B,) int32 their global frame indices
    query_valid: torch.Tensor,  # (B,) bool — slots holding real descriptors
) -> Tuple[LoopCandidates, DetectorState]:
    """Score a batch of consecutive new descriptors (one K1 launch on CUDA)
    and apply the 3-way temporal-consistency rule. Returns candidates and
    the updated carry."""
    limits = query_limits(db, global_idx, cfg.exclusion_window)
    mx, ar = similarity.max_and_argmax(queries, db.vectors, limits, db.global_ids)
    searchable = (limits > 0) & query_valid
    return temporal_consistency(cfg, state, mx, ar, global_idx, searchable, query_valid)


def detect_batch_quantized(
    cfg: LoopConfig,
    db: QuantizedDB,
    state: DetectorState,
    queries: torch.Tensor,  # (B, D)
    global_idx: torch.Tensor,  # (B,) int32
    query_valid: torch.Tensor,  # (B,) bool
) -> Tuple[LoopCandidates, DetectorState]:
    """``detect_batch`` over an int8-quantized DB: the same temporal
    consistency, scored by ``max_and_argmax_int8`` (one ``torch._int_mm``
    on CUDA)."""
    limits = query_limits(db, global_idx, cfg.exclusion_window)
    mx, ar = similarity.max_and_argmax_int8(queries, db.values, db.scales, limits, db.global_ids)
    searchable = (limits > 0) & query_valid
    return temporal_consistency(cfg, state, mx, ar, global_idx, searchable, query_valid)
