"""Top-k (faiss-style) candidate generators: the reference's Methods B and C
(counterpart of cerebro_tpu/loop/topk_methods.py).

Method B — ``faiss__naive_loopcandidate_generator`` (src/Cerebro.cpp:366-
492): k-NN retrieval per query; accept the best neighbour when its dot
exceeds 0.9 and the best neighbours of consecutive queries agree within a
locality window: Method A's rule and 2-entry carry on the rank-0 hit.

Method C — ``faiss_clique_loopcandidate_generator`` (src/Cerebro.cpp:506-
722): per query, merge the k-NN hits of the W newest queries into
history-axis cliques of width ±hypothesis_locality and emit the
best-supported clique's centre (the reference subsamples at random when
several cliques survive; here the strongest, deterministically). The hits
of the last W-1 queries are carried across batches.

Both take the top-k results of ``ops.similarity.search_topk`` and stay on
the tensors' device. History indices are GLOBAL ids.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cerebro_tpu_torch.config import LoopConfig
from cerebro_tpu_torch.loop.detector import DetectorState, LoopCandidates, temporal_consistency

# the reference accumulates hits over 4 consecutive frames (src/Cerebro.cpp:506-722)
CLIQUE_WINDOW = 4


def naive_topk_candidates(
    cfg: LoopConfig,
    state: DetectorState,
    topk_vals: torch.Tensor,  # (Q, k) scores, queries consecutive
    topk_idx: torch.Tensor,  # (Q, k) history global ids
    query_idx: torch.Tensor,  # (Q,) global indices of the queries
    query_valid: torch.Tensor,  # (Q,) bool
    searchable: torch.Tensor,  # (Q,) bool — query has a non-empty window
    threshold: float = 0.9,  # the reference's faiss variant uses 0.9 (src/Cerebro.cpp:375)
) -> Tuple[LoopCandidates, DetectorState]:
    """Method B: Method A's 3-consecutive rule on the best top-k hit, with
    the cross-batch 2-entry carry."""
    cfg_b = dataclasses.replace(cfg, dot_threshold=threshold)
    return temporal_consistency(
        cfg_b, state, topk_vals[:, 0], topk_idx[:, 0], query_idx,
        searchable & query_valid, query_valid,
    )


@dataclasses.dataclass(frozen=True)
class CliqueState:
    """Carry for Method C: the top-k hits of the last W-1 queries."""

    idx: torch.Tensor  # (W-1, k) int32 global ids
    val: torch.Tensor  # (W-1, k) float32
    ok: torch.Tensor  # (W-1, k) bool


def init_clique_state(k: int, window: int = CLIQUE_WINDOW, device="cuda") -> CliqueState:
    w1 = max(window - 1, 0)
    return CliqueState(
        idx=torch.zeros((w1, k), dtype=torch.int32, device=device),
        val=torch.full((w1, k), float("-inf"), dtype=torch.float32, device=device),
        ok=torch.zeros((w1, k), dtype=torch.bool, device=device),
    )


def clique_topk_candidates(
    cfg: LoopConfig,
    state: CliqueState,
    topk_vals: torch.Tensor,  # (Q, k)
    topk_idx: torch.Tensor,  # (Q, k)
    query_idx: torch.Tensor,  # (Q,)
    query_valid: torch.Tensor,  # (Q,) bool
    threshold: float = 0.85,
    min_support: int | None = None,
):
    """Method C, per query: for each query q, merge the top-k hits of the W
    newest queries ending at q (carry + this batch) into cliques and emit
    the best-supported clique's centre. A clique fires when its hit count
    reaches ``min_support`` (default cfg.hypothesis_promote) and its best
    dot beats ``threshold``. Padded queries contribute no hits, so streamed
    and batched feeds agree. Returns (curr (Q,), prev (Q,), score (Q,),
    valid (Q,), state)."""
    Q, k = topk_vals.shape
    loc = cfg.hypothesis_locality
    ms = cfg.hypothesis_promote if min_support is None else min_support
    W = state.idx.shape[0] + 1  # the carry holds W-1 rows

    vals = topk_vals.float()
    batch_ok = (vals > threshold) & query_valid[:, None]
    all_idx = torch.cat([state.idx, topk_idx.to(torch.int32)])  # (W-1+Q, k)
    all_val = torch.cat([state.val, vals])
    all_ok = torch.cat([state.ok, batch_ok])

    # (Q, W*k) rolling windows: row q sees queries q-W+1 .. q
    wi = torch.stack([all_idx[i : i + Q] for i in range(W)], 1).reshape(Q, W * k)
    wv = torch.stack([all_val[i : i + Q] for i in range(W)], 1).reshape(Q, W * k)
    wo = torch.stack([all_ok[i : i + Q] for i in range(W)], 1).reshape(Q, W * k)

    # support of hit h = number of window hits within ±loc on the history axis
    near = (wi[:, :, None] - wi[:, None, :]).abs() <= loc
    support = (near & wo[:, None, :] & wo[:, :, None]).sum(dim=-1)
    support = torch.where(wo, support, torch.zeros_like(support))  # (Q, W*k)

    best = support.argmax(dim=-1, keepdim=True)  # first maximum, as jnp.argmax
    center = wi.gather(1, best)[:, 0]
    supp = support.gather(1, best)[:, 0]
    in_clique = ((wi - center[:, None]).abs() <= loc) & wo
    score = torch.where(in_clique, wv, torch.full_like(wv, float("-inf"))).amax(dim=-1)
    valid = (supp >= ms) & (score > threshold) & query_valid

    # carry the newest W-1 REAL queries' hits across the batch boundary
    w1 = W - 1
    n_valid = query_valid.to(torch.int64).sum()
    take = torch.clamp(n_valid + torch.arange(w1, device=vals.device), 0, w1 + Q - 1)
    new_state = CliqueState(
        idx=all_idx.index_select(0, take),
        val=all_val.index_select(0, take),
        ok=all_ok.index_select(0, take),
    )
    return query_idx, center, score, valid, new_state
