"""Multi-hypothesis temporal tracker: the reference's Method D (counterpart
of cerebro_tpu/loop/hypothesis.py).

Re-implements HypothesisManager (src/HypothesisManager.{h,cpp}; fed by
``faiss_multihypothesis_tracking``, src/Cerebro.cpp:731-885) as a
fixed-shape table updated on the device:

  * a putative pair (a, b, dot > 0.85) JOINS the first active hypothesis
    whose tail is within ±locality of (a, b) (ref ±7,
    src/HypothesisManager.cpp:51); otherwise it SPAWNS one in the first free
    slot, or in the slot with the lowest TTL when none is free;
  * TTL starts at 20 (ref src/HypothesisManager.h:32), +1 on support, +5
    past 100 total support (ref :110-122), -decay per digest (ref -4,
    src/HypothesisManager.cpp:74-86);
  * a hypothesis whose TTL reaches 0 dies; one whose support reaches the
    promotion threshold emits a loop candidate (a_tail, b_tail, mean dot)
    once (the emitted latch resets when a new hypothesis takes the slot).

The digest fires after every ``cfg.hypothesis_digest_every`` valid queries;
the query counter lives in the table, so a stream fed one query at a time
or a batch at a time emits the same candidates. The JAX package's
``lax.scan`` over the pairs is a Python loop of device operations here:
nothing in it reads a tensor on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cerebro_tpu_torch.config import LoopConfig


@dataclasses.dataclass(frozen=True)
class HypothesisTable:
    a_tail: torch.Tensor  # (H,) int32 — newest query index in the hypothesis
    b_tail: torch.Tensor  # (H,) int32 — newest matched history index
    ttl: torch.Tensor  # (H,) int32
    support: torch.Tensor  # (H,) int32 — number of joined pairs
    score_sum: torch.Tensor  # (H,) float32 — sum of dots (mean = sum/support)
    active: torch.Tensor  # (H,) bool
    emitted: torch.Tensor  # (H,) bool — this hypothesis already emitted
    qcount: torch.Tensor  # () int32 — valid queries seen since the last digest


def create_table(capacity: int = 64, device="cuda") -> HypothesisTable:
    def z():
        return torch.zeros((capacity,), dtype=torch.int32, device=device)

    return HypothesisTable(
        a_tail=z(),
        b_tail=z(),
        ttl=z(),
        support=z(),
        score_sum=torch.zeros((capacity,), dtype=torch.float32, device=device),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        emitted=torch.zeros((capacity,), dtype=torch.bool, device=device),
        qcount=torch.zeros((), dtype=torch.int32, device=device),
    )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when none), as jnp.argmax on a bool
    array; torch.argmax takes no bool tensor, and on int8 it also returns
    the first maximum."""
    return mask.to(torch.int8).argmax()


def _add_one(table: HypothesisTable, a, b, dot, valid, cfg: LoopConfig) -> HypothesisTable:
    """Insert one putative pair (0-d tensors a, b, dot, valid)."""
    loc = cfg.hypothesis_locality
    near = ((table.a_tail - a).abs() <= loc) & ((table.b_tail - b).abs() <= loc) & table.active
    has_match = near.any()
    free = ~table.active
    free_idx = torch.where(free.any(), _first_true(free), table.ttl.argmin())
    idx = torch.where(has_match, _first_true(near), free_idx).reshape(1)
    onehot = (torch.arange(table.ttl.shape[0], device=idx.device) == idx) & valid

    support_i = table.support.index_select(0, idx)[0]
    # join: +1 TTL (+5 past 100 support, ref :110-122); spawn: initial TTL
    accel = torch.where(support_i > 100, 5, 1)
    new_ttl = torch.where(has_match, table.ttl.index_select(0, idx)[0] + accel, cfg.hypothesis_ttl)
    new_support = torch.where(has_match, support_i + 1, 1)
    new_score = torch.where(has_match, table.score_sum.index_select(0, idx)[0] + dot, dot)
    # a NEW hypothesis took this slot (fresh or recycled): the emitted latch
    # resets (ref slot reuse, src/HypothesisManager.cpp:51-86)
    spawned = onehot & ~has_match
    return dataclasses.replace(
        table,
        a_tail=torch.where(onehot, a, table.a_tail),
        b_tail=torch.where(onehot, b, table.b_tail),
        ttl=torch.where(onehot, new_ttl.to(torch.int32), table.ttl),
        support=torch.where(onehot, new_support.to(torch.int32), table.support),
        score_sum=torch.where(onehot, new_score, table.score_sum),
        active=table.active | onehot,
        emitted=table.emitted & ~spawned,
    )


def _digest(table: HypothesisTable, cfg: LoopConfig, promote_support: int):
    """One digest tick: decay TTL, kill dead slots, promote and latch."""
    ttl = table.ttl - cfg.hypothesis_decay
    alive = table.active & (ttl > 0)
    promoted = alive & (table.support >= promote_support)
    emit_now = promoted & ~table.emitted
    new = dataclasses.replace(
        table,
        ttl=torch.where(alive, ttl, torch.zeros_like(ttl)),
        support=torch.where(alive, table.support, torch.zeros_like(table.support)),
        score_sum=torch.where(alive, table.score_sum, torch.zeros_like(table.score_sum)),
        active=alive,
        emitted=(table.emitted | promoted) & alive,
        qcount=torch.zeros_like(table.qcount),
    )
    return new, emit_now


def update(
    cfg: LoopConfig,
    table: HypothesisTable,
    pairs_a: torch.Tensor,  # (B,) int32 query indices
    pairs_b: torch.Tensor,  # (B,) int32 matched history indices
    dots: torch.Tensor,  # (B,) float32
    pair_valid: torch.Tensor,  # (B,) bool — the hit exists (query real + scored)
    query_valid: torch.Tensor | None = None,  # (B,) bool — slot advances digest time
    promote_support: int = 8,
) -> Tuple[HypothesisTable, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Feed a batch of putative pairs, digesting at the query cadence.

    Returns ``(table, emits (B, H) bool, a_tails (B, H), b_tails (B, H),
    mean_scores (B, H))``: ``emits[q, h]`` marks hypothesis ``h`` crossing
    the promotion threshold at the digest following pair ``q``, with the
    tails and mean captured at that digest."""
    pairs_a = pairs_a.to(torch.int32)
    pairs_b = pairs_b.to(torch.int32)
    dots = dots.float()
    strong = pair_valid & (dots > cfg.dot_threshold)
    qv = torch.ones_like(strong) if query_valid is None else query_valid
    every = max(int(cfg.hypothesis_digest_every), 1)

    emits, a_tails, b_tails, means = [], [], [], []
    for i in range(pairs_a.shape[0]):
        # insertion gates on the PAIR's validity; the query flag only
        # advances the digest clock (several top-k pairs share one query)
        tbl = _add_one(table, pairs_a[i], pairs_b[i], dots[i], strong[i], cfg)
        tbl = dataclasses.replace(tbl, qcount=tbl.qcount + qv[i].to(torch.int32))
        a_tails.append(tbl.a_tail)
        b_tails.append(tbl.b_tail)
        means.append(tbl.score_sum / torch.clamp(tbl.support.float(), min=1.0))
        digested, emit_now = _digest(tbl, cfg, promote_support)
        do = tbl.qcount >= every
        table = HypothesisTable(
            **{
                f.name: torch.where(do, getattr(digested, f.name), getattr(tbl, f.name))
                for f in dataclasses.fields(HypothesisTable)
            }
        )
        emits.append(emit_now & do)
    return (
        table,
        torch.stack(emits),
        torch.stack(a_tails),
        torch.stack(b_tails),
        torch.stack(means),
    )
