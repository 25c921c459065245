"""Pose-graph Gauss-Newton sharded over a mesh's ranks (counterpart of
cerebro_tpu/posegraph/distributed.py).

The node states and the switch variables are replicated; the edges are
split: rank r of the axis holds the r-th block of the odometry edges and
of the loop edges, linearizes them, and applies their Jacobian blocks. The
only traffic between ranks is one ``all_reduce`` of J^T r per GN step, one
of J^T J v per CG matvec, and one of the final cost. Each rank's residual
carries the gauge row with weight 10/sqrt(n), so the summed normal
equations are the single-device ones.

Every rank runs the CG on the reduced vectors. An ``all_reduce`` hands
every rank the same bits, and the CG's arithmetic on them is the same on
every rank, so the host-side stopping test (``optimizer._cg``) decides
alike everywhere and no rank waits in a collective the others skipped. At
one rank the solve is ``optimizer.optimize``'s, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cerebro_tpu_torch.config import PoseGraphConfig
from cerebro_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from cerebro_tpu_torch.posegraph.optimizer import PoseGraph, gauss_newton


def _pad_to(t: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    pad = n - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, torch.full((pad, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)])


def pad_graph(graph: PoseGraph, n_dev: int) -> PoseGraph:
    """The graph with its odometry and loop edges padded to multiples of
    ``n_dev`` by invalid edges (node 0 to node 0, zero measurement)."""

    def up(n):
        return -(-n // n_dev) * n_dev

    eo, el = up(graph.odo_i.shape[0]), up(graph.loop_i.shape[0])
    return dataclasses.replace(
        graph,
        odo_i=_pad_to(graph.odo_i, eo), odo_j=_pad_to(graph.odo_j, eo),
        odo_meas=_pad_to(graph.odo_meas, eo), odo_valid=_pad_to(graph.odo_valid, eo, False),
        loop_i=_pad_to(graph.loop_i, el), loop_j=_pad_to(graph.loop_j, el),
        loop_meas=_pad_to(graph.loop_meas, el), loop_valid=_pad_to(graph.loop_valid, el, False),
    )


def optimize_sharded(
    graph: PoseGraph, cfg: PoseGraphConfig, mesh: Mesh, axis: str = "db"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-sharded Gauss-Newton over the ranks of ``axis``: every rank
    passes the same graph, with its edge arrays padded to multiples of the
    axis size (``pad_graph``), and gets (states, switches (El,), cost)."""
    n, r = mesh.shape[axis], mesh.rank(axis)
    eo, el = graph.odo_i.shape[0], graph.loop_i.shape[0]
    if eo % n or el % n:
        raise ValueError(f"edge counts ({eo}, {el}) must be multiples of the axis size {n}: pad_graph")
    bo, bl = eo // n, el // n
    odo, loops = slice(r * bo, (r + 1) * bo), slice(r * bl, (r + 1) * bl)
    mine = dataclasses.replace(
        graph,
        odo_i=graph.odo_i[odo], odo_j=graph.odo_j[odo],
        odo_meas=graph.odo_meas[odo], odo_valid=graph.odo_valid[odo],
        loop_i=graph.loop_i[loops], loop_j=graph.loop_j[loops],
        loop_meas=graph.loop_meas[loops], loop_valid=graph.loop_valid[loops],
    )
    # the JAX package's f32 10 / sqrt(n); 10.0 exactly at one rank
    gauge = float(np.float32(10.0) / np.sqrt(np.float32(n)))
    return gauss_newton(graph, mine, cfg, loops=loops, gauge=gauge,
                        reduce=lambda tree: all_reduce_sum(tree, mesh, axis))
