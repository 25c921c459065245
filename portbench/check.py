"""The comparison that decides ``correct``, run once the window has closed
and the system is freed: the reference recomputes what it needs from the
inputs the benchmark made (the frames, the route, the weights the cell's
net module names) and judges the system's outputs (``reference/judge.py``
says what each number is). The descriptors are the reference of the net the
configuration names (``portbench/nets/<net>.py``).

``control=True`` puts the reference in the system's place, one precision
below the configuration's: the net module's control descriptors (float8 for
the bfloat16 flagship; and the candidates and best scores they give the
system's queries), a bfloat16 solve for the float32 one. It is the run each
limit has to fail; the benchmark's own runs never make it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from portbench.reference import judge
from portbench.reference import posegraph as ref_pg
from portbench import world as W


def numbers(out: dict, stream, device, net, weights_dir: Path, control: bool = False) -> dict:
    """The compared numbers; ``net`` is the cell's net module, its weights
    in ``weights_dir``."""
    weights = net.load(weights_dir, device)
    gid_frame = list(out["gid_frame"])
    frames = out["left"][gid_frame] if gid_frame else out["left"][:0]
    ref = net.describe_all(weights, frames, device)
    mismatch = _stream_mismatch(out, stream)

    lcfg = out["loop_cfg"]
    k = max(int(lcfg.candidates_per_query), 1)
    gid_of_store = {s: g for g, s in enumerate(out["gid_store"])}
    queries = [(gid_of_store[c], gid_of_store[p]) for c, p in out["candidates"]
               if c in gid_of_store and p in gid_of_store]
    mismatch += len(out["candidates"]) - len(queries)
    rows, scores = out["db_rows"], out["scores"]
    excl = int(lcfg.exclusion_window)
    if control:
        rows = net.describe_all(weights, frames, device, control=True)
        queries = [(q, _control_pick(rows, q, excl)) for q, _ in queries]
        scores = judge.best_scores(rows, excl)
    nums = {
        "desc_gap": judge.desc_gap(rows, ref),
        "cand_gap": judge.cand_gap(ref, queries, k, float(lcfg.dot_threshold), excl),
        "score_gap": judge.score_gap(scores, ref, excl),
    }
    sf = out["store_frame"]
    edges = [(sf[p], sf[c], T) for p, c, T in out["edges"]]
    nums["edge_rot_deg"], nums["edge_trans_m"] = judge.edge_errors(edges, stream.gt_poses)
    nums["solve_gap"] = _solve_gap(out, stream, device, control)
    nums["stream_mismatch"] = float(mismatch)
    return nums


def _control_pick(rows: np.ndarray, q: int, exclusion: int) -> int:
    """The control's best row for query q among those it may match."""
    s = rows[: q - exclusion].astype(np.float64) @ rows[q].astype(np.float64)
    return int(np.argmax(s))


def _stream_mismatch(out: dict, stream) -> int:
    sf = np.asarray(out["store_frame"])
    bad = int((sf < 0).sum())
    ok = sf >= 0
    bad += int((out["store_world"][ok] != stream.world[sf[ok]]).sum())
    bad += int((out["store_pose_valid"][ok] != stream.has_pose[sf[ok]]).sum())
    gf = np.asarray(out["gid_frame"])
    bad += int((np.diff(gf) <= 0).sum()) if len(gf) > 1 else 0
    bad += int((out["db_gids"] != np.arange(len(out["db_gids"]))).sum())
    return bad


def _solve_gap(out: dict, stream, device, control: bool) -> float:
    """The share of the cost reduction that the reference's exact solve of
    the same graph reaches and the judged solve leaves undone:
    (C(x_judged) - C(x_ref)) / (C(x_init) - C(x_ref)), C the objective
    with each switch at its optimum. 0 without a solve or a loop edge."""
    solve = out["solve"]
    if solve is None:
        return 0.0
    sf = np.asarray(out["store_frame"][: solve["size"]])
    pv = out["store_pose_valid"][: solve["size"]]
    nodes = np.nonzero(pv)[0]
    node_of = {int(s): n for n, s in enumerate(nodes)}
    frames = sf[nodes]
    loops = [(node_of[p], node_of[c], T) for p, c, T in out["edges"][: solve["n_edges"]]
             if p in node_of and c in node_of]
    if not loops:
        return 0.0
    g = ref_pg.build(stream.odom_poses[frames], stream.world[frames], W.body_T_cam(), loops)
    pg = out["pg_cfg"]
    w = pg.switch_prior_weight
    x_ref = ref_pg.solve_exact(g, pg.max_gn_iters, pg.damping, w, device=device)
    if control:
        x = ref_pg.solve(g, pg.max_gn_iters, pg.cg_iters, pg.damping, w, dtype=torch.bfloat16)
    else:
        if len(solve["traj"]) != len(nodes):
            return float("inf")
        x = ref_pg.states_of(solve["traj"], W.body_T_cam())
    c_ref, c_init = ref_pg.cost(g, x_ref, w), ref_pg.cost(g, g["x"], w)
    if c_init - c_ref <= 1e-12 * max(c_init, 1.0):
        return 0.0
    return float((ref_pg.cost(g, x, w) - c_ref) / (c_init - c_ref))
