"""What decides ``correct``: the numbers compared with the plain reference.

Each number is a widest gap; the limits live in ``portbench/limits/<cell>.json``.

* ``desc_gap`` (describe): over a seeded sample of the keyframes in the
  DB, 1 - cos between the row the system stored for a keyframe and the
  reference's float32 descriptor of the same frame.
* ``cand_gap`` (detect: K1 / K2 and Method A's rules): for every loop
  candidate the system raised, scored with the reference's descriptors
  over the rows the query may match (ids below its own minus the
  exclusion window): how far the candidate's score lies below the k-th
  best score (k candidates per query), or below the dot-product threshold,
  whichever is further; 0 when it is neither.
* ``score_gap`` (detect: K1 / K2 over the DB): for every query, how far
  the rank-0 score the system logged lies from the reference's best score
  over the rows the query may match (-1 where it may match none). A search
  that skips rows, or returns nothing, reads the distance to the best it
  missed.
* ``edge_rot_deg``, ``edge_trans_m`` (verify, K3's depth inside it): over
  every accepted loop edge, the rotation angle and the translation norm of
  the edge's relative pose against the ground-truth relative pose of its
  two frames, which the benchmark's route fixes.
* ``solve_gap`` (pose graph): the reference builds the graph of the
  judged solve (the route's odometry, the worlds it states, the judged
  edges), solves it with exact Gauss-Newton steps, and reports the share of
  the cost reduction from the initial states to its optimum that the
  system's trajectory leaves undone (the cost with each switch at its
  optimum). A solve that returns its input reads 1.
* ``stream_mismatch``: frames whose stored stamp or world id differ from
  the stream pushed, plus DB rows whose keyframe is out of order: 0.
"""

from __future__ import annotations

import numpy as np


def desc_gap(stored: np.ndarray, ref: np.ndarray) -> float:
    if not len(stored) and not len(ref):
        return 0.0
    if stored.shape != ref.shape:
        return float("inf")
    a = stored / np.maximum(np.linalg.norm(stored, axis=1, keepdims=True), 1e-30)
    b = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-30)
    return float(np.max(1.0 - np.sum(a.astype(np.float64) * b, axis=1)))


def cand_gap(ref_desc: np.ndarray, cands: list, k: int, threshold: float, exclusion: int) -> float:
    """``ref_desc`` (gids, D) rows in DB order; ``cands`` [(query gid, hit gid)]."""
    worst = 0.0
    for q, p in cands:
        lim = q - exclusion
        if p >= lim or p < 0:
            return float("inf")
        s = ref_desc[:lim].astype(np.float64) @ ref_desc[q].astype(np.float64)
        kth = np.partition(s, len(s) - k)[len(s) - k] if len(s) >= k else -np.inf
        worst = max(worst, kth - s[p], threshold - s[p])
    return float(worst)


def best_scores(desc: np.ndarray, exclusion: int) -> np.ndarray:
    """(N,) each row's best dot product with the rows it may match (ids
    below its own minus ``exclusion``), -1 where there are none."""
    d = desc.astype(np.float64)
    s = d @ d.T
    out = np.full(len(d), -1.0)
    for q in range(exclusion + 1, len(d)):
        out[q] = float(np.max(s[q, : q - exclusion]))
    return out


def score_gap(scores, ref_desc: np.ndarray, exclusion: int) -> float:
    """``scores`` the system's rank-0 score per query, in DB order."""
    if len(scores) != len(ref_desc):
        return float("inf")
    if not len(scores):
        return 0.0
    return float(np.max(np.abs(np.asarray(scores, np.float64) - best_scores(ref_desc, exclusion))))


def rot_angle_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def edge_errors(edges: list, gt_poses: np.ndarray) -> tuple:
    """``edges`` [(prev frame, curr frame, T_prev_curr)] -> (max rotation
    error deg, max translation error m); (0, 0) without edges."""
    rot = trans = 0.0
    for prev, curr, T in edges:
        G = np.linalg.inv(gt_poses[prev].astype(np.float64)) @ gt_poses[curr].astype(np.float64)
        D = np.linalg.inv(G) @ np.asarray(T, np.float64)
        rot = max(rot, rot_angle_deg(D[:3, :3]))
        trans = max(trans, float(np.linalg.norm(T[:3, 3] - G[:3, 3])))
    return rot, trans


def compare(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers the cell's limits
    name, each at or under its limit; a limit whose number the run did not
    produce fails."""
    rows = [(k, float(numbers.get(k, float("nan"))), float(lim)) for k, lim in limits.items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
