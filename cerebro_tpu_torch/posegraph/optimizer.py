"""Switch-constrained pose-graph optimizer: damped Gauss-Newton with a
matrix-free conjugate-gradient solve (counterpart of
cerebro_tpu/posegraph/optimizer.py).

This is the capability of the reference's external pose-graph solver
(mpkuse/solve_keyframe_pose_graph: switch-constrained, kidnap-aware
multi-world merge, ref README.md:176-194):

  * 4-DOF state per keyframe (x, y, z, yaw), or full se(3) twists with
    ``dof=6``;
  * odometry edges (consecutive, within a world) and loop edges with
    Suenderhauf-style switch variables: the loop residual is scaled by
    s = sigmoid(s_logit) in (0, 1), with a prior (1 - s) * weight;
  * the normal equations (J^T J + damping) dx = -J^T r are solved by CG
    without assembling J: each GN step linearizes every edge once, its
    (d, d) Jacobian blocks for both end nodes coming from
    ``torch.func.jvp`` of the edge residual (2d batched calls), and each CG
    matvec applies J and J^T through those blocks (gather, batched product,
    ``index_add_``). The JAX package evaluates J^T J v with one ``jvp`` and
    one ``vjp`` of the whole residual per matvec, which XLA fuses; run
    eagerly, that is hundreds of small operations per CG iteration (44 s
    per solve of 365 keyframes on the H100, ``chip_smoke.py``), where the
    blocks take a few dozen.

The CG solve is the JAX package's ``jax.scipy.sparse.linalg.cg`` over the
pair {x, s_logit}, written out: x0 = 0, stop once the squared residual norm
is <= tol^2 * |b|^2 (tol = 1e-5, atol = 0) or after ``cg_iters``
iterations. The stopping test is read on the host once per iteration (the
JAX ``while_loop``'s condition), so the iterations run are the same as
JAX's. Everything stays on the caller's device, in the type of the states
(f32 from the pipeline). On CUDA, ``index_add_`` sums with atomics, so the
last bits of a solve may change from run to run.

Graph assembly helpers (``relative_yaw_t_np``, ``initialize_worlds``) are
host numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from cerebro_tpu_torch.config import PoseGraphConfig
from cerebro_tpu_torch.geometry import se3

CG_TOL = 1e-5  # jax.scipy.sparse.linalg.cg's default tol (atol = 0)


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Problem container (fixed shapes; masked edges)."""

    # nodes
    xyzyaw: torch.Tensor  # (N, 4) initial state per keyframe ((N, 6) twists for dof=6)
    node_valid: torch.Tensor  # (N,) bool
    # odometry edges i -> j (usually j = i+1 in the same world)
    odo_i: torch.Tensor  # (Eo,) int
    odo_j: torch.Tensor  # (Eo,) int
    odo_meas: torch.Tensor  # (Eo, 4) measured (dx, dy, dz, dyaw) in frame i
    odo_valid: torch.Tensor  # (Eo,) bool
    # loop edges i -> j with switch variables
    loop_i: torch.Tensor  # (El,) int
    loop_j: torch.Tensor  # (El,) int
    loop_meas: torch.Tensor  # (El, 4) measured (dx, dy, dz, dyaw) in frame i
    loop_valid: torch.Tensor  # (El,) bool


def relative_yaw_t(T_i: torch.Tensor, T_j: torch.Tensor) -> torch.Tensor:
    """4-DOF measurement (dx, dy, dz, dyaw) of j in i's frame from 4x4
    poses."""
    D = se3.pose_inverse(T_i) @ T_j
    dyaw = se3.rot_to_ypr(D[..., :3, :3])[..., 0]
    return torch.cat([D[..., :3, 3], dyaw[..., None]], dim=-1)


def relative_yaw_t_np(T_i, T_j):
    """Numpy twin of :func:`relative_yaw_t`, batched over leading dims (graph
    assembly runs on the host)."""
    T_i = np.asarray(T_i, np.float32)
    T_j = np.asarray(T_j, np.float32)
    Rt = np.swapaxes(T_i[..., :3, :3], -1, -2)
    Dr = Rt @ T_j[..., :3, :3]
    Dt = np.einsum("...ij,...j->...i", Rt, T_j[..., :3, 3] - T_i[..., :3, 3])
    dyaw = np.arctan2(Dr[..., 1, 0], Dr[..., 0, 0])
    return np.concatenate([Dt, dyaw[..., None]], axis=-1)


def relative_se3(T_i: torch.Tensor, T_j: torch.Tensor) -> torch.Tensor:
    """6-DOF measurement twist of j in i's frame (for dof=6 graphs)."""
    return se3.se3_log(se3.pose_inverse(T_i) @ T_j)


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def _rotz(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    return torch.stack(
        [torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1), torch.stack([z, z, o], -1)],
        dim=-2,
    )


def _pair_residual(xi: torch.Tensor, xj: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """Between-edge residual of end states xi, xj (E, d): d = 4 gives the
    4-DOF residual (translation in i's yaw frame, wrapped yaw), d = 6 the
    se(3) log-map residual log(T_meas^-1 . T_i^-1 . T_j)."""
    if xi.shape[-1] == 4:
        Ri_T = _rotz(xi[:, 3]).transpose(-1, -2)  # (E, 3, 3)
        dt_pred = (Ri_T @ (xj[:, :3] - xi[:, :3])[..., None])[..., 0]
        r_t = dt_pred - meas[:, :3]
        r_y = _wrap(xj[:, 3] - xi[:, 3] - meas[:, 3])
        return torch.cat([r_t, r_y[:, None]], dim=-1)  # (E, 4)
    # 6-DOF: measurements stored as twists
    D = se3.pose_inverse(se3.se3_exp(meas)) @ se3.pose_inverse(se3.se3_exp(xi)) @ se3.se3_exp(xj)
    return se3.se3_log(D)  # (E, 6)


@dataclasses.dataclass
class _Edges:
    """One edge set linearized at the current states: residuals r (E, d)
    and Jacobian blocks Ji, Jj (E, d, d) for the end nodes i, j."""

    i: torch.Tensor
    j: torch.Tensor
    r: torch.Tensor
    Ji: torch.Tensor
    Jj: torch.Tensor

    @classmethod
    def linearize(cls, x, i, j, meas, jacobians: bool = True):
        xi, xj = x.index_select(0, i), x.index_select(0, j)
        d = x.shape[-1]
        if not jacobians:
            return cls(i, j, _pair_residual(xi, xj, meas), None, None)

        def f(a, b):
            return _pair_residual(a, b, meas)

        cols_i, cols_j = [], []
        for k in range(d):  # column k of each block: a jvp along e_k
            e = torch.zeros_like(xi)
            e[:, k] = 1.0
            r, ci = torch.func.jvp(f, (xi, xj), (e, torch.zeros_like(xj)))
            cols_i.append(ci)
            cols_j.append(torch.func.jvp(f, (xi, xj), (torch.zeros_like(xi), e))[1])
        return cls(i, j, r, torch.stack(cols_i, -1), torch.stack(cols_j, -1))

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """J v: (E, d) from node tangents v (N, d)."""
        vi, vj = v.index_select(0, self.i), v.index_select(0, self.j)
        return (self.Ji @ vi[..., None] + self.Jj @ vj[..., None])[..., 0]

    def apply_t(self, u: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """out += J^T u for edge rows u (E, d), scattered onto the nodes."""
        out.index_add_(0, self.i, (self.Ji.transpose(-1, -2) @ u[..., None])[..., 0])
        out.index_add_(0, self.j, (self.Jj.transpose(-1, -2) @ u[..., None])[..., 0])
        return out


class _Linearized:
    """The stacked residual [odometry, loops, switch prior, gauge] and its
    Jacobian at (x, s_logit). Odometry rows are masked by validity; loop
    rows are scaled by s * valid, with d/ds_logit = valid * s(1-s) * r_e;
    the switch prior (1 - s) * weight * valid has d/ds_logit = -weight *
    valid * s(1-s); the gauge 10 (x[0] - x_init[0]) pins node 0."""

    def __init__(self, params: Dict[str, torch.Tensor], graph: PoseGraph, cfg: PoseGraphConfig,
                 jacobians: bool = True):
        x, logit = params["x"], params["s_logit"]
        self.n = x.shape[0]
        self.odo = _Edges.linearize(x, graph.odo_i, graph.odo_j, graph.odo_meas, jacobians)
        self.loop = _Edges.linearize(x, graph.loop_i, graph.loop_j, graph.loop_meas, jacobians)
        self.ov = graph.odo_valid.to(x.dtype)[:, None]
        lv = graph.loop_valid.to(x.dtype)
        s = torch.sigmoid(logit)
        self.sv = (s * lv)[:, None]
        ds = lv * s * (1.0 - s)
        self.dl = ds[:, None] * self.loop.r  # (El, d) d r_loop / d s_logit
        self.dsw = -cfg.switch_prior_weight * ds  # (El,) d r_switch / d s_logit
        self.r = (
            self.ov * self.odo.r,
            self.sv * self.loop.r,
            (1.0 - s) * cfg.switch_prior_weight * lv,
            10.0 * (x[0] - graph.xyzyaw[0]),
        )

    def cost(self) -> torch.Tensor:
        return 0.5 * sum((t * t).sum() for t in self.r)

    def j(self, v: Dict[str, torch.Tensor]):
        vx, vl = v["x"], v["s_logit"]
        return (
            self.ov * self.odo.apply(vx),
            self.sv * self.loop.apply(vx) + self.dl * vl[:, None],
            self.dsw * vl,
            10.0 * vx[0],
        )

    def jt(self, u) -> Dict[str, torch.Tensor]:
        uo, ul, us, ug = u
        gx = torch.zeros((self.n,) + ug.shape, dtype=ug.dtype, device=ug.device)
        self.odo.apply_t(self.ov * uo, gx)
        self.loop.apply_t(self.sv * ul, gx)
        gx[0] += 10.0 * ug
        return {"s_logit": (self.dl * ul).sum(-1) + self.dsw * us, "x": gx}


def _vdot(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> torch.Tensor:
    # leaves in the JAX pytree's (sorted-key) order
    return sum((a[k] * b[k]).sum() for k in sorted(a))


def _cg(matvec, b: Dict[str, torch.Tensor], maxiter: int) -> Dict[str, torch.Tensor]:
    """jax.scipy.sparse.linalg.cg(matvec, b, maxiter=maxiter) with x0 = 0
    (so r0 = b), tol = 1e-5, atol = 0 and no preconditioner."""
    atol2 = CG_TOL**2 * _vdot(b, b)
    x = {k: torch.zeros_like(v) for k, v in b.items()}
    r = dict(b)
    p = dict(b)
    gamma = _vdot(r, r)
    for _ in range(maxiter):
        if not bool(gamma > atol2):
            break
        Ap = matvec(p)
        alpha = gamma / _vdot(p, Ap)
        x = {k: x[k] + alpha * p[k] for k in x}
        r = {k: r[k] - alpha * Ap[k] for k in r}
        gamma_new = _vdot(r, r)
        beta = gamma_new / gamma
        p = {k: r[k] + beta * p[k] for k in p}
        gamma = gamma_new
    return x


def optimize(
    graph: PoseGraph, cfg: PoseGraphConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton, ``cfg.max_gn_iters`` steps. Returns (states
    (N, 4) or (N, 6), switches (El,), final cost), on the graph's device,
    in the states' floating type (f32 from the pipeline)."""
    x0 = graph.xyzyaw
    params = {
        "x": x0,
        "s_logit": torch.full(graph.loop_i.shape, 2.0, dtype=x0.dtype, device=x0.device),
    }
    for _ in range(cfg.max_gn_iters):
        lin = _Linearized(params, graph, cfg)

        def jtj_matvec(v, lin=lin):
            jtv = lin.jt(lin.j(v))
            return {k: jtv[k] + cfg.damping * v[k] for k in v}

        g = lin.jt(lin.r)
        dx = _cg(jtj_matvec, {k: -v for k, v in g.items()}, cfg.cg_iters)
        params = {k: params[k] + dx[k] for k in params}
    cost = _Linearized(params, graph, cfg, jacobians=False).cost()
    return params["x"], torch.sigmoid(params["s_logit"]), cost


def poses_from_xyzyaw(x: torch.Tensor) -> torch.Tensor:
    """(N, 4) -> (N, 4, 4) w_T_c poses (yaw-only rotation)."""
    return se3.yaw_translation_pose(x[..., 3], x[..., :3])


# ---------------------------------------------------------------------------
# Multi-world re-anchoring (host numpy)
# ---------------------------------------------------------------------------


def _comp4(a, b):
    """4-DOF compose: pose of (b in a's parent frame) given b in a's frame."""
    c, s = np.cos(a[..., 3]), np.sin(a[..., 3])
    t = np.stack(
        [
            a[..., 0] + c * b[..., 0] - s * b[..., 1],
            a[..., 1] + s * b[..., 0] + c * b[..., 1],
            a[..., 2] + b[..., 2],
        ],
        axis=-1,
    )
    return np.concatenate([t, (a[..., 3] + b[..., 3])[..., None]], axis=-1)


def _inv4(a):
    c, s = np.cos(a[..., 3]), np.sin(a[..., 3])
    t = np.stack(
        [-(c * a[..., 0] + s * a[..., 1]), -(-s * a[..., 0] + c * a[..., 1]), -a[..., 2]],
        axis=-1,
    )
    return np.concatenate([t, (-a[..., 3])[..., None]], axis=-1)


def initialize_worlds(xyzyaw, world_id, loop_i, loop_j, loop_meas, loop_valid):
    """Re-anchor each world onto the frame of the earliest world it shares a
    verified loop edge with, chaining transitively (host numpy, once before
    ``optimize``): the reference ecosystem's kidnap-recovery merge, which
    initializes a new world's anchor from its first cross-world loop edge
    (ref README.md:177-186). Without it the switches would rather turn
    cross-world edges off than move a whole world."""
    x = np.array(xyzyaw, np.float32)
    wid = np.asarray(world_id)
    worlds = sorted(set(int(w) for w in np.unique(wid)))
    anchored = {worlds[0]} if worlds else set()
    edges = [
        (int(loop_i[k]), int(loop_j[k]), np.asarray(loop_meas[k], np.float32))
        for k in range(len(loop_i))
        if bool(loop_valid[k])
    ]
    changed = True
    while changed:
        changed = False
        for i, j, m in edges:
            wi, wj = int(wid[i]), int(wid[j])
            if wi == wj:
                continue
            # orient: known world -> unknown world
            if wj in anchored and wi not in anchored:
                xj_in_wi = _comp4(x[i], m)
                W = _comp4(x[j], _inv4(xj_in_wi))  # wi-frame -> anchored
                mask = wid == wi
                x[mask] = _comp4(W, x[mask])
                anchored.add(wi)
                changed = True
            elif wi in anchored and wj not in anchored:
                xj_in_wi = _comp4(x[i], m)
                W = _comp4(xj_in_wi, _inv4(x[j]))
                mask = wid == wj
                x[mask] = _comp4(W, x[mask])
                anchored.add(wj)
                changed = True
    return x
