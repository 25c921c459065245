"""Plain reference of the 4-DOF switch-constrained pose graph and its solve.

The graph (the system's ``pose_graph`` semantics): one node per frame with
an odometry pose, its state (x, y, z, yaw) of the body (w_T_cam @
cam_T_body); odometry edges between consecutive posed frames of one world
(measurement: j's translation in i's yaw frame and the yaw difference);
loop edges from the accepted loop closures, conjugated into the body frame.
Each world is first re-anchored onto the earliest world a loop edge joins it
to. Residuals: odometry r = Rz(yaw_i)^T (t_j - t_i) - m_t, wrap(yaw_j -
yaw_i - m_yaw); loop edges the same scaled by s = sigmoid(s_logit) (s_logit
starts at 2), a switch prior (1 - s) * weight, and a gauge 10 (x_0 -
x_0,init).

``solve_exact`` is the reference: damped Gauss-Newton, ``max_gn_iters``
steps, each solving (J^T J + damping) dx = -J^T r exactly, in float64.
``solve`` is the algorithm the configuration states, each step's system
solved by conjugate gradients from zero, stopping once |r|^2 <= (1e-5)^2
|b|^2 or after ``cg_iters`` iterations, in the dtype asked for: the control
runs it in bfloat16. ``cost`` is the objective with each switch at its
optimum, by which a solve is judged. It imports nothing of the system.
"""

from __future__ import annotations

import numpy as np
import torch

CG_TOL = 1e-5


def _yaw(T):
    return np.arctan2(T[..., 1, 0], T[..., 0, 0])


def relative_yaw_t(T_i: np.ndarray, T_j: np.ndarray) -> np.ndarray:
    Rt = np.swapaxes(T_i[..., :3, :3], -1, -2)
    Dr = Rt @ T_j[..., :3, :3]
    Dt = np.einsum("...ij,...j->...i", Rt, T_j[..., :3, 3] - T_i[..., :3, 3])
    return np.concatenate([Dt, np.arctan2(Dr[..., 1, 0], Dr[..., 0, 0])[..., None]], -1)


def _comp4(a, b):
    c, s = np.cos(a[..., 3]), np.sin(a[..., 3])
    t = np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                  a[..., 1] + s * b[..., 0] + c * b[..., 1], a[..., 2] + b[..., 2]], -1)
    return np.concatenate([t, (a[..., 3] + b[..., 3])[..., None]], -1)


def _inv4(a):
    c, s = np.cos(a[..., 3]), np.sin(a[..., 3])
    t = np.stack([-(c * a[..., 0] + s * a[..., 1]), -(-s * a[..., 0] + c * a[..., 1]), -a[..., 2]], -1)
    return np.concatenate([t, (-a[..., 3])[..., None]], -1)


def anchor_worlds(x: np.ndarray, wid: np.ndarray, edges: list) -> np.ndarray:
    """Re-anchor each world onto the frame of an already anchored one
    through its loop edges (i, j, meas), chaining transitively."""
    x = x.copy()
    anchored = {int(wid.min())} if len(wid) else set()
    changed = True
    while changed:
        changed = False
        for i, j, m in edges:
            wi, wj = int(wid[i]), int(wid[j])
            if wi == wj:
                continue
            xj_in_wi = _comp4(x[i], m)
            if wj in anchored and wi not in anchored:
                Wt, moved = _comp4(x[j], _inv4(xj_in_wi)), wi
            elif wi in anchored and wj not in anchored:
                Wt, moved = _comp4(xj_in_wi, _inv4(x[j])), wj
            else:
                continue
            mask = wid == moved
            x[mask] = _comp4(Wt, x[mask])
            anchored.add(moved)
            changed = True
    return x


def build(odom_poses: np.ndarray, world: np.ndarray, body_T_cam: np.ndarray, loops: list) -> dict:
    """The graph over posed frames (poses (N, 4, 4) w_T_cam in order, their
    worlds) and loop edges [(node_prev, node_curr, T_prev_curr)]."""
    cam_T_body = np.linalg.inv(body_T_cam.astype(np.float64))
    T = odom_poses.astype(np.float64) @ cam_T_body[None]
    x0 = np.concatenate([T[:, :3, 3], _yaw(T)[:, None]], -1)
    oi = np.arange(len(T) - 1)
    keep = world[:-1] == world[1:]
    om = relative_yaw_t(T[:-1], T[1:])
    li, lj, lm = [], [], []
    B = body_T_cam.astype(np.float64)
    for i, j, T_rel in loops:
        li.append(i)
        lj.append(j)
        lm.append(relative_yaw_t(np.eye(4), B @ T_rel.astype(np.float64) @ np.linalg.inv(B)))
    lm = np.asarray(lm, np.float64).reshape(-1, 4)
    x_init = anchor_worlds(x0, world, list(zip(li, lj, lm)))
    return {"x": x_init, "oi": oi[keep], "oj": oi[keep] + 1, "om": om[keep],
            "li": np.asarray(li, np.int64), "lj": np.asarray(lj, np.int64), "lm": lm}


def _blocks(x, i, j, m):
    """Residuals (E, 4) and Jacobian blocks (E, 4, 4) for the end nodes."""
    xi, xj = x[i], x[j]
    c, s = torch.cos(xi[:, 3]), torch.sin(xi[:, 3])
    d = xj[:, :3] - xi[:, :3]
    rx = c * d[:, 0] + s * d[:, 1] - m[:, 0]
    ry = -s * d[:, 0] + c * d[:, 1] - m[:, 1]
    rz = d[:, 2] - m[:, 2]
    e = xj[:, 3] - xi[:, 3] - m[:, 3]
    ryaw = torch.atan2(torch.sin(e), torch.cos(e))
    r = torch.stack([rx, ry, rz, ryaw], -1)
    E = len(i)
    Jj = torch.zeros((E, 4, 4), dtype=x.dtype, device=x.device)
    Jj[:, 0, 0], Jj[:, 0, 1], Jj[:, 1, 0], Jj[:, 1, 1] = c, s, -s, c
    Jj[:, 2, 2] = 1.0
    Jj[:, 3, 3] = 1.0
    Ji = -Jj.clone()
    Ji[:, 0, 3] = -s * d[:, 0] + c * d[:, 1]
    Ji[:, 1, 3] = -c * d[:, 0] - s * d[:, 1]
    return r, Ji, Jj


def solve(g: dict, max_gn_iters: int = 25, cg_iters: int = 100, damping: float = 1e-6,
          switch_weight: float = 1.0, dtype=torch.float64) -> np.ndarray:
    """Optimized states (N, 4) of the graph ``g`` (``build``)."""
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    x = t(g["x"])
    x_init0 = x[0].clone()
    oi, oj, om = t(g["oi"], torch.int64), t(g["oj"], torch.int64), t(g["om"])
    li, lj, lm = t(g["li"], torch.int64), t(g["lj"], torch.int64), t(g["lm"])
    logit = torch.full((len(li),), 2.0, dtype=dtype)
    N = len(x)

    def jt(u_o, u_l, u_s, u_g, Jo, Jl, dl, dsw, sv):
        gx = torch.zeros((N, 4), dtype=dtype)
        gx.index_add_(0, oi, (Jo[0].transpose(1, 2) @ u_o[..., None])[..., 0])
        gx.index_add_(0, oj, (Jo[1].transpose(1, 2) @ u_o[..., None])[..., 0])
        ul = sv[:, None] * u_l
        gx.index_add_(0, li, (Jl[0].transpose(1, 2) @ ul[..., None])[..., 0])
        gx.index_add_(0, lj, (Jl[1].transpose(1, 2) @ ul[..., None])[..., 0])
        gx[0] += 10.0 * u_g
        return gx, (dl * u_l).sum(-1) + dsw * u_s

    for _ in range(max_gn_iters):
        ro, Joi, Joj = _blocks(x, oi, oj, om)
        rl, Jli, Jlj = _blocks(x, li, lj, lm)
        s = torch.sigmoid(logit)
        ds = s * (1.0 - s)
        dl = ds[:, None] * rl
        dsw = -switch_weight * ds

        def jv(vx, vl):
            ao = (Joi @ vx[oi][..., None] + Joj @ vx[oj][..., None])[..., 0]
            al = s[:, None] * (Jli @ vx[li][..., None] + Jlj @ vx[lj][..., None])[..., 0] + dl * vl[:, None]
            return ao, al, dsw * vl, 10.0 * vx[0]

        def matvec(vx, vl):
            gx, gl = jt(*jv(vx, vl), (Joi, Joj), (Jli, Jlj), dl, dsw, s)
            return gx + damping * vx, gl + damping * vl

        bx, bl = jt(ro, s[:, None] * rl, (1.0 - s) * switch_weight, 10.0 * (x[0] - x_init0),
                    (Joi, Joj), (Jli, Jlj), dl, dsw, s)
        bx, bl = -bx, -bl
        dx, dlg = _cg(matvec, bx, bl, cg_iters)
        x, logit = x + dx, logit + dlg
    return x.double().numpy()


def _cg(matvec, bx, bl, maxiter):
    dot = lambda a, b: (a[0] * b[0]).sum() + (a[1] * b[1]).sum()  # noqa: E731
    b = (bx, bl)
    atol2 = CG_TOL ** 2 * dot(b, b)
    xs = (torch.zeros_like(bx), torch.zeros_like(bl))
    r, p = b, b
    gamma = dot(r, r)
    for _ in range(maxiter):
        if not bool(gamma > atol2):
            break
        Ap = matvec(*p)
        alpha = gamma / dot(p, Ap)
        xs = (xs[0] + alpha * p[0], xs[1] + alpha * p[1])
        r = (r[0] - alpha * Ap[0], r[1] - alpha * Ap[1])
        gamma_new = dot(r, r)
        p = (r[0] + gamma_new / gamma * p[0], r[1] + gamma_new / gamma * p[1])
        gamma = gamma_new
    return xs


def cost(g: dict, x: np.ndarray, switch_weight: float = 1.0) -> float:
    """The objective as a function of the states alone, each switch at its
    optimum s = w^2 / (|r|^2 + w^2): odometry 0.5 |r|^2, loop edges
    0.5 w^2 |r|^2 / (|r|^2 + w^2), the gauge 0.5 * 100 |x_0 - x_0,init|^2."""
    t = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    X = t(x)
    ro, _, _ = _blocks(X, t(g["oi"], torch.int64), t(g["oj"], torch.int64), t(g["om"]))
    rl, _, _ = _blocks(X, t(g["li"], torch.int64), t(g["lj"], torch.int64), t(g["lm"]))
    r2 = (rl * rl).sum(-1)
    w2 = switch_weight ** 2
    gauge = 100.0 * ((X[0] - t(g["x"])[0]) ** 2).sum()
    return float(0.5 * (ro * ro).sum() + 0.5 * (w2 * r2 / (r2 + w2)).sum() + 0.5 * gauge)


def solve_exact(g: dict, max_gn_iters: int = 25, damping: float = 1e-6,
                switch_weight: float = 1.0, device="cpu") -> np.ndarray:
    """Damped Gauss-Newton over (x, s_logit) with each step's normal
    equations solved exactly (dense, float64): the optimum the truncated
    conjugate gradients approach."""
    f64 = torch.float64
    t = lambda a, dt=f64: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    x = t(g["x"])
    x0 = x[0].clone()
    oi, oj, om = t(g["oi"], torch.int64), t(g["oj"], torch.int64), t(g["om"])
    li, lj, lm = t(g["li"], torch.int64), t(g["lj"], torch.int64), t(g["lm"])
    N, L = len(x), len(li)
    logit = torch.full((L,), 2.0, dtype=f64, device=device)
    n = 4 * N + L
    for _ in range(max_gn_iters):
        ro, Joi, Joj = _blocks(x, oi, oj, om)
        rl, Jli, Jlj = _blocks(x, li, lj, lm)
        s = torch.sigmoid(logit)
        ds = s * (1.0 - s)
        rows = 4 * len(oi) + 4 * L + L + 4
        J = torch.zeros((rows, n), dtype=f64, device=device)
        r = torch.zeros(rows, dtype=f64, device=device)
        Eo = len(oi)
        ridx = torch.arange(Eo, device=device)[:, None] * 4 + torch.arange(4, device=device)[None]
        for blk, nodes in ((Joi, oi), (Joj, oj)):
            cols = nodes[:, None] * 4 + torch.arange(4, device=device)[None]
            J.index_put_((ridx[:, :, None].expand(-1, 4, 4), cols[:, None, :].expand(-1, 4, 4)), blk,
                         accumulate=True)
        r[: 4 * Eo] = ro.reshape(-1)
        base = 4 * Eo
        ridx = base + torch.arange(L, device=device)[:, None] * 4 + torch.arange(4, device=device)[None]
        for blk, nodes in ((Jli, li), (Jlj, lj)):
            cols = nodes[:, None] * 4 + torch.arange(4, device=device)[None]
            J.index_put_((ridx[:, :, None].expand(-1, 4, 4), cols[:, None, :].expand(-1, 4, 4)),
                         s[:, None, None] * blk, accumulate=True)
        lcol = 4 * N + torch.arange(L, device=device)
        J[ridx, lcol[:, None].expand(-1, 4)] = ds[:, None] * rl
        r[base: base + 4 * L] = (s[:, None] * rl).reshape(-1)
        base += 4 * L
        J[base + torch.arange(L, device=device), lcol] = -switch_weight * ds
        r[base: base + L] = (1.0 - s) * switch_weight
        base += L
        J[base + torch.arange(4, device=device), torch.arange(4, device=device)] = 10.0
        r[base:] = 10.0 * (x[0] - x0)
        A = J.T @ J + damping * torch.eye(n, dtype=f64, device=device)
        d = torch.linalg.solve(A, -(J.T @ r))
        x = x + d[: 4 * N].reshape(N, 4)
        logit = logit + d[4 * N:]
    return x.cpu().numpy()


def states_of(traj: np.ndarray, body_T_cam: np.ndarray) -> np.ndarray:
    """Body states (N, 4) of a trajectory of w_T_cam poses (N, 4, 4)."""
    T = traj.astype(np.float64) @ np.linalg.inv(body_T_cam.astype(np.float64))[None]
    return np.concatenate([T[:, :3, 3], _yaw(T)[:, None]], -1)


def positions(x: np.ndarray, body_T_cam: np.ndarray) -> np.ndarray:
    """Camera positions (N, 3) of body states (N, 4)."""
    c, s = np.cos(x[:, 3]), np.sin(x[:, 3])
    R = np.zeros((len(x), 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -s, s, c, 1.0
    return x[:, :3] + R @ body_T_cam[:3, 3].astype(np.float64)
