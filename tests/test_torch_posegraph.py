"""Switch-constrained pose graph and ATE: the port against the JAX package
on tests/test_posegraph.py's graphs (odometry drift closed by loops, a false
loop that its switch must turn off, two worlds merged by cross-world loops,
and a 6-DOF chain).

The solver is Gauss-Newton with a truncated CG solve stopped at
||r||^2 <= 1e-10 ||b||^2. At the JAX tests' own settings (15 GN steps of up
to 80 CG iterations) that stopping test decides between iterations whose
steps are large on these ill-conditioned chains, so the JAX package's own
result moves by centimetres when its inputs change by one part in 10^7
(and still does in f64): no second implementation can match it to 1e-3
there. So the exact comparison runs 5 GN steps of 8 CG iterations, where
the solve is a smooth function of its inputs, and must hold within 1e-3 m
/ 1e-3 rad for states and 1e-3 for switches. At the JAX tests' settings the port must land in the same basin
(within 0.15, the tolerance of test_sharded_optimizer_matches_single_device)
and pass the JAX tests' own quality checks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.config import PoseGraphConfig as JPoseGraphConfig
from cerebro_tpu.eval import ate_rmse as j_ate_rmse
from cerebro_tpu.geometry import se3 as jse3
from cerebro_tpu.posegraph import PoseGraph as JPoseGraph
from cerebro_tpu.posegraph import initialize_worlds as j_initialize_worlds
from cerebro_tpu.posegraph import optimize as j_optimize
from cerebro_tpu.posegraph import optimizer as jopt
from cerebro_tpu_torch import eval as teval
from cerebro_tpu_torch.config import PoseGraphConfig
from cerebro_tpu_torch.posegraph import optimizer as topt

import test_posegraph as tp

PARITY = dict(max_gn_iters=5, cg_iters=8)
FULL = dict(max_gn_iters=15, cg_iters=80)


def _drift():
    rng = np.random.default_rng(0)
    n = 60
    x_gt = tp.circle_traj(n)
    odo = tp.odo_measurements(x_gt, rng)
    x_init = tp.integrate(odo, x_gt[0])
    T = tp.to_poses(x_gt)
    loops = [(n - 1, 0), (n - 2, 1), (n - 3, 2)]
    lm = [np.asarray(jopt.relative_yaw_t(jnp.asarray(T[a]), jnp.asarray(T[b]))) for a, b in loops]
    return tp.build_graph(x_init, odo, loops, lm), 4, x_gt


def _false_loop():
    rng = np.random.default_rng(0)
    n = 60
    x_gt = tp.circle_traj(n)
    odo = tp.odo_measurements(x_gt, rng)
    x_init = tp.integrate(odo, x_gt[0])
    T = tp.to_poses(x_gt)
    good = [(n - 1, 0), (n - 2, 1)]
    lm = [np.asarray(jopt.relative_yaw_t(jnp.asarray(T[a]), jnp.asarray(T[b]))) for a, b in good]
    lm_bad = np.array([5.0, -3.0, 1.0, 2.0], np.float32)
    return tp.build_graph(x_init, odo, good + [(30, 5)], lm + [lm_bad]), 4, x_gt


def _multi_world_inputs():
    """test_multi_world_merge's two worlds: world 1 re-integrated from a
    wrong anchor, three cross-world loops."""
    n0, n1 = 30, 30
    x_gt = tp.circle_traj(n0 + n1)
    T = tp.to_poses(x_gt)
    odo = tp.odo_measurements(x_gt, np.random.default_rng(1), drift_y=0.0)
    x_init = tp.integrate(odo, x_gt[0])
    x_init[n0] = np.array([7.0, -4.0, 0.5, 0.8], np.float32)
    for i in range(n0, n0 + n1 - 1):
        c, s = np.cos(x_init[i][3]), np.sin(x_init[i][3])
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        x_init[i + 1] = np.concatenate([x_init[i][:3] + R @ odo[i][:3], [x_init[i][3] + odo[i][3]]])
    loops = [(40, 10), (41, 11), (42, 12)]
    lm = np.asarray(
        [np.asarray(jopt.relative_yaw_t(jnp.asarray(T[a]), jnp.asarray(T[b]))) for a, b in loops]
    )
    world_id = np.concatenate([np.zeros(n0, np.int32), np.ones(n1, np.int32)])
    return x_gt, odo, x_init, world_id, loops, lm


def _multi_world():
    x_gt, odo, x_init, world_id, loops, lm = _multi_world_inputs()
    li, lj = [a for a, _ in loops], [b for _, b in loops]
    x_anchored = j_initialize_worlds(x_init, world_id, li, lj, lm, np.ones(3, bool))
    odo_valid = np.ones(len(odo), bool)
    odo_valid[29] = False  # the kidnap gap
    g = tp.build_graph(x_anchored, odo, loops, list(lm))
    return dataclasses.replace(g, odo_valid=jnp.asarray(odo_valid)), 4, x_gt


def _six_dof():
    n = 40
    xi_gt = np.zeros((n, 6), np.float32)
    for i in range(1, n):
        xi_gt[i] = xi_gt[i - 1] + np.array([0.3, 0.02, 0.05, 0.01, 0.015, 0.02], np.float32)
    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(xi_gt)))
    noise = np.random.default_rng(0)
    odo = []
    for i in range(n - 1):
        m = np.array(jopt.relative_se3(jnp.asarray(T_gt[i]), jnp.asarray(T_gt[i + 1])))
        odo.append(m + noise.normal(0, 0.004, 6))
    odo = np.asarray(odo, np.float32)
    T = np.eye(4, dtype=np.float32)
    Ts = [T]
    for m in odo:
        T = T @ np.asarray(jse3.se3_exp(jnp.asarray(m)))
        Ts.append(T.astype(np.float32))
    x_init = np.asarray(jse3.se3_log(jnp.asarray(np.stack(Ts))))
    loops = [(n - 1, 0), (n - 2, 1)]
    lm = [np.array(jopt.relative_se3(jnp.asarray(T_gt[a]), jnp.asarray(T_gt[b]))) for a, b in loops]
    g = JPoseGraph(
        xyzyaw=jnp.asarray(x_init),
        node_valid=jnp.ones(n, dtype=bool),
        odo_i=jnp.arange(n - 1, dtype=jnp.int32),
        odo_j=jnp.arange(1, n, dtype=jnp.int32),
        odo_meas=jnp.asarray(odo),
        odo_valid=jnp.ones(n - 1, dtype=bool),
        loop_i=jnp.asarray([a for a, _ in loops], jnp.int32),
        loop_j=jnp.asarray([b for _, b in loops], jnp.int32),
        loop_meas=jnp.asarray(np.asarray(lm, np.float32)),
        loop_valid=jnp.ones(2, dtype=bool),
    )
    return g, 6, xi_gt


GRAPHS = {"drift": _drift, "false_loop": _false_loop, "multi_world": _multi_world, "six_dof": _six_dof}


def _to_torch(g):
    return topt.PoseGraph(
        **{f.name: torch.from_numpy(np.array(getattr(g, f.name))) for f in dataclasses.fields(g)}
    )


def _solve_both(name, iters):
    g, dof, x_gt = GRAPHS[name]()
    xj, sj, cj = j_optimize(g, JPoseGraphConfig(dof=dof, **iters))
    xt, st, ct = topt.optimize(_to_torch(g), PoseGraphConfig(dof=dof, **iters))
    assert xt.dtype == torch.float32 and st.dtype == torch.float32
    return (np.asarray(xj), np.asarray(sj), float(cj)), (xt.numpy(), st.numpy(), float(ct)), g, x_gt


@pytest.mark.parametrize("name", list(GRAPHS))
def test_optimize_matches_jax(name):
    (xj, sj, cj), (xt, st, ct), g, _ = _solve_both(name, PARITY)
    assert np.abs(xj - np.asarray(g.xyzyaw)).max() > 5e-3  # the solve moved the states
    np.testing.assert_allclose(xt, xj, atol=1e-3, rtol=0)
    np.testing.assert_allclose(st, sj, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", ["drift", "false_loop", "multi_world"])
def test_optimize_full_settings_same_basin(name):
    """At the JAX tests' settings: the same basin as JAX, and the JAX tests'
    own quality checks hold for the port's solution. (The 6-DOF chain is
    held at the parity settings only, to keep this file's time down.)"""
    (xj, sj, _), (xt, st, _), g, x_gt = _solve_both(name, FULL)
    np.testing.assert_allclose(xt, xj, atol=0.15, rtol=0)
    np.testing.assert_allclose(st, sj, atol=2e-2, rtol=0)
    x_init = np.asarray(g.xyzyaw)
    if name == "drift":
        assert tp.ate(xt, x_gt) < 0.5 * tp.ate(x_init, x_gt)
        assert np.linalg.norm(xt[-1, :3] - x_gt[-1, :3]) < 0.15
        assert np.all(st > 0.7)
    elif name == "false_loop":
        assert np.all(st[:2] > 0.6) and st[2] < 0.3
        assert tp.ate(xt, x_gt) < 1.0
    else:
        assert tp.ate(xt, x_gt) < 0.6 and np.all(st > 0.5)


def test_initialize_worlds_matches_jax():
    """Re-anchoring world 1 from its first cross-world loop (host numpy on
    both sides): within 1e-5."""
    x_gt, odo, x_init, world_id, loops, lm = _multi_world_inputs()
    li, lj = [a for a, _ in loops], [b for _, b in loops]
    want = j_initialize_worlds(x_init, world_id, li, lj, lm, np.ones(3, bool))
    got = topt.initialize_worlds(x_init, world_id, li, lj, lm, np.ones(3, bool))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tp.ate(got, x_gt) < 2.0


def _random_poses(n=8, seed=3):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        T[k, :3, :3] = np.asarray(jse3.ypr_to_rot(jnp.asarray(rng.uniform(-1.5, 1.5, 3))))
        T[k, :3, 3] = rng.uniform(-5, 5, 3)
    return T


def test_relative_measurements_match_jax():
    """relative_yaw_t (device and numpy twins), relative_se3, se3_log,
    yaw_translation_pose and poses_from_xyzyaw: within 1e-5."""
    T = _random_poses()
    a, b = T[:-1], T[1:]
    want = np.asarray(jopt.relative_yaw_t(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(topt.relative_yaw_t_np(a, b), jopt.relative_yaw_t_np(a, b), atol=1e-6)
    np.testing.assert_allclose(topt.relative_yaw_t_np(a, b), want, atol=1e-5)
    got = topt.relative_yaw_t(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # twists: small motions (the 6-DOF chain) and large rotations
    small = np.asarray(jse3.se3_exp(jnp.asarray(np.random.default_rng(4).normal(0, 0.05, (8, 6)), jnp.float32)))
    for x, y in ((a, b), (small[:-1], small[1:])):
        np.testing.assert_allclose(
            topt.relative_se3(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))).numpy(),
            np.asarray(jopt.relative_se3(jnp.asarray(x), jnp.asarray(y))),
            atol=1e-5,
        )
    xyzyaw = np.random.default_rng(5).uniform(-3, 3, (8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        topt.poses_from_xyzyaw(torch.from_numpy(xyzyaw)).numpy(),
        np.asarray(jopt.poses_from_xyzyaw(jnp.asarray(xyzyaw))),
        atol=1e-6,
    )


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_matches_jax(align):
    rng = np.random.default_rng(6)
    gt = rng.normal(size=(40, 3)).astype(np.float32)
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    est = gt @ R.T + np.array([2.0, -1.0, 0.5], np.float32) + rng.normal(0, 0.1, (40, 3)).astype(np.float32)
    want = j_ate_rmse(est, gt, align=align)
    got = teval.ate_rmse(est, gt, align=align)
    assert abs(got - want) < 1e-5
    assert (got < 0.3) == align


def test_run_sequence_trace_dir_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teval.run_sequence(None, [], trace_dir="trace")
