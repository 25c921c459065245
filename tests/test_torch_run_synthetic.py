"""``python -m cerebro_tpu_torch.run_synthetic`` against
``scripts/run_synthetic.py``, both run with ``--cpu`` at ``FRAMES`` frames
(the JAX script as a subprocess: its ``main`` reads ``sys.argv`` and sets
up its own 8 virtual devices).

- The rendered frames: each frame's pose (``se3.make_pose`` of
  ``ypr_to_rot``) within 1 ulp of JAX's, and the images rendered through
  the port's ``remap_bilinear`` equal to the JAX script's (numpy rays, a
  jnp ``remap_bilinear``) but for at most ``MAX_PIXELS_OFF`` pixels of the
  2,150,400 in the 14 stereo pairs, each off by one grey level: f32
  rounding in the two samplers and in the poses (21 pixels when this test
  was written: 2 from the samplers, the rest from 4 pose elements one ulp
  apart).
- ``result.json`` and ``debug/``: the same status counts (frames,
  keyframes, described, loop edges, rejected candidates, pending), the
  same kidnap intervals and world id, the same verified edge pairs and
  rejections, the same verdict (``OK`` / ``DEGRADED``); the score curve
  (``dump_debug`` writes it as a 240 x 640 plot, one row a score step of
  2/239, about 8e-3) with the same detection marks and, in every column,
  within one row of JAX's (the scores are products of bf16 DB rows, within
  about 1e-3 of each other); the session-2 ATE and the optimized
  trajectory within 0.07 m, the spread RANSAC's own seed gives the edge
  poses (ROADMAP's test conventions: the packages draw their RANSAC
  hypotheses from different generators).
- ``--out`` is required, and without CUDA the script raises unless given
  ``--cpu`` (tests/test_torch_boundary.py)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from cerebro_tpu.geometry import se3 as jse3
from cerebro_tpu.geometry import stereo as jstereo
from cerebro_tpu_torch import run_synthetic as rs

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FRAMES = 10
MAX_PIXELS_OFF = 64
RANSAC_SPREAD_M = 0.07


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's out dir, its stdout, the port's out dir, its result); the two
    runs overlap in time."""
    root = tmp_path_factory.mktemp("run_synthetic")
    jdir, tdir = root / "jax", root / "port"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "run_synthetic.py"), "--out", str(jdir),
         "--cpu", "--frames", str(FRAMES)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        result = rs.main(["--out", str(tdir), "--cpu", "--frames", str(FRAMES)])
        out = proc.communicate(timeout=240)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    return jdir, out, tdir, result


def _jax_pose(i):
    return np.asarray(jse3.make_pose(jse3.ypr_to_rot(jnp.asarray([0.02 * i, 0.0, 0.0])),
                                     jnp.asarray([0.35 * i, 0.05 * i, 0.0]))).astype(np.float32)


def _jax_render(tex, w_T_c):
    """scripts/run_synthetic.py's ``render``, line for line."""
    R, tv = w_T_c[:3, :3], w_T_c[:3, 3]
    u, v = np.meshgrid(np.arange(rs.W, dtype=np.float32), np.arange(rs.H, dtype=np.float32))
    rays = np.stack([(u - rs.CX) / rs.FX, (v - rs.CY) / rs.FX, np.ones_like(u)], -1)
    dirs = rays @ R.T
    s_near = (rs.Z_NEAR - tv[2]) / dirs[..., 2]
    p_near = tv[None, None] + s_near[..., None] * dirs
    s = np.where(p_near[..., 0] < rs.X_SPLIT, s_near, (rs.Z_FAR - tv[2]) / dirs[..., 2])
    p = tv[None, None] + s[..., None] * dirs
    tx = p[..., 0] * 150.0 + tex.shape[1] / 2
    ty = p[..., 1] * 150.0 + tex.shape[0] / 2
    img = np.asarray(jstereo.remap_bilinear(jnp.asarray(tex), jnp.asarray(np.stack([tx, ty], -1))))
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def test_rendered_frames_match_the_jax_script():
    tex = rs.fractal_texture(np.random.default_rng(rs.TEXTURE_SEED))
    off, worst = 0, 0
    for i in range(14):
        pj, pt = _jax_pose(i), rs.cam_pose(i)
        np.testing.assert_array_max_ulp(pt, pj, maxulp=1)
        Tr = pj.copy()
        Tr[:3, 3] += pj[:3, :3] @ np.array([rs.BASE, 0, 0], np.float32)
        for want, got in zip((_jax_render(tex, pj), _jax_render(tex, Tr)), rs.stereo_pair(tex, pt)):
            off += int((want != got).sum())
            worst = max(worst, int(np.abs(want.astype(int) - got).max()))
    assert off <= MAX_PIXELS_OFF and worst <= 1, (off, worst)
    np.testing.assert_array_max_ulp(
        rs.kidnap_offset(),
        np.asarray(jse3.make_pose(jse3.ypr_to_rot(jnp.asarray([0.35, 0.0, 0.0])),
                                  jnp.asarray([4.0, 0.0, 0.0]))).astype(np.float32), maxulp=1)


def _load(d, name):
    with open(d / name) as f:
        return json.load(f)


def test_status_edges_and_verdict_match(runs):
    jdir, jout, tdir, result = runs
    jres, tres = _load(jdir, "result.json"), _load(tdir, "result.json")
    assert set(jres) == set(tres) == {"status", "verified_edges", "session2_merged_ate_m",
                                      "session2_anchor_error_m", "timings_ms"}
    for key in ("frames", "keyframes", "described", "shed_descriptors", "pending_descriptors",
                "pending_candidates", "loop_edges", "rejected_candidates", "kidnap"):
        assert tres["status"][key] == jres["status"][key], key
    assert tres["verified_edges"] == jres["verified_edges"] >= 1
    assert tres["session2_anchor_error_m"] == jres["session2_anchor_error_m"]
    assert abs(tres["session2_merged_ate_m"] - jres["session2_merged_ate_m"]) < RANSAC_SPREAD_M
    verdict = jout.strip().splitlines()[-1]
    assert verdict == ("OK" if result["ok"] else "DEGRADED") == "OK"
    assert {k for k in result if k != "ok"} == set(tres)
    for name in ("loop_edges.json", "rejections.json"):
        je, te = _load(jdir / "debug", name), _load(tdir / "debug", name)
        pairs = lambda es: sorted((e.get("idx0"), e.get("idx1"), e.get("reason")) for e in es)  # noqa: E731
        assert pairs(te) == pairs(je), name
    assert _load(tdir / "debug", "status.json")["loop_edges"] == _load(jdir / "debug", "status.json")["loop_edges"]


def test_score_curve_and_trajectory_match(runs):
    jdir, _, tdir, _ = runs
    sj, st = (np.load(d / "debug" / "score_curve.npy") for d in (jdir, tdir))
    assert sj.shape == st.shape
    fg, mark = np.array([80, 220, 120], np.uint8), np.array([240, 80, 80], np.uint8)
    # the same detection marks
    marks = [np.nonzero((img == mark).all(-1).any(0))[0] for img in (sj, st)]
    np.testing.assert_array_equal(*marks)
    # the curve: in every column, each drawn row within one row of one of
    # the other's
    for x in range(sj.shape[1]):
        a, b = (np.nonzero((img[:, x] == fg).all(-1))[0] for img in (sj, st))
        assert (len(a) == 0) == (len(b) == 0), x
        if len(a):
            d = np.abs(a[:, None] - b[None, :])
            assert d.min(1).max() <= 1 and d.min(0).max() <= 1, x
    tj, tt = (np.load(d / "debug" / "trajectory.npy") for d in (jdir, tdir))
    assert tj.shape == tt.shape
    np.testing.assert_allclose(tt[:, :3, 3], tj[:, :3, 3], atol=RANSAC_SPREAD_M, rtol=0)
    rj, rt = (np.load(d / "trajectory_render.npy") for d in (jdir, tdir))
    assert rj.shape == rt.shape and rj.dtype == rt.dtype


def test_out_is_required():
    with pytest.raises(SystemExit):
        rs.parse_args(["--cpu"])
