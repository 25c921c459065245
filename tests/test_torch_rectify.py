"""The port's stereo rectification against the JAX package's
(cerebro_tpu_torch/geometry/stereo.py: stereo_rectify, rectify_map,
remap_bilinear, StereoRectifier) on the bundled EuRoC rig.

- stereo_rectify: R0, R1, fx, fy, cx, cy and the baseline within 1e-6;
- rectify_map at 480x752: within 2e-3 px;
- remap_bilinear: within 1e-5, with coordinates out of range, on the
  half-pixel border and exactly on the last row and column;
- StereoRectifier.rectify on a raw 480x752 pair: at most 1 grey level
  apart anywhere, 0.01 on average; float32 images out;
- the rectifier refuses to build without CUDA unless given the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.geometry import stereo as jst
from cerebro_tpu.io.rig_config import load_rig_config as jload
from cerebro_tpu_torch.geometry import stereo as tst
from cerebro_tpu_torch.io.rig_config import load_rig_config as tload

RIG = os.path.join(os.path.dirname(__file__), "..", "configs", "euroc", "euroc_stereo_config.yaml")


@pytest.fixture(scope="module")
def rigs():
    js, ts = jload(RIG), tload(RIG)
    T = js.c1_T_c0.astype(np.float32)
    jr = jst.stereo_rectify(js.cam0, js.cam1, jnp.asarray(T))
    tr = tst.stereo_rectify(ts.cam0, ts.cam1, T)
    return js, ts, jr, tr


def test_stereo_rectify_matches_jax(rigs):
    _, _, jr, tr = rigs
    for name in ("R0", "R1"):
        np.testing.assert_allclose(getattr(tr, name), np.asarray(getattr(jr, name)), atol=1e-6, rtol=0)
    for name in ("fx", "fy", "cx", "cy", "baseline"):
        assert abs(getattr(tr, name) - float(getattr(jr, name))) <= 1e-6 * max(1.0, abs(getattr(tr, name))), name
    assert abs(tr.baseline - 0.110) < 1e-3


@pytest.mark.parametrize("cam", [0, 1])
def test_rectify_map_matches_jax(rigs, cam):
    js, ts, jr, tr = rigs
    jc, tc = (js.cam0, ts.cam0) if cam == 0 else (js.cam1, ts.cam1)
    jm = np.asarray(jst.rectify_map(jc, jr.R0 if cam == 0 else jr.R1, jr, (480, 752)))
    tm = tst.rectify_map(tc, tr.R0 if cam == 0 else tr.R1, tr, (480, 752), device="cpu").numpy()
    assert tm.shape == (480, 752, 2)
    np.testing.assert_allclose(tm, jm, atol=2e-3, rtol=0)


def test_remap_bilinear_matches_jax(rng):
    H, W = 37, 53
    img = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    xy = np.stack([rng.uniform(-3.0, W + 2.0, 4000), rng.uniform(-3.0, H + 2.0, 4000)], -1)
    edges = np.array(
        [[-0.5, 0.0], [-0.5001, 3.0], [W - 0.5, 4.0], [W - 0.4999, 4.0], [W - 1.0, H - 1.0],
         [0.0, -0.5], [7.0, H - 0.5], [7.0, H - 0.49], [-1e-6, -1e-6], [W - 1.0, 2.5]],
    )
    xy = np.concatenate([xy, edges]).astype(np.float32).reshape(401, 10, 2)
    jo = np.asarray(jst.remap_bilinear(jnp.asarray(img), jnp.asarray(xy)))
    to = tst.remap_bilinear(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
    assert (to == 0).any() and (to != 0).any()


def test_stereo_rectifier_matches_jax(rigs, rng):
    js, ts, _, _ = rigs
    T = js.c1_T_c0.astype(np.float32)
    jrect = jst.StereoRectifier(js.cam0, js.cam1, T, out_hw=(480, 752))
    trect = tst.StereoRectifier(ts.cam0, ts.cam1, T, out_hw=(480, 752), device="cpu")
    # a smooth raw pair with texture at several scales
    yy, xx = np.mgrid[0:480, 0:752].astype(np.float32)
    base = 128 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0) + 30 * np.sin((xx + yy) / 5.0)
    left = np.clip(base + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)
    right = np.roll(left, -9, axis=1)
    jl, jr_ = jrect.rectify(left, right)
    tl, tr_ = trect.rectify(left, right)
    assert tl.dtype == np.float32 and tr_.dtype == np.float32 and tl.shape == (480, 752)
    for t, j in ((tl, jl), (tr_, jr_)):
        d = np.abs(t - np.asarray(j, np.float32))
        assert d.max() <= 1.0 and d.mean() <= 0.01, (d.max(), d.mean())
    only_left, none = trect.rectify(left)
    assert none is None
    np.testing.assert_array_equal(only_left, tl)


def test_stereo_rectifier_needs_cuda_or_cpu(rigs, monkeypatch):
    _, ts, _, _ = rigs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.StereoRectifier(ts.cam0, ts.cam1, ts.c1_T_c0, out_hw=(48, 64))


def _chip_smoke():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_fixture(tmp_path_factory):
    cs = _chip_smoke()
    mav0, rig, _, rendered = cs.write_euroc_fixture(str(tmp_path_factory.mktemp("euroc")), 20, 2.0)
    return cs, mav0, tload(rig), rendered


@pytest.mark.parametrize("dist_scale, passes", [
    ((1.0, 1.0, 1.0, 1.0), True),  # the fixture's own distortion
    ((1.1, 1.0, 1.0, 1.0), False),  # k1 10% off
    ((0.0, 0.0, 0.0, 0.0), False),  # no undistortion
], ids=["exact", "k1_10pct_off", "no_undistortion"])
def test_chip_smoke_roundtrip_gate_tells_a_wrong_map(smoke_fixture, dist_scale, passes):
    """chip_smoke's euroc fixture and its round-trip gate (rectified left
    against the image its raw frame was made from, mean grey levels per
    pixel): the fixture's own rig passes it, a rectifier built with a
    wrong distortion fails it."""
    import dataclasses

    from cerebro_tpu_torch.io.euroc import EurocSequence

    cs, mav0, spec, rendered = smoke_fixture
    scale = torch.tensor(dist_scale)
    c0, c1 = (dataclasses.replace(c, dist=c.dist * scale) for c in (spec.cam0, spec.cam1))
    rect = tst.StereoRectifier(c0, c1, spec.c1_T_c0.astype(np.float32), out_hw=spec.image_hw, device="cpu")
    seq = EurocSequence(mav0)
    index_of = {f.stamp: i for i, f in enumerate(seq.frames())}
    times = cs.new_times()
    for _ in cs.rectified_frames(seq.frames(), rect, times, rendered=lambda s: rendered[index_of[s]][0]):
        pass
    err = float(np.mean(times["roundtrip_err"]))
    assert len(times["roundtrip_err"]) == 2
    assert (err <= cs.ROUNDTRIP_LIMIT) == passes, err
