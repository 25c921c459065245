"""The port's camera models and rig config front-end against the JAX
package's (cerebro_tpu_torch/geometry/cameras.py, io/rig_config.py).

- project and lift for each of the four models on the same random points
  and pixels: pixels within 1e-4 px, unit rays within 1e-5;
- from_yaml_dict on the bundled EuRoC camera yamls: equal parameters;
- load_rig_config on the bundled EuRoC rig, the mm-rule extrinsic and the
  verbatim reference yaml of tests/test_rig_config.py: cam0, cam1,
  c1_T_c0 (1e-12) and image_hw equal."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.geometry import cameras as jcam
from cerebro_tpu.io import rig_config as jrig
from cerebro_tpu_torch.geometry import cameras as tcam
from cerebro_tpu_torch.io import rig_config as trig

from test_rig_config import REF_MAIN_YAML, _write_rig

REPO = os.path.join(os.path.dirname(__file__), "..")
EUROC = os.path.join(REPO, "configs", "euroc")

MODELS = {
    "pinhole": ("make_pinhole", dict(
        fx=458.654, fy=457.296, cx=367.215, cy=248.375,
        dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    )),
    "kannala_brandt": ("make_kannala_brandt", dict(
        mu=460.0, mv=460.0, u0=376.0, v0=240.0, k=(-0.01, 0.005, -0.002, 0.0005),
    )),
    "mei": ("make_mei", dict(
        gamma1=600.0, gamma2=600.0, u0=376.0, v0=240.0, xi=1.0, dist=(-0.1, 0.02, 0.001, -0.0005),
    )),
    "scaramuzza": ("make_scaramuzza", dict(
        c=1.001, u0=376.0, v0=240.0, poly=(420.0, -0.0013, 1e-6, -2e-9), d_affine=0.002,
    )),
}


def _points(rng, n=512):
    xy = rng.uniform(-0.6, 0.6, size=(n, 2))
    z = rng.uniform(0.5, 20.0, size=(n, 1))
    return np.concatenate([xy * z, z], axis=-1).astype(np.float32)


def _pixels(rng, n=512):
    return np.stack(
        [rng.uniform(0.0, 752.0, n), rng.uniform(0.0, 480.0, n)], axis=-1
    ).astype(np.float32)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_project_and_lift_match_jax(model, rng):
    factory, kw = MODELS[model]
    jc = getattr(jcam, factory)(**kw)
    tc = getattr(tcam, factory)(**kw)
    assert (tc.model, tc.width, tc.height) == (jc.model, jc.width, jc.height)
    P = _points(rng)
    uv_j = np.array(jcam.project(jc, jnp.asarray(P)))
    uv_t = tcam.project(tc, torch.from_numpy(P)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-4, rtol=0)

    uv = _pixels(rng)
    ray_j = np.asarray(jcam.lift(jc, jnp.asarray(uv)))
    ray_t = tcam.lift(tc, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(ray_t, ray_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(ray_t, axis=-1), 1.0, atol=1e-5)

    nc_j = np.asarray(jcam.normalized_coords(jc, jnp.asarray(uv_j)))
    nc_t = tcam.normalized_coords(tc, torch.from_numpy(uv_j)).numpy()
    np.testing.assert_allclose(nc_t, nc_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tcam.K_matrix(tc).numpy(), np.asarray(jcam.K_matrix(jc)))


def _cam_fields(c):
    return (
        [float(np.asarray(getattr(c, f))) for f in ("fx", "fy", "cx", "cy", "xi")]
        + np.asarray(c.dist).tolist() + [c.model, c.width, c.height]
    )


@pytest.mark.parametrize("name", ["cam0_pinhole.yaml", "cam1_pinhole.yaml"])
def test_from_yaml_dict_matches_jax(name):
    with open(os.path.join(EUROC, name)) as f:
        tree = trig.parse_opencv_yaml(f.read())
    assert _cam_fields(tcam.from_yaml_dict(tree)) == _cam_fields(jcam.from_yaml_dict(tree))


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown camera model"):
        tcam.from_yaml_dict({"model_type": "FISHEYE9"})


def _same_spec(t, j):
    assert _cam_fields(t.cam0) == _cam_fields(j.cam0)
    assert (t.cam1 is None) == (j.cam1 is None)
    if j.cam1 is not None:
        assert _cam_fields(t.cam1) == _cam_fields(j.cam1)
    np.testing.assert_allclose(t.c1_T_c0, j.c1_T_c0, atol=1e-12, rtol=0)
    assert t.image_hw == j.image_hw


def test_bundled_euroc_rig_matches_jax():
    path = os.path.join(EUROC, "euroc_stereo_config.yaml")
    _same_spec(trig.load_rig_config(path), jrig.load_rig_config(path))


@pytest.mark.parametrize("extrinsic", ["mm_file", "body_T_cam"])
def test_reference_rig_yaml_matches_jax(tmp_path, extrinsic):
    text = REF_MAIN_YAML
    if extrinsic == "body_T_cam":
        text = text.replace('extrinsic_1_T_0: "extrinsics.yaml"', "")
    path = _write_rig(tmp_path, text)
    t, j = trig.load_rig_config(path), jrig.load_rig_config(path)
    _same_spec(t, j)
    if extrinsic == "mm_file":  # -110.074 mm -> -0.110074 m
        assert abs(t.c1_T_c0[0, 3] + 0.110074) < 1e-12
    tree_t, tree_j = trig.parse_opencv_yaml(text), jrig.parse_opencv_yaml(text)
    assert sorted(tree_t) == sorted(tree_j)
    for k in tree_j:
        np.testing.assert_array_equal(np.asarray(tree_t[k]), np.asarray(tree_j[k]))
