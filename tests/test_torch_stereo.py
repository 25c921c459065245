"""Stereo block matching (K3's plain version) and 3D point maps: the port
against the JAX package's XLA block_match and its Pallas kernel (interpret
mode on the CPU), on tests/test_stereo.py's textured scenes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.geometry import stereo as js
from cerebro_tpu.ops.stereo_pallas import block_match_pallas
from cerebro_tpu_torch.geometry import stereo as ts
from cerebro_tpu_torch.ops import stereo_kernel

from test_stereo import textured


def _constant(rng, h, w, d_true):
    base = textured(rng, h, w + d_true)
    return base[:, :-d_true], base[:, d_true:]


def _two_planes(rng, h, w, d1=6, d2=20):
    base = textured(rng, h, w + 32)
    left = base[:, :w]
    right = np.zeros_like(left)
    right[: h // 2] = base[: h // 2, d1 : d1 + w]
    right[h // 2 :] = base[h // 2 :, d2 : d2 + w]
    return left, right


SCENES = {
    "constant": lambda rng: _constant(rng, 96, 256, 12),
    "two_planes": lambda rng: _two_planes(rng, 96, 256),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_block_match_matches_jax_xla(scene):
    """Both sum the box in f32 in different orders: masks agree on >= 99.9%
    of pixels and |Δd| <= 1e-3 where both are valid."""
    left, right = SCENES[scene](np.random.default_rng(0))
    dj, vj = js.block_match(jnp.asarray(left), jnp.asarray(right), num_disp=32, block=11)
    dt, vt = ts.block_match(torch.from_numpy(left), torch.from_numpy(right), num_disp=32, block=11)
    dj, vj, dt, vt = np.asarray(dj), np.asarray(vj), dt.numpy(), vt.numpy()
    assert vj.sum() > 0.3 * vj.size
    assert (vj == vt).mean() >= 0.999
    both = vj & vt
    assert np.abs(dj[both] - dt[both]).max() <= 1e-3


def test_block_match_full_size_matches_jax_xla():
    """The verification shape: 240x320, 64 disparities, block 21."""
    left, right = _constant(np.random.default_rng(1), 240, 320, 23)
    dj, vj = js.block_match(jnp.asarray(left), jnp.asarray(right), num_disp=64, block=21)
    dt, vt = ts.block_match(torch.from_numpy(left), torch.from_numpy(right), num_disp=64, block=21)
    dj, vj, dt, vt = np.asarray(dj), np.asarray(vj), dt.numpy(), vt.numpy()
    assert (vj == vt).mean() >= 0.999
    both = vj & vt
    assert np.abs(dj[both] - dt[both]).max() <= 1e-3


def test_block_match_matches_jax_pallas():
    """Against the Pallas kernel (interpret mode), at the bounds the JAX
    package holds its own two forms to (tests/test_stereo_pallas.py): p95
    |Δd| <= 1 and masks agree on > 90%."""
    left, right = _constant(np.random.default_rng(0), 96, 256, 12)
    dp, vp = block_match_pallas(jnp.asarray(left), jnp.asarray(right), num_disp=32, block=11)
    dt, vt = stereo_kernel.block_match(
        torch.from_numpy(left), torch.from_numpy(right), num_disp=32, block=11
    )
    dp, vp, dt, vt = np.asarray(dp), np.asarray(vp), dt.numpy(), vt.numpy()
    both = vp & vt
    assert np.percentile(np.abs(dp[both] - dt[both]), 95) <= 1.0
    assert (vp == vt).mean() > 0.9


def test_batched_equals_per_image():
    rng = np.random.default_rng(2)
    pairs = [_constant(rng, 48, 96, 8 + 2 * s) for s in range(3)]
    L = torch.from_numpy(np.stack([p[0] for p in pairs]))
    R = torch.from_numpy(np.stack([p[1] for p in pairs]))
    db, vb = stereo_kernel.block_match(L, R, num_disp=16, block=7)
    for k in range(3):
        d, v = ts.block_match(L[k], R[k], num_disp=16, block=7)
        np.testing.assert_array_equal(db[k].numpy(), d.numpy())
        np.testing.assert_array_equal(vb[k].numpy(), v.numpy())


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 32, 64))
    with pytest.raises(ValueError):
        stereo_kernel.block_match_cuda(x, x, num_disp=16, block=7)


def test_disparity_to_points_matches_jax():
    rng = np.random.default_rng(3)
    disp = rng.uniform(0.2, 60.0, size=(40, 56)).astype(np.float32)
    valid = rng.random((40, 56)) > 0.3
    jr = js.RectifiedRig(
        R0=jnp.eye(3), R1=jnp.eye(3), fx=jnp.asarray(400.0), fy=jnp.asarray(410.0),
        cx=jnp.asarray(28.0), cy=jnp.asarray(20.0), baseline=jnp.asarray(0.11),
    )
    tr = ts.RectifiedRig(
        R0=np.eye(3), R1=np.eye(3), fx=400.0, fy=410.0, cx=28.0, cy=20.0, baseline=0.11
    )
    pj, oj = js.disparity_to_points(jnp.asarray(disp), jnp.asarray(valid), jr)
    pt, ot = ts.disparity_to_points(torch.from_numpy(disp), torch.from_numpy(valid), tr)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
