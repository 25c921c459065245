"""The gather matcher (tier 2 of the verification cascade) and the random
projection it draws: the port against the JAX package.

Inputs are tests/test_verify.py's rendered two-plane scene, 2x2-averaged to
120x160, with max_kp <= 256. Tolerances:

- jaxrand: bits equal to jax.random.bits; normals within 3e-5;
- harris_corners_pyramid: xy, valid and lvl identical;
- orientations within 1e-4 rad (mod 2 pi);
- oriented patches within 1e-5; patch_descriptors within 1e-4;
- match_image_pair (single-scale plain, single-scale oriented, the default
  scale banks): match count within 2% of JAX's, and >= 98% of JAX's matches
  present in the port's, compared by coordinates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.geometry import se3 as jse3
from cerebro_tpu.ops import features as jfeat
from cerebro_tpu_torch.ops import features as tfeat
from cerebro_tpu_torch.utils import jaxrand

from test_verify import big_texture, stereo_pair


@pytest.mark.parametrize("seed,shape", [(42, (256, 128)), (7, (600, 64))], ids=["patch", "gist"])
def test_jaxrand_matches_jax_random(seed, shape):
    key = jax.random.PRNGKey(seed)
    want_bits = np.asarray(jax.random.bits(key, shape))
    got_bits = jaxrand.bits(jaxrand.prng_key(seed), shape)
    assert got_bits.dtype == np.uint32
    np.testing.assert_array_equal(got_bits, want_bits)
    want = np.asarray(jax.random.normal(key, shape))
    got = jaxrand.normal(jaxrand.prng_key(seed), shape)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def test_jaxrand_rejects_seeds_beyond_32_bits():
    with pytest.raises(ValueError):
        jaxrand.prng_key(2**32)


def _half(img):
    return img.reshape(img.shape[0] // 2, 2, img.shape[1] // 2, 2).mean(axis=(1, 3))


@pytest.fixture(scope="module")
def pairs():
    """120x160 left images: a revisit with yaw (b), an approach to 1.54x
    the scale (z), an unrelated scene (c)."""
    tex = big_texture(np.random.default_rng(0))
    Ta = np.eye(4, dtype=np.float32)
    Tb = np.asarray(
        jse3.make_pose(jse3.ypr_to_rot(jnp.asarray([np.deg2rad(4.0), 0.0, 0.0], jnp.float32)),
                       jnp.asarray([0.25, 0.1, 0.15]))
    ).astype(np.float32)
    Tz = np.eye(4, dtype=np.float32)
    Tz[2, 3] = 1.4
    left = lambda t, T: _half(np.asarray(stereo_pair(t, T)[0], np.float32)).astype(np.float32)
    return {"a": left(tex, Ta), "b": left(tex, Tb), "z": left(tex, Tz),
            "c": left(big_texture(np.random.default_rng(999)), Ta)}


def _stack(img, octaves=3, blur=5):
    """The multi-octave path's (L, H, W) smoothing stack, from JAX."""
    return np.stack([
        np.asarray(jfeat._box_filter(jnp.asarray(img), (blur << l) | 1)) / float(((blur << l) | 1) ** 2)
        for l in range(octaves)
    ]).astype(np.float32)


@pytest.mark.parametrize("max_kp,border", [(256, 16), (128, 8)])
def test_harris_pyramid_identical(pairs, max_kp, border):
    for name in ("a", "z"):
        img = pairs[name]
        kj, lj = jfeat.harris_corners_pyramid(jnp.asarray(img), max_kp=max_kp, border=border)
        kt, lt = tfeat.harris_corners_pyramid(torch.from_numpy(img), max_kp=max_kp, border=border)
        np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
        np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        assert int(kt.valid.sum()) >= 64


def test_stack_filters_match_jax(pairs):
    img = pairs["a"]
    got = torch.stack([
        tfeat._box_filter(torch.from_numpy(img), (5 << l) | 1) / float(((5 << l) | 1) ** 2)
        for l in range(3)
    ])
    np.testing.assert_allclose(got.numpy(), _stack(img), atol=1e-5, rtol=0)


def _keypoints(img, max_kp=256):
    kj, lj = jfeat.harris_corners_pyramid(jnp.asarray(img), max_kp=max_kp)
    kt = tfeat.Keypoints(
        xy=torch.from_numpy(np.array(kj.xy)), score=torch.from_numpy(np.array(kj.score)),
        valid=torch.from_numpy(np.array(kj.valid)),
    )
    return kj, jnp.asarray(lj), kt, torch.from_numpy(np.array(lj))


def _angle_err(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.arctan2(np.sin(d), np.cos(d)))


def test_orientations_within_1e4(pairs):
    img = pairs["a"]
    kj, lj, kt, lt = _keypoints(img)
    # the plain path: integer patches of the image
    want = jfeat.keypoint_orientations(jnp.asarray(img), kj.xy)
    got = tfeat.keypoint_orientations(torch.from_numpy(img), kt.xy)
    assert _angle_err(got.numpy(), want).max() < 1e-4
    # the stack path: per-keypoint spacing and level
    stack = _stack(img)
    sc_j = 2.0 ** lj.astype(jnp.float32)
    want = jfeat.keypoint_orientations(jnp.asarray(stack), kj.xy, scale=sc_j, lvl=lj)
    got = tfeat.keypoint_orientations(
        torch.from_numpy(stack), kt.xy, scale=2.0 ** lt.float(), lvl=lt
    )
    assert _angle_err(got.numpy(), want).max() < 1e-4


def test_oriented_patches_within_1e5(pairs):
    img = pairs["b"]
    kj, lj, kt, lt = _keypoints(img)
    theta = np.random.default_rng(3).uniform(-np.pi, np.pi, kj.xy.shape[0]).astype(np.float32)
    want = jfeat._extract_oriented_patches(jnp.asarray(img), kj.xy, jnp.asarray(theta), 16)
    got = tfeat._extract_oriented_patches(torch.from_numpy(img), kt.xy, torch.from_numpy(theta), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    stack = _stack(img)
    sc = (2.0 * 1.41421356 * 2.0 ** np.asarray(lj)).astype(np.float32)
    want = jfeat._extract_oriented_patches(
        jnp.asarray(stack), kj.xy, jnp.asarray(theta), 16, scale=jnp.asarray(sc), lvl=lj
    )
    got = tfeat._extract_oriented_patches(
        torch.from_numpy(stack), kt.xy, torch.from_numpy(theta), 16,
        scale=torch.from_numpy(sc), lvl=lt,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # keypoints at the image's edges clamp the same way
    edge = np.array([[0.0, 0.0], [159.0, 119.0], [159.4, 3.2]], np.float32)
    want = jfeat._extract_patches(jnp.asarray(img), jnp.asarray(edge), 16)
    got = tfeat._extract_patches(torch.from_numpy(img), torch.from_numpy(edge), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_patch_descriptors_within_1e4(pairs):
    img = pairs["a"]
    kj, lj, kt, lt = _keypoints(img)
    ji, ti = jnp.asarray(img), torch.from_numpy(img)
    for kw in ({}, {"oriented": True}):
        want = jfeat.patch_descriptors(ji, kj, **kw)
        got = tfeat.patch_descriptors(ti, kt, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    stack = _stack(img)
    theta = np.random.default_rng(4).uniform(-np.pi, np.pi, kj.xy.shape[0]).astype(np.float32)
    sc = (2.0 * 0.70710678 * 2.0 ** np.asarray(lj)).astype(np.float32)
    want = jfeat.patch_descriptors(
        jnp.asarray(stack), kj, oriented=True, theta=jnp.asarray(theta), scale=jnp.asarray(sc), lvl=lj
    )
    got = tfeat.patch_descriptors(
        torch.from_numpy(stack), kt, oriented=True, theta=torch.from_numpy(theta),
        scale=torch.from_numpy(sc), lvl=lt,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    norms = torch.linalg.vector_norm(got, dim=-1)
    assert bool(((norms - 1).abs() < 1e-4).all())


@pytest.mark.parametrize("banks,tol", [(False, 0.0), (True, 0.0), (True, 4.0)],
                         ids=["single", "banks", "banks_spatial"])
def test_mutual_nn_match_identical(pairs, banks, tol):
    """The same descriptors into both: the same matches, slot for slot."""
    kaj, _, kat, _ = _keypoints(pairs["a"])
    kbj, _, kbt, _ = _keypoints(pairs["b"])
    da = np.array(jfeat.patch_descriptors(jnp.asarray(pairs["a"]), kaj))
    db = np.array(jfeat.patch_descriptors(jnp.asarray(pairs["b"]), kbj))
    if banks:
        db = np.stack([db, np.roll(db, 1, axis=0), db[::-1]])
    want = jfeat.mutual_nn_match(jnp.asarray(da), jnp.asarray(db), kaj, kbj, spatial_tol=tol)
    got = tfeat.mutual_nn_match(torch.from_numpy(da), torch.from_numpy(db), kat, kbt, spatial_tol=tol)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.idx_b.numpy()[v], np.asarray(want.idx_b)[v])
    assert v.sum() > 20


def _match_set(m):
    v = np.asarray(m.valid)
    return {tuple(r) for r in np.concatenate([np.asarray(m.xy_a), np.asarray(m.xy_b)], -1)[v].tolist()}


@pytest.mark.parametrize(
    "kw,pair",
    [
        ({}, "b"),
        ({"oriented": True}, "b"),
        ({"oriented": True, "scales": (0.5, 0.70710678, 1.0, 1.41421356)}, "z"),
    ],
    ids=["single_plain", "single_oriented", "scale_banks"],
)
def test_match_image_pair_matches_jax(pairs, kw, pair):
    a, b = pairs["a"], pairs[pair]
    common = dict(max_kp=256, gms_factor=4.0, **kw)
    mj = jfeat.match_image_pair(jnp.asarray(a), jnp.asarray(b), **common)
    mt = tfeat.match_image_pair(torch.from_numpy(a), torch.from_numpy(b), **common)
    nj, nt = int(mj.count()), int(mt.count())
    assert nj >= 20, nj
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)
    sj, st = _match_set(mj), _match_set(mt)
    assert len(sj & st) >= 0.98 * len(sj), (len(sj & st), len(sj))
    # the unrelated scene keeps few matches on both sides
    mc = tfeat.match_image_pair(torch.from_numpy(a), torch.from_numpy(pairs["c"]), **common)
    mcj = jfeat.match_image_pair(jnp.asarray(a), jnp.asarray(pairs["c"]), **common)
    assert abs(int(mc.count()) - int(mcj.count())) <= max(2, 0.02 * int(mcj.count()))
