"""The port's in-framework descriptor net (cerebro_tpu_torch/models/
backbones.py, netvlad.py, descriptor.py) and the random draws behind its
seeded initialization (utils/jaxrand.py) against the JAX package's.

- ``fold_in``, ``uniform`` and flax's static path folding bit for bit;
  ``truncated_normal`` within 4 ulps (XLA contracts parts of its log1p and
  erfinv polynomial into FMAs; measured at most 3);
- XLA's SAME padding: (0, 1) at even stride-2 inputs, (1, 1) at odd ones;
- ``create_descriptor_model(cfg, seed)``'s parameters equal flax's
  ``net.init`` to 1e-6 relative (mobile, vgg16, ghost, and the default
  config);
- ``DescriptorNet`` through ``convert_params`` of JAX's parameters at
  (48, 64) and at (40, 56), whose stride-2 inputs go odd: float32 within
  1e-4 on unit descriptors, bfloat16 to a per-descriptor cosine of 0.999
  (measured above 0.9999); GhostVLAD's ghost mass within 1e-4;
- the trained synth weights: the npz equal to the orbax checkpoint, and
  ``describe_batch`` on it against JAX's on the checkpoint;
- ``CerebroPipeline()`` at the default config builds on the CPU with
  JAX's seeded parameters, and takes flax-shaped ``params``."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.config import DescriptorConfig as JDescriptorConfig
from cerebro_tpu.models import descriptor as jdesc
from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch.models import descriptor as tdesc
from cerebro_tpu_torch.models.backbones import same_pads
from cerebro_tpu_torch.utils import jaxrand

from test_pipeline import scene  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SYNTH = os.path.join(REPO, "artifacts", "descriptor_synth")
SYNTH_NPZ = os.path.join(REPO, "artifacts", "descriptor_synth_npz")

VARIANTS = {
    "mobile": {},
    "vgg16": {"backbone": "vgg16"},
    "ghost": {"num_ghost": 2},
}


def _key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key), np.uint32)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_fold_in_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 7, 123456789, 2**32 - 1):
        got = np.asarray(jaxrand.fold_in(jaxrand.prng_key(seed), data), np.uint32)
        np.testing.assert_array_equal(got, _key_words(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 2.0), (-0.9544997, 0.9544997)])
def test_uniform_matches_jax(lo, hi):
    for seed in (0, 11):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (37, 41), minval=lo, maxval=hi))
        np.testing.assert_array_equal(jaxrand.uniform(jaxrand.prng_key(seed), (37, 41), lo, hi), want)


@pytest.mark.parametrize("shape", [(3, 3, 1, 32), (1, 1, 128, 256), (256, 18)])
def test_truncated_normal_matches_jax(shape):
    for seed in (0, 5):
        want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2.0, 2.0, shape))
        got = jaxrand.truncated_normal(jaxrand.prng_key(seed), -2.0, 2.0, shape)
        assert got.dtype == np.float32 and got.shape == shape
        ulps = np.abs(got - want) / np.spacing(np.abs(want))
        assert ulps.max() <= 4, ulps.max()
        assert (np.abs(got) < 2.0).all()


def test_fold_in_static_matches_flax():
    from flax.core.scope import _fold_in_static

    key = jax.random.PRNGKey(9)
    for data in [("MobileTrunk_0", "Conv_0", 1), ("NetVLAD_0", 3), ("a", 255, "b", 256), ()]:
        got = np.asarray(jaxrand.fold_in_static(jaxrand.prng_key(9), data), np.uint32)
        np.testing.assert_array_equal(got, _key_words(_fold_in_static(key, data)))


@pytest.mark.parametrize("size", [240, 120, 60, 30, 15, 5, 4, 3])
@pytest.mark.parametrize("k,stride", [(3, 2), (3, 1), (1, 1)])
def test_same_pads_match_xla(size, k, stride):
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert same_pads(size, k, stride) == tuple(want)


def _configs(hw, variant, dtype="float32"):
    kw = dict(image_hw=hw, trunk_dim=32, num_clusters=4, dtype=dtype, **VARIANTS[variant])
    return JDescriptorConfig(**kw), tcfg.DescriptorConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_model(hw, variant, dtype="float32", seed=1):
    """(flax net, params) of a test config; the params do not depend on the
    dtype, so each (hw, variant) is initialized once (flax's init runs the
    net op by op, seconds each)."""
    jc, _ = _configs(hw, variant, dtype)
    if dtype != "float32":
        _, params = _jax_model(hw, variant, seed=seed)
        return jdesc.DescriptorNet(
            num_clusters=jc.num_clusters, trunk_dim=jc.trunk_dim, num_ghost=jc.num_ghost,
            backbone=jc.backbone, dtype=jnp.dtype(dtype),
        ), params
    return jdesc.create_descriptor_model(jc, seed=seed)


def _flat(params) -> dict:
    return {
        "/".join(p.key for p in path[1:]): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _assert_params_close(want: dict, got: dict):
    assert set(got) == set(want)
    for k in want:
        scale = np.maximum(np.abs(want[k]), 1e-30)
        rel = np.max(np.abs(got[k] - want[k]) / scale)
        assert rel <= 1e-6, (k, rel)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_seeded_params_match_flax(variant):
    _, tc = _configs((48, 64), variant)
    _, jparams = _jax_model((48, 64), variant)
    _assert_params_close(_flat(jparams), tdesc.init_flax_params(tc, seed=1))
    net, state = tdesc.create_descriptor_model(tc, seed=1, device="cpu")
    want = tdesc.convert_params(jax.tree.map(np.asarray, jparams), tc, "cpu")
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=0)
        assert torch.equal(state[k], v)


@functools.lru_cache(maxsize=None)
def _jax_default():
    return jdesc.create_descriptor_model(JDescriptorConfig(), seed=0)


def test_default_config_params_match_flax():
    """The default net (mobile, 16 x 256 = 4,096-d, 240x320 gray)."""
    _, jparams = _jax_default()
    _assert_params_close(_flat(jparams), tdesc.init_flax_params(tcfg.DescriptorConfig(), seed=0))


def _images(hw, n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 1), dtype=np.uint8)


def _describe_both(net, tc, jparams, imgs):
    want = np.asarray(jdesc.describe_batch(net, jparams, jnp.asarray(imgs)))
    tnet = tdesc._net(tc, "cpu")
    state = tdesc.convert_params(jax.tree.map(np.asarray, jparams), tc, "cpu")
    got = tdesc.describe_batch(tnet, state, torch.from_numpy(imgs)).numpy()
    return want, got


@pytest.mark.parametrize("hw", [(48, 64), (40, 56)])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_describe_matches_jax(hw, variant, dtype):
    _, tc = _configs(hw, variant, dtype)
    net, jparams = _jax_model(hw, variant, dtype)
    want, got = _describe_both(net, tc, jparams, _images(hw))
    assert got.shape == want.shape == (3, 4 * 32) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        cos = (got * want).sum(axis=1)
        assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("hw", [(48, 64), (40, 56)])
def test_ghost_mass_matches_jax(hw):
    _, tc = _configs(hw, "ghost")
    net, jparams = _jax_model(hw, "ghost")
    imgs = _images(hw, seed=4)
    from cerebro_tpu.models.backbones import normalize_image

    jv, inter = net.apply(jparams, normalize_image(jnp.asarray(imgs)), mutable=["intermediates"])
    jmass = np.asarray(jax.tree.leaves(inter["intermediates"])[0])
    tnet = tdesc._net(tc, "cpu")
    tnet.load_state_dict(tdesc.convert_params(jax.tree.map(np.asarray, jparams), tc, "cpu"))
    with torch.no_grad():
        tv, tmass = tnet(torch.from_numpy(imgs), return_ghost_mass=True)
    assert tmass.shape == jmass.shape == (3, -(-hw[0] // 16) * -(-hw[1] // 16))
    np.testing.assert_allclose(tmass.numpy(), jmass, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)


def test_convert_params_rejects_another_net():
    _, jparams = _jax_model((48, 64), "mobile")
    _, wider = _configs((48, 64), "ghost")
    with pytest.raises(ValueError, match="do not fit"):
        tdesc.convert_params(jax.tree.map(np.asarray, jparams), wider, "cpu")
    narrow = dataclasses.replace(wider, num_ghost=0, trunk_dim=16)
    with pytest.raises(ValueError):
        tdesc.convert_params(jax.tree.map(np.asarray, jparams), narrow, "cpu")


def _synth_configs(dtype="bfloat16"):
    kw = dict(image_hw=(240, 320), trunk_dim=64, num_clusters=4, dtype=dtype)
    return JDescriptorConfig(**kw), tcfg.DescriptorConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_synth(dtype="bfloat16"):
    """The JAX package's trained synth net (orbax restore), once per dtype."""
    return jdesc.load_descriptor_params(SYNTH, _synth_configs(dtype)[0])


def test_synth_npz_equals_checkpoint():
    """scripts/export_descriptor_synth.py's npz holds every array of the
    orbax checkpoint, bit for bit, and its meta.json."""
    _, jparams = _jax_synth()
    want = _flat(jparams)
    with np.load(os.path.join(SYNTH_NPZ, "params.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(want) and len(got) == 42
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(os.path.join(SYNTH, "meta.json")) as a, open(os.path.join(SYNTH_NPZ, "meta.json")) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synth_describe_matches_jax(scene, dtype):  # noqa: F811
    """The trained net on the test scene's frames: the port on the npz
    against JAX on the checkpoint (float32 within 1e-4, bfloat16 to a
    cosine of 0.999)."""
    _, tc = _synth_configs(dtype)
    net, jparams = _jax_synth(dtype)
    imgs = np.stack([scene[i][0] for i in (0, 5, 9, 13)])[..., None]
    want = np.asarray(jdesc.describe_batch(net, jparams, jnp.asarray(imgs)))
    tnet, state = tdesc.load_descriptor_params(SYNTH_NPZ, tc, device="cpu")
    got = tdesc.describe_batch(tnet, state, torch.from_numpy(imgs)).numpy()
    assert got.shape == (4, 256)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert ((got * want).sum(axis=1)).min() >= 0.999


def test_default_pipeline_builds_with_jax_params():
    """CerebroPipeline() at the default config builds on the CPU: the
    seeded 4,096-d net with flax's parameters, a 29,184-row DB; its
    describe_fn agrees with JAX's describe_batch on those parameters (bf16,
    cosine 0.999); flax-shaped numpy params given as ``params=`` replace
    the seeded ones."""
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    tp = CerebroPipeline(device="cpu")
    assert tp.cfg == tcfg.CerebroConfig() and tp.cfg.descriptor.kind == "netvlad"
    assert tp.db.dim == 4096 and tp.db.capacity == 29184
    jnet, jparams = _jax_default()
    want = tdesc.convert_params(jax.tree.map(np.asarray, jparams), tp.cfg.descriptor, "cpu")
    for k, v in tp.params.items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=0)
    imgs = _images((240, 320), n=8, seed=3)
    jd = np.asarray(jdesc.describe_batch(jnet, jparams, jnp.asarray(imgs)))
    td = tp.describe_fn(torch.from_numpy(imgs)).numpy()
    assert td.shape == (8, 4096)
    assert ((jd * td).sum(axis=1)).min() >= 0.999
    tp.close()

    small = tcfg.CerebroConfig(loop=tcfg.LoopConfig(db_capacity=64))
    other = jax.tree.map(np.asarray, jdesc.create_descriptor_model(JDescriptorConfig(), seed=4)[1])
    tq = CerebroPipeline(small, params=other, device="cpu")
    want = tdesc.convert_params(other, tq.cfg.descriptor, "cpu")
    assert all(torch.equal(tq.params[k], want[k]) for k in want)
    tq.close()
