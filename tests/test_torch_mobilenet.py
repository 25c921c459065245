"""Ported MobileNetV1-conv_pw_7 + NetVLAD descriptor: the port's
convert_params + ported_forward against the JAX ported_forward, on both
bundled artifacts (raw and m1to1 input scales)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.models import mobilenet as jm
from cerebro_tpu_torch.models import mobilenet as tm

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts")

# f32: the same arithmetic in another summation order -> cosine >= 0.99999.
# bf16: both round the same inputs to bf16 and multiply and accumulate in
# f32 (XLA's preferred_element_type=f32), so only the summation order
# differs, as at f32, until a bf16 rounding of a layer input flips -> the
# same bound.
TOL = {"float32": 0.99999, "bfloat16": 0.99999}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("artifact", ["descriptor_ported", "descriptor_ported_conv6_m1to1"])
def test_ported_forward_matches_jax(artifact, dtype):
    pj, meta = jm.load_ported_params(os.path.join(ART, artifact))
    pt, meta_t = tm.load_ported_params(os.path.join(ART, artifact), device="cpu")
    assert meta_t == meta
    x = np.random.default_rng(5).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    ref = np.asarray(
        jm.ported_forward(pj, jnp.asarray(x), dtype=getattr(jnp, dtype),
                          input_scale=meta["input_scale"]),
        np.float32,
    )
    got = tm.ported_forward(
        pt, torch.from_numpy(x), dtype=getattr(torch, dtype), input_scale=meta["input_scale"]
    ).numpy()
    assert got.shape == (2, meta["descriptor_dim"])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    cos = (ref * got).sum(-1)
    assert cos.min() >= TOL[dtype], cos


def test_gray_input_adapts_like_reference():
    pj, _ = jm.load_ported_params(os.path.join(ART, "descriptor_ported"))
    pt, _ = tm.load_ported_params(os.path.join(ART, "descriptor_ported"), device="cpu")
    assert [i for i, _ in tm.v1_blocks_in(pt)] == [i for i, _ in jm.v1_blocks_in(pj)]
    g = np.random.default_rng(6).integers(0, 256, (1, 48, 64, 1), dtype=np.uint8)
    ref = np.asarray(jm.ported_forward(pj, jnp.asarray(g), dtype=jnp.float32))
    got = tm.ported_forward(pt, torch.from_numpy(g), dtype=torch.float32).numpy()
    assert float((ref * got).sum()) >= TOL["float32"]


def test_convert_params_layouts():
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)  # HWIO
    dw = rng.normal(size=(3, 3, 1, 8)).astype(np.float32)  # depthwise HWIO
    out = tm.convert_params({"a/kernel": conv, "b/kernel": dw, "a/bias": np.ones(8, np.float32)},
                            device="cpu")
    assert tuple(out["a/kernel"].shape) == (8, 4, 3, 3)
    assert tuple(out["b/kernel"].shape) == (8, 1, 3, 3)
    np.testing.assert_array_equal(out["a/kernel"][5, 2, 1, 0].item(), conv[1, 0, 2, 5])
    np.testing.assert_array_equal(out["b/kernel"][7, 0, 2, 1].item(), dw[2, 1, 0, 7])
    assert tuple(out["a/bias"].shape) == (8,)
