"""The port's training path (cerebro_tpu_torch/train/,
cerebro_tpu_torch/pretrain_synthetic.py) against the JAX package's:

- ``allpair_loss`` on random unit descriptors with repeated labels, and on
  a batch with no negatives, within 1e-6;
- the port's Adam against ``optax.adam`` over 3 updates on identical
  gradients: count exact, ``mu``, ``nu`` and params within 1e-7;
- ``value_and_grad`` of the descriptor train loss at a small f32 config
  (64x64, trunk 16, K = 4, batch 8): the loss within 1e-5 relative, each
  gradient tensor within 1e-4 of its norm (plus 1e-6 of the whole
  gradient's, for a tensor whose gradient is rounding noise); in bf16 the
  loss within 1e-3 relative, the whole gradient's cosine with JAX's at
  least 0.95 and its distance from the f32 gradient at most 1.5x JAX's
  (JAX's bf16 convolutions give bf16 cotangents; the port's CPU path
  convolves the bf16-rounded operands in f32, so the two round at
  different points, and bf16 moves this gradient by 10-40% in either);
- 3 f32 ``train_step``s from the same seeded init, each from JAX's state
  before it (``convert_train_state``): losses within 1e-4, and Adam's
  ``mu`` and ``nu`` after the step against JAX's next state, each tensor
  within 1e-4 of its norm plus 1e-6 of the whole's; the converted
  state after one step carries params, ``mu``, ``nu``, ``count`` and
  ``step`` exactly;
- ``mesh=`` at one rank gives the unsharded step's loss and state bit for
  bit (the data-parallel step across ranks: tests/test_torch_parallel.py);
- ``fractal_texture`` bit-equal to scripts/run_synthetic.py's;
- ``python -m cerebro_tpu_torch.pretrain_synthetic --cpu`` at one step
  writes an npz whose names and shapes are the shipped artifact's, which
  ``load_descriptor_params`` reads back; ``--out`` has no default, so no
  run writes into the JAX package's artifact.

The seeded parameters come from the port's ``init_flax_params`` (equal to
flax's ``net.init`` within 4 ulps, tests/test_torch_netvlad.py) and go to
both packages, so no test pays for flax's op-by-op init; each JAX
reference is computed once per module."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cerebro_tpu.config import DescriptorConfig as JDescriptorConfig
from cerebro_tpu.models.backbones import normalize_image as jnormalize
from cerebro_tpu.models.descriptor import DescriptorNet as JDescriptorNet
from cerebro_tpu.train import allpair_loss as jallpair_loss
from cerebro_tpu.train import create_train_state as jcreate_train_state
from cerebro_tpu.train import train_step as jtrain_step
from cerebro_tpu_torch import config as tcfg
from cerebro_tpu_torch import pretrain_synthetic
from cerebro_tpu_torch.models import descriptor as tdesc
from cerebro_tpu_torch.train import (
    Adam,
    allpair_loss,
    convert_train_state,
    create_train_state,
    train_step,
)
from cerebro_tpu_torch.train.trainer import apply_updates, descriptor_loss, value_and_grad

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SYNTH_NPZ = os.path.join(REPO, "artifacts", "descriptor_synth_npz")
SMALL = dict(image_hw=(64, 64), trunk_dim=16, num_clusters=4)
LABELS = np.asarray([0, 0, 1, 1, 1, 2, 2, 3], np.int32)
STEPS = 3


def _nest(flat: dict) -> dict:
    """Flat "a/b/name" arrays -> flax's nested {"params": ...} tree."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return {"params": root}


def _jnet(dtype: str) -> JDescriptorNet:
    jc = JDescriptorConfig(dtype=dtype, **SMALL)
    return JDescriptorNet(num_clusters=jc.num_clusters, trunk_dim=jc.trunk_dim,
                          num_ghost=jc.num_ghost, backbone=jc.backbone, dtype=jnp.dtype(dtype))


def _images() -> np.ndarray:
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 255, size=(8, 64, 64, 1)).astype(np.uint8)
    for i in range(1, 8):  # views of one place are near copies
        if LABELS[i] == LABELS[i - 1]:
            imgs[i] = np.clip(imgs[i - 1].astype(np.int32) + rng.integers(-8, 8, (64, 64, 1)),
                              0, 255).astype(np.uint8)
    return imgs


@pytest.fixture(scope="module")
def ref():
    flat = tdesc.init_flax_params(tcfg.DescriptorConfig(**SMALL), seed=0)
    params = _nest(flat)
    imgs = _images()
    x, y = jnp.asarray(imgs), jnp.asarray(LABELS)
    out = {"flat": flat, "imgs": imgs, "vg": {}}
    for dtype in ("float32", "bfloat16"):
        net = _jnet(dtype)

        def loss_fn(p, net=net):
            return jallpair_loss(net.apply(p, jnormalize(x)), y)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        out["vg"][dtype] = (float(loss), jax.tree.map(np.asarray, grads))

    net = _jnet("float32")
    state, tx = jcreate_train_state(params, lr=1e-3)
    states, losses = [], []
    for _ in range(STEPS):
        states.append(jax.tree.map(np.asarray, state))
        state, loss = jtrain_step(net, tx, state, x, y)
        losses.append(float(loss))
    out["states"], out["losses"] = states + [jax.tree.map(np.asarray, state)], losses
    return out


def _cfg(dtype="float32"):
    return tcfg.DescriptorConfig(dtype=dtype, **SMALL)


def _tnet(dtype="float32"):
    return tdesc._net(_cfg(dtype), "cpu")


# ---------------------------------------------------------------------------
# allpair_loss and Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("labels", [
    [0, 0, 1, 1, 1, 2, 2, 3, 3, 3, 4, 0],
    [5, 5, 5, 5, 5, 5],  # no negatives: the loss is 0
    [0, 1, 2, 3, 4, 5],  # no positives
])
def test_allpair_loss_matches_jax(labels):
    rng = np.random.default_rng(len(labels))
    d = rng.normal(size=(len(labels), 16)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lab = np.asarray(labels, np.int32)
    got = float(allpair_loss(torch.from_numpy(d), torch.from_numpy(lab)))
    want = float(jallpair_loss(jnp.asarray(d), jnp.asarray(lab)))
    assert abs(got - want) <= 1e-6
    if len(set(labels)) in (1, len(labels)):
        assert got == 0.0


def test_adam_matches_optax_on_identical_gradients():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b/c": (7,), "d": (2, 2, 3, 4)}
    # |p| < 1: one f32 ulp of a parameter is below the 1e-7 tolerance
    p = {k: rng.uniform(-1, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = optax.adam(3e-3)
    jp, jopt = {k: jnp.asarray(v) for k, v in p.items()}, tx.init({k: jnp.asarray(v) for k, v in p.items()})
    adam = Adam(3e-3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    topt = adam.init(tp)
    for g in grads:
        upd, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, topt = adam.update({k: torch.from_numpy(v) for k, v in g.items()}, topt, tp)
        tp = apply_updates(tp, tupd)
        assert int(topt.count) == int(jopt[0].count)
        assert topt.count.dtype == torch.int32
        for k in shapes:
            for got, want in ((topt.mu[k], jopt[0].mu[k]), (topt.nu[k], jopt[0].nu[k]), (tp[k], jp[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# The descriptor's train loss and step
# ---------------------------------------------------------------------------


def _port_value_and_grad(ref, dtype):
    net = _tnet(dtype)
    params = tdesc.convert_params(ref["flat"], _cfg(dtype), "cpu")
    x = torch.from_numpy(ref["imgs"])
    y = torch.from_numpy(LABELS)
    with torch.no_grad():  # the step takes its gradient whatever the caller's mode
        return value_and_grad(lambda p: descriptor_loss(net, p, x, y), params)


def _flat_grad(grads: dict) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in grads.values()])


def _close_per_tensor(got: dict, want: dict, what: str):
    """Each tensor within 1e-4 of its norm, plus 1e-6 of the whole's norm:
    the stem GroupNorm's scale has a gradient of ~5e-8, rounding noise,
    since the per-channel GroupNorm after the depthwise conv normalizes its
    effect away."""
    assert list(got) == list(want)
    floor = 1e-6 * float(_flat_grad(want).norm())
    for name, g in got.items():
        w = want[name]
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + floor, (what, name)


def test_value_and_grad_f32_matches_jax(ref):
    """Loss within 1e-5 relative; each gradient tensor within 1e-4 of its
    norm, plus 1e-6 of the whole gradient's norm."""
    loss, grads = _port_value_and_grad(ref, "float32")
    want_loss, want_grads = ref["vg"]["float32"]
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    _close_per_tensor(grads, tdesc.convert_params(want_grads, _cfg(), "cpu"), "grad")


def test_value_and_grad_bf16_matches_jax(ref):
    """bf16: the loss within 1e-3 relative. The gradient of this loss on an
    untrained net lives in small differences between nearly equal
    descriptors, so bf16 rounding moves it by 10-40% per tensor in either
    package (JAX's bf16 convolutions give bf16 cotangents; the port's CPU
    path convolves bf16-rounded operands in f32). Held: the whole gradient's
    cosine with JAX's at least 0.95, and its distance from the f32 gradient
    at most 1.5x that of JAX's bf16 gradient."""
    loss, grads = _port_value_and_grad(ref, "bfloat16")
    want_loss, want_grads = ref["vg"]["bfloat16"]
    assert abs(float(loss) - want_loss) <= 1e-3 * abs(want_loss)
    g = _flat_grad(grads)
    j = _flat_grad(tdesc.convert_params(want_grads, _cfg("bfloat16"), "cpu"))
    f = _flat_grad(tdesc.convert_params(ref["vg"]["float32"][1], _cfg(), "cpu"))
    cos = float(g @ j / (g.norm() * j.norm()))
    assert cos >= 0.95, cos
    assert float((g - f).norm()) <= 1.5 * float((j - f).norm()), (float((g - f).norm()), float((j - f).norm()))


def test_train_steps_match_jax(ref):
    """Each of 3 f32 steps from JAX's state before it: the loss within 1e-4
    and the step count advanced. (A chain of the port's own steps would
    compare parameters after steps of independently computed gradients:
    Adam's first step is nearly -lr * sign(g), and an entry near 0 can flip
    its sign between the packages.) Adam's moments after each step against
    JAX's next state: the step's gradient as it reaches the update (``mu``
    is 0.1 g after the first step)."""
    net = _tnet()
    x, y = torch.from_numpy(ref["imgs"]), torch.from_numpy(LABELS)
    tx = Adam(1e-3)
    for i, want in enumerate(ref["losses"]):
        state = convert_train_state(ref["states"][i], _cfg(), "cpu")
        state, loss = train_step(net, tx, state, x, y)
        assert abs(float(loss) - want) <= 1e-4, (i, float(loss), want)
        assert int(state.step) == i + 1 and int(state.opt_state.count) == i + 1
        after = convert_train_state(ref["states"][i + 1], _cfg(), "cpu").opt_state
        _close_per_tensor(state.opt_state.mu, after.mu, f"mu after step {i + 1}")
        _close_per_tensor(state.opt_state.nu, after.nu, f"nu after step {i + 1}")


def test_create_train_state_starts_at_zero(ref):
    params = tdesc.convert_params(ref["flat"], _cfg(), "cpu")
    state, tx = create_train_state(params, lr=5e-4)
    assert tx.lr == 5e-4
    assert int(state.step) == 0 and int(state.opt_state.count) == 0
    assert state.step.dtype == state.opt_state.count.dtype == torch.int32
    assert list(state.opt_state.mu) == list(params)
    assert all(float(v.abs().max()) == 0.0 for v in state.opt_state.nu.values())


def test_convert_train_state_carries_jax_state_exactly(ref):
    jstate = ref["states"][1]  # after one step
    state = convert_train_state(jstate, _cfg(), "cpu")
    assert int(state.step) == int(jstate.step) == 1
    assert int(state.opt_state.count) == int(jstate.opt_state[0].count) == 1
    for got, want in ((state.params, jstate.params), (state.opt_state.mu, jstate.opt_state[0].mu),
                      (state.opt_state.nu, jstate.opt_state[0].nu)):
        want = tdesc.convert_params(want, _cfg(), "cpu")
        assert list(got) == list(want)
        for name in got:
            assert torch.equal(got[name], want[name]), name


def test_mesh_raises_naming_the_roadmap_item(ref):
    """``mesh=`` runs (the name is kept from when it raised): the
    data-parallel step at one rank gives the unsharded step's loss and
    state, and a batch that does not divide over the ranks raises."""
    from test_torch_parallel import one_rank_mesh

    params = tdesc.convert_params(ref["flat"], _cfg(), "cpu")
    x, y = torch.from_numpy(ref["imgs"]), torch.from_numpy(LABELS)
    state, tx = create_train_state(params)
    plain, loss = train_step(_tnet(), tx, state, x, y)
    with one_rank_mesh() as mesh:
        sharded, loss_mesh = train_step(_tnet(), tx, state, x, y, mesh=mesh)
        assert mesh.shape == {"db": 1}
    assert torch.equal(loss_mesh, loss)
    for got, want in ((sharded.params, plain.params), (sharded.opt_state.mu, plain.opt_state.mu)):
        for name in want:
            assert torch.equal(got[name], want[name]), name


def test_data_parallel_batch_must_divide():
    from cerebro_tpu_torch.parallel.mesh import Mesh
    from cerebro_tpu_torch.train.trainer import _data_parallel_grads

    mesh = Mesh(("db",), (3,), (None,), (0,), torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        _data_parallel_grads(_tnet(), {}, torch.zeros((8, 64, 64, 1), dtype=torch.uint8),
                             torch.from_numpy(LABELS), mesh, "db")


# ---------------------------------------------------------------------------
# python -m cerebro_tpu_torch.pretrain_synthetic
# ---------------------------------------------------------------------------


def test_export_params_inverts_convert_params():
    """The npz arrays written from a PyTorch state are the flax arrays it
    was converted from, bit for bit (the synth artifact's)."""
    cfg = tcfg.DescriptorConfig(image_hw=(240, 320), trunk_dim=64, num_clusters=4)
    with np.load(os.path.join(SYNTH_NPZ, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    back = tdesc.export_params(tdesc.convert_params(flat, cfg, "cpu"), cfg)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(back[k], v)


def test_fractal_texture_bit_equal_to_run_synthetic():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from run_synthetic import fractal_texture
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    for seed in (3, 8):
        got = pretrain_synthetic.fractal_texture(np.random.default_rng(seed), n=256)
        want = fractal_texture(np.random.default_rng(seed), n=256)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_pretrain_synthetic_writes_a_loadable_npz(tmp_path, capsys):
    out = tmp_path / "synth"
    summary = pretrain_synthetic.main(["--cpu", "--steps", "1", "--places", "2", "--views", "2",
                                       "--batch-places", "2", "--out", str(out)])
    assert "step 0: loss" in capsys.readouterr().out
    assert summary["steps"] == 1 and len(summary["losses"]) == 1 and summary["images"] == 4
    assert np.isfinite(summary["losses"][0]) and len(summary["step_ms"]) == 1
    with np.load(out / "params.npz") as got, np.load(os.path.join(SYNTH_NPZ, "params.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
    with open(out / "meta.json") as fh:
        meta = json.load(fh)
    with open(os.path.join(SYNTH_NPZ, "meta.json")) as fh:
        assert meta["config"] == json.load(fh)["config"]
    assert meta["steps"] == 1 and meta["places"] == 2
    assert meta["same_place_sim"] == summary["same_place_sim"]
    cfg = tcfg.DescriptorConfig(image_hw=(240, 320), trunk_dim=64, num_clusters=4)
    net, params = tdesc.load_descriptor_params(str(out), cfg, device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 240, 320, 1), dtype=np.uint8))
    d = tdesc.describe_batch(net, params, imgs)
    assert d.shape == (2, 256) and torch.allclose(d.norm(dim=1), torch.ones(2), atol=1e-4)


def test_pretrain_synthetic_out_has_no_default(capsys):
    """The JAX script writes to artifacts/descriptor_synth, the reference's
    own artifact; the port's entry point takes no default directory."""
    with pytest.raises(SystemExit):
        pretrain_synthetic.parse_args(["--cpu", "--steps", "1"])
    assert "--out" in capsys.readouterr().err


def test_pretrain_synthetic_needs_cuda_or_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        pretrain_synthetic.main(["--steps", "1", "--out", str(tmp_path)])
