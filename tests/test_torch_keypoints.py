"""The port's SuperPoint-class keypoint model
(cerebro_tpu_torch/models/keypoints.py) against the JAX package's, at
desc_dim 16, width 8 and 64x64 images:

- the seeded init equal to flax's ``net.init`` for 2 seeds, within the 4
  ulps tests/test_torch_netvlad.py allows ``truncated_normal`` (XLA
  contracts parts of its log1p and erfinv into FMAs; the draw's 3 ulps
  can round to 4 once scaled by the stddev), and ``convert_params`` of
  JAX's params;
- the f32 forward (JAX's ``KeypointNet(dtype=float32)``) within 1e-5; the
  bf16 forward's logits within 0.0625 and its descriptors to a per-cell
  cosine of 0.998 (each conv's bf16 result rounds at 2^-8 relative, and the
  sums run in another order);
- ``heatmap_from_logits``: the 65 -> 8x8 layout exact (one-hot cells: the
  softmax is exact), softmax values within 2e-7 (XLA's exp and PyTorch's
  differ in the last bit);
- ``detect_keypoints`` in f32 with max_kp above the number of maxima:
  ``xy`` and ``valid`` exact, the -inf tail's index order included; scores
  within 1e-6, descriptors within 1e-5; ``match_image_pair_learned``'s
  ``idx_b`` and ``valid`` equal;
- ``synthetic_corner_batch`` bit-equal for 2 seeds;
- both losses within 1e-6; ``value_and_grad`` of the train loss in f32 (both
  views, the detector and the 0.3-weighted InfoNCE terms): loss, det and desc
  within 1e-5 relative, each gradient tensor within 1e-4 of its norm plus
  1e-6 of the whole gradient's; ``train_step`` in f32 on 2 steps, each from
  JAX's state before it: loss, det and desc within 1e-4, and Adam's ``mu``
  and ``nu`` after the step against JAX's next state at the gradient's
  tolerance (the gradient as it passes through the step: ``mu`` is 0.1 g
  after the first).

Each JAX reference is computed once per module (compiling them is most of
the cost); no test trains for long (convergence is checked on the card by
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.models import keypoints as jkp
from cerebro_tpu_torch.models import keypoints as tkp

DESC, WIDTH = 16, 8
SEEDS = (0, 1)
# bf16: 4 bf16 ulps at the logits' scale (2 to 4), and a per-cell cosine of
# the unit descriptors (measured 0.039 and 0.9995)
BF16_LOGIT_ATOL, BF16_DESC_COS = 0.0625, 0.998


def _flat(params) -> dict:
    return {
        "/".join(p.key for p in path[1:]): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _scene(seed: int, hw: int = 64) -> np.ndarray:
    """A (hw, hw) f32 image of four distinct quads on a flat ground."""
    rng = np.random.default_rng(seed)
    img = np.full((hw, hw), 0.15, np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for qi, (cx0, cy0) in enumerate([(20, 20), (44, 22), (22, 44), (44, 44)]):
        ang = np.sort(rng.uniform(0, 2 * np.pi, size=4))
        rad = rng.uniform(5, 9, size=4)
        pts = np.stack([cx0 + rad * np.cos(ang), cy0 + rad * np.sin(ang)], -1)
        inside = np.ones((hw, hw), bool)
        for i in range(4):
            p, q = pts[i], pts[(i + 1) % 4]
            inside &= (xx - p[0]) * (q[1] - p[1]) - (yy - p[1]) * (q[0] - p[0]) <= 0
        img = np.where(inside, 0.45 + 0.13 * qi, img)
    img = img + rng.normal(0, 0.01, img.shape).astype(np.float32)
    return img.clip(0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """Everything the tests compare against, from the JAX package."""
    net16 = jkp.KeypointNet(desc_dim=DESC, width=WIDTH)
    net32 = jkp.KeypointNet(desc_dim=DESC, width=WIDTH, dtype=jnp.float32)
    # create_keypoint_model's net.init, jitted: flax runs it op by op
    # otherwise, ~25 s on one core (the values are the same bits)
    init = jax.jit(net16.init)
    zeros = jnp.zeros((1, 64, 64, 1), jnp.float32)
    out = {"init": {s: init(jax.random.PRNGKey(s), zeros) for s in SEEDS}}
    params = out["init"][1]
    # one batch (B = 2) for the forward, the losses and the train step, so
    # each jitted function compiles once
    imgs, labels = jkp.synthetic_corner_batch(np.random.default_rng(3), 2)
    out["batch"] = (imgs, labels)
    fwd32 = jax.jit(net32.apply)
    # the forward on noise in [-1, 1] (on the flat synthetic images flax's
    # fast variance cancels in small groups, and the two packages' sums in
    # another order differ there by up to 3e-5)
    x = np.random.default_rng(5).uniform(-1, 1, imgs.shape).astype(np.float32)
    out["x"] = x
    out["fwd32"] = [np.asarray(a) for a in fwd32(params, jnp.asarray(x))]
    out["fwd16"] = [np.asarray(a) for a in jax.jit(net16.apply)(params, jnp.asarray(x))]
    logits, da = fwd32(params, jnp.asarray(imgs * 2.0 - 1.0))
    _, db = fwd32(params, jnp.asarray(np.clip(imgs * 1.1 + 0.05, 0, 1) * 2.0 - 1.0))
    out["det_loss"] = float(jkp._detector_loss(logits, jnp.asarray(labels)))
    out["desc_loss"] = float(jkp._descriptor_loss(da, db))
    out["logits"], out["da"], out["db"] = np.asarray(logits), np.asarray(da), np.asarray(db)

    img_a = _scene(9)
    img_b = np.roll(np.roll(img_a, 8, axis=0), 8, axis=1)
    out["img_a"], out["img_b"] = img_a, img_b
    kps, desc = jkp.detect_keypoints(net32, params, jnp.asarray(img_a), max_kp=128)
    out["detect"] = {k: np.asarray(getattr(kps, k)) for k in ("xy", "score", "valid")}
    out["detect"]["desc"] = np.asarray(desc)
    m = jkp.match_image_pair_learned(net32, params, jnp.asarray(img_a), jnp.asarray(img_b),
                                     max_kp=128, min_score=0.5)
    out["match"] = {k: np.asarray(getattr(m, k)) for k in ("xy_a", "xy_b", "idx_b", "valid")}

    # each step's starting state, its losses, and the state after it
    x, y = jnp.asarray(imgs), jnp.asarray(labels)
    p, opt, steps = params, jkp.make_optimizer_state(params), []
    for _ in range(2):
        start = jax.tree.map(np.asarray, (p, opt))
        p, opt, loss, det, desc = jkp.train_step(net32, p, opt, x, y)
        steps.append((start, (float(loss), float(det), float(desc)), jax.tree.map(np.asarray, opt)))
    # value_and_grad of train_step's loss at the seeded init, as JAX's
    # train_step computed it: the value it returns, and the gradient from
    # optax's first moment after the first step, mu = (1 - b1) g + b1 0 (one
    # f32 rounding from g; a second jitted value_and_grad would double this
    # fixture's compile time)
    mu = steps[0][2][0].mu
    out["vg"] = (steps[0][1], jax.tree.map(lambda m: m / np.float32(1 - 0.9), mu))
    out["steps"] = steps
    return out


def _port_net(ref, dtype=torch.float32):
    net = tkp.KeypointNet(desc_dim=DESC, width=WIDTH, dtype=dtype)
    params = tkp.convert_params(ref["init"][1], DESC, WIDTH, device="cpu")
    net.load_state_dict(params)
    return net, params


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_init_matches_flax(ref, seed):
    _, params = tkp.create_keypoint_model(DESC, WIDTH, seed=seed, device="cpu")
    want = tkp.convert_params(ref["init"][seed], DESC, WIDTH, device="cpu")
    assert list(params) == list(want)
    for name, got in params.items():
        g, w = got.numpy(), want[name].numpy()
        ulps = np.abs(g - w) / np.spacing(np.maximum(np.abs(w), np.float32(1e-30)))
        assert ulps.max() <= 4, (name, ulps.max())


def test_layout_is_flax_names_and_shapes(ref):
    flat = _flat(ref["init"][0])
    layout = tkp.keypoint_layout(DESC, WIDTH)
    assert {"/".join(p): s for p, _, s, _ in layout} == {k: v.shape for k, v in flat.items()}
    net = tkp.KeypointNet(DESC, WIDTH)
    assert {n for _, n, _, _ in layout} == set(net.state_dict())


def test_convert_params_carries_flax_arrays(ref):
    flat = _flat(ref["init"][1])
    params = tkp.convert_params(flat, DESC, WIDTH, device="cpu")
    for path, name, _, _ in tkp.keypoint_layout(DESC, WIDTH):
        a = flat["/".join(path)]
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(params[name].numpy(), a)
    with pytest.raises(ValueError):
        tkp.convert_params(flat, DESC + 1, WIDTH, device="cpu")


def test_forward_f32_matches_jax(ref):
    net, _ = _port_net(ref)
    with torch.no_grad():
        logits, desc = net(torch.from_numpy(ref["x"]))
    assert logits.shape == (2, 8, 8, 65) and desc.shape == (2, 8, 8, DESC)
    np.testing.assert_allclose(logits.numpy(), ref["fwd32"][0], atol=1e-5)
    np.testing.assert_allclose(desc.numpy(), ref["fwd32"][1], atol=1e-5)


def test_forward_bf16_matches_jax(ref):
    net, _ = _port_net(ref, torch.bfloat16)
    with torch.no_grad():
        logits, desc = net(torch.from_numpy(ref["x"]))
    assert logits.dtype == desc.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref["fwd16"][0], rtol=0, atol=BF16_LOGIT_ATOL)
    assert (desc.numpy() * ref["fwd16"][1]).sum(-1).min() >= BF16_DESC_COS


def test_heatmap_layout_exact_and_values(ref):
    rng = np.random.default_rng(4)
    # one-hot cells (the rest at -1e30): softmax is exact in both packages,
    # so the 64 -> 8x8 unpacking is compared bit for bit
    hot = rng.integers(0, 65, (2, 3, 5))
    logits = np.full((2, 3, 5, 65), -1e30, np.float32)
    np.put_along_axis(logits, hot[..., None], 0.0, axis=-1)
    got = tkp.heatmap_from_logits(torch.from_numpy(logits)).numpy()
    want = np.asarray(jkp.heatmap_from_logits(jnp.asarray(logits)))
    assert got.shape == (2, 24, 40)
    np.testing.assert_array_equal(got, want)
    got = tkp.heatmap_from_logits(torch.tensor(ref["fwd32"][0])).numpy()
    want = np.asarray(jkp.heatmap_from_logits(jnp.asarray(ref["fwd32"][0])))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_detect_keypoints_matches_jax(ref):
    net, params = _port_net(ref)
    kps, desc = tkp.detect_keypoints(net, params, torch.from_numpy(ref["img_a"]), max_kp=128)
    want = ref["detect"]
    n_max = int(np.isfinite(want["score"]).sum())
    assert 0 < n_max < 128  # the -inf tail is part of the comparison
    np.testing.assert_array_equal(kps.xy.numpy(), want["xy"])
    np.testing.assert_array_equal(kps.valid.numpy(), want["valid"])
    np.testing.assert_allclose(kps.score.numpy(), want["score"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(desc.numpy(), want["desc"], rtol=0, atol=1e-5)


def test_match_image_pair_learned_matches_jax(ref):
    net, params = _port_net(ref)
    m = tkp.match_image_pair_learned(net, params, torch.from_numpy(ref["img_a"]),
                                     torch.from_numpy(ref["img_b"]), max_kp=128, min_score=0.5)
    want = ref["match"]
    np.testing.assert_array_equal(m.valid.numpy(), want["valid"])
    np.testing.assert_array_equal(m.idx_b.numpy(), want["idx_b"])
    np.testing.assert_array_equal(m.xy_a.numpy(), want["xy_a"])
    assert want["valid"].sum() > 0


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_corner_batch_bit_equal(seed):
    got = tkp.synthetic_corner_batch(np.random.default_rng(seed), 6)
    want = jkp.synthetic_corner_batch(np.random.default_rng(seed), 6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_losses_match_jax(ref):
    _, labels = ref["batch"]
    det = tkp._detector_loss(torch.tensor(ref["logits"]), torch.from_numpy(labels))
    desc = tkp._descriptor_loss(torch.tensor(ref["da"]), torch.tensor(ref["db"]))
    assert abs(float(det) - ref["det_loss"]) <= 1e-6
    assert abs(float(desc) - ref["desc_loss"]) <= 1e-6


def _close_per_tensor(got: dict, want: dict, what: str):
    """Each tensor within 1e-4 of its norm, plus 1e-6 of the whole's (a
    tensor whose value is rounding noise is held at the whole's scale)."""
    assert list(got) == list(want)
    floor = 1e-6 * float(torch.cat([w.reshape(-1) for w in want.values()]).norm())
    for name, g in got.items():
        w = want[name]
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + floor, (what, name)


def test_value_and_grad_f32_matches_jax(ref):
    """The gradient of train_step's loss, both views and both terms, at the
    seeded init, against the one JAX's train_step takes: a detached view or
    a dropped term shows here."""
    from cerebro_tpu_torch.train.optim import value_and_grad

    net, params = _port_net(ref)
    imgs, labels = (torch.from_numpy(a) for a in ref["batch"])
    with torch.no_grad():  # the gradient is taken whatever the caller's mode
        (loss, (det, desc)), grads = value_and_grad(lambda p: tkp.train_loss(net, p, imgs, labels),
                                                    params)
    want, want_grads = ref["vg"]
    for got_v, want_v in zip((loss, det, desc), want):
        assert abs(float(got_v) - want_v) <= 1e-5 * abs(want_v), (float(got_v), want_v)
    _close_per_tensor(grads, tkp.convert_params(want_grads, DESC, WIDTH, device="cpu"), "grad")


def _port_opt_state(opt):
    """optax.adam's state -> the port's AdamState (keypoint layout)."""
    from cerebro_tpu_torch.train import AdamState

    adam = opt[0]
    return AdamState(
        torch.tensor(int(adam.count), dtype=torch.int32),
        tkp.convert_params(adam.mu, DESC, WIDTH, device="cpu"),
        tkp.convert_params(adam.nu, DESC, WIDTH, device="cpu"),
    )


def test_train_step_f32_matches_jax(ref):
    """Each step from JAX's state before it: the first from the seeded
    init, the second after one Adam step. (A chain of the port's own steps
    drifts: Adam's first step is nearly -lr * sign(g), and a gradient entry
    near 0 can flip its sign between the packages.) Adam's moments after
    each step against JAX's next state: the step's gradient as it reaches
    the update."""
    net, _ = _port_net(ref)
    imgs, labels = (torch.from_numpy(a) for a in ref["batch"])
    for (p, opt), want, (after, _) in ref["steps"]:
        params = tkp.convert_params(p, DESC, WIDTH, device="cpu")
        opt = _port_opt_state(opt)
        count = int(opt.count)
        params, opt, loss, det, desc = tkp.train_step(net, params, opt, imgs, labels)
        np.testing.assert_allclose([float(loss), float(det), float(desc)], want, rtol=0, atol=1e-4)
        assert int(opt.count) == count + 1
        want_opt = _port_opt_state((after,))
        assert int(want_opt.count) == int(opt.count)
        _close_per_tensor(opt.mu, want_opt.mu, f"mu after step {count + 1}")
        _close_per_tensor(opt.nu, want_opt.nu, f"nu after step {count + 1}")
    assert count == 1
