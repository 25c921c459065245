"""Tier-1 verification pieces and whole pairs: the port against the JAX
package, on tests/test_verify.py's rendered two-plane scene."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.geometry import se3 as jse3
from cerebro_tpu.ops import features as jfeat
from cerebro_tpu.ops import ransac as jransac
from cerebro_tpu.verify import verify_pair as jverify_pair
from cerebro_tpu_torch.config import VerifyConfig
from cerebro_tpu_torch.geometry.stereo import RectifiedRig
from cerebro_tpu_torch.ops import features as tfeat
from cerebro_tpu_torch.ops import ransac as transac
from cerebro_tpu_torch.verify.geometric import verify_pair, verify_pair_batch

from test_verify import BASELINE, CFG, CX, CY, FX, FY, big_texture, make_rig, stereo_pair

TCFG = VerifyConfig(**dataclasses.asdict(CFG))
TRIG = RectifiedRig(R0=np.eye(3), R1=np.eye(3), fx=FX, fy=FY, cx=CX, cy=CY, baseline=BASELINE)


@pytest.fixture(scope="module")
def scene():
    tex = big_texture(np.random.default_rng(0))
    Ta = np.eye(4, dtype=np.float32)
    Tb = np.asarray(
        jse3.make_pose(jse3.ypr_to_rot(jnp.asarray([np.deg2rad(4.0), 0.0, 0.0], jnp.float32)),
                       jnp.asarray([0.25, 0.1, 0.15]))
    ).astype(np.float32)
    la, ra = (np.array(x, np.float32) for x in stereo_pair(tex, Ta))
    lb, rb = (np.array(x, np.float32) for x in stereo_pair(tex, Tb))
    tex2 = big_texture(np.random.default_rng(999))
    lc, rc = (np.array(x, np.float32) for x in stereo_pair(tex2, Ta))
    return {"a": (la, ra), "b": (lb, rb), "c": (lc, rc)}


def test_harris_keypoints_identical(scene):
    img = scene["a"][0]
    for max_kp, border in ((512, 8), (1024, 16)):
        kj = jfeat.harris_corners(jnp.asarray(img), max_kp=max_kp, border=border)
        kt = tfeat.harris_corners(torch.from_numpy(img), max_kp=max_kp, border=border)
        np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))
        np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    # a coarse level with fewer maxima than slots: -inf ties fill by index
    small = np.ascontiguousarray(img[:60, :80])
    kj = jfeat.harris_corners(jnp.asarray(small), max_kp=256, border=8)
    kt = tfeat.harris_corners(torch.from_numpy(small), max_kp=256, border=8)
    np.testing.assert_array_equal(kt.xy.numpy(), np.asarray(kj.xy))


def test_steerable_match_count_within_2_percent(scene):
    la, lb = scene["a"][0], scene["b"][0]
    mj = jfeat.match_image_pair_steerable(jnp.asarray(la), jnp.asarray(lb), gms_factor=4.0)
    mt = tfeat.match_image_pair_steerable(torch.from_numpy(la), torch.from_numpy(lb), gms_factor=4.0)
    nj, nt = int(mj.count()), int(mt.count())
    assert nj >= 150
    assert abs(nt - nj) <= 0.02 * nj, (nt, nj)


def _correspondences(seed, n=300, outliers=0.2):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    R = np.asarray(jse3.ypr_to_rot(jnp.asarray([0.1, -0.05, 0.03])))
    t = np.array([0.3, -0.1, 0.2])
    Xb = X @ R.T + t
    x = Xb[:, :2] / Xb[:, 2:] + rng.normal(0, 0.002, (n, 2))
    bad = rng.random(n) < outliers
    x[bad] += rng.uniform(-0.3, 0.3, (bad.sum(), 2))
    Xb_noisy = Xb + rng.normal(0, 0.01, Xb.shape)
    Xb_noisy[bad] += rng.uniform(-1, 1, (bad.sum(), 3))
    valid = rng.random(n) > 0.1
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    f = lambda a: a.astype(np.float32)
    return f(X), f(x), f(Xb_noisy), valid, f(T)


def _same_result(rt, rj):
    assert bool(rt.success) == bool(rj.success)
    assert abs(int(rt.inlier_count) - int(rj.inlier_count)) <= 1
    ang, tr = jse3.pose_delta_metrics(jnp.asarray(rt.T.numpy()), rj.T)
    assert float(ang) < np.rad2deg(1e-3) and float(tr) < 1e-3, (float(ang), float(tr))


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_with_jax_samples(seed):
    X, x, _, valid, _ = _correspondences(seed)
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(jransac._sample_indices(key, len(X), jnp.asarray(valid), 128, 6))
    rj = jransac.ransac_pnp(key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(valid), n_hyp=128)
    rt = transac.ransac_pnp(
        None, torch.from_numpy(X), torch.from_numpy(x), torch.from_numpy(valid),
        n_hyp=128, sample_idx=torch.from_numpy(idx),
    )
    assert bool(rj.success)
    _same_result(rt, rj)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_icp_with_jax_samples(seed):
    X, _, Xb, valid, _ = _correspondences(seed)
    key = jax.random.PRNGKey(seed + 10)
    idx = np.asarray(jransac._sample_indices(key, len(X), jnp.asarray(valid), 128, 4))
    rj = jransac.ransac_icp(key, jnp.asarray(X), jnp.asarray(Xb), jnp.asarray(valid), n_hyp=128)
    rt = transac.ransac_icp(
        None, torch.from_numpy(X), torch.from_numpy(Xb), torch.from_numpy(valid),
        n_hyp=128, sample_idx=torch.from_numpy(idx),
    )
    assert bool(rj.success)
    _same_result(rt, rj)


def test_default_sampler_draws_distinct_valid_points():
    valid = torch.from_numpy(np.random.default_rng(4).random(50) > 0.5)
    g = torch.Generator().manual_seed(0)
    idx = transac.sample_indices(g, valid, 64, 6)
    assert idx.shape == (64, 6)
    assert bool(valid[idx].all())
    assert all(len(set(row.tolist())) == 6 for row in idx)


def _verify_both(scene, a, b, seed):
    la, ra = scene[a]
    lb, rb = scene[b]
    rj = jverify_pair(CFG, jax.random.PRNGKey(seed), la, ra, lb, rb, make_rig())
    g = torch.Generator().manual_seed(seed)
    rt = verify_pair(TCFG, g, *(torch.from_numpy(v) for v in (la, ra, lb, rb)), TRIG)
    return rj, rt


def _gate(res):
    """The first failing gate, in the order the pipeline reports it."""
    n = int(res.n_matches)
    if n < CFG.min_matches_attempt:
        return "matches"
    if not np.asarray(res.option_success).all():
        return "ransac"
    if not bool(res.consistent):
        return "consistency"
    return "accept" if bool(res.accepted) else "accept_gate"


def _jax_samples(key, la, ra, lb, rb):
    """The (H, S) samples JAX's verify_pair draws for options A, B and C,
    rebuilt from its own intermediates (its matches, depth and masks)."""
    from cerebro_tpu.geometry import stereo as jstereo
    from cerebro_tpu.verify.geometric import _gather_3d

    rig = make_rig()
    pts_a, ok_a, _ = jstereo.depth_pipeline_rectified(la, ra, rig)
    pts_b, ok_b, _ = jstereo.depth_pipeline_rectified(lb, rb, rig)
    m = jfeat.match_image_pair_steerable(
        jnp.asarray(la), jnp.asarray(lb), max_kp=CFG.max_features, gms_factor=CFG.gms_factor
    )
    X_a, d_a = _gather_3d(pts_a, ok_a, m.xy_a)
    X_b, d_b = _gather_3d(pts_b, ok_b, m.xy_b)
    ok_a = d_a & (X_a[:, 2] > CFG.min_depth) & (X_a[:, 2] < CFG.max_depth)
    ok_b = d_b & (X_b[:, 2] > CFG.min_depth) & (X_b[:, 2] < CFG.max_depth)
    keys = jax.random.split(key, 3)
    masks = (m.valid & ok_a, m.valid & ok_b, m.valid & ok_a & ok_b)
    sizes = (CFG.pnp_sample_size, CFG.pnp_sample_size, CFG.icp_sample_size)
    return tuple(
        torch.from_numpy(np.asarray(jransac._sample_indices(
            k, CFG.max_features, v, CFG.ransac_hypotheses, s)))
        for k, v, s in zip(keys, masks, sizes)
    )


def test_verify_revisit_pair_matches_jax(scene):
    """Independent RNG: the same decision and gate. The pose is compared
    with JAX's own RANSAC samples fed to the port: with independent samples
    the reference's Option-A pose itself moves by ~1 deg / 0.07 m from seed
    to seed on this pair (9 px PnP threshold), wider than 0.5 deg / 2 cm."""
    rj, rt = _verify_both(scene, "a", "b", 0)
    assert bool(rj.accepted) and bool(rt.accepted)
    assert _gate(rt) == _gate(rj)

    (la, ra), (lb, rb) = scene["a"], scene["b"]
    idx = _jax_samples(jax.random.PRNGKey(0), la, ra, lb, rb)
    rs = verify_pair(TCFG, None, *(torch.from_numpy(v) for v in (la, ra, lb, rb)), TRIG,
                     sample_idx=idx)
    assert bool(rs.accepted)
    ang, tr = jse3.pose_delta_metrics(jnp.asarray(rs.T_b_a.numpy()), rj.T_b_a)
    assert float(ang) < 0.5 and float(tr) < 0.02, (float(ang), float(tr))


def test_verify_non_matching_pair_matches_jax(scene):
    rj, rt = _verify_both(scene, "a", "c", 1)
    assert not bool(rj.accepted) and not bool(rt.accepted)
    assert _gate(rt) == _gate(rj)


def test_verify_batch_equals_single(scene):
    (la, ra), (lb, rb) = scene["a"], scene["b"]
    L = [torch.from_numpy(v) for v in (la, ra, lb, rb)]
    idx = [[torch.from_numpy(np.asarray(jransac._sample_indices(
        jax.random.PRNGKey(k), TCFG.max_features, jnp.ones(TCFG.max_features, bool),
        TCFG.ransac_hypotheses, s))) for k, s in enumerate((6, 6, 4))]]
    one = verify_pair(TCFG, None, *L, TRIG, sample_idx=idx[0])
    two = verify_pair_batch(
        TCFG, None, *(torch.stack([v, v]) for v in L), TRIG, sample_idx=idx * 2
    )
    for p in range(2):
        assert bool(two.accepted[p]) == bool(one.accepted)
        assert int(two.n_matches[p]) == int(one.n_matches)
        torch.testing.assert_close(two.T_b_a[p], one.T_b_a)


def _first(res):
    """Pair 0 of a batched VerifiedLoop."""
    return type(res)(**{f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})


@pytest.mark.parametrize("b", ["b", "c"], ids=["revisit", "non_matching"])
def test_verify_gather_banks_matches_jax(scene, b):
    """Tier 2 as the cascade runs it: verify_pair_batch with the gather
    matcher, the default scale banks and 1,024 features, against the JAX
    package's verify_pair on the same pair: the same decision and gate, and
    the match count within 2% (tier 1's standard)."""
    cfg = dataclasses.replace(CFG, matcher="gather")
    assert cfg.scale_banks == VerifyConfig().scale_banks and cfg.max_features == 1024
    (la, ra), (lb, rb) = scene["a"], scene[b]
    rj = jverify_pair(cfg, jax.random.PRNGKey(2), la, ra, lb, rb, make_rig())
    rt = _first(verify_pair_batch(
        dataclasses.replace(TCFG, matcher="gather"), torch.Generator().manual_seed(2),
        *(torch.from_numpy(v)[None] for v in (la, ra, lb, rb)), TRIG,
    ))
    assert bool(rt.accepted) == bool(rj.accepted) == (b == "b")
    assert _gate(rt) == _gate(rj)
    nj, nt = int(rj.n_matches), int(rt.n_matches)
    assert abs(nt - nj) <= 0.02 * max(nj, 1), (nt, nj)
