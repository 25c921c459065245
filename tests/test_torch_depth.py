"""The depth-camera rig of the port against the JAX package:
geometry/stereo.py::depth_to_points, verify/geometric.py::verify_pair_depth
(fed JAX's own RANSAC samples) and the depth branches of CerebroPipeline
(ingest_frame(depth_img=...), _load_pair's depth fallback, verify_pending's
one call per pair), on tests/test_verify.py's two-plane scene with its
analytic depth (tests/test_pipeline.py's depth-camera stream). Depth
verification never reaches block matching (K3 on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.geometry import se3 as jse3
from cerebro_tpu.geometry import stereo as jstereo
from cerebro_tpu.ops import features as jfeat
from cerebro_tpu.ops import ransac as jransac
from cerebro_tpu.runtime import CerebroPipeline as JPipeline
from cerebro_tpu.verify import verify_pair_depth as jverify_pair_depth
from cerebro_tpu_torch.geometry import stereo as tstereo
from cerebro_tpu_torch.ops import stereo_kernel
from cerebro_tpu_torch.runtime import CerebroPipeline
from cerebro_tpu_torch.verify.geometric import verify_pair_depth

from test_pipeline import camera_pose, small_config
from test_torch_pipeline import _port_config
from test_torch_verify import TCFG, TRIG, _gate
from test_verify import CFG, CX, CY, FX, FY, H, W, X_SPLIT, Z_FAR, Z_NEAR, big_texture, make_rig, render


def depth_map(w_T_c):
    """Analytic camera-z depth of the two-plane scene from w_T_c
    (tests/test_pipeline.py::test_pipeline_depth_camera_mode's)."""
    R, t = w_T_c[:3, :3], w_T_c[:3, 3]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    rays = np.stack([(u - CX) / FX, (v - CY) / FY, np.ones_like(u)], -1)
    dirs = rays @ R.T
    s_near = (Z_NEAR - t[2]) / dirs[..., 2]
    p_near = t[None, None, :] + s_near[..., None] * dirs
    use_near = p_near[..., 0] < X_SPLIT
    return np.where(use_near, s_near, (Z_FAR - t[2]) / dirs[..., 2]).astype(np.float32)


def to8(x):
    return np.clip(np.asarray(x) * 255, 0, 255).astype(np.uint8)


def test_depth_to_points_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(-1.0, 30.0, (2, H, W)).astype(np.float32)
    depth[0, :5] = 0.0
    depth[0, 5, :7] = np.nan
    depth[1, 6, :7] = np.inf
    depth[1, 7, :3] = (0.1, 25.0, 24.999)  # the gate's edges
    for lo, hi in ((0.1, 25.0), (0.5, 8.0)):
        pts_t, ok_t = tstereo.depth_to_points(torch.from_numpy(depth), TRIG, lo, hi)
        for b in range(2):
            pts_j, ok_j = jstereo.depth_to_points(jnp.asarray(depth[b]), make_rig(), lo, hi)
            np.testing.assert_array_equal(ok_t[b].numpy(), np.asarray(ok_j))
            fin = np.isfinite(depth[b])
            np.testing.assert_allclose(pts_t[b].numpy()[fin], np.asarray(pts_j)[fin], atol=1e-6, rtol=0)
            np.testing.assert_array_equal(
                np.isnan(pts_t[b].numpy()), np.isnan(np.asarray(pts_j))
            )


@pytest.fixture(scope="module")
def depth_scene():
    tex = big_texture(np.random.default_rng(0))
    Ta = np.eye(4, dtype=np.float32)
    Tb = np.asarray(
        jse3.make_pose(jse3.ypr_to_rot(jnp.asarray([np.deg2rad(4.0), 0.0, 0.0], jnp.float32)),
                       jnp.asarray([0.25, 0.1, 0.15]))
    ).astype(np.float32)
    tex2 = big_texture(np.random.default_rng(999))
    return {
        "a": (np.array(render(tex, Ta), np.float32), depth_map(Ta)),
        "b": (np.array(render(tex, Tb), np.float32), depth_map(Tb)),
        "c": (np.array(render(tex2, Ta), np.float32), depth_map(Ta)),
    }


def _jax_depth_samples(key, la, da, lb, db):
    """The (H, S) samples JAX's verify_pair_depth draws for options A, B
    and C, rebuilt from its own intermediates."""
    from cerebro_tpu.verify.geometric import _gather_3d

    rig = make_rig()
    pts_a, ok_a = jstereo.depth_to_points(jnp.asarray(da), rig, CFG.min_depth, CFG.max_depth)
    pts_b, ok_b = jstereo.depth_to_points(jnp.asarray(db), rig, CFG.min_depth, CFG.max_depth)
    m = jfeat.match_image_pair_steerable(
        jnp.asarray(la), jnp.asarray(lb), max_kp=CFG.max_features, gms_factor=CFG.gms_factor,
        oriented=CFG.oriented_matching, scales=CFG.scale_banks,
    )
    X_a, d_a = _gather_3d(pts_a, ok_a, m.xy_a)
    X_b, d_b = _gather_3d(pts_b, ok_b, m.xy_b)
    ok_a = d_a & (X_a[:, 2] > CFG.min_depth) & (X_a[:, 2] < CFG.max_depth)
    ok_b = d_b & (X_b[:, 2] > CFG.min_depth) & (X_b[:, 2] < CFG.max_depth)
    keys = jax.random.split(key, 3)
    masks = (m.valid & ok_a, m.valid & ok_b, m.valid & ok_a & ok_b)
    sizes = (CFG.pnp_sample_size, CFG.pnp_sample_size, CFG.icp_sample_size)
    return tuple(
        torch.from_numpy(np.array(jransac._sample_indices(
            k, CFG.max_features, v, CFG.ransac_hypotheses, s)))
        for k, v, s in zip(keys, masks, sizes)
    )


@pytest.fixture
def no_block_matching(monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("depth verification ran block matching")

    monkeypatch.setattr(stereo_kernel, "block_match", fail)
    monkeypatch.setattr(tstereo, "block_match", fail)


@pytest.mark.parametrize("b,accept", [("b", True), ("c", False)], ids=["revisit", "non_matching"])
def test_verify_pair_depth_on_jax_samples(depth_scene, b, accept, no_block_matching):
    (la, da), (lb, db) = depth_scene["a"], depth_scene[b]
    key = jax.random.PRNGKey(4)
    rj = jverify_pair_depth(CFG, key, la, da, lb, db, make_rig())
    idx = _jax_depth_samples(key, la, da, lb, db)
    rt = verify_pair_depth(
        TCFG, None, *(torch.from_numpy(v) for v in (la, da, lb, db)), TRIG, sample_idx=idx
    )
    assert bool(rj.accepted) == bool(rt.accepted) == accept
    assert _gate(rt) == _gate(rj)
    assert abs(int(rt.n_matches) - int(rj.n_matches)) <= 0.02 * int(rj.n_matches)
    if accept:
        ang, tr = jse3.pose_delta_metrics(jnp.asarray(rt.T_b_a.numpy()), rj.T_b_a)
        assert float(ang) < 0.5 and float(tr) < 0.02, (float(ang), float(tr))


def test_depth_rig_pipeline_matches_jax(tmp_path, no_block_matching):
    """tests/test_pipeline.py:240-285 through both packages: no right
    images, per-pixel depth drives verification; the same candidates and
    the same edges, each near identity (an identical-view revisit)."""
    tex = big_texture(np.random.default_rng(11), n=4096)
    stream = [(float(i), i, camera_pose(i)) for i in range(14)]
    stream += [(20.0 + k, i, camera_pose(14 + k)) for k, i in enumerate(range(2, 6))]
    views = {i: (to8(render(tex, camera_pose(i))), depth_map(camera_pose(i))) for i in range(14)}
    jcfg = small_config(tmp_path / "j")
    jp = JPipeline(jcfg, rig=make_rig())
    tp = CerebroPipeline(_port_config(jcfg), rig=TRIG, device="cpu")
    for pipe in (jp, tp):
        for t, i, pose in stream:
            left, depth = views[i]
            pipe.ingest_frame(t, left, n_tracked=100, pose=pose, depth_img=depth)
        pipe.flush_descriptors()
    jc = [(c.idx_curr, c.idx_prev) for c in jp.candidates]
    tc = [(c.idx_curr, c.idx_prev) for c in tp.candidates]
    assert tc == jc and len(tc) >= 1
    n_j, n_t = jp.verify_pending(), tp.verify_pending()
    assert n_t == n_j >= 1
    te = {(e.idx_curr, e.idx_prev): e for e in tp.loop_edges}
    assert te.keys() == {(e.idx_curr, e.idx_prev) for e in jp.loop_edges}
    for e in te.values():
        ang, tr = jse3.pose_delta_metrics(jnp.eye(4), jnp.asarray(e.T_prev_curr, jnp.float32))
        assert float(ang) < 1.5 and float(tr) < 0.1
    # no cascade for depth pairs: no tier-2 pass, nothing escalated
    assert tp.status()["escalated_to_tier2"] == 0
    assert [(r.idx_curr, r.idx_prev) for r in tp.rejected_candidates] == [
        (r.idx_curr, r.idx_prev) for r in jp.rejected_candidates
    ]
    tp.close()
