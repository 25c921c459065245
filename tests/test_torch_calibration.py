"""The port's calibration tools (cerebro_tpu_torch/geometry/calibration.py,
chessboard.py) against the JAX package's, on tests/test_calibration.py's
synthetic boards and tests/test_chessboard.py's rendered ones.

Both packages compute in float32, but their eigen solvers, SVDs, solves
and convolutions round differently, and Levenberg-Marquardt's
accept/reject can branch apart on a near-equal cost; so the results are
compared, not the iterates:

- ``estimate_homography`` within 1e-4 of JAX's (and 2e-3 of the truth);
  Zhang's K within 1e-3 relative and the views' poses within 1e-4 on the
  same homographies;
- ``refine_calibration`` and ``refine_calibration_model`` (Kannala-Brandt,
  Mei, Scaramuzza) from JAX's own starting point, and ``calibrate_planar``
  for the four models: fx and fy within 5e-5 relative (Mei's focal and
  xi trade off along a flat valley, gamma / (1 + xi) being what the views
  pin down: there the packages part by 2e-5), cx and cy within 0.01 px,
  the distortion and xi within 1e-4 (Scaramuzza's a0 within 0.01 px),
  the poses within 1e-4,
  the RMS within 1e-4 px, the same success flag, and the JAX tests' own
  2% and RMS gates; identical views flagged degenerate in both;
- ``corner_response`` within 1e-5; ``find_corner_candidates``: the same
  pixels, scores within 1e-5, filler slots identical, and the same order
  except among slots whose scores are within 1e-5 of each other (the
  axis-aligned board's corners are symmetric, so their responses tie to
  a few ulps, which each package rounds its own way, and which of the
  weakest tied peaks the cut keeps differs too); on the perspective
  boards, the same slots in the same order;
- ``detect_chessboard`` and ``order_grid``: the same found flag and the
  same corner order, within 1e-3 px, or the reverse order where the two
  orientations' fits tie (see ``_same_grid``); ``board_points`` equal;
- numpy inputs without CUDA and without ``device="cpu"`` raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebro_tpu.geometry import calibration as jcal
from cerebro_tpu.geometry import cameras as jcam
from cerebro_tpu.geometry import chessboard as jcb
from cerebro_tpu_torch.geometry import calibration as tcal
from cerebro_tpu_torch.geometry import cameras as tcam
from cerebro_tpu_torch.geometry import chessboard as tcb

import test_calibration as tc
import test_chessboard as tch

FOCAL_REL, PX, DIST, POSE, RMS = 5e-5, 0.01, 1e-4, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's refinements on the CPU are thousands of ops on tensors of
    at most 1,000 x 69: threads only add synchronisation, and on a CPU the
    other test workers keep busy, intra-op threads that wait for a core
    made a calibration 20x slower (148 s against 7.8 s for one
    Scaramuzza calibration beside 8 busy processes). The module's port
    calls run on one thread; the setting is restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
MODELS = {
    "pinhole": (jcam.PINHOLE, None),
    "kannala_brandt": (jcam.KANNALA_BRANDT,
                       lambda: jcam.make_kannala_brandt(380.0, 375.0, 370.0, 245.0,
                                                        (-0.01, 0.02, -0.008, 0.001))),
    "mei": (jcam.MEI, lambda: jcam.make_mei(720.0, 710.0, 370.0, 245.0, xi=0.9,
                                           dist=(-0.1, 0.02, 0.0, 0.0))),
    "scaramuzza": (jcam.SCARAMUZZA,
                   lambda: jcam.make_scaramuzza(1.0, 370.0, 245.0, poly=(420.0, -6e-4, 1e-7, 0.0))),
}


def _obs(name):
    rng = np.random.default_rng(0)
    board = tc.make_board()
    model, gt = MODELS[name]
    obs = tc.render_views(rng, board, n_views=10)[0] if gt is None else tc.render_views_cam(rng, gt(), board)
    return board, obs


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _same_camera(t, j, a0=False):
    for f in ("fx", "fy", "cx", "cy"):
        a, b = float(getattr(t, f)), float(getattr(j, f))
        assert abs(a - b) < (FOCAL_REL * abs(b) if f in ("fx", "fy") else PX), (f, a, b)
    dist_t, dist_j = _np(t.dist), _np(j.dist)
    if a0:  # Scaramuzza's a0 is a focal length in pixels
        assert abs(dist_t[0] - dist_j[0]) < PX
        dist_t, dist_j = dist_t[1:], dist_j[1:]
    np.testing.assert_allclose(dist_t, dist_j, atol=DIST, rtol=0)
    assert abs(float(t.xi) - float(j.xi)) < DIST


@pytest.fixture(scope="module")
def planar():
    """JAX's calibrate_planar per model, and the port's on the same obs."""
    out = {}
    for name, (model, _) in MODELS.items():
        board, obs = _obs(name)
        j = jcal.calibrate_planar(jnp.asarray(board), jnp.asarray(obs), model=model)
        t = tcal.calibrate_planar(board, obs, model=model, device="cpu")
        out[name] = (board, obs, j, t)
    return out


def test_homography_matches_jax(rng):
    H_gt = np.array([[1.2, 0.1, 30.0], [-0.05, 0.9, 10.0], [1e-4, -2e-4, 1.0]], np.float32)
    src = rng.uniform(0, 100, (40, 2)).astype(np.float32)
    sh = np.concatenate([src, np.ones((40, 1), np.float32)], -1) @ H_gt.T
    dst = sh[:, :2] / sh[:, 2:3]
    got = _np(tcal.estimate_homography(src, dst))
    want = np.asarray(jcal.estimate_homography(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, H_gt, atol=2e-3)


def test_zhang_and_extrinsics_match_jax():
    board, obs = _obs("pinhole")
    Hs = np.stack([np.asarray(jcal.estimate_homography(jnp.asarray(board), jnp.asarray(o))) for o in obs])
    Kj = np.asarray(jcal.intrinsics_from_homographies(jnp.asarray(Hs)))
    Kt = _np(tcal.intrinsics_from_homographies(torch.from_numpy(Hs)))
    np.testing.assert_allclose(Kt, Kj, rtol=1e-3, atol=1e-3)
    K = jnp.asarray(Kj)
    Pj = np.stack([np.asarray(jcal.extrinsics_from_homography(K, jnp.asarray(H))) for H in Hs])
    Pt = _np(tcal.extrinsics_from_homography(torch.from_numpy(Kj), torch.from_numpy(Hs)))
    np.testing.assert_allclose(Pt, Pj, atol=POSE, rtol=0)
    assert (Pt[:, 2, 3] > 0).all()  # the board in front of the camera


def _start(board, obs):
    """JAX's Zhang start for both packages."""
    Hs = jnp.stack([jcal.estimate_homography(jnp.asarray(board), jnp.asarray(o)) for o in obs])
    K0 = jcal.intrinsics_from_homographies(Hs)
    P0 = jnp.stack([jcal.extrinsics_from_homography(K0, H) for H in Hs])
    return K0, P0


def test_refine_calibration_matches_jax():
    board, obs = _obs("pinhole")
    K0, P0 = _start(board, obs)
    thj, vj, rj = jcal.refine_calibration(K0, P0, jnp.asarray(board), jnp.asarray(obs))
    tht, vt, rt = tcal.refine_calibration(torch.from_numpy(np.asarray(K0)), torch.from_numpy(np.asarray(P0)),
                                          torch.from_numpy(board), torch.from_numpy(obs))
    np.testing.assert_allclose(_np(tht[:4]), np.asarray(thj[:4]), atol=PX, rtol=0)
    np.testing.assert_allclose(_np(tht[4:]), np.asarray(thj[4:]), atol=DIST, rtol=0)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=POSE, rtol=0)
    assert abs(float(rt) - float(rj)) < RMS


@pytest.mark.parametrize("name", ["kannala_brandt", "mei", "scaramuzza"])
def test_refine_calibration_model_matches_jax(name):
    model = MODELS[name][0]
    board, obs = _obs(name)
    K0, P0 = _start(board, obs)
    th, views, _ = jcal.refine_calibration(K0, P0, jnp.asarray(board), jnp.asarray(obs))
    cam = jcam.make_pinhole(th[0], th[1], th[2], th[3])
    theta0 = jcal._theta_init(model, cam)
    thj, vj, rj = jcal.refine_calibration_model(model, theta0, views, jnp.asarray(board),
                                                jnp.asarray(obs))
    tcam0 = tcam.make_pinhole(*(float(v) for v in th[:4]))
    theta0_t = tcal._theta_init(model, tcam0)
    np.testing.assert_array_equal(_np(theta0_t), np.asarray(theta0))
    tht, vt, rt = tcal.refine_calibration_model(model, theta0_t, torch.from_numpy(np.asarray(views)),
                                                torch.from_numpy(board), torch.from_numpy(obs))
    _same_camera(tcal._theta_camera(model, tht), jcal._theta_camera(model, thj),
                 a0=model == jcam.SCARAMUZZA)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=POSE, rtol=0)
    assert abs(float(rt) - float(rj)) < RMS


@pytest.mark.parametrize("name", list(MODELS))
def test_calibrate_planar_matches_jax(planar, name):
    board, obs, j, t = planar[name]
    model = MODELS[name][0]
    assert t.success and j.success and t.camera.model == model
    _same_camera(t.camera, j.camera, a0=model == jcam.SCARAMUZZA)
    np.testing.assert_allclose(_np(t.view_poses), np.asarray(j.view_poses), atol=POSE, rtol=0)
    assert abs(float(t.rms_px) - float(j.rms_px)) < RMS and float(t.rms_px) < 0.5
    cam = t.camera
    if name == "pinhole":  # test_full_calibration_recovers_intrinsics's gates
        for f, want in (("fx", tc.FX), ("fy", tc.FY), ("cx", tc.CX), ("cy", tc.CY)):
            assert abs(float(getattr(cam, f)) - want) < 2.0
        assert abs(float(cam.dist[0]) - tc.K1) < 0.02 and abs(float(cam.dist[1]) - tc.K2) < 0.05
    elif name == "kannala_brandt":
        assert tc._rel_err(cam.fx, 380.0) < 0.02 and tc._rel_err(cam.fy, 375.0) < 0.02
    elif name == "mei":
        paraxial = float(cam.fx) / (1.0 + float(cam.xi))
        assert abs(paraxial - 720.0 / 1.9) / (720.0 / 1.9) < 0.02
    else:
        assert tc._rel_err(cam.dist[0], 420.0) < 0.02


def test_degenerate_views_flagged():
    board, obs = _obs("pinhole")
    same = np.repeat(obs[:1], 6, axis=0)
    assert not jcal.calibrate_planar(jnp.asarray(board), jnp.asarray(same)).success
    assert not tcal.calibrate_planar(board, same, device="cpu").success
    assert tcal.calibrate_planar(torch.from_numpy(board), torch.from_numpy(obs[:6])).success


# ---------------------------------------------------------------------------
# Chessboard detection
# ---------------------------------------------------------------------------


def _axis_aligned():
    Hm = np.array([[28.0, 0, 30.0], [0, 28.0, 25.0], [0, 0, 1.0]])
    return tch._render_homography(Hm, hw=(240, 320), square=1.0)


def _perspective(trial):
    """tests/test_chessboard.py's perspective boards, with their noise."""
    rng = np.random.default_rng(3)
    for t in range(trial + 1):
        th = rng.uniform(-0.3, 0.3)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        Hm = np.eye(3)
        Hm[:2, :2] = R * 26.0
        Hm[:2, 2] = [60.0 + 10 * t, 50.0]
        Hm[2, :2] = rng.uniform(-6e-4, 6e-4, size=2)
        img = tch._render_homography(Hm, hw=(240, 320), square=1.0)
        noisy = img + rng.normal(0, 0.01, img.shape).astype(np.float32)
    return noisy


BOARDS = {"axis_aligned": _axis_aligned, **{f"perspective{t}": (lambda t=t: _perspective(t)) for t in range(3)}}


@pytest.mark.parametrize("board", list(BOARDS))
def test_corner_response_and_candidates_match_jax(board):
    img = BOARDS[board]()
    rj = np.asarray(jcb.corner_response(jnp.asarray(img)))
    rt = tcb.corner_response(img, device="cpu").numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-5, rtol=0)
    n = tch.ROWS * tch.COLS + 8
    uj, sj = (np.asarray(a) for a in jcb.find_corner_candidates(jnp.asarray(img), n))
    ut, st = (a.numpy() for a in tcb.find_corner_candidates(img, n, device="cpu"))
    real = sj > 0
    np.testing.assert_array_equal(st > 0, real)
    np.testing.assert_array_equal(ut[~real], uj[~real])  # fillers: the clipped index's pixel
    # a peak beside the border mask fits its subpixel offset to -inf: NaN
    # in both packages, at the same slots
    np.testing.assert_array_equal(np.isnan(ut), np.isnan(uj))
    if board != "axis_aligned":  # no ties: the same slots in the same order
        np.testing.assert_allclose(np.nan_to_num(ut), np.nan_to_num(uj), atol=1e-4, rtol=0)
        np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
        return
    # each JAX slot's pixel at one port slot, its score within 1e-5, except
    # slots tied with the weakest kept one (which of them the cut keeps
    # is decided at the ulp level)
    sr, ujr, utr = sj[real], uj[real], ut[real]
    clear = (sr > sr.min() + 1e-5) & ~np.isnan(ujr).any(-1)
    d = np.linalg.norm(ujr[clear][:, None] - utr[None], axis=-1)
    pos = np.nanargmin(d, axis=1)
    assert (np.nanmin(d, axis=1) < 1e-4).all() and len(set(pos.tolist())) == clear.sum()
    np.testing.assert_allclose(st[real][pos], sr[clear], atol=1e-5, rtol=0)
    # the order, except among near-equal scores
    sc = sr[clear]
    for a in range(len(sc)):
        for b in range(a + 1, len(sc)):
            if sc[a] - sc[b] > 1e-5:
                assert pos[a] < pos[b], (a, b)


@pytest.mark.parametrize("board", list(BOARDS))
def test_detect_chessboard_matches_jax(board):
    img = BOARDS[board]()
    cj, fj = jcb.detect_chessboard(img, (tch.ROWS, tch.COLS))
    ct, ft = tcb.detect_chessboard(img, (tch.ROWS, tch.COLS), device="cpu")
    assert fj and ft
    _same_grid(ct, cj)
    # order_grid alone on the same candidates (a shuffled copy)
    perm = np.random.default_rng(1).permutation(len(cj))
    oj, okj = jcb.order_grid(cj[perm], (tch.ROWS, tch.COLS))
    ot, okt = tcb.order_grid(cj[perm], (tch.ROWS, tch.COLS))
    assert okj and okt
    _same_grid(ot, oj)


def _same_grid(got, want):
    """The same corners in the same row-major order, within 1e-3 px, or
    in the reverse order where the two are a tie: the grid is symmetric
    under a half turn, so ``order_grid``'s fits from opposite corners cost
    the same to within the precision of a float32 DLT fit (it takes the
    null vector of A^T A): 2.10765 against 2.10773 on perspective0, and
    each package takes the one its rounding makes cheaper."""
    if np.allclose(got, want, atol=1e-3, rtol=0):
        return
    np.testing.assert_allclose(got, want[::-1], atol=1e-3, rtol=0)
    rows, cols = tch.ROWS, tch.COLS
    unit = np.stack(np.meshgrid(np.arange(cols, dtype=np.float64),
                                np.arange(rows, dtype=np.float64)), axis=-1).reshape(-1, 2)
    costs = []
    for grid in (got, want):
        Hm = tcb._homography_np(unit, grid)
        costs.append(np.linalg.norm(tcb._apply_h(Hm, unit) - grid, axis=-1).sum())
    assert abs(costs[0] - costs[1]) <= 1e-4 * costs[1], costs


def test_board_points_and_too_few_candidates():
    np.testing.assert_array_equal(tcb.board_points((5, 7), 0.04), jcb.board_points((5, 7), 0.04))
    grid, ok = tcb.order_grid(np.zeros((3, 2), np.float32), (5, 7))
    assert not ok and grid.shape == (35, 2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-CUDA path")
def test_numpy_inputs_need_cuda_or_cpu():
    board, obs = _obs("pinhole")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcal.calibrate_planar(board, obs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcb.detect_chessboard(_axis_aligned(), (tch.ROWS, tch.COLS))
