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
from test_torch_kernels_cuda import wrap_scene


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


# ---------------------------------------------------------------------------
# A numpy replay of K3's schedule (csrc/stereo_bm.cu): strips, bands, the row
# ring, fill steps, per-thread column and disparity-slot ownership, the slots
# with d >= nd held at DEAD, the x >= d masks, the texture wrap at x = 0, the
# one-round horizontal sums and the 4-lane one-pass winner. It checks the design on the CPU; the card tests in
# test_torch_kernels_cuda.py check the kernel itself.
# ---------------------------------------------------------------------------

_CW, _G, _LANES, _SEG, _BIG, _DEAD = 64, 4, 4, 16, np.float32(1e3), np.float32(1e30)


def _pick_band(H, blocks_per_band_row, sms, max_band=40, min_band=16):
    """The launch's band height: the most even split of H into bands of at
    most max_band rows, max_band halved (to min_band at least) while the
    grid would have fewer blocks than the card has SMs."""
    while True:
        bands = -(-H // max_band)
        band = -(-H // bands)
        if -(-H // band) * blocks_per_band_row >= sms or max_band <= min_band:
            return band
        max_band = max(min_band, max_band // 2)


def _k3_block(L, R, x0, y0, y_end, nd, block, uniq, tex, J, disp, valid):
    """One thread block of K3: strip x0, output rows y0 .. y_end - 1."""
    H, W = L.shape
    h = block // 2
    nc, slots, ds = _CW + 2 * h, block + 1, _G * J
    slot = 2 * nc + nd + 1
    # ring element e: L columns x0-h-1 .., L column W-1, R columns x0-h-(nd-1) ..
    e = np.arange(slot)
    src_img = np.where(e <= nc + 1, 0, 1)
    src_x = np.where(e <= nc, x0 - h - 1 + e, np.where(e == nc + 1, W - 1, x0 - h - (nd - 1) + e - nc - 2))
    src_ok = (src_x >= 0) & (src_x < W)
    images = np.stack([L, R])
    ring = np.full((slots, slot), np.nan, np.float32)  # an unwritten read shows as NaN

    t = np.arange(nc * _G)
    c, g = t % nc, t // nc
    x = x0 - h + c
    col_in = (x >= 0) & (x < W)
    jlive = np.where(g < nd, (nd - 1 - g) // _G + 1, 0)
    jge = np.where(x < g, 0, np.minimum(jlive, (x - g) // _G + 1))
    jj = np.arange(J)
    masked = jge < jlive  # the thread takes the masked path: some live slot has x < d
    big = masked[:, None] & (jj[None, :] >= jge[:, None])  # ... where slots j >= jge add BIG
    rix = (nc + 2 + c + nd - 1 - g)[:, None] - _G * jj[None, :]
    assert rix.min() >= 0 and rix.max() < slot
    tix = np.where(x == 0, nc + 1, c)
    acc = np.where(jj[None, :] < jlive[:, None], np.float32(0), _DEAD).astype(np.float32)
    tacc = np.zeros(len(t), np.float32)
    colsum = np.zeros((nc, ds + 1), np.float32)  # column c, slot d; the texture sum at ds
    d_of = g[:, None] + _G * jj[None, :]
    tex_own = col_in & (g == 0)

    for y in range(max(y0 - 2 * h, -h), y_end):
        r_in, r_out = y + h, y - h - 1
        add = r_in < H
        sub = r_out >= 0 and r_out >= y0 - h
        if add:
            ring[r_in % slots] = np.where(src_ok, images[src_img, r_in, np.clip(src_x, 0, W - 1)], 0)
        s_in, s_out = ring[r_in % slots], ring[(r_out + slots) % slots]
        a = np.where(big, _BIG, np.abs(s_in[c + 1][:, None] - s_in[rix]))
        b = np.where(big, _BIG, np.abs(s_out[c + 1][:, None] - s_out[rix]))
        v = a - b if add and sub else a if add else -b if sub else np.zeros_like(a)
        acc[col_in] += v[col_in]
        if add:
            tacc[tex_own] += np.abs(s_in[c + 1] - s_in[tix])[tex_own]
        if sub:
            tacc[tex_own] -= np.abs(s_out[c + 1] - s_out[tix])[tex_own]
        if y < y0:
            continue
        colsum[np.broadcast_to(c[:, None], d_of.shape)[col_in], d_of[col_in]] = acc[col_in]
        colsum[c[tex_own], ds] = tacc[tex_own]

        # horizontal: (d, 16-column segment) running sums, one round
        cost = np.zeros((_CW, ds + 1), np.float32)
        for xs in range(0, _CW, _SEG):
            s = np.zeros(ds + 1, np.float32)
            for k in range(2 * h + 1):
                s += colsum[xs + k]
            cost[xs] = s
            for j in range(1, _SEG):
                s += colsum[xs + j + 2 * h] - colsum[xs + j - 1]
                cost[xs + j] = s
        _k3_winner(cost, x0, y, nd, ds, uniq, tex, J, disp, valid)


def _k3_winner(cost, x0, y, nd, ds, uniq, tex, J, disp, valid):
    """Lane l of a pixel holds d = l + 4k: its first minimum m1 at k1 and the
    minimum m2 of its other slots; the lanes merge (lower d on ties); the
    second best outside +-1 of the winner is m2 of the lane whose slot k1
    is excluded, else m1."""
    W = disp.shape[1]
    lanes = np.arange(_LANES)
    dk = lanes[:, None] + _LANES * np.arange(J)[None, :]  # (lanes, J)
    cv = cost[:, dk]  # (CW, lanes, J)
    k1 = cv.argmin(axis=2)  # first minimum
    m1 = np.take_along_axis(cv, k1[..., None], 2)[..., 0]
    others = np.where(np.arange(J)[None, None, :] == k1[..., None], np.inf, cv)
    m2 = others.min(axis=2)
    d1 = lanes[None, :] + _LANES * k1
    best = m1.min(axis=1)
    bidx = np.where(m1 == best[:, None], d1, ds).min(axis=1)
    dx = bidx[:, None] - 1 + ((lanes[None, :] - bidx[:, None] + 1) & (_LANES - 1))
    second = np.where((dx <= bidx[:, None] + 1) & (dx == d1), m2, m1).min(axis=1)
    d0 = np.clip(bidx, 1, nd - 2)
    px = np.arange(_CW)
    cm, cc, cp = cost[px, d0 - 1], cost[px, d0], cost[px, d0 + 1]
    denom = np.maximum(cm - np.float32(2) * cc + cp, np.float32(1e-6))
    delta = np.clip(np.float32(0.5) * (cm - cp) / denom, -1, 1).astype(np.float32)
    xw = x0 + px
    ok = (best < np.float32(uniq) * second) & (cost[:, ds] > tex) & (bidx > 0) & (bidx < nd - 1) & (xw >= nd)
    w = xw < W
    disp[y, xw[w]] = d0[w] + delta[w]
    valid[y, xw[w]] = ok[w]


def k3_schedule_model(left, right, num_disp, block, sms, uniqueness=0.85, texture_thresh=0.5):
    """K3's launch and blocks replayed in numpy; returns (disparity, valid)."""
    B, H, W = left.shape
    J = next(j for j in (4, 8, 16, 32) if _G * j >= num_disp)
    strips = -(-W // _CW)
    band = _pick_band(H, strips * B, sms)
    disp = np.full((B, H, W), np.nan, np.float32)
    valid = np.zeros((B, H, W), bool)
    for b in range(B):
        for s in range(strips):
            for y0 in range(0, H, band):
                _k3_block(left[b], right[b], s * _CW, y0, min(y0 + band, H), num_disp, block,
                          uniqueness, texture_thresh, J, disp[b], valid[b])
    return disp, valid


@pytest.mark.parametrize(
    "B,H,W,nd,block,sms,shift",
    [
        (2, 41, 130, 37, 11, 132, 5),   # 41 rows: a partial band; nd % G != 0; a 2-column strip
        (1, 83, 100, 16, 7, 1, 5),      # 3 bands of <= 28 rows, no halving
        (1, 9, 50, 16, 11, 132, 5),     # H below the block, W below one strip
        (1, 40, 90, 24, 31, 132, 5),    # block 31
        (1, 20, 140, 128, 5, 132, 5),   # J = 32
        (1, 24, 40, 3, 5, 132, 5),      # nd = 3: lane 3 and group 3 hold no disparity
        (3, 36, 70, 8, 21, 4, 5),       # valid pixels at x <= 10 whose texture reads column W - 1
        (1, 30, 120, 37, 9, 132, 45),   # the true shift lies among the slots with d >= nd
    ],
)
def test_k3_schedule_model_matches_plain(B, H, W, nd, block, sms, shift):
    """Integer images: every running sum is exact in f32, so masks are equal
    and disparities agree to 1e-5 everywhere. The nd = 8 case also runs
    with L(W - 1) = L(0), where the wrap term is 0 and the same pixels fail
    the texture test."""
    rng = np.random.default_rng(H * W + nd)
    left, right = wrap_scene(rng, B, H, W, shift)
    scenes = [left]
    if nd == 8:
        scenes.append(left.copy())
        scenes[1][..., W - 1] = left[..., 0]
    masks = []
    for im in scenes:
        dm, vm = k3_schedule_model(im, right, nd, block, sms)
        dp, vp = ts.block_match(torch.from_numpy(im), torch.from_numpy(right), num_disp=nd, block=block)
        np.testing.assert_array_equal(vm, vp.numpy())
        assert not np.isnan(dm).any()
        np.testing.assert_allclose(dm, dp.numpy(), rtol=0, atol=1e-5)
        masks.append(vm)
    if nd == 8:  # the case reaches the wrap
        assert (masks[0] != masks[1]).any()


@pytest.mark.parametrize(
    "H,per,sms,band",
    [(240, 40, 132, 40), (240, 5, 132, 16), (240, 5, 60, 20), (41, 1, 1, 21), (83, 3, 1, 28),
     (9, 1, 132, 9), (480, 40, 132, 40)],
)
def test_k3_band_height(H, per, sms, band):
    """40-row bands at the main shape (8 images x 5 strips: 240 blocks),
    halved to 20 and then 16 rows while the grid is short of SMs."""
    assert _pick_band(H, per, sms) == band


@pytest.mark.parametrize(
    "num_disp,block,match",
    [(129, 21, "num_disp <= 128"), (64, 195, "at most 1024 threads")],
)
def test_cuda_wrapper_limits(num_disp, block, match):
    """K3's limits are checked before the device: 128 disparities, and
    (64 + 2 (block // 2)) x 4 <= 1024 threads (block 193 is the largest)."""
    x = torch.zeros((1, 32, 64))
    with pytest.raises(ValueError, match=match):
        stereo_kernel.block_match_cuda(x, x, num_disp=num_disp, block=block)
