"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and ``nvcc`` (the kernels build on first use), so
they carry the ``cuda`` marker and skip elsewhere. On a machine with a GPU:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

They cover the shapes the main path never gives the kernels (ragged N, a DB
below one TMA box, Q across 64-query tiles, D below one TMA chunk and with a
ragged last chunk,
exact duplicate rows across tile and block edges, banned lists of 1 and 8
gids, every top-k list size, heights that are no multiple of the row band,
narrow and wide images, nd at the kernel's limit, small and large blocks,
the texture wrap at x = 0, more blocks than the card holds at once, float
images, a DB of a descriptor width that is no multiple of 8, stored
padded), the int8 DB's ``torch._int_mm`` search against the plain int8
product, and the in-framework descriptor net on the card against the CPU;
chip_smoke.py covers the main path's. Three tests hold
properties
of the plain PyTorch code on the card: the feature filters give the same
matches whatever cuDNN's TF32 flag says, a pose-graph solve gives the same
bits twice, and the rectifier's maps built on the card match the CPU's.
"""

import numpy as np
import pytest
import torch

from cerebro_tpu_torch.geometry import stereo
from cerebro_tpu_torch.ops import similarity as sim
from cerebro_tpu_torch.ops import stereo_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit_db(cuda, rng, N, D):
    db = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(cuda)
    return torch.nn.functional.normalize(db, dim=1).to(torch.bfloat16)


# Q: one query, a ragged tile of 16, one full 64-query tile, and 64-query
# tiles on grid axis y with 1 and 2 queries over. D: below one 64-column
# TMA chunk, a ragged last chunk (200 = 3 x 64 + 8), the main width.
_QS = [1, 9, 64, 65, 130]
_DS = [8, 200, 8192]


@pytest.mark.parametrize("Q", _QS)
@pytest.mark.parametrize("D", _DS)
def test_k1_matches_plain(cuda, Q, D):
    N = 1000 + 37 * Q
    rng = np.random.default_rng(Q * N + D)
    db = _unit_db(cuda, rng, N, D)
    rows = rng.integers(0, N, Q)
    q = db[torch.from_numpy(rows).to(cuda)].float()  # planted: no near-ties
    gids = torch.from_numpy(((np.arange(N) + N // 3) % N).astype(np.int32)).to(cuda)
    lim = torch.from_numpy(rng.integers(0, N + 1, Q).astype(np.int32)).to(cuda)
    lim[0] = 0  # all masked
    km, kg = sim.max_and_argmax(q, db, lim, gids)
    pm, pg = sim.max_and_argmax_plain(q, db, lim, gids)
    assert torch.equal(kg, pg)
    # f32 sums of bf16 products in another order: 1e-3 on unit vectors
    torch.testing.assert_close(km, pm, atol=1e-3, rtol=0)
    assert bool(km[0] == sim.NEG_INF) and int(kg[0]) == int(gids[0])


def test_k1_rejects_unaligned_dim(cuda):
    q = torch.zeros((2, 12), device=cuda)
    db = torch.zeros((5, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D % 8"):
        sim.max_and_argmax(q, db, torch.ones(2, dtype=torch.int32, device=cuda))


def _k2_case(cuda, Q, N, D, KB, seed):
    """A ring-wrapped DB with planted queries, random limits (some windows
    empty or short) and banned lists: each query's planted gid, gids absent
    from the DB, inert -1 slots."""
    rng = np.random.default_rng(seed)
    db = _unit_db(cuda, rng, N, D)
    rows = rng.integers(0, N, Q)
    q = db[torch.from_numpy(rows).to(cuda)].float()
    g = ((np.arange(N) + N // 3) % N).astype(np.int32)
    lim = rng.integers(0, N + 1, Q).astype(np.int32)
    lim[0] = 0  # all masked
    banned = np.full((Q, KB), -1, np.int32)
    banned[:, 0] = np.where(rng.random(Q) < 0.5, g[rows], N + 5)  # planted, or absent
    if KB > 1:
        banned[:, 1:] = rng.integers(-1, N, (Q, KB - 1))
    return (q, db, torch.from_numpy(lim).to(cuda), torch.from_numpy(g).to(cuda),
            torch.from_numpy(banned).to(cuda))


@pytest.mark.parametrize("Q", _QS)
@pytest.mark.parametrize("D", _DS)
def test_k2_matches_plain(cuda, Q, D):
    KB = 8 if Q % 2 else 1
    N = 1000 + 37 * Q
    q, db, lim, gids, banned = _k2_case(cuda, Q, N, D, KB, seed=Q * N + D + KB)
    km, kg = sim.max_and_argmax_banned_cuda(q, db, lim, gids, banned)
    pm, pg = sim.max_and_argmax_banned_plain(q, db, lim, gids, banned)
    assert torch.equal(kg, pg)
    # f32 sums of bf16 products in another order: 1e-3 on unit vectors
    torch.testing.assert_close(km, pm, atol=1e-3, rtol=0)
    assert bool(km[0] == sim.NEG_INF) and int(kg[0]) == int(gids[0])


@pytest.mark.parametrize("N", [1, 5, 31])
@pytest.mark.parametrize("Q,D,KB", [(1, 8, 1), (9, 200, 8)])
def test_k1_and_banned_on_db_below_one_box(cuda, N, Q, D, KB):
    """A DB smaller than one 32-row TMA box: one block owns one partial
    tile. K1, the banned argmax and a top-k of every row against their
    plain versions; the single query of Q=1 sees every row."""
    q, db, lim, gids, banned = _k2_case(cuda, Q, N, D, KB, seed=N * Q + D)
    if Q == 1:
        lim[0] = N
    for kernel, plain, extra in (
        (sim.max_and_argmax_cuda, sim.max_and_argmax_plain, ()),
        (sim.max_and_argmax_banned_cuda, sim.max_and_argmax_banned_plain, (banned,)),
    ):
        km, kg = kernel(q, db, lim, gids, *extra)
        pm, pg = plain(q, db, lim, gids, *extra)
        assert torch.equal(kg, pg)
        torch.testing.assert_close(km, pm, atol=1e-3, rtol=0)
    k = min(N, 8)
    kv, ki = sim.search_topk_cuda(q, db, lim, gids, k=k)
    pv, pi = sim.search_topk_plain(q, db, lim, gids, k=k)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, atol=1e-3, rtol=0)


@pytest.mark.parametrize("edge", ["tile", "block"])
def test_duplicate_rows_across_edges_score_alike(cuda, edge):
    """Exact copies of a DB row on both sides of a tile edge (inside a
    block) or of a block edge score bit-identically, and the lower row wins:
    K1, the banned argmax with the lower copy banned, and both copies in
    row order in the top-k."""
    N, D = 50_000, 256
    rpb, _ = sim.row_blocks(N, cuda)
    e = 3 * rpb + sim.TILE_ROWS if edge == "tile" else 5 * rpb
    assert (e % rpb != 0) == (edge == "tile")
    rng = np.random.default_rng(e)
    db = _unit_db(cuda, rng, N, D)
    db[e - 1] = db[e]
    q = db[[e, 7]].float()
    gids = torch.arange(N, dtype=torch.int32, device=cuda) + 11
    lim = torch.full((2,), N + 11, dtype=torch.int32, device=cuda)
    _, kg = sim.max_and_argmax(q, db, lim, gids)
    assert int(kg[0]) == e - 1 + 11
    banned = torch.tensor([[e - 1 + 11], [-1]], dtype=torch.int32, device=cuda)
    _, bg = sim.max_and_argmax_banned(q, db, lim, gids, banned)
    assert int(bg[0]) == e + 11
    tv, ti = sim.search_topk(q, db, lim, gids, k=3)
    assert ti[0, :2].tolist() == [e - 1 + 11, e + 11]
    assert float(tv[0, 0]) == float(tv[0, 1])
    pv, pi = sim.search_topk_plain(q, db, lim, gids, k=3)
    assert torch.equal(ti, pi)


@pytest.mark.parametrize("KB", [1, 8])
def test_five_rows_top5_and_all_masked(cuda, KB):
    """N = k = 5: every row fills a slot, masked ones after the real hits;
    an all-masked query gives all five rows at NEG_INF in row order; the
    banned argmax with KB gids agrees with its plain version."""
    q, db, lim, gids, banned = _k2_case(cuda, 3, 5, 64, KB, seed=KB)
    lim[1] = int(gids.min()) + 2  # two matchable rows
    kv, ki = sim.search_topk(q, db, lim, gids, k=5)
    pv, pi = sim.search_topk_plain(q, db, lim, gids, k=5)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, atol=1e-3, rtol=0)
    assert ki[0].tolist() == gids.tolist() and bool((kv[0] == sim.NEG_INF).all())
    km, kg = sim.max_and_argmax_banned(q, db, lim, gids, banned)
    pm, pg = sim.max_and_argmax_banned_plain(q, db, lim, gids, banned)
    assert torch.equal(kg, pg)
    torch.testing.assert_close(km, pm, atol=1e-3, rtol=0)


@pytest.mark.parametrize("Q,N,D,k", [(8, 600, 64, 3), (17, 2000, 128, 5), (5, 40, 8192, 5)])
def test_search_topk_cuda_matches_plain_on_every_slot(cuda, Q, N, D, k):
    """One K2 launch equals the plain dense top-k on every slot, including
    queries with fewer than k matchable rows."""
    q, db, lim, gids, _ = _k2_case(cuda, Q, N, D, 1, seed=Q + N + k)
    lim[1:4] = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda)  # 1, 2, 3 rows
    kv, ki = sim.search_topk(q, db, lim, gids, k=k)
    pv, pi = sim.search_topk_plain(q, db, lim, gids, k=k)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, atol=1e-3, rtol=0)
    assert bool((kv <= sim.NEG_INF / 2).any())


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 32])
def test_search_topk_every_list_size(cuda, k):
    """Every instantiated K, and k rounded up to the next one (9 -> 16,
    17 -> 32), on every slot against the plain dense top-k; one launch of
    K2 per call."""
    q, db, lim, gids, _ = _k2_case(cuda, 10, 3000, 128, 1, seed=k)
    lim[1:4] = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda)
    before = sim.K2.launches
    kv, ki = sim.search_topk(q, db, lim, gids, k=k)
    assert sim.K2.launches == before + 1 and ki.shape == (10, k)
    pv, pi = sim.search_topk_plain(q, db, lim, gids, k=k)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, atol=1e-3, rtol=0)


def test_search_topk_rejects_k_above_largest_size(cuda):
    q, db, lim, gids, _ = _k2_case(cuda, 2, 100, 64, 1, seed=0)
    with pytest.raises(ValueError, match=f"largest top-k size, {sim.MAX_TOPK}"):
        sim.search_topk(q, db, lim, gids, k=sim.MAX_TOPK + 1)


def wrap_scene(rng, B, H, W, shift=5):
    """Integer-valued images, random with a shift of `shift` columns, but
    for a strip-0 scene where the texture test passes only through the
    wrap term |L(0) - L(W - 1)| (x = 0 reads column W - 1): L is flat (100)
    on columns 0..31 and 101 on column W - 1; R is 100 there too, except
    columns 18 and 19 at 5100, so pixel x = 9 (block 21, nd 8) matches
    uniquely at d = 2 (costs per row: d 0: 10,000, d 1: 6,000, d 2: 2,000,
    d 3: 3,000, ...: 1,000 for each column of the box with x < d). Every
    box sum stays below 2^24, exact in f32."""
    base = rng.integers(0, 256, (B, H, W + shift)).astype(np.float32)
    left, right = base[..., :-shift].copy(), base[..., shift:].copy()
    left[..., :32] = 100.0
    left[..., W - 1] = 101.0
    right[..., :32] = 100.0
    right[..., 18:20] = 5100.0
    return left, right


# The main shape; heights that are no multiple of the band (241: a partial
# last band; 37, 41); W below one strip (63) and a ragged last strip; nd not
# a multiple of the 4 disparity groups (37) and at the kernel's limit (128,
# J = 32); block 5 and 31; strip 0 whose texture term reads column W - 1;
# a grid of 768 blocks, more than the card holds at once (3 per SM); a true
# disparity beyond nd.
@pytest.mark.parametrize(
    "B,H,W,nd,block,scene",
    [(1, 37, 200, 32, 11, "shift"), (3, 96, 256, 32, 11, "shift"), (2, 240, 320, 64, 21, "shift"),
     (1, 20, 2100, 16, 5, "shift"), (1, 50, 100, 16, 31, "shift"), (1, 241, 320, 64, 21, "shift"),
     (2, 41, 200, 32, 11, "shift"), (1, 96, 63, 16, 9, "shift"), (2, 60, 150, 37, 11, "shift"),
     (1, 64, 300, 128, 15, "shift"), (3, 36, 70, 8, 21, "wrap"), (128, 96, 128, 64, 21, "shift"),
     (1, 30, 120, 37, 9, "far")],
)
def test_k3_matches_plain(cuda, B, H, W, nd, block, scene):
    """Integer images shifted by 9 columns ("far": by 45, beyond nd, so the
    kernel's slots with d >= nd see the true match and must not win)."""
    rng = np.random.default_rng(H * W)
    if scene == "wrap":
        left, right = wrap_scene(rng, B, H, W)
    else:
        shift = 45 if scene == "far" else 9
        base = rng.integers(0, 256, (B, H, W + shift)).astype(np.float32)
        left, right = base[..., :-shift].copy(), base[..., shift:].copy()
    L = torch.from_numpy(left).to(cuda)
    R = torch.from_numpy(right).to(cuda)
    dk, vk = stereo_kernel.block_match(L, R, num_disp=nd, block=block)
    dp, vp = stereo.block_match(L, R, num_disp=nd, block=block)
    # integer images: every box sum is exact in f32, whatever the order
    assert torch.equal(vk, vp)
    both = vk & vp
    assert bool(both.any())
    assert float((dk - dp).abs()[both].max()) <= 1e-5
    if scene == "wrap":  # pixels x <= 10 pass the texture test through L(W - 1)
        assert bool(vk[..., nd:11].any())


def test_k3_float_images_match_plain(cuda):
    """Smooth float images: the running sums round differently from the
    plain version's convolutions, so (as chip_smoke holds K3) masks agree on
    >= 99.9% of pixels and |disparity difference| <= 1e-3 where both are
    valid."""
    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.normal(0.0, 40.0, (4, 1, 240, 340)).astype(np.float32)).to(cuda)
    base = torch.nn.functional.avg_pool2d(base, 3, stride=1, padding=1)[:, 0] + 128.0
    L, R = base[..., :320].contiguous(), base[..., 13:333].contiguous()
    dk, vk = stereo_kernel.block_match(L, R, num_disp=64, block=21)
    dp, vp = stereo.block_match(L, R, num_disp=64, block=21)
    assert float((vk == vp).float().mean()) >= 0.999
    both = vk & vp
    assert int(both.sum()) > 0.3 * both.numel()
    assert float((dk - dp).abs()[both].max()) <= 1e-3


def test_k3_rejects_num_disp_above_limit(cuda):
    x = torch.zeros((1, 32, 64), device=cuda)
    before = stereo_kernel.K3.launches
    with pytest.raises(ValueError, match="128"):
        stereo_kernel.block_match(x, x, num_disp=129, block=21)
    assert stereo_kernel.K3.launches == before


def _textured(rng, H=240, W=320):
    """A smooth random texture with corners at several scales, as 8-bit
    levels in f32 (the pipeline's images)."""
    img = np.zeros((H, W), np.float32)
    for scale, amp in ((4, 0.5), (16, 1.0), (48, 2.0)):
        small = rng.normal(size=(H // scale + 1, W // scale + 1)).astype(np.float32)
        img += amp * np.kron(small, np.ones((scale, scale), np.float32))[:H, :W]
    img = (img - img.min()) / (img.max() - img.min())
    return np.round(img * 255.0).astype(np.float32)


def test_feature_matching_ignores_tf32_flag(cuda):
    """PyTorch's default lets cuDNN convolutions round f32 inputs to TF32.
    The matchers' filters (Sobel, box and GMS sums) are single-channel
    cuDNN convolutions, for which cuDNN picks no TF32 algorithm: keypoints
    and matches are the same bits with the flag on (the default) and off."""
    from cerebro_tpu_torch.ops import features

    rng = np.random.default_rng(5)
    base = _textured(rng, 260, 340)
    a = torch.from_numpy(np.ascontiguousarray(base[:240, :320])).to(cuda)
    b = torch.from_numpy(np.ascontiguousarray(base[12:252, 9:329])).to(cuda)
    banks = (0.5, 0.70710678, 1.0, 1.41421356)
    runs = {
        "harris": lambda: features.harris_corners_pyramid(a, max_kp=1024)[0].xy,
        "steerable": lambda: features.match_image_pair_steerable(a, b, gms_factor=4.0).valid,
        "gather_tier1": lambda: features.match_image_pair(a, b, gms_factor=4.0, oriented=True).valid,
        "gather_tier2": lambda: features.match_image_pair(
            a, b, gms_factor=4.0, oriented=True, scales=banks
        ).valid,
    }
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        on = {k: f() for k, f in runs.items()}
        torch.backends.cudnn.allow_tf32 = False
        off = {k: f() for k, f in runs.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for k in runs:
        assert torch.equal(on[k], off[k]), k
    assert int(on["steerable"].sum()) > 50 and int(on["gather_tier2"].sum()) > 50


def test_pose_graph_solve_is_bit_reproducible(cuda):
    """Two solves of one graph give the same bits (J^T sums in a fixed
    order; an index_add_ would add with atomics in any order)."""
    from cerebro_tpu_torch.config import PoseGraphConfig
    from cerebro_tpu_torch.posegraph import optimizer as opt

    rng = np.random.default_rng(0)
    n = 400
    t = np.linspace(0, 4 * np.pi, n)
    gt = np.stack([8 * np.cos(t), 8 * np.sin(t), 0.1 * np.sin(3 * t), t + np.pi / 2], -1)
    odo = np.diff(gt, axis=0) + rng.normal(0, [0.02, 0.02, 0.005, 0.004], (n - 1, 4))
    x0 = np.concatenate([gt[:1], gt[:1] + np.cumsum(odo, 0)]).astype(np.float32)
    li = np.arange(0, n // 2, 5)
    lj = li + n // 2  # the second lap revisits the first
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    T = opt.poses_from_xyzyaw(torch.from_numpy(gt.astype(np.float32)))
    meas = lambda i, j: opt.relative_yaw_t(T[i], T[j]).numpy()
    graph = opt.PoseGraph(
        xyzyaw=f(x0), node_valid=f(np.ones(n, bool)),
        odo_i=f(np.arange(n - 1)), odo_j=f(np.arange(1, n)), odo_meas=f(meas(np.arange(n - 1), np.arange(1, n))),
        odo_valid=f(np.ones(n - 1, bool)),
        loop_i=f(li), loop_j=f(lj), loop_meas=f(meas(li, lj)), loop_valid=f(np.ones(len(li), bool)),
    )
    cfg = PoseGraphConfig()
    x1, s1, c1 = opt.optimize(graph, cfg)
    x2, s2, c2 = opt.optimize(graph, cfg)
    assert torch.equal(x1, x2) and torch.equal(s1, s2) and torch.equal(c1, c2)
    assert float((x1 - graph.xyzyaw).abs().max()) > 1e-2  # the solve moved the states


@pytest.mark.parametrize("D", [15, 191, 200])
def test_k1_and_topk_on_padded_db(cuda, D):
    """A CUDA DB of width D stores rows zero-padded to a multiple of 8 and
    detection pads its queries alike (db/descriptors.py): K1 and a top-3
    search_topk on it give the plain version's gids on every slot, on the
    unpadded rows."""
    from cerebro_tpu_torch.db import descriptors as ddb

    rng = np.random.default_rng(D)
    N, Q = 700, 9
    db = ddb.create(N, D, device=cuda)
    assert db.dim == D and db.vectors.shape[1] == -(-D // 8) * 8
    rows = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(N + 100, D)).astype(np.float32)), dim=1
    ).to(cuda)
    for i in range(0, N + 100, 100):  # past capacity: the ring wraps
        ddb.append(db, rows[i : i + 100], 100)
    assert bool((db.vectors[:, D:] == 0).all())
    q = rows[torch.from_numpy(rng.integers(100, N + 100, Q)).to(cuda)]
    lim = torch.from_numpy(rng.integers(100, N + 101, Q).astype(np.int32)).to(cuda)
    lim[1] = 101  # one matchable row: top-3 fills two slots
    flat = db.vectors[:, :D]
    km, kg = sim.max_and_argmax(ddb.pad_queries(db, q), db.vectors, lim, db.global_ids)
    pm, pg = sim.max_and_argmax_plain(q, flat, lim, db.global_ids)
    assert torch.equal(kg, pg)
    torch.testing.assert_close(km, pm, atol=1e-3, rtol=0)
    kv, ki = sim.search_topk(ddb.pad_queries(db, q), db.vectors, lim, db.global_ids, k=3)
    pv, pi = sim.search_topk_plain(q, flat, lim, db.global_ids, k=3)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, atol=1e-3, rtol=0)


def test_pipeline_with_unaligned_wpca_detects(cuda, tmp_path):
    """gist -> WPCA to 15 dims on the card: the DB holds 15 logical columns
    in 16-wide rows and each detect batch launches K1 once."""
    from cerebro_tpu_torch import config as C
    from cerebro_tpu_torch.models import gist, wpca
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (40, 32, 64), dtype=np.uint8)
    bank = gist.gist_descriptors(torch.from_numpy(imgs).to(cuda), dim=128).cpu().numpy()
    path = str(tmp_path / "wpca.npz")
    wpca.save_wpca(wpca.fit_wpca(bank, out_dim=15), path)
    cfg = C.CerebroConfig(
        descriptor=C.DescriptorConfig(
            image_hw=(32, 64), kind="gist", num_clusters=1, trunk_dim=128, wpca_artifact=path,
        ),
        loop=C.LoopConfig(db_capacity=128, exclusion_window=2),
        runtime=C.RuntimeConfig(descriptor_batch=4, stash_dir=""),
    )
    pipe = CerebroPipeline(cfg, device="cuda")
    assert pipe.db.dim == 15 and pipe.db.vectors.shape[1] == 16
    before = sim.K1.launches
    for t in range(12):
        pipe.ingest_frame(float(t), imgs[t % 6], n_tracked=50)
    pipe.flush_descriptors()
    assert sim.K1.launches - before == pipe.timer.stats()["detect"]["count"] == 3
    norms = pipe.db.vectors[:12].float().norm(dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms), atol=5e-3, rtol=0)
    pipe.close()


def test_rectifier_maps_built_on_the_card_match_the_cpu(cuda):
    """StereoRectifier's maps built on the card equal the CPU-built ones
    within 1e-3 px (cuBLAS and the CPU sum the 3x3 rotation in another
    order), on the bundled EuRoC rig at 480x752."""
    import os

    from cerebro_tpu_torch.io.rig_config import load_rig_config

    spec = load_rig_config(os.path.join(
        os.path.dirname(__file__), "..", "configs", "euroc", "euroc_stereo_config.yaml"
    ))
    T = spec.c1_T_c0.astype(np.float32)
    on_card = stereo.StereoRectifier(spec.cam0, spec.cam1, T, spec.image_hw, device="cuda")
    on_cpu = stereo.StereoRectifier(spec.cam0, spec.cam1, T, spec.image_hw, device="cpu")
    np.testing.assert_allclose(on_card.map0, on_cpu.map0, atol=1e-3, rtol=0)
    np.testing.assert_allclose(on_card.map1, on_cpu.map1, atol=1e-3, rtol=0)


@pytest.mark.parametrize("Q,N,D", [(1, 1024, 64), (8, 29184, 8192), (17, 2048, 4096), (64, 512, 200)])
def test_int8_search_matches_plain(cuda, Q, N, D):
    """max_and_argmax_int8 on CUDA tensors (one torch._int_mm, the queries
    padded to 24+ rows; D = 200 stored padded to 208) against the plain
    exact product (f64) on the same card: gids equal, maxima within 1e-6."""
    from cerebro_tpu_torch.db import descriptors as ddb

    rng = np.random.default_rng(Q + N)
    vecs = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(cuda)
    vecs = torch.nn.functional.normalize(vecs, dim=1)
    db = ddb.create_quantized(N, D, device=cuda)
    ddb.append_quantized(db, vecs, N)
    rows = torch.from_numpy(rng.integers(0, N, Q)).to(cuda)
    q = ddb.pad_queries(db, vecs[rows])
    lim = torch.from_numpy(rng.integers(1, N + 1, Q).astype(np.int32)).to(cuda)
    before = sim.INT8_MM.launches
    km, kg = sim.max_and_argmax_int8(q, db.values, db.scales, lim, db.global_ids)
    assert sim.INT8_MM.launches == before + 1
    pm, pg = sim.max_and_argmax_int8_plain(q, db.values, db.scales, lim, db.global_ids)
    assert torch.equal(kg, pg)
    torch.testing.assert_close(km, pm, atol=1e-6, rtol=0)


@pytest.mark.parametrize("tf32", [False, True], ids=["tf32_off", "tf32_on"])
@pytest.mark.parametrize("variant", [{}, {"backbone": "vgg16"}, {"num_ghost": 2}])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_netvlad_net_on_the_card_matches_the_cpu(cuda, variant, dtype, tf32):
    """The seeded DescriptorNet at 240x320 on the card against the same
    params on the CPU: float32 within 1e-4 on unit descriptors, bfloat16
    (bf16 cuDNN convolutions) to a cosine of 0.995. Each with the caller's
    TF32 flags for cuDNN and matmul off, and on (cuDNN's is on by PyTorch's
    default): a float32 net turns TF32 off for its own products, and leaves
    the caller's flags as they were."""
    from cerebro_tpu_torch.config import DescriptorConfig
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model, describe_batch

    cfg = DescriptorConfig(dtype=dtype, **variant)
    net, params = create_descriptor_model(cfg, seed=0, device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 240, 320, 1), dtype=np.uint8))
    want = describe_batch(net, params, imgs)
    net, params = net.to(cuda), {k: v.to(cuda) for k, v in params.items()}
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        got = describe_batch(net, params, imgs.to(cuda)).cpu()
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert flags == (tf32, tf32)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        assert float((got * want).sum(dim=1).min()) >= 0.995


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["descriptor_64x64_trunk16_batch8_seeded",
                                  "keypoints_default_batch2_seeded",
                                  "descriptor_240x320_trunk64_batch8_synth_npz_places"])
def test_f32_train_gradients_on_the_card_match_the_cpu(cuda, case):
    """A float32 train loss's gradient on the card, with the caller's TF32
    flags on for cuDNN and matmul, against the CPU, and against the card's
    own with the caller's flags off, on chip_smoke.py's (d) cases and by its
    procedure and bounds (``train_grad_case``, ``grads_card_vs_cpu``,
    ``train_grads_hold``): the loss within 1e-4 relative; each gradient
    tensor within 1e-4 of its norm plus 1e-6 of the whole gradient's on the
    CPU parity tests' batches, and at the artifact's 240x320 within twice
    the change a 1e-7 relative move of the input makes on the CPU (at least
    1e-4, at most 1e-3); TF32 on against off within 1e-5 (the step holds
    TF32 off over the forward and the backward; cuDNN allows TF32 by
    default, and a leak would show at ~1e-3); the caller's flags left as
    they were."""
    cs = _chip_smoke()
    r = cs.grads_card_vs_cpu(cuda, *cs.train_grad_case(case))
    assert cs.train_grads_hold(r), r


def test_train_step_on_the_card_advances_its_state(cuda):
    """A bf16 descriptor train step on the card: the state stays on the
    card, the step and Adam's count advance, the loss is finite."""
    from cerebro_tpu_torch.config import DescriptorConfig
    from cerebro_tpu_torch.models.descriptor import create_descriptor_model
    from cerebro_tpu_torch.train import create_train_state, train_step

    cfg = DescriptorConfig(image_hw=(96, 128), trunk_dim=32, num_clusters=4)
    net, params = create_descriptor_model(cfg, seed=0, device=cuda)
    state, tx = create_train_state(params, lr=1e-3)
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 96, 128, 1), dtype=np.uint8))
    y = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], dtype=torch.int32, device=cuda)
    for i in range(2):
        state, loss = train_step(net, tx, state, x.to(cuda), y)
        assert torch.isfinite(loss) and loss.is_cuda
    assert int(state.step) == 2 and int(state.opt_state.count) == 2
    assert all(v.is_cuda for v in state.params.values())


def test_detect_keypoints_on_the_card_matches_the_cpu(cuda):
    """The seeded f32 keypoint net's detect_keypoints on the card against
    the CPU on a 64x64 frame with fewer maxima than max_kp: xy and valid
    exact (the (-score, index) order, the -inf tail included), scores within
    1e-5, descriptors within 1e-4; and the tie order alone on the card:
    equal scores come out in ascending index."""
    from cerebro_tpu_torch.models import keypoints as kp
    from cerebro_tpu_torch.ops.features import topk_lowest_index

    _, params = kp.create_keypoint_model(desc_dim=32, width=16, seed=3, device="cpu")
    net = kp.KeypointNet(desc_dim=32, width=16, dtype=torch.float32)
    imgs, _ = kp.synthetic_corner_batch(np.random.default_rng(8), 1)
    img = torch.from_numpy(imgs[0, :, :, 0])
    kc, dc = kp.detect_keypoints(net, params, img, max_kp=256)
    kg, dg = kp.detect_keypoints(net.to(cuda), {k: v.to(cuda) for k, v in params.items()},
                                 img.to(cuda), max_kp=256)
    assert int(torch.isinf(kc.score).sum()) > 0
    assert torch.equal(kg.xy.cpu(), kc.xy) and torch.equal(kg.valid.cpu(), kc.valid)
    finite = torch.isfinite(kc.score)
    torch.testing.assert_close(kg.score.cpu()[finite], kc.score[finite], atol=1e-5, rtol=0)
    torch.testing.assert_close(dg.cpu(), dc, atol=1e-4, rtol=0)
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 4, 76800).astype(np.float32)).to(cuda)
    x[::7] = -torch.inf
    vals, idx = topk_lowest_index(x, 60000)
    v, i = vals.cpu().numpy(), idx.cpu().numpy()
    order = np.lexsort((i, -v))
    assert (order == np.arange(len(v))).all()


# ---------------------------------------------------------------------------
# The mesh's n-shard merge (parallel/sharded_search.py) on the card: one
# card takes one rank, so the n-shard search is held in one process: K1 and
# K2 on 4 row blocks of one DB, merged by the merge functions the ranks use
# ---------------------------------------------------------------------------


def _planted_ring(cuda, N=29184, D=8192, Q=8):
    """A wrapped ring (gid != row) of unit bf16 rows; query q is a copy of
    row rows[q]; query 1's row has an exact twin in the last block (a tie
    across blocks, won by the lower row); query 0 sees no row."""
    g = torch.Generator(device=cuda).manual_seed(29)
    db = torch.nn.functional.normalize(torch.randn((N, D), generator=g, device=cuda), dim=1)
    db = db.to(torch.bfloat16)
    rows = [5, 100, 7296, 14591, 14592, 21887, 25000, N - 1]  # across the 4 blocks' edges
    db[N - 3] = db[rows[1]]
    gids = ((torch.arange(N, device=cuda) + N // 3) % N).to(torch.int32)
    lim = torch.full((Q,), N, dtype=torch.int32, device=cuda)
    lim[0] = 0
    return db[rows].float(), db, lim, gids


@pytest.mark.parametrize("k", [None, 1, 3, 5])
def test_four_block_merge_equals_one_call(cuda, k):
    from cerebro_tpu_torch.parallel import merge_argmax, merge_topk

    q, db, lim, gids = _planted_ring(cuda)
    rows = db.shape[0] // 4
    blocks = [slice(i * rows, (i + 1) * rows) for i in range(4)]
    if k is None:  # K1
        parts = [sim.max_and_argmax_cuda(q, db[b], lim, gids[b]) for b in blocks]
        m, a = merge_argmax(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))
        pm, pa = sim.max_and_argmax_cuda(q, db, lim, gids)
        assert int(a[1]) == int(gids[100])  # the tie across blocks: the lower row
        assert int(a[0]) == int(gids[0]) and bool(m[0] == sim.NEG_INF)
    else:  # K2, one top-k call per block
        parts = [sim.search_topk_cuda(q, db[b], lim, gids[b], k=k) for b in blocks]
        m, a = merge_topk(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]), k)
        pm, pa = sim.search_topk_cuda(q, db, lim, gids, k=k)
    assert torch.equal(a, pa)
    assert torch.equal(m, pm)


def test_mesh_of_one_rank_on_the_card_is_the_plain_call(cuda):
    """sharded_max_and_argmax and sharded_topk over a 1-rank NCCL group:
    the unsharded kernels' answers."""
    import socket

    import torch.distributed as dist

    from cerebro_tpu_torch.parallel import make_mesh, sharded_max_and_argmax, sharded_topk
    from cerebro_tpu_torch.parallel.multihost import init_multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh()
        q, db, lim, gids = _planted_ring(cuda)
        m, a = sharded_max_and_argmax(q, db, lim, gids, mesh)
        pm, pa = sim.max_and_argmax_cuda(q, db, lim, gids)
        assert torch.equal(a, pa) and torch.equal(m, pm)
        v, g = sharded_topk(q, db, lim, gids, mesh, k=3)
        pv, pg = sim.search_topk_cuda(q, db, lim, gids, k=3)
        assert torch.equal(g, pg) and torch.equal(v, pv)
    finally:
        dist.destroy_process_group()
