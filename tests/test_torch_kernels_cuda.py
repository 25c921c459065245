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


# ---------------------------------------------------------------------------
# Verification on the card: the small-matrix kernel, the per-pair graph
# ---------------------------------------------------------------------------


def _svd3_inputs(kind, rng, B=256):
    """B 3x3 matrices: Gaussian; two singular values 1e-6 apart with det > 0
    (the closest rotation is then U Vt, well defined); det < 0; rank 2 (the
    Umeyama H of points on one plane, as the nadir camera's ground)."""
    if kind == "rank2":
        A = rng.normal(size=(B, 3, 2)) @ rng.normal(size=(B, 2, 3))
    elif kind == "near_degenerate":
        U, _, Vt = np.linalg.svd(rng.normal(size=(B, 3, 3)))
        U[..., :, 2] *= np.sign(np.linalg.det(U @ Vt))[:, None]
        A = U @ np.diag([2.0, 1.0 + 1e-6, 1.0]) @ Vt
    else:
        A = rng.normal(size=(B, 3, 3))
        if kind == "reflection":
            A[np.linalg.det(A) > 0] *= -1.0
    return torch.from_numpy(A.astype(np.float32))


def _closest_rotation(U, Vt):
    d = torch.sign(torch.linalg.det(U @ Vt))
    return U @ torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)) @ Vt


@pytest.mark.parametrize("kind", ["random", "near_degenerate", "reflection", "rank2"])
def test_small_eig_svd3_matches_linalg(cuda, kind):
    """The kernel's U, S, Vt against torch.linalg.svd on the card: S within
    4e-6 of the largest (f32 rounding of the column norms), U and Vt
    orthogonal within 2e-6, A rebuilt within 4e-6, and the callers' rotation
    U diag(1, 1, d) Vt, d = sign det(U Vt), per matrix within 1e-6 (s1 /
    (s2 + d s3) + 1): f32 rounding of both factorisations, amplified by the
    rotation's condition (a reflection's turns on the gap between its two
    smallest singular values)."""
    from cerebro_tpu_torch.ops import small_eig

    A = _svd3_inputs(kind, np.random.default_rng(len(kind))).to(cuda)
    U, S, Vt = small_eig.svd3(A)
    Ul, Sl, Vtl = torch.linalg.svd(A)
    scale = float(Sl[:, 0].max())
    assert float((S - Sl).abs().max()) <= 4e-6 * scale
    eye = torch.eye(3, device=cuda)
    for Q in (U, Vt):
        assert float((Q @ Q.transpose(-1, -2) - eye).abs().max()) <= 2e-6
    assert float((U @ torch.diag_embed(S) @ Vt - A).abs().max()) <= 4e-6 * scale
    d = torch.sign(torch.linalg.det(A))
    tol = 1e-6 * (Sl[:, 0] / (Sl[:, 1] + d * Sl[:, 2]) + 1.0)
    err = (_closest_rotation(U, Vt) - _closest_rotation(Ul, Vtl)).abs().amax(dim=(1, 2))
    assert bool((err <= tol).all()), float((err / tol).max())
    if kind == "reflection":
        assert bool((small_eig.det3(A) < 0).all())


def _sym12_inputs(kind, rng):
    """A 12x12 symmetric matrix: random SPD; a clustered spectrum (the
    smallest alone, the others in pairs 1e-6 apart); a DLT normal matrix
    of 60 noisy correspondences; rank 11 (a null vector, eigenvalue 0)."""
    if kind == "clustered":
        Q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
        w = np.array([1e-4, 1, 1 + 1e-6, 2, 2 + 1e-6, 3, 3 + 1e-6, 4, 4, 5, 5, 6])
        return (Q * w) @ Q.T
    if kind == "dlt":
        X = np.stack([rng.uniform(-2, 2, 60), rng.uniform(-1.5, 1.5, 60), rng.uniform(3, 8, 60)], -1)
        x = (X + [0.3, -0.1, 0.2])[:, :2] / (X + [0.3, -0.1, 0.2])[:, 2:] + rng.normal(0, 2e-3, (60, 2))
        Xh = np.concatenate([X, np.ones((60, 1))], 1)
        z = np.zeros_like(Xh)
        A = np.concatenate([np.concatenate([Xh, z, -x[:, :1] * Xh], 1),
                            np.concatenate([z, Xh, -x[:, 1:] * Xh], 1)])
        return A.T @ A
    X = rng.normal(size=(11 if kind == "rank11" else 40, 12))
    return X.T @ X


@pytest.mark.parametrize("kind", ["random", "clustered", "dlt", "rank11"])
def test_small_eig_eigvec_matches_linalg(cuda, kind):
    """The kernel's smallest eigenvector against torch.linalg.eigh's on the
    card, up to sign: 1 - |<v, v_ref>| within 1e-5 times the condition of
    the eigenvector (the largest eigenvalue over the gap to the next
    smallest), and the residual |M v - l_min v| within 1e-5 of |M|."""
    from cerebro_tpu_torch.ops import small_eig

    M64 = _sym12_inputs(kind, np.random.default_rng(3 + len(kind)))
    M = torch.from_numpy(M64.astype(np.float32)).to(cuda)
    v = small_eig.smallest_eigvec(M[None])[0]
    w, V = torch.linalg.eigh(M)
    wd = np.linalg.eigvalsh(M64)
    cond = max(1.0, wd[-1] / (wd[1] - wd[0]))
    assert abs(1.0 - abs(float(v @ V[:, 0]))) <= 1e-5 * cond
    assert abs(float(v.norm()) - 1.0) <= 1e-6
    assert float((M @ v - w[0] * v).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("cond", [1.0, 1e3, 1e6])
def test_small_eig_spd_solve_matches_linalg(cuda, cond):
    """pnp_refine_gn's JᵀJ + 1e-6 I at three column scalings of J: the
    Cholesky solve against torch.linalg.solve on the card within 2e-5 x
    cond of the solution (f32 rounding, amplified by the condition), and
    NaN, not a number, for a matrix that is not positive definite."""
    from cerebro_tpu_torch.ops import small_eig

    rng = np.random.default_rng(int(np.log10(cond)))
    J = rng.normal(size=(200, 6)) * np.sqrt(np.logspace(0, np.log10(cond), 6))
    H = torch.from_numpy((J.T @ J + 1e-6 * np.eye(6)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=6).astype(np.float32)).to(cuda)
    x = small_eig.spd_solve(H, g)
    want = torch.linalg.solve(H, g)
    assert float((x - want).abs().max()) <= 2e-5 * cond * float(want.abs().max())
    bad = torch.diag(torch.tensor([1.0, 1.0, -1.0, 1.0, 1.0, 1.0], device=cuda))
    assert bool(small_eig.spd_solve(bad, g).isnan().any())


def test_small_eig_rejects_what_the_kernel_does_not_take(cuda):
    from cerebro_tpu_torch.ops import small_eig

    with pytest.raises(ValueError, match="12, 12"):
        small_eig.smallest_eigvec(torch.eye(6, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        small_eig.svd3(torch.eye(3, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="6, 6"):
        small_eig.spd_solve(torch.eye(3, device=cuda), torch.ones(3, device=cuda))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_refit_at_the_fewest_inliers_matches_cpu(cuda, seed):
    """ransac_pnp's refit, pnp_dlt's exact path then pnp_refine_gn's five
    Cholesky steps, on the card against the CPU's eigh and LU solves, at the
    fewest weighted points a PnP option can succeed on: 14, 0.7 of
    min_points_for_solve (20). Points 3-8 m deep, 1e-3 of pixel-plane
    noise. The two poses agree within 1e-4 (float32 rounding of two
    solvers, amplified by a pose fixed by 14 noisy points)."""
    from cerebro_tpu_torch.geometry import se3
    from cerebro_tpu_torch.ops import pnp

    rng = np.random.default_rng(seed)
    N, n_in = 64, 14
    X = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 8, N)], -1)
    xi = np.concatenate([rng.normal(0, 0.1, 3), rng.normal(0, 0.05, 3)])
    T = se3.se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy()
    Pc = X @ T[:3, :3].T + T[:3, 3]
    x = Pc[:, :2] / Pc[:, 2:] + rng.normal(0, 1e-3, (N, 2))
    x[n_in:] += rng.normal(0, 0.2, (N - n_in, 2))  # outliers, weighted 0
    w = (np.arange(N) < n_in).astype(np.float32)

    def refit(device):
        Xt, xt, wt = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (X, x, w))
        return pnp.pnp_refine_gn(pnp.pnp_dlt(Xt, xt, wt), Xt, xt, wt, iters=5).cpu()

    on_cpu, on_card = refit("cpu"), refit(cuda)
    assert bool(torch.isfinite(on_card).all()) and bool(torch.isfinite(on_cpu).all())
    assert float((on_card - on_cpu).abs().max()) <= 1e-4
    assert float((on_card - torch.from_numpy(T)).abs().max()) <= 0.05  # the pose it should find


@pytest.fixture(scope="module")
def photo_pairs():
    """Photo-world stereo frames at the EuRoC rig's 480x752 (the
    benchmark's world and rig), their K3 depth, and the benchmark
    configuration's two tiers: 5,000 features, gate 800. Frames 0 and 1 lie
    9 cm apart (an accepted pair: 1,179 matches through tier 1 on the CPU),
    2 elsewhere (no match), 3 a further 9 cm on (accepted with 1, rejected
    at the gate with 0: 988 and 739 matches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import dataclasses
    import json
    import os

    from cerebro_tpu_torch.geometry.stereo import RectifiedRig
    from portbench import system
    from portbench import world as W

    root = os.path.join(os.path.dirname(__file__), "..", "portbench")
    with open(os.path.join(root, "configs", "bench_e2e_top3.json")) as fh:
        cfg_file = json.load(fh)
    with open(os.path.join(root, "traffic", "relocalize.json")) as fh:
        traffic = json.load(fh)
    dev = torch.device("cuda")
    tex, mask, tex_m, _ = W.load_world(traffic["world"])
    ren = W.Renderer(tex, mask, tex_m, dev, cfg_file["rig"])
    xy = np.array([[14.0, 0.0], [14.05, 0.08], [0.0, 14.0], [14.1, 0.15]], np.float32)
    left, right = ren.stereo_frames(xy)
    vcfg = system.make_config(cfg_file["cerebro_config"]).verify
    rig = RectifiedRig(R0=np.eye(3, dtype=np.float32), R1=np.eye(3, dtype=np.float32),
                       **W.rig_params(cfg_file["rig"]))
    L = torch.from_numpy(left).to(dev).float()
    R = torch.from_numpy(right).to(dev).float()
    pts, ok, _ = stereo.depth_pipeline_rectified(L, R, rig, num_disp=vcfg.num_disparities,
                                                 block=vcfg.block_size)
    tiers = {"tier1": vcfg, "tier2": dataclasses.replace(vcfg, matcher="gather")}
    return tiers, rig, lambda a, b: (L[a], pts[a], ok[a], L[b], pts[b], ok[b])


@pytest.mark.parametrize("tier", ["tier1", "tier2"])
def test_verify_graph_replay_matches_eager(cuda, photo_pairs, tier):
    """Replayed pairs against eager ``verify_from_points`` from the same
    generator state, pair after pair (the first captures): every output
    bit-equal (the same kernels in the same order on the same inputs and
    philox offsets), and the generators' states equal after each pair. Each
    replay counts the small-matrix launches its capture recorded."""
    import dataclasses

    from cerebro_tpu_torch.ops import small_eig
    from cerebro_tpu_torch.verify import geometric as G

    tiers, rig, points = photo_pairs
    cfg = tiers[tier]
    gen_g = torch.Generator(device=cuda).manual_seed(2147483659)
    gen_e = torch.Generator(device=cuda).manual_seed(2147483659)
    graphs = G.VerifyGraphs(gen_g)
    for k in small_eig.KERNELS:
        k.reset()
    decided = []
    for a, b in [(0, 1), (0, 2), (3, 1), (0, 1), (3, 0)]:
        got = graphs.run(cfg, rig, *points(a, b))
        want = G.verify_from_points(cfg, gen_e, *points(a, b), rig)
        for f in dataclasses.fields(G.VerifiedLoop):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), (a, b, f.name)
        assert torch.equal(gen_g.get_state(), gen_e.get_state())
        decided.append((bool(got.accepted), int(got.n_matches)))
    assert len(graphs._graphs) == 1
    for k in small_eig.KERNELS:
        # 6 eager bodies (the capture's first pair, 5 references) and the
        # capture from the host; 4 replays of the capture on the device
        assert k.captured > 0 and k.launches == 7 * k.captured, k.functions
        assert k.replayed == 4 * k.captured and k.runs == 10 * k.captured, k.functions
    if tier == "tier1":  # the pairs give both outcomes
        assert [acc for acc, _ in decided] == [True, False, True, True, False], decided


@pytest.mark.parametrize("tier", ["tier1", "tier2"])
def test_verify_body_reads_nothing_back(cuda, photo_pairs, tier):
    """One eager call of the per-pair body under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in it synchronises
    with the host (after a first call, which builds the kernels and puts the
    matchers' constants on the device)."""
    from cerebro_tpu_torch.verify import geometric as G

    tiers, rig, points = photo_pairs
    gen = torch.Generator(device=cuda).manual_seed(1)
    G.verify_from_points(tiers[tier], gen, *points(0, 1), rig)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = G.verify_from_points(tiers[tier], gen, *points(0, 1), rig)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out.n_matches) > 0


def test_warmed_pipeline_replays_like_eager(cuda):
    """chip_smoke's photo run (240x320, 200 frames over 1.4 laps, the
    default cascade) through a warmed pipeline that replays its graphs and
    through one that verifies eagerly, one after the other on the default
    stream: the same edges (poses bit-equal) and the same rejections. The
    replaying one captured both tiers in warmup and replayed every pair."""
    from cerebro_tpu_torch import photoworld as pw
    from cerebro_tpu_torch import synthworld as sw
    from cerebro_tpu_torch.runtime.pipeline import CerebroPipeline

    cs = _chip_smoke()
    seq = pw.make_photo_sequence(n_frames=200, laps=1.4)
    ren = sw.Renderer(pw.PhotoWorld.create(seed=0))
    frames = [ren.stereo(float(x), float(y)) for x, y in seq.xy]
    runs = []
    for replay in (True, False):
        pipe = CerebroPipeline(cs.photo_config(200), rig=ren.rig(), body_T_cam=sw.body_T_cam(),
                               device="cuda")
        if not replay:
            pipe._verify_graphs = None
        pipe.warmup(verify_device_batches=(4,))
        cs.feed_survey(pipe, seq, frames)
        pipe.verify_pending()
        runs.append((
            [(e.idx_curr, e.idx_prev, e.n_matches, e.weight, e.T_prev_curr.tobytes())
             for e in pipe.loop_edges],
            [(r.idx_curr, r.idx_prev, r.reason, r.n_matches) for r in pipe.rejected_candidates],
            pipe.status()["counters"],
        ))
        pipe.close()
    (edges_g, rej_g, c), (edges_e, rej_e, c_e) = runs
    assert edges_g == edges_e and rej_g == rej_e
    assert len(edges_g) >= 1
    pairs = c["pairs.verified.tier1"] + c.get("pairs.verified.tier2", 0)
    assert (c["verify.graph.captured"], c["verify.graph.eager"]) == (2, 0)
    assert c["verify.graph.replayed"] == pairs > 0
    assert c_e["verify.graph.eager"] == pairs and c_e["verify.graph.replayed"] == 0
