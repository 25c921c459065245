"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and ``nvcc`` (the kernels build on first use), so
they carry the ``cuda`` marker and skip elsewhere. On a machine with a GPU:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

They cover the shapes the main path never gives the kernels (ragged N, Q
across query groups, D off the main width, banned lists of 1 and 8 gids,
heights that are no multiple of the row band, narrow and wide images, a
large block); chip_smoke.py covers the main path's.
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


@pytest.mark.parametrize("Q,N,D", [(1, 1, 8), (3, 1000, 64), (9, 4097, 256), (40, 777, 8192)])
def test_k1_matches_plain(cuda, Q, N, D):
    rng = np.random.default_rng(Q * N + D)
    db = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(cuda)
    db = torch.nn.functional.normalize(db, dim=1).to(torch.bfloat16)
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
    db = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(cuda)
    db = torch.nn.functional.normalize(db, dim=1).to(torch.bfloat16)
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


@pytest.mark.parametrize(
    "Q,N,D,KB", [(1, 1, 8, 1), (3, 1000, 64, 1), (9, 4097, 256, 8), (40, 777, 8192, 8)]
)
def test_k2_matches_plain(cuda, Q, N, D, KB):
    q, db, lim, gids, banned = _k2_case(cuda, Q, N, D, KB, seed=Q * N + D + KB)
    km, kg = sim.max_and_argmax_banned_cuda(q, db, lim, gids, banned)
    pm, pg = sim.max_and_argmax_banned_plain(q, db, lim, gids, banned)
    assert torch.equal(kg, pg)
    # f32 sums of bf16 products in another order: 1e-3 on unit vectors
    torch.testing.assert_close(km, pm, atol=1e-3, rtol=0)
    assert bool(km[0] == sim.NEG_INF) and int(kg[0]) == int(gids[0])


@pytest.mark.parametrize("Q,N,D,k", [(8, 600, 64, 3), (17, 2000, 128, 5), (5, 40, 8192, 5)])
def test_search_topk_cuda_matches_plain_on_every_slot(cuda, Q, N, D, k):
    """K2's k passes plus the dense filler order equal the plain dense top-k
    on every slot, including queries with fewer than k matchable rows."""
    q, db, lim, gids, _ = _k2_case(cuda, Q, N, D, 1, seed=Q + N + k)
    lim[1:4] = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda)  # 1, 2, 3 rows
    kv, ki = sim.search_topk(q, db, lim, gids, k=k)
    pv, pi = sim.search_topk_plain(q, db, lim, gids, k=k)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, atol=1e-3, rtol=0)
    assert bool((kv <= sim.NEG_INF / 2).any())


@pytest.mark.parametrize(
    "B,H,W,nd,block",
    [(1, 37, 200, 32, 11), (3, 96, 256, 32, 11), (2, 240, 320, 64, 21), (1, 20, 2100, 16, 5),
     (1, 50, 100, 16, 31)],
)
def test_k3_matches_plain(cuda, B, H, W, nd, block):
    rng = np.random.default_rng(H * W)
    base = rng.integers(0, 256, (B, H, W + 9)).astype(np.float32)
    L = torch.from_numpy(base[..., :-9].copy()).to(cuda)
    R = torch.from_numpy(base[..., 9:].copy()).to(cuda)
    dk, vk = stereo_kernel.block_match(L, R, num_disp=nd, block=block)
    dp, vp = stereo.block_match(L, R, num_disp=nd, block=block)
    # integer images: every box sum is exact in f32, whatever the order
    assert torch.equal(vk, vp)
    both = vk & vp
    assert bool(both.any())
    assert float((dk - dp).abs()[both].max()) <= 1e-5
