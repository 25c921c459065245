"""Kernel K3: fused stereo block matching (counterpart of
cerebro_tpu/ops/stereo_pallas.py).

``block_match`` runs the CUDA kernel ``csrc/stereo_bm.cu`` on CUDA tensors
and the plain PyTorch version, ``geometry.stereo.block_match``, on CPU
tensors. Both compute the same function; the kernel never writes the
(B, D, H, W) cost volume to device memory.
"""

from __future__ import annotations

import ctypes

import torch

from cerebro_tpu_torch.geometry import stereo
from cerebro_tpu_torch.ops._cuda import Kernel

# The kernel's limits: G = 4 disparity groups of at most 32 register slots,
# and one thread per (colsum column, group) with 64 + 2 (block // 2)
# columns.
MAX_NUM_DISP = 128
MAX_THREADS = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
K3 = Kernel(
    "stereo_bm.cu",
    {
        "stereo_bm_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    },
)


def block_match_cuda(
    left: torch.Tensor,  # (B, H, W) float32 on a CUDA device
    right: torch.Tensor,
    num_disp: int = 64,
    block: int = 21,
    uniqueness: float = 0.85,
    texture_thresh: float = 0.5,
):
    """K3 over a batch: (disparity (B,H,W) f32, valid (B,H,W) bool). Raises
    ValueError, before any launch, for num_disp above MAX_NUM_DISP or a block
    that needs more than MAX_THREADS threads; the launch fails (CUDA error
    1, invalid value) for a num_disp and block whose per-block state does
    not fit in shared memory."""
    if left.shape != right.shape or left.dim() != 3:
        raise ValueError(f"bad shapes {tuple(left.shape)} / {tuple(right.shape)}")
    if block % 2 != 1 or num_disp < 3:
        raise ValueError(f"need an odd block and num_disp >= 3, got {block}, {num_disp}")
    if num_disp > MAX_NUM_DISP:
        raise ValueError(f"K3 takes num_disp <= {MAX_NUM_DISP}, got {num_disp}")
    threads = 4 * (64 + 2 * (block // 2))
    if threads > MAX_THREADS:
        raise ValueError(
            f"K3 takes a block of at most {MAX_THREADS} threads, (64 + 2 (block // 2)) x 4; "
            f"block {block} needs {threads}"
        )
    if not (left.is_cuda and right.is_cuda):
        raise ValueError("K3 needs CUDA tensors")
    B, H, W = left.shape
    L = left.float().contiguous()
    R = right.to(device=L.device, dtype=torch.float32).contiguous()
    disp = torch.empty((B, H, W), dtype=torch.float32, device=L.device)
    valid = torch.empty((B, H, W), dtype=torch.bool, device=L.device)
    with torch.cuda.device(L.device):
        K3.launch(
            "stereo_bm_launch",
            L.data_ptr(), R.data_ptr(), disp.data_ptr(), valid.data_ptr(),
            B, H, W, num_disp, block, uniqueness, texture_thresh,
        )
    return disp, valid


def block_match(
    left: torch.Tensor,  # (H, W) or (B, H, W) float32 rectified
    right: torch.Tensor,
    num_disp: int = 64,
    block: int = 21,
    uniqueness: float = 0.85,
    texture_thresh: float = 0.5,
):
    """SAD block matching, K3 on CUDA tensors and the plain version on CPU
    tensors. Returns (disparity, valid) of the input's shape."""
    if not left.is_cuda:
        return stereo.block_match(left, right, num_disp, block, uniqueness, texture_thresh)
    single = left.dim() == 2
    if single:
        left, right = left[None], right[None]
    disp, valid = block_match_cuda(left, right, num_disp, block, uniqueness, texture_thresh)
    return (disp[0], valid[0]) if single else (disp, valid)
