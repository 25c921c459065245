"""Float32 precision on CUDA.

PyTorch lets cuDNN use TF32 by default, which keeps 10 of an f32
operand's 23 mantissa bits. ``exact_fp32`` holds a float32 computation on
CUDA to full f32 (the convolutions and products of ``models/``, and a
train step's forward and backward in ``train/optim.value_and_grad``).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_fp32(x: torch.Tensor, dtype):
    """Turns TF32 off for cuDNN and matmul while a float32 computation on
    CUDA runs, and restores the caller's flags after it (they are process
    wide); a no-op for other dtypes and devices."""
    if not (x.is_cuda and dtype == torch.float32):
        yield
        return
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
