"""The flagship describe net: MobileNetV1 (alpha = 1) + NetVLAD, its plain
float32 reference and its FLOP rule.

MobileNetV1 with batch norm folded into each convolution, cut after the
last pointwise block the weights hold (conv_pw_7 for the flagship
``mobilenet_conv7_allpairloss``), then NetVLAD with K clusters over its
channels (scripts/predict_utils.py:11-79 of the reference):

  * stride-2 convolutions pad the bottom and right by one pixel, then run
    valid (Keras ``ZeroPadding2D((0,1),(0,1))``); the others pad SAME;
  * every convolution adds its bias and clamps to [0, 6] (relu6);
  * NetVLAD: soft assignment a = softmax(f W + b) over the clusters,
    V_k = sum_n a_nk f_n + (sum_n a_nk) C_k (the Keras ``x + C`` sign: the
    trained centres are stored negated), each V_k L2-normalized, then the
    whole (K * C) vector;
  * gray frames are replicated to the three input channels; pixels enter
    raw, in [0, 255].

The weights are the artifact the configuration file names under
``weights`` (``params.npz``, HWIO kernels; the system reads the same file).
This module reads it itself and imports nothing of the system. ``control``
rounds every convolution's and product's operands to float8 (e4m3, one
scale per tensor), the precision below the configured bfloat16: the run
that a limit has to fail.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
STRIDE2_DW = (2, 4, 6, 12)  # Keras MobileNetV1's stride-2 depthwise blocks


def weights_dir(cfg_file: dict, cache_dir: Path) -> Path:
    """The published artifact the configuration names (a directory of the
    checkout holding ``params.npz`` and ``meta.json``)."""
    rel = Path(cfg_file["weights"])
    if rel.is_absolute() or ".." in rel.parts:
        raise ValueError(f"the weights {rel} lie outside the checkout")
    return ROOT / rel


def load(directory: Path, device) -> Dict[str, torch.Tensor]:
    out = {}
    with np.load(os.path.join(directory, "params.npz")) as z:
        for k in z.files:
            a = np.asarray(z[k], np.float32)
            if k.endswith("/kernel"):  # HWIO -> OIHW
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            out[k] = torch.from_numpy(a).to(device)
    return out


def weight_shapes(directory: Path) -> dict:
    """name -> shape of every tensor in the artifact (HWIO kernels)."""
    with np.load(os.path.join(directory, "params.npz")) as z:
        return {k: tuple(z[k].shape) for k in z.files}


def width(directory: Path) -> int:
    """The descriptor's width: K clusters x C channels."""
    K, C = weight_shapes(directory)["vlad/centers"]
    return int(K * C)


def _blocks(names: Iterable[str]) -> list:
    return sorted(int(k[len("conv_dw_"):].split("/")[0])
                  for k in names if k.startswith("conv_dw_") and k.endswith("/kernel"))


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude onto 448), back in float32."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _conv(x, w, b, stride, groups, q):
    if stride == 2:
        x, pad = F.pad(x, (0, 1, 0, 1)), 0
    else:
        pad = w.shape[-1] // 2
    return torch.clamp(F.conv2d(q(x), q(w), stride=stride, padding=pad, groups=groups)
                       + b[None, :, None, None], 0.0, 6.0)


def describe(weights: Dict[str, torch.Tensor], frames_u8: torch.Tensor,
             control: bool = False) -> torch.Tensor:
    """(B, H, W) uint8 gray frames -> (B, K * C) float32 unit descriptors."""
    q = _fp8 if control else (lambda t: t)
    x = frames_u8.float()[:, None].repeat(1, weights["conv1/kernel"].shape[1], 1, 1)
    x = _conv(x, weights["conv1/kernel"], weights["conv1/bias"], 2, 1, q)
    for i in _blocks(weights):
        w = weights[f"conv_dw_{i}/kernel"]
        x = _conv(x, w, weights[f"conv_dw_{i}/bias"], 2 if i in STRIDE2_DW else 1, w.shape[0], q)
        x = _conv(x, weights[f"conv_pw_{i}/kernel"], weights[f"conv_pw_{i}/bias"], 1, 1, q)
    B, C = x.shape[:2]
    f = x.flatten(2).transpose(1, 2)  # (B, positions, C)
    a = torch.softmax(q(f) @ q(weights["vlad/assign_w"]) + weights["vlad/assign_b"], dim=-1)
    V = q(a).transpose(1, 2) @ q(f) + a.sum(1)[..., None] * weights["vlad/centers"][None]
    V = V / (torch.linalg.vector_norm(V, dim=-1, keepdim=True) + 1e-12)
    v = V.reshape(B, -1)
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def describe_all(weights, frames_u8: np.ndarray, device, control: bool = False,
                 block: int = 64) -> np.ndarray:
    """Descriptors of a host stack of frames, in blocks, with TF32 off."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        with torch.no_grad():
            for s in range(0, len(frames_u8), block):
                x = torch.from_numpy(np.ascontiguousarray(frames_u8[s:s + block])).to(device)
                out.append(describe(weights, x, control).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 0), np.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# The FLOP rule: multiply-adds x 2 of every convolution and of NetVLAD's
# two products (the rule of the bring-up smoke run's ``forward_flops``)
# ---------------------------------------------------------------------------


def _out(n: int, stride: int) -> int:
    # stride 2: Keras' (0, 1) zero padding then a valid 3x3; stride 1: SAME
    return (n + 1 - 3) // 2 + 1 if stride == 2 else n


def describe_flops(directory: Path, hw: Iterable[int]) -> float:
    """FLOPs of one frame of ``hw`` through the net whose weights are in
    ``directory``: each convolution's output elements x input channels per
    group x kernel area x 2, and NetVLAD's assignment (positions x C x K x
    2) and aggregation (K x positions x C x 2)."""
    shapes = weight_shapes(directory)
    h, w = hw
    kh, kw, cin, cout = shapes["conv1/kernel"]
    h, w = _out(h, 2), _out(w, 2)
    total = 2.0 * h * w * cout * cin * kh * kw
    for i in _blocks(shapes):
        kh, kw, _, c = shapes[f"conv_dw_{i}/kernel"]
        s = 2 if i in STRIDE2_DW else 1
        h, w = _out(h, s), _out(w, s)
        total += 2.0 * h * w * c * kh * kw
        _, _, cin, cout = shapes[f"conv_pw_{i}/kernel"]
        total += 2.0 * h * w * cout * cin
    C, K = shapes["vlad/assign_w"]
    total += 2.0 * h * w * C * K + 2.0 * K * h * w * C
    return total
