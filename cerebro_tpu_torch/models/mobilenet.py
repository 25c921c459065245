"""Ported MobileNetV1 + NetVLAD descriptor, the reference's flagship model
(counterpart of cerebro_tpu/models/mobilenet.py).

Runs the reference's trained weights (``mobilenet_conv7_allpairloss``,
selected by launch/euroc_vinsfusion.launch:57) from the same
``artifacts/descriptor_ported/params.npz`` the JAX package reads: the Keras
MobileNetV1 (alpha=1) trunk cut at ``conv_pw_7_relu`` followed by a NetVLAD
layer with K=16 clusters over 512 channels -> 8192-dim L2-normalized
descriptor (scripts/predict_utils.py:11-79).

Three details carry over exactly:
  * the asymmetric ``(0,1),(0,1)`` zero padding before every stride-2 conv
    (Keras ``ZeroPadding2D`` + valid conv);
  * the Keras ``x + C`` NetVLAD residual sign (the trained centers are
    stored negated), so ``V = aᵀf + (Σa)·C``;
  * the ``raw`` / ``m1to1`` input scale, a property of each checkpoint.

Public functions keep the JAX layout (NHWC images, HWIO weights in the
artifact); ``convert_params`` turns the weights into PyTorch's OIHW once.
Convolutions and the NetVLAD products round their inputs to the configured
dtype (bf16) and then multiply and accumulate in f32, with f32 bias and
relu6: what the JAX ``_conv``'s ``preferred_element_type=f32`` gives. A
bf16 value is exact in TF32, so the result does not depend on whether the
caller allows TF32.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_ARTIFACT = os.path.join(
    os.path.dirname(__file__), "..", "..", "artifacts", "descriptor_ported"
)


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in f32, so the products that use it
    are exact and accumulate in f32 (XLA's preferred_element_type=f32)."""
    return x.to(dtype).float()


def _conv(x, weight, bias, *, stride=1, asym=False, groups=1, dtype=torch.bfloat16):
    """NCHW conv of ``dtype``-rounded inputs, accumulated in f32, plus the
    f32 bias. ``asym`` is
    Keras' (0,1),(0,1) padding before a valid stride-2 conv; otherwise the
    padding is SAME for the 3x3 and 1x1 kernels used here."""
    k = weight.shape[-1]
    if asym:
        x = F.pad(x, (0, 1, 0, 1))
        pad = 0
    else:
        pad = k // 2
    y = F.conv2d(
        _rounded(x, dtype), _rounded(weight, dtype), stride=stride, padding=pad, groups=groups
    )
    return y + bias.float()[None, :, None, None]


def v1_blocks_in(params: Dict[str, torch.Tensor]) -> Tuple[Tuple[int, int], ...]:
    """(block index, depthwise stride) for the V1 blocks a checkpoint
    actually contains — the reference ships cuts at different depths
    (flagship conv_pw_7, June2019 conv_pw_6_relu variant). Strides follow
    the canonical Keras MobileNetV1 schedule (s2 at dw 2/4/6/12)."""
    idx = sorted(
        int(k[len("conv_dw_"):].split("/")[0])
        for k in params
        if k.startswith("conv_dw_") and k.endswith("/kernel")
    )
    return tuple((i, 2 if i in (2, 4, 6, 12) else 1) for i in idx)


def mobilenet_v1_trunk(
    params: Dict[str, torch.Tensor], x: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """BN-folded MobileNetV1 trunk: (B,3,H,W) -> coarse features (B,C,h,w).

    ``params`` are OIHW (``convert_params``). The block set comes from the
    checkpoint (see v1_blocks_in) so one function serves every bundled cut.
    """
    x = _relu6(
        _conv(x, params["conv1/kernel"], params["conv1/bias"], stride=2, asym=True, dtype=dtype)
    )
    for i, stride in v1_blocks_in(params):
        dw_k = params[f"conv_dw_{i}/kernel"]
        x = _relu6(
            _conv(
                x, dw_k, params[f"conv_dw_{i}/bias"], stride=stride,
                asym=stride == 2, groups=dw_k.shape[0], dtype=dtype,
            )
        )
        x = _relu6(
            _conv(x, params[f"conv_pw_{i}/kernel"], params[f"conv_pw_{i}/bias"], dtype=dtype)
        )
    return x


def netvlad_keras_head(
    params: Dict[str, torch.Tensor], feats: torch.Tensor, dtype=torch.bfloat16
) -> torch.Tensor:
    """Reference-semantics NetVLAD: (B,D,h,w) -> (B, K*D) unit descriptors.

    Matches scripts/predict_utils.py:36-71 including the ``x + C`` residual
    sign (centers are (K, D) = keras ``cluster_centers`` transposed).
    """
    B, D = feats.shape[:2]
    f = feats.flatten(2).transpose(1, 2)  # (B, N, D)
    logits = (
        torch.matmul(_rounded(f, dtype), _rounded(params["vlad/assign_w"], dtype))
        + params["vlad/assign_b"].float()
    )
    a = torch.softmax(logits, dim=-1)  # (B, N, K) f32
    af = torch.matmul(_rounded(a, dtype).transpose(1, 2), _rounded(f, dtype))  # (B, K, D)
    a_sum = a.sum(dim=1)  # (B, K)
    V = af + a_sum[..., None] * params["vlad/centers"].float()[None]  # x + C convention
    V = V / (torch.linalg.vector_norm(V, dim=-1, keepdim=True) + 1e-12)
    v = V.reshape(B, -1)
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def _adapt_channels(x: torch.Tensor, c_model: int) -> torch.Tensor:
    """Adapt stream channels (last axis) to the trained model's input
    channels: gray -> RGB by replication, RGB -> gray by mean, so one
    artifact serves both stream types."""
    c_in = x.shape[-1]
    if c_in == c_model:
        return x
    if c_in == 1:
        return x.repeat_interleave(c_model, dim=-1)
    return x.mean(dim=-1, keepdim=True)


def ported_forward(
    params: Dict[str, torch.Tensor],
    images_u8: torch.Tensor,
    dtype=torch.bfloat16,
    input_scale: str = "raw",
) -> torch.Tensor:
    """uint8 (B,H,W,C) -> (B, 8192) f32 unit descriptors.

    ``input_scale`` is a property of the trained checkpoint: the flagship
    consumes RAW [0,255] pixels, the June2019 ``centeredinput-m1to1`` models
    take (im-128)*2/255 (whole_image_desc_compute_server.py:629)."""
    x = images_u8.float()
    if input_scale == "m1to1":
        x = (x - 128.0) * (2.0 / 255.0)
    elif input_scale != "raw":
        raise ValueError(f"unknown input_scale {input_scale!r}")
    x = _adapt_channels(x, params["conv1/kernel"].shape[1])
    feats = mobilenet_v1_trunk(params, x.permute(0, 3, 1, 2), dtype=dtype)
    return netvlad_keras_head(params, feats, dtype=dtype)


def convert_params(np_params: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """Artifact weights (JAX layout) -> PyTorch tensors on ``device``.

    Convolution kernels go HWIO -> OIHW; a depthwise kernel (3,3,1,C) goes
    to (C,1,3,3) by the same transpose. Biases and the NetVLAD tensors keep
    their shapes."""
    out = {}
    for k, v in np_params.items():
        a = np.asarray(v, np.float32)
        if k.endswith("/kernel"):
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        out[k] = torch.from_numpy(a).to(device)
    return out


def load_ported_params(directory: str = DEFAULT_ARTIFACT, device="cuda"):
    """Load a ported-weights artifact (scripts/port_keras_weights.py output).

    Returns (params dict of OIHW tensors on ``device``, meta dict).
    meta["descriptor_dim"] gives the output dimension (8192 for the flagship).
    """
    with np.load(os.path.join(directory, "params.npz")) as z:
        params = convert_params({k: z[k] for k in z.files}, device=device)
    with open(os.path.join(directory, "meta.json")) as fh:
        meta = json.load(fh)
    return params, meta
