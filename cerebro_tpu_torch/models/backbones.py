"""CNN trunks for the in-framework descriptor network (counterpart of
cerebro_tpu/models/backbones.py).

Behavioral equivalent of the reference's Keras backbones
(scripts/keras_helpers.py:231-336): a depthwise-separable MobileNet-style
trunk and a VGG16 trunk cut at a block boundary, each downsampling the
image to a coarse feature map that NetVLAD aggregates. GroupNorm replaces
BatchNorm, so inference needs no running statistics.

The modules take NHWC input, as the JAX package's do, and compute in NCHW.
Four details follow flax exactly:

  * ``padding="SAME"`` is XLA's: a stride-2 3x3 conv pads (0, 1) at an even
    input size and (1, 1) at an odd one (``same_pads``), so every conv pads
    explicitly with ``F.pad``;
  * GroupNorm has flax's epsilon (1e-6) and its fast variance, E[x^2] -
    E[x]^2 clipped at 0, computed in f32;
  * a conv rounds its input and kernel (and bias) to ``dtype`` and gives a
    ``dtype`` result, as flax's ``Conv(dtype=...)`` does; GroupNorm returns
    f32, and VGG casts back to ``dtype`` after it;
  * ``max_pool((2, 2))`` is VALID: it floors, as ``F.max_pool2d`` does.

A conv of bf16 operands on CUDA runs in bf16 on the tensor cores with f32
accumulation; elsewhere it runs in f32 on the rounded operands (exact
products, f32 sums) and rounds the result. A float32 conv on CUDA runs with
TF32 off whatever the caller's setting (``exact_fp32``): PyTorch lets cuDNN
use TF32 by default, which would keep 10 of an f32 operand's 23 mantissa
bits.

Parameter layouts are PyTorch's: a kernel is (O, I / groups, kh, kw);
``models/descriptor.convert_params`` carries flax's HWIO kernels across.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cerebro_tpu_torch.utils.precision import exact_fp32


def same_pads(size: int, k: int, stride: int) -> tuple:
    """(low, high) padding of XLA's SAME rule for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


class Conv(nn.Module):
    """flax ``nn.Conv(padding="SAME")`` on NCHW tensors: ``dtype``-rounded
    operands, a ``dtype`` result."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.groups, self.k = stride, groups, k
        self.weight = nn.Parameter(torch.zeros(c_out, c_in // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        (ph0, ph1), (pw0, pw1) = (same_pads(n, self.k, self.stride) for n in x.shape[2:])
        x = F.pad(x, (pw0, pw1, ph0, ph1))
        if x.is_cuda and dtype == torch.bfloat16:
            y = F.conv2d(x.to(dtype), self.weight.to(dtype), stride=self.stride, groups=self.groups)
        else:
            with exact_fp32(x, dtype):
                y = F.conv2d(
                    _round(x, dtype), _round(self.weight, dtype), stride=self.stride,
                    groups=self.groups,
                ).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)[None, :, None, None]
        return y


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(dtype=float32)``: f32 statistics over each
    group's channels and pixels, fast variance, epsilon 1e-6."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        g = x.float().reshape(B, self.num_groups, C // self.num_groups, H, W)
        mean = g.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp((g * g).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().reshape(1, self.num_groups, -1, 1, 1)
        y = (g - mean) * mul + self.bias.float().reshape(1, self.num_groups, -1, 1, 1)
        return y.reshape(B, C, H, W)


class SeparableBlock(nn.Module):
    """Depthwise 3x3 + pointwise 1x1, the MobileNet v1 building block."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.depthwise = Conv(c_in, c_in, 3, stride=stride, groups=c_in)
        self.norm1 = GroupNorm(min(32, c_in), c_in)
        self.pointwise = Conv(c_in, features, 1)
        self.norm2 = GroupNorm(min(32, features), features)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = torch.relu(self.norm1(self.depthwise(x, dtype)))
        return torch.relu(self.norm2(self.pointwise(x, dtype)))


class MobileTrunk(nn.Module):
    """MobileNet-style trunk: a stride-2 stem conv and separable blocks, to
    a /16 feature map of ``out_dim`` channels (the analog of mobilenet cut
    at conv_pw_7, ref keras_helpers.py:231-287). Returns f32."""

    def __init__(self, in_channels: int = 1, out_dim: int = 256,
                 widths: Sequence[int] = (64, 128, 128, 256, 256),
                 strides: Sequence[int] = (2, 1, 2, 1, 1)):
        super().__init__()
        self.stem = Conv(in_channels, 32, 3, stride=2)
        self.stem_norm = GroupNorm(8, 32)
        blocks, c = [], 32
        for w, s in zip(widths, strides):
            blocks.append(SeparableBlock(c, w, s))
            c = w
        blocks.append(SeparableBlock(c, out_dim, 2))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        # x: (B, C, H, W) float in [-1, 1]
        x = torch.relu(self.stem_norm(self.stem(x.to(dtype), dtype)))
        for block in self.blocks:
            x = block(x, dtype)
        return x


VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGGTrunk(nn.Module):
    """VGG16-style trunk cut at block ``cut_block`` (1-indexed; 4 = through
    block4_conv3 at /16 of the input after four pools), GroupNorm after each
    block's pool, and a final 1x1 projection to ``out_dim`` when the last
    block's width differs (ref keras_helpers.py:231-336
    ``make_from_vgg16``). Returns ``dtype``."""

    def __init__(self, in_channels: int = 1, out_dim: int = 256, cut_block: int = 4):
        super().__init__()
        convs, norms, c = [], [], in_channels
        self.depths = []
        for width, depth in VGG_BLOCKS[:cut_block]:
            for _ in range(depth):
                convs.append(Conv(c, width, 3, bias=True))
                c = width
            norms.append(GroupNorm(min(32, width), width))
            self.depths.append(depth)
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.proj = Conv(c, out_dim, 1) if c != out_dim else None

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = x.to(dtype)
        convs = iter(self.convs)
        for depth, norm in zip(self.depths, self.norms):
            for _ in range(depth):
                x = torch.relu(next(convs)(x, dtype))
            x = norm(F.max_pool2d(x, 2, 2)).to(dtype)
        if self.proj is not None:
            x = self.proj(x, dtype)
        return x


def normalize_image(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8/float image -> [-1, 1] float, matching the reference server's
    ``(im - 128) * 2 / 255`` (scripts/whole_image_desc_compute_server.py:629)."""
    return (img_u8.float() - 128.0) * (2.0 / 255.0)
