"""Whole-image descriptor network: trunk + NetVLAD (counterpart of
cerebro_tpu/models/descriptor.py), the default descriptor kind
(``DescriptorConfig.kind == "netvlad"``).

Image in, L2-normalized descriptor out; the dimension is num_clusters *
trunk_dim (4,096 by default). The reference computes this in a Keras server
over ROS RPC (scripts/whole_image_desc_compute_server.py, called from
src/Cerebro.cpp:263); here it is one batched forward pass on the device.

Parameters come three ways, all in the JAX package's flax layout first:

  * ``create_descriptor_model(cfg, seed)`` draws what
    ``DescriptorNet.init(jax.random.PRNGKey(seed), ...)`` draws, through
    ``utils/jaxrand`` (flax's per-path key folding, ``lecun_normal``'s
    truncated normal, zeros and ones), so a seeded pipeline describes as
    the JAX package's does;
  * ``load_descriptor_params(directory, cfg)`` reads a ``params.npz`` of
    flax paths (``artifacts/descriptor_synth_npz``, written from the JAX
    package's orbax checkpoint by scripts/export_descriptor_synth.py, or
    by ``python -m cerebro_tpu_torch.pretrain_synthetic``);
  * ``convert_params`` takes flax params as numpy arrays (nested, as
    ``net.init`` returns them, or flat ``"MobileTrunk_0/Conv_0/kernel"``
    keys) and returns the PyTorch state: HWIO kernels go to OIHW.
    ``export_params`` goes back, to the npz's arrays.

The draw and both conversions read one table of (flax path, PyTorch
name, flax shape, initializer), ``flax_layout(cfg)``; the keypoint net
(``models/keypoints.py``) has its own table and shares the rest.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from cerebro_tpu_torch.models.backbones import VGG_BLOCKS, MobileTrunk, VGGTrunk, normalize_image
from cerebro_tpu_torch.models.netvlad import GhostVLAD, NetVLAD
from cerebro_tpu_torch.utils import jaxrand

MOBILE_WIDTHS = (64, 128, 128, 256, 256)


class DescriptorNet(nn.Module):
    """(B, H, W, C) images -> (B, num_clusters * trunk_dim) unit
    descriptors. Images are uint8 (normalized here, as ``describe_batch``
    does in the JAX package) or already in [-1, 1]."""

    def __init__(self, num_clusters: int = 16, trunk_dim: int = 256, num_ghost: int = 0,
                 backbone: str = "mobile", dtype=torch.bfloat16, in_channels: int = 1):
        super().__init__()
        if backbone not in ("mobile", "vgg16"):
            raise ValueError(f"unknown backbone {backbone!r}")
        self.num_clusters, self.trunk_dim, self.num_ghost = num_clusters, trunk_dim, num_ghost
        self.backbone, self.dtype = backbone, dtype
        if backbone == "vgg16":
            self.trunk = VGGTrunk(in_channels, trunk_dim)
        else:
            self.trunk = MobileTrunk(in_channels, trunk_dim, MOBILE_WIDTHS)
        vlad = GhostVLAD if num_ghost > 0 else NetVLAD
        self.vlad = vlad(trunk_dim, num_clusters, num_ghost)

    @property
    def descriptor_dim(self) -> int:
        return self.num_clusters * self.trunk_dim

    def forward(self, images: torch.Tensor, return_ghost_mass: bool = False):
        """``return_ghost_mass`` (GhostVLAD): also the (B, H' * W') mass the
        ghost clusters absorbed per trunk token, which the JAX package sows
        as the ``ghost_mass`` intermediate."""
        if images.dtype == torch.uint8:
            images = normalize_image(images)
        feats = self.trunk(images.permute(0, 3, 1, 2), self.dtype)
        return self.vlad(feats, self.dtype, return_ghost_mass=return_ghost_mass)


def _net(cfg, device) -> DescriptorNet:
    return DescriptorNet(
        num_clusters=cfg.num_clusters, trunk_dim=cfg.trunk_dim, num_ghost=cfg.num_ghost,
        backbone=cfg.backbone, dtype=getattr(torch, cfg.dtype), in_channels=cfg.num_channels,
    ).to(device)


# ---------------------------------------------------------------------------
# The flax layout: one entry per parameter
# ---------------------------------------------------------------------------


def flax_layout(cfg) -> List[Tuple[tuple, str, tuple, str]]:
    """(flax path, PyTorch state name, flax shape, initializer) of every
    parameter of ``cfg``'s net, in flax's auto-names: ``MobileTrunk_0`` /
    ``VGGTrunk_0``, ``Conv_i``, ``GroupNorm_i``, ``SeparableBlock_i``,
    ``NetVLAD_0`` / ``GhostVLAD_0``. The initializer is flax's default for
    the parameter: ``lecun_normal`` for kernels and NetVLAD's ``assign_w``
    and ``centers``, zeros for biases, ones for GroupNorm's scale."""
    C = cfg.num_channels
    out = []

    def conv(path, name, k, c_in, c_out, bias=False):
        out.append((path + ("kernel",), name + ".weight", (k, k, c_in, c_out), "lecun"))
        if bias:
            out.append((path + ("bias",), name + ".bias", (c_out,), "zeros"))

    def norm(path, name, c):
        out.append((path + ("scale",), name + ".weight", (c,), "ones"))
        out.append((path + ("bias",), name + ".bias", (c,), "zeros"))

    if cfg.backbone == "vgg16":
        t = ("VGGTrunk_0",)
        i, c = 0, C
        for b, (width, depth) in enumerate(VGG_BLOCKS[:4]):
            for _ in range(depth):
                conv(t + (f"Conv_{i}",), f"trunk.convs.{i}", 3, c, width, bias=True)
                i, c = i + 1, width
            norm(t + (f"GroupNorm_{b}",), f"trunk.norms.{b}", width)
        if c != cfg.trunk_dim:
            conv(t + (f"Conv_{i}",), "trunk.proj", 1, c, cfg.trunk_dim)
    else:
        t = ("MobileTrunk_0",)
        conv(t + ("Conv_0",), "trunk.stem", 3, C, 32)
        norm(t + ("GroupNorm_0",), "trunk.stem_norm", 32)
        c = 32
        for i, w in enumerate(MOBILE_WIDTHS + (cfg.trunk_dim,)):
            b, n = t + (f"SeparableBlock_{i}",), f"trunk.blocks.{i}"
            # depthwise: (3, 3, 1, c) with feature_group_count = c
            out.append((b + ("Conv_0", "kernel"), n + ".depthwise.weight", (3, 3, 1, c), "lecun"))
            norm(b + ("GroupNorm_0",), n + ".norm1", c)
            conv(b + ("Conv_1",), n + ".pointwise", 1, c, w)
            norm(b + ("GroupNorm_1",), n + ".norm2", w)
            c = w
    K, G, D = cfg.num_clusters, cfg.num_ghost, cfg.trunk_dim
    v = ("GhostVLAD_0" if G > 0 else "NetVLAD_0",)
    out.append((v + ("assign_w",), "vlad.assign_w", (D, K + G), "lecun"))
    out.append((v + ("assign_b",), "vlad.assign_b", (K + G,), "zeros"))
    out.append((v + ("centers",), "vlad.centers", (K, D), "lecun"))
    return out


def _lecun_normal(key, shape) -> np.ndarray:
    """flax/jax ``lecun_normal()``: variance scaling 1 / fan_in (in axis -2,
    out axis -1, the rest the receptive field) with a standard normal
    truncated to (-2, 2), divided by its stddev .87962566103423978."""
    fan_in = shape[-2] * (float(np.prod(shape)) / shape[-2] / shape[-1])
    f = np.float32
    stddev = np.sqrt(f(1.0 / fan_in)) / f(0.87962566103423978)
    return (jaxrand.truncated_normal(key, -2.0, 2.0, shape) * stddev).astype(f)


def init_flax_params(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """The parameters ``DescriptorNet.init(jax.random.PRNGKey(seed), x)``
    returns in the JAX package, as flat ``"a/b/name"`` numpy arrays
    (``init_from_layout``)."""
    return init_from_layout(flax_layout(cfg), seed)


def init_from_layout(layout, seed: int = 0) -> Dict[str, np.ndarray]:
    """What flax's ``Module.init(jax.random.PRNGKey(seed), x)`` draws for
    the parameters of ``layout`` (a ``flax_layout``-style table), as flat
    ``"a/b/name"`` numpy arrays: each parameter's key is flax's static fold
    of (its module path, the scope's make_rng counter) into the init key.
    In a scope the counter counts the parameters in creation order: a
    kernel is 1 and its bias 2, GroupNorm's scale 1 and bias 2, NetVLAD's
    assign_w 1, assign_b 2, centers 3."""
    root = jaxrand.prng_key(seed)
    counters: Dict[tuple, int] = {}
    out = {}
    for path, _, shape, init in layout:
        scope = path[:-1]
        counters[scope] = counters.get(scope, 0) + 1
        if init == "lecun":
            key = jaxrand.fold_in_static(root, scope + (counters[scope],))
            value = _lecun_normal(key, shape)
        else:
            value = (np.ones if init == "ones" else np.zeros)(shape, np.float32)
        out["/".join(path)] = value
    return out


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    if not isinstance(tree, dict):
        return {"/".join(prefix): np.asarray(tree, np.float32)}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, prefix + (str(k),)))
    return out


def convert_params(flax_params, cfg, device="cuda") -> Dict[str, torch.Tensor]:
    """flax params of ``cfg``'s net (numpy arrays; nested as ``net.init``
    returns them, with or without the ``"params"`` level, or flat
    ``"a/b/name"`` keys) -> the PyTorch state of ``DescriptorNet`` on
    ``device`` (``state_from_layout``)."""
    return state_from_layout(flax_params, flax_layout(cfg), device)


def state_from_layout(flax_params, layout, device="cuda") -> Dict[str, torch.Tensor]:
    """flax params (nested or flat, as ``convert_params`` takes them) -> the
    PyTorch state named by ``layout`` on ``device``. Kernels go HWIO ->
    OIHW (a depthwise (3, 3, 1, C) to (C, 1, 3, 3)); every other array
    keeps its shape. Raises unless the names and shapes are exactly those
    of ``layout``."""
    flat = _flatten(flax_params)
    flat = {k.removeprefix("params/"): v for k, v in flat.items()}
    want = {"/".join(p) for p, *_ in layout}
    if set(flat) != want:
        raise ValueError(
            f"params do not fit the configured net: missing {sorted(want - set(flat))[:4]}, "
            f"unexpected {sorted(set(flat) - want)[:4]}"
        )
    state = {}
    for path, name, shape, _ in layout:
        a = flat["/".join(path)]
        if a.shape != shape:
            raise ValueError(f"{'/'.join(path)} is {a.shape}, the configured net's is {shape}")
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1)
        state[name] = torch.tensor(np.ascontiguousarray(a, np.float32), device=device)
    return state


def export_params(state, cfg) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_params``: ``cfg``'s net's PyTorch state ->
    flat ``"a/b/name"`` float32 numpy arrays under flax's paths (OIHW
    kernels back to HWIO), as ``load_descriptor_params`` reads them from a
    ``params.npz``."""
    out = {}
    for path, name, _, _ in flax_layout(cfg):
        a = state[name].detach().float().cpu().numpy()
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 1, 0)
        out["/".join(path)] = np.ascontiguousarray(a)
    return out


def create_descriptor_model(cfg, seed: int = 0, device="cuda") -> Tuple[DescriptorNet, dict]:
    """(net, params) for ``cfg``, the params drawn as the JAX package's
    ``create_descriptor_model(cfg, seed)`` draws them (see
    ``init_flax_params``). The net holds the same values."""
    net = _net(cfg, device)
    params = convert_params(init_flax_params(cfg, seed), cfg, device)
    net.load_state_dict(params)
    return net, params


def load_descriptor_params(directory: str, cfg, device="cuda") -> Tuple[DescriptorNet, dict]:
    """(net, params) from a trained-weights artifact: ``params.npz`` of flax
    paths in ``directory`` (scripts/export_descriptor_synth.py), shaped for
    ``cfg``."""
    with np.load(os.path.join(directory, "params.npz")) as z:
        params = convert_params({k: z[k] for k in z.files}, cfg, device)
    net = _net(cfg, device)
    net.load_state_dict(params)
    return net, params


def describe_batch(net: DescriptorNet, params, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 image batch (B, H, W, C) -> (B, D) f32 unit descriptors, with
    ``params`` (a PyTorch state of ``net``; None: the net's own)."""
    with torch.no_grad():
        if params is None:
            return net(images_u8)
        return torch.func.functional_call(net, params, (images_u8,))
