"""Descriptor training step (counterpart of cerebro_tpu/train/trainer.py).

One step: the all-pairs loss of a place-labelled batch, its gradient with
respect to every parameter, and an Adam update. This replaces the
reference's out-of-repo GPU training (mpkuse/cartwheel_train, ref
README.md:155) with a path in the package.

The optimizer and the gradient are ``train/optim.py``'s: ``Adam``
computes what ``optax.adam(lr)`` computes, in optax's state layout, and
``value_and_grad`` takes the gradient whatever the caller's mode
(``describe_batch`` runs under ``no_grad``), with TF32 off on CUDA over
the forward and the backward.

The data-parallel step over a mesh (the JAX package's ``mesh=``) is not
ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from cerebro_tpu_torch.models.backbones import normalize_image
from cerebro_tpu_torch.models.descriptor import DescriptorNet, convert_params
from cerebro_tpu_torch.train.loss import allpair_loss
from cerebro_tpu_torch.train.optim import Adam, AdamState, apply_updates, value_and_grad


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Dict[str, torch.Tensor]  # a PyTorch state of the net
    opt_state: AdamState
    step: torch.Tensor  # () int32


def create_train_state(params: Dict[str, torch.Tensor], lr: float = 1e-3) -> Tuple[TrainState, Adam]:
    tx = Adam(lr)
    some = next(iter(params.values()))
    return TrainState(params=dict(params), opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=some.device)), tx


def convert_train_state(jax_state, cfg, device="cuda") -> TrainState:
    """The JAX package's ``TrainState`` for ``cfg``'s net, its leaves as
    numpy arrays (``jax.tree.map(np.asarray, state)``), as the port's:
    params and Adam's ``mu`` and ``nu`` through ``convert_params``; Adam's
    ``count`` and the step copied. ``jax_state.opt_state`` is optax.adam's
    state, whose first element holds ``count``, ``mu`` and ``nu``."""
    adam = jax_state.opt_state[0]

    def scalar(x):
        return torch.tensor(int(x), dtype=torch.int32, device=device)

    return TrainState(
        params=convert_params(jax_state.params, cfg, device),
        opt_state=AdamState(scalar(adam.count), convert_params(adam.mu, cfg, device),
                            convert_params(adam.nu, cfg, device)),
        step=scalar(jax_state.step),
    )


def descriptor_loss(net: DescriptorNet, params: Dict[str, torch.Tensor],
                    images_u8: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The train step's loss: ``allpair_loss`` of the batch's descriptors."""
    desc = torch.func.functional_call(net, params, (normalize_image(images_u8),))
    return allpair_loss(desc, labels)


def train_step(
    net: DescriptorNet,
    tx: Adam,
    state: TrainState,
    images_u8: torch.Tensor,  # (B, H, W, C) uint8
    labels: torch.Tensor,  # (B,) integer place ids
    mesh=None,
    axis: str = "db",
) -> Tuple[TrainState, torch.Tensor]:
    """One Adam step on the all-pairs loss: (new state, the loss before
    the step). ``mesh`` (the JAX package's data-parallel step) raises."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is not ported yet "
            "(ROADMAP Queue 1: item 7, parallel/)"
        )
    loss, grads = value_and_grad(lambda p: descriptor_loss(net, p, images_u8, labels), state.params)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    return TrainState(params=apply_updates(state.params, updates), opt_state=opt_state,
                      step=state.step + 1), loss
