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

With ``mesh=``, the step is data-parallel over the mesh's ranks: each
rank describes its contiguous ``B/n`` of the batch, the descriptors are
all-gathered, and every rank computes the whole batch's all-pairs loss
(the loss couples every pair of the batch, so per-rank losses would be
another function). Autograd reaches only the rank's own descriptors, so
each rank's parameter gradient is its shard's share, counted once; one
``all_reduce`` sums the shares into the full batch's gradient, and every
rank takes the same Adam step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from cerebro_tpu_torch.models.backbones import normalize_image
from cerebro_tpu_torch.models.descriptor import DescriptorNet, convert_params
from cerebro_tpu_torch.parallel.mesh import all_gather, all_reduce_sum
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
    images_u8: torch.Tensor,  # (B, H, W, C) uint8, B divisible by the mesh axis
    labels: torch.Tensor,  # (B,) integer place ids
    mesh=None,  # parallel.Mesh: data-parallel over its ``axis`` ranks
    axis: str = "db",
) -> Tuple[TrainState, torch.Tensor]:
    """One Adam step on the all-pairs loss: (new state, the loss before
    the step). On a mesh every rank passes the whole batch and gets the
    same state."""
    if mesh is None:
        loss, grads = value_and_grad(
            lambda p: descriptor_loss(net, p, images_u8, labels), state.params
        )
    else:
        loss, grads = _data_parallel_grads(net, state.params, images_u8, labels, mesh, axis)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    return TrainState(params=apply_updates(state.params, updates), opt_state=opt_state,
                      step=state.step + 1), loss


def _data_parallel_grads(net, params, images_u8, labels, mesh, axis):
    """(loss, gradient) of ``descriptor_loss`` on the whole batch, each rank
    running the net on its ``B/n`` images."""
    n, r = mesh.shape[axis], mesh.rank(axis)
    B = images_u8.shape[0]
    if B % n:
        raise ValueError(f"batch {B} must divide over the mesh's {n} ranks")
    b = B // n

    def loss_fn(p):
        local = torch.func.functional_call(net, p, (normalize_image(images_u8[r * b : (r + 1) * b]),))
        parts = list(all_gather(local.detach(), mesh, axis))
        parts[r] = local  # the gradient flows through this rank's rows only
        return allpair_loss(torch.cat(parts), labels)

    loss, grads = value_and_grad(loss_fn, params)
    return loss, all_reduce_sum(grads, mesh, axis)
