"""Adam with optax's semantics, and the gradient of a loss over a params
dict: the pieces of a train step that need no model (``train/trainer.py``'s
descriptor step and ``models/keypoints.py``'s step share them).

``Adam`` computes what ``optax.adam(lr)`` computes (b1 0.9, b2 0.999, eps
1e-8, eps_root 0), and keeps its state in optax's layout, ``(count, mu,
nu)``: an int32 count, incremented before the bias correction, and f32
first and second moments under the parameters' names. ``torch.optim.Adam``
keeps its state elsewhere and under other names, so the update is written
here as ``torch._foreach_*`` ops over the params dict.

``value_and_grad`` takes the gradient with ``torch.autograd.grad`` under
``torch.enable_grad()``, whatever the caller's mode. On CUDA the forward
and the backward run with TF32 off for cuDNN and matmul: the backward runs
inside ``autograd.grad``, after the forward's own ``exact_fp32`` scopes
have closed, and cuDNN allows TF32 by default.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from cerebro_tpu_torch.utils.precision import exact_fp32

_INT32_MAX = 2**31 - 1


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the moments."""

    count: torch.Tensor  # () int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """``optax.adam(lr)`` over a dict of float32 tensors: ``init`` and
    ``update`` as optax's ``GradientTransformation`` has them, and
    ``apply_updates``. Per parameter:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
        update = -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    """

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        some = next(iter(params.values()))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=some.device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params=None) -> Tuple[Dict[str, torch.Tensor], AdamState]:
        names = list(grads)
        g = [grads[k] for k in names]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul([state.mu[k] for k in names], self.b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
                                torch._foreach_mul([state.nu[k] for k in names], self.b2))
        # optax's safe_increment: the count stops at the int32 maximum
        count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
        # the bias corrections in f32, as optax computes decay**count
        mu_hat = torch._foreach_div(mu, 1 - self.b1 ** count.float())
        nu_hat = torch._foreach_div(nu, 1 - self.b2 ** count.float())
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, den), -self.lr)
        return dict(zip(names, updates)), AdamState(count, dict(zip(names, mu)), dict(zip(names, nu)))


def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]) -> dict:
    """``optax.apply_updates``: params + updates, per name."""
    names = list(params)
    new = torch._foreach_add([params[k] for k in names], [updates[k] for k in names])
    return dict(zip(names, new))


def value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor]):
    """(``loss_fn(params)``, its gradient with respect to every tensor of
    ``params``), both detached. ``loss_fn`` returns the loss or (loss,
    aux), as ``jax.value_and_grad(..., has_aux=True)`` takes it. Runs under
    ``enable_grad`` and, on CUDA, with TF32 off for the forward and the
    backward."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    with torch.enable_grad(), exact_fp32(leaves[0], torch.float32):
        out = loss_fn(dict(zip(names, leaves)))
        loss = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss, leaves)
    if isinstance(out, tuple):
        out = (out[0].detach(), tuple(t.detach() for t in out[1]))
    else:
        out = out.detach()
    return out, dict(zip(names, grads))
