"""The training path's optimizers: plain functions on tensors, with their
state in dicts keyed like the parameters.

Counterpart of the optax transforms ``islam_tpu/train.py`` builds (Adam,
RMSprop, SGD for the pose head; Adam for the denoiser), with optax's update
rules, so that the port and the JAX package step alike from one gradient:

- Adam: ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
  correction), which is also ``torch.optim.Adam``'s rule.
- RMSprop: ``optax.rmsprop``: nu = 0.9 nu + 0.1 g^2 from nu = 0, and the step
  -lr g / sqrt(nu + eps), eps inside the root.  ``torch.optim.RMSprop``
  differs (alpha 0.99, eps outside the root), so it is not used.
- SGD: -lr g.

``--fix-model-parts`` freezes by leaving the named parameters out of the
optimizer altogether (``trainable``): they get no update and no state, as
``requires_grad=False`` does in the reference (VONet.py:20-26).  The JAX
package wraps the optimizer in ``optax.masked`` instead, which passes the
raw gradient through for the masked leaves, so its frozen leaves move.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], Dict]
    # (grads, state) -> (updates, new state); updates are added to params
    update: Callable[[Tensors, Dict], Tuple[Tensors, Dict]]


def sgd(lr: float) -> Optimizer:
    def update(grads, state):
        return {k: -lr * g for k, g in grads.items()}, state
    return Optimizer(lambda params: {}, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state):
        count = state["count"] + 1
        # optax forms the bias corrections in float32, from the float32
        # decays: 1 - 0.999 is 1.3e-5 off in float32, which is 6e-6 of
        # the first step.
        c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(count))
                  for b in (b1, b2))
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1.0 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1.0 - b2) * g * g + b2 * state["nu"][k]
            out[k] = -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
        return out, {"count": count, "mu": mu, "nu": nu}
    return Optimizer(init, update)


def rmsprop(lr: float, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state):
        nu, out = {}, {}
        for k, g in grads.items():
            nu[k] = (1.0 - decay) * g * g + decay * state["nu"][k]
            out[k] = -lr * (g * torch.rsqrt(nu[k] + eps))
        return out, {"nu": nu}
    return Optimizer(init, update)


OPTIMIZERS = {"adam": adam, "rmsprop": rmsprop, "sgd": sgd}


def trainable(named_params: Iterable[Tuple[str, torch.Tensor]],
              frozen_prefixes: Iterable[str] = ()) -> Tensors:
    """{name: parameter} of the parameters whose name starts with none of
    ``frozen_prefixes``."""
    frozen = tuple(frozen_prefixes)
    return {k: p for k, p in named_params if not k.startswith(frozen)}


def state_dict(state: Dict) -> Dict:
    """An optimizer state as a checkpoint holds it: the same nesting, each
    tensor copied to the CPU."""
    if torch.is_tensor(state):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: state_dict(v) for k, v in state.items()}
    return state


def load_state_dict(saved: Dict, device) -> Dict:
    """An optimizer state from ``state_dict``'s form, tensors on ``device``."""
    if torch.is_tensor(saved):
        return saved.to(device)
    if isinstance(saved, dict):
        return {k: load_state_dict(v, device) for k, v in saved.items()}
    return saved


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params[k] += updates[k], in place, for every key of ``updates``."""
    for k, u in updates.items():
        params[k].add_(u)
