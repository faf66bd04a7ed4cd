"""Minimal optax-style optimizers over a flat parameter buffer.

An Optimizer is (init_fn, update_fn):
    state = init(flat)
    new_flat, new_state = update(flat, grad, state, lr)

``flat`` is a `utils.tree.FlatParams` buffer, so one update covers every
leaf.  SGD (+momentum) is what the DeltaGrad path assumes (plain SGD);
AdamW waits for the LM training loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Dict[str, Any]]
    update: Callable[[torch.Tensor, torch.Tensor, Dict[str, Any], float],
                     Tuple[torch.Tensor, Dict[str, Any]]]
    name: str = "opt"


def sgd(momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(flat):
        if momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "mu": torch.zeros_like(flat)}

    def update(flat, grad, state, lr):
        if weight_decay:
            grad = grad + weight_decay * flat
        if momentum == 0.0:
            return flat - lr * grad, {"step": state["step"] + 1}
        mu = momentum * state["mu"] + grad
        return flat - lr * mu, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update, name="sgd")
