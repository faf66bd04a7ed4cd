"""Minimal optax-style optimizers over a flat parameter buffer.

An Optimizer is (init_fn, update_fn):
    state = init(flat)
    new_flat, new_state = update(flat, grad, state, lr)

``flat`` is a `utils.tree.FlatParams` buffer, so one update covers every
leaf.  SGD (+momentum) is what the DeltaGrad path assumes (plain SGD);
AdamW serves the LM training loop.  States hold flat f32 tensors of the
buffer's length and the step as a Python int.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
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


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Optimizer:
    """The reference's AdamW: the gradient clipped to global norm
    `grad_clip` (0: no clip), both bias corrections in f32, and the
    weight decay decoupled from the moments, in the reference's order.
    The global norm is one sum over the flat vector where the reference
    sums leaf by leaf, so the two differ in the sum's order only."""

    def init(flat):
        return {"step": 0, "m": torch.zeros_like(flat, dtype=torch.float32),
                "v": torch.zeros_like(flat, dtype=torch.float32)}

    def update(flat, grad, state, lr):
        if grad_clip:
            gn = torch.sqrt(torch.sum(torch.square(grad.float())))
            scale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
            grad = grad * scale
        step = state["step"] + 1
        # 1 - b ** step in f32 on the host, as the reference's
        # ``1.0 - b ** step.astype(f32)``
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        m = b1 * state["m"] + (1 - b1) * grad
        v = b2 * state["v"] + (1 - b2) * torch.square(grad)
        mhat = m / bc1
        vhat = v / bc2
        new = flat - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * flat)
        return new, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, name="adamw")
