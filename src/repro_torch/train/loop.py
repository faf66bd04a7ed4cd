"""The warm-start fine-tuner of the descent-to-delete algorithm.

The JAX package compiles `steps` full-batch train steps under one
``lax.scan``; here they are a Python loop of eager steps (PyTorch compiles
nothing per shape).  The LM training loop (`make_train_step` with
gradient accumulation, `make_serve_step`) waits for the LM's training
driver.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.state import TrainState, init_state
from repro_torch.utils.tree import FlatParams


def make_finetune_runner(loss_fn: Callable[[Mapping[str, torch.Tensor], Any],
                                           torch.Tensor],
                         optimizer: Optimizer, lr: float, steps: int,
                         project_radius: Optional[float] = None):
    """`steps` full-batch gradient steps of ``loss_fn(params, batch)`` from
    the given params: the descent-to-delete inner loop (noisy projected
    fine-tuning from the last checkpoint; `core.algorithms`).

    `project_radius` adds the projected-GD step the convex analysis
    assumes: after each update the params are radially projected back onto
    the L2 ball of that radius (a no-op while the iterates stay inside).

    Returns ``run(params, batch) -> (params, losses)``, losses a (steps,)
    tensor on the params' device."""

    def project(flat: torch.Tensor) -> torch.Tensor:
        if project_radius is None:
            return flat
        norm = torch.sqrt(torch.clamp(torch.sum(flat * flat), min=1e-30))
        return flat * torch.clamp(project_radius / norm, max=1.0)

    def step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        with torch.enable_grad():
            flat = state.params.flat.detach().requires_grad_(True)
            loss = loss_fn(state.params.with_flat(flat), batch)
            (grad,) = torch.autograd.grad(loss, [flat])
        new, opt_state = optimizer.update(state.params.flat, grad,
                                          state.opt_state, lr)
        params = state.params.with_flat(project(new))
        return TrainState(params, opt_state, state.step + 1), loss.detach()

    def run(params: FlatParams, batch) -> Tuple[FlatParams, torch.Tensor]:
        state = init_state(params, optimizer)
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(loss)
        return state.params, (torch.stack(losses) if losses else
                              params.flat.new_zeros(0))

    return run
