"""Step builders: the train step with gradient accumulation, the serve
step, and the warm-start fine-tuner of the descent-to-delete algorithm.

The port's copy of the JAX package's ``train/loop.py`` on one device.  The
reference compiles its steps (and the fine-tuner's `steps` under one
``lax.scan``); here they are eager Python loops (PyTorch compiles nothing
per shape).  The reference's sharding arguments belong to the multi-GPU
item (ROADMAP.md queue 1 item 8) and are refused.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import torch

from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.state import TrainState, init_state
from repro_torch.utils.tree import FlatParams


def _grad(loss_fn, params: FlatParams, batch):
    """(loss, flat f32 gradient) of ``loss_fn(params, batch)``."""
    with torch.enable_grad():
        flat = params.flat.detach().requires_grad_(True)
        loss = loss_fn(params.with_flat(flat), batch)
        (grad,) = torch.autograd.grad(loss, [flat])
    return loss.detach(), grad


def make_train_step(
    loss_fn: Callable[[Mapping[str, torch.Tensor], Any], torch.Tensor],
    optimizer: Optimizer,
    lr_schedule: Callable[[int], float],
    grad_accum: int = 1,
    microbatch_sharding: Optional[Callable] = None,
    compute_sharding: Optional[Any] = None,
    compute_dtype=None,
    storage_sharding: Optional[Any] = None,
):
    """(state, batch) -> (state, {"loss", "lr"}).  loss_fn: (params,
    batch) -> scalar.

    With ``grad_accum > 1`` the batch splits along axis 0 into that many
    microbatches, whose losses and f32 gradients are summed in order and
    divided by their count, as the reference's scan does.  The optimizer
    updates the f32 master parameters; the loss is a device scalar."""
    sharding = dict(microbatch_sharding=microbatch_sharding,
                    compute_sharding=compute_sharding,
                    compute_dtype=compute_dtype,
                    storage_sharding=storage_sharding)
    given = [k for k, v in sharding.items() if v is not None]
    if given:
        raise NotImplementedError(
            f"make_train_step({', '.join(given)}=...): sharded and "
            "mixed-precision ZeRO steps belong to multi-GPU training, which "
            "is not ported (ROADMAP.md queue 1 item 8)")

    def train_step(state: TrainState, batch):
        params = state.params
        if grad_accum == 1:
            loss, grads = _grad(loss_fn, params, batch)
        else:
            loss = params.flat.new_zeros((), dtype=torch.float32)
            grads = torch.zeros_like(params.flat, dtype=torch.float32)
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            for i in range(grad_accum):
                lo, g = _grad(loss_fn, params, {k: v[i] for k, v in micro.items()})
                loss = loss + lo
                grads = grads + g
            loss = loss / grad_accum
            grads = grads / grad_accum
        lr = lr_schedule(state.step)
        new, opt_state = optimizer.update(params.flat, grads,
                                          state.opt_state, lr)
        return (TrainState(params.with_flat(new), opt_state, state.step + 1),
                {"loss": loss, "lr": lr})

    return train_step


def make_serve_step(decode_fn: Callable):
    """(params, batch, caches) -> (logits, caches)."""

    def serve_step(params, batch, caches):
        return decode_fn(params, batch, caches)

    return serve_step


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
        loss, grad = _grad(loss_fn, state.params, batch)
        new, opt_state = optimizer.update(state.params.flat, grad,
                                          state.opt_state, lr)
        params = state.params.with_flat(project(new))
        return TrainState(params, opt_state, state.step + 1), loss

    def run(params: FlatParams, batch) -> Tuple[FlatParams, torch.Tensor]:
        state = init_state(params, optimizer)
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(loss)
        return state.params, (torch.stack(losses) if losses else
                              params.flat.new_zeros(0))

    return run
