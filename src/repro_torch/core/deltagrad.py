"""DeltaGrad: Algorithm 1 (batch deletion/addition, GD and SGD).

Reference: Wu, Dobriban, Davidson, "DeltaGrad: Rapid retraining of machine
learning models", ICML 2020.  Notation follows the paper:

  w_t    cached original iterates            (TrainingHistory)
  g_t    cached (mini-)batch mean gradients  (TrainingHistory)
  w^I_t  DeltaGrad iterates
  w^U_t  exact retraining iterates ("BaseL", eq. (1)/(S6))

This module holds the objective and the public entry points; the execution
lives in `core.engine`.  Every entry point takes ``device``: None means the
card, and raises when there is none; pass ``device="cpu"`` for the plain
path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (DeltaGradConfig, RetrainStats,
                                     run_baseline, run_replay, run_training)
from repro_torch.core.history import HistoryMeta, TrainingHistory
from repro_torch.data.dataset import Dataset
from repro_torch.models.attention_config import check_impl, use_attention_impl
from repro_torch.utils.tree import FlatParams, key_order

__all__ = ["Objective", "DeltaGradConfig", "RetrainStats", "HistoryMeta",
           "TrainingHistory", "sgd_train_with_cache", "baseline_retrain",
           "deltagrad_retrain"]


@dataclass(eq=False)
class Objective:
    """Per-example loss; the engine derives every gradient from it.

    per_example_loss(params, batch_columns) -> (k,) losses, one per row.
    l2: coefficient of the (lambda/2)||w||^2 term included in every F_i.
    """

    per_example_loss: Callable[[Mapping[str, torch.Tensor],
                                Dict[str, torch.Tensor]], torch.Tensor]
    l2: float = 0.0

    def weighted_mean_loss(self, params: Mapping[str, torch.Tensor],
                           batch: Dict[str, torch.Tensor],
                           weights: torch.Tensor) -> torch.Tensor:
        losses = self.per_example_loss(params, batch)
        denom = torch.clamp(weights.sum(), min=1.0)
        data_term = (losses * weights).sum() / denom
        if self.l2:
            sq = sum(torch.sum(params[k] * params[k]) for k in key_order(params))
            return data_term + 0.5 * self.l2 * sq
        return data_term

    def make_grad_fn(self):
        """(params: FlatParams, batch, weights) -> flat mean gradient over
        the weighted rows, in the flat order of `params` (autograd)."""

        def grad_fn(params: FlatParams, batch, weights) -> torch.Tensor:
            names = key_order(params)
            with torch.enable_grad():
                leaves = {k: params[k].detach().requires_grad_(True)
                          for k in names}
                loss = self.weighted_mean_loss(leaves, batch, weights)
                grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            return torch.cat([g.reshape(-1) for g in grads])

        return grad_fn

    @classmethod
    def from_model(cls, model, *, remat: bool = False,
                   loss_chunk: Optional[int] = None, l2: float = 0.0,
                   attn_impl: Optional[str] = None,
                   dtype: Optional[torch.dtype] = None) -> "Objective":
        """An Objective over a `models.registry.Model`'s LM loss.

        Row i's loss is the model's loss on the batch of document i
        alone: its mean masked token loss and, for an MoE model, the
        router's aux term with row i routed as its own token group.  The
        reference builds that with ``jax.vmap`` over batch-1 slices; here
        one batched forward gives every row's value
        (`Model.per_row_loss_fn`): rows never mix in attention, and the
        MoE FFN routes each row under its own capacity, so row i's loss
        does not depend on the other rows of its batch, which is what
        DeltaGrad's subtraction of the changed rows' gradients needs.
        ``remat`` and ``loss_chunk`` go to the loss (per-layer activation
        checkpointing, the logits' chunk); ``dtype`` is the compute dtype
        (None: the model's bf16).  ``attn_impl`` pins
        `models.attention_config` for every call of this objective:
        ``"flash"`` puts the flash kernel on every forward pass."""
        if attn_impl is not None:
            check_impl(attn_impl)
        kw: Dict[str, object] = {"remat": remat}
        if loss_chunk is not None:
            kw["loss_chunk"] = loss_chunk
        if dtype is not None:
            kw["dtype"] = dtype

        def per_example_loss(params, batch):
            with use_attention_impl(attn_impl):
                return model.per_row_loss_fn(params, batch, **kw)

        return cls(per_example_loss=per_example_loss, l2=l2)


def sgd_train_with_cache(objective: Objective, params0: FlatParams,
                         ds: Dataset, meta: HistoryMeta, tier: str = "stacked",
                         codec: str = "f32", spill_dir: Optional[str] = None,
                         window: int = 0, spill_window: Optional[int] = None,
                         device=None) -> Tuple[FlatParams, TrainingHistory]:
    """Train w_t by plain SGD (the paper's optimizer), caching (w_t, g_t).

    ``tier="stacked"`` keeps the path on the device as f32.  ``"host"``
    offloads it to host RAM and ``"disk"`` spills it under `spill_dir`
    (``"auto"``: a fresh tempdir), each encoded by `codec` ("f32", "bf16",
    "int8", "delta_bf16", "delta_int8") and recorded `window` steps at a
    time (0: auto); `deltagrad_retrain` then streams it back in windows."""
    return run_training(objective, params0, ds, meta, device=device,
                        tier=tier, codec=codec, spill_dir=spill_dir,
                        window=window, spill_window=spill_window)


def baseline_retrain(objective: Objective, ds: Dataset, meta: HistoryMeta,
                     params0: FlatParams, changed_idx: np.ndarray,
                     mode: str = "delete",
                     device=None) -> Tuple[FlatParams, RetrainStats]:
    """BaseL: exact retraining from scratch on the modified dataset,
    replaying the original schedule (paper eq. (1) / (S6))."""
    return run_baseline(objective, ds, meta, params0, changed_idx, mode=mode,
                        device=device)


def deltagrad_retrain(objective: Objective, history: TrainingHistory,
                      ds: Dataset, changed_idx: np.ndarray,
                      cfg: DeltaGradConfig, mode: str = "delete",
                      params0: Optional[FlatParams] = None,
                      device=None, placement=None,
                      store=None) -> Tuple[FlatParams, RetrainStats]:
    """Algorithm 1 (GD + SGD unified; GD == SGD with batch_size >= n).

    `placement` (a `core.store.PlacementPolicy`) shards the replay across
    the ranks of the default process group, each of which makes this
    call; `store` reuses a prebuilt `core.store.HistoryStore` across
    calls."""
    return run_replay(objective, history, ds, changed_idx, cfg, mode=mode,
                      params0=params0, device=device, placement=placement,
                      store=store)
