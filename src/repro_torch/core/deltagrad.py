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
from repro_torch.utils.tree import FlatParams

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
            sq = sum(torch.sum(params[k] * params[k]) for k in sorted(params))
            return data_term + 0.5 * self.l2 * sq
        return data_term

    def make_grad_fn(self):
        """(params: FlatParams, batch, weights) -> flat mean gradient over
        the weighted rows, in the flat order of `params` (autograd)."""

        def grad_fn(params: FlatParams, batch, weights) -> torch.Tensor:
            names = sorted(params)
            with torch.enable_grad():
                leaves = {k: params[k].detach().requires_grad_(True)
                          for k in names}
                loss = self.weighted_mean_loss(leaves, batch, weights)
                grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            return torch.cat([g.reshape(-1) for g in grads])

        return grad_fn


def sgd_train_with_cache(objective: Objective, params0: FlatParams,
                         ds: Dataset, meta: HistoryMeta,
                         device=None) -> Tuple[FlatParams, TrainingHistory]:
    """Train w_t by plain SGD (the paper's optimizer), caching (w_t, g_t)."""
    return run_training(objective, params0, ds, meta, device=device)


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
                      device=None) -> Tuple[FlatParams, RetrainStats]:
    """Algorithm 1 (GD + SGD unified; GD == SGD with batch_size >= n)."""
    return run_replay(objective, history, ds, changed_idx, cfg, mode=mode,
                      params0=params0, device=device)
