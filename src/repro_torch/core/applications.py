"""The paper's §5 applications on the DeltaGrad replay.

§5.4 data valuation (leave-one-out influence), §5.5 jackknife bias
reduction, §5.6 cross-conformal prediction.  Each needs MANY retrainings on
(n-1)- or (n-n/K)-row subsets, and each retrains with `deltagrad_retrain`
instead of from scratch: that is the paper's point.  ``device`` goes to
every replay (None: the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.deltagrad import (DeltaGradConfig, Objective,
                                        deltagrad_retrain)
from repro_torch.core.history import TrainingHistory
from repro_torch.data.dataset import Dataset
from repro_torch.utils.tree import FlatParams


def leave_one_out_models(objective: Objective, history: TrainingHistory,
                         ds: Dataset, indices: Sequence[int],
                         cfg: DeltaGradConfig, device=None) -> List[FlatParams]:
    """w^I_{-i} for each i: the workhorse of §5.4 and §5.5."""
    return [deltagrad_retrain(objective, history, ds, np.array([i]), cfg,
                              mode="delete", device=device)[0]
            for i in indices]


def data_values(objective: Objective, history: TrainingHistory, ds: Dataset,
                indices: Sequence[int], cfg: DeltaGradConfig,
                device=None) -> np.ndarray:
    """Influence of each row, ||w_{-i} - w*|| (Cook-style deletion
    diagnostics, §5.4)."""
    w_star = history.final_params.flat
    return np.asarray([
        float((p.flat - w_star.to(p.flat.device)).norm())
        for p in leave_one_out_models(objective, history, ds, indices, cfg,
                                      device=device)])


def jackknife_bias_correct(estimator: Callable[[Any], np.ndarray],
                           objective: Objective, history: TrainingHistory,
                           ds: Dataset, cfg: DeltaGradConfig,
                           indices: Optional[Sequence[int]] = None,
                           device=None) -> Dict[str, np.ndarray]:
    """Quenouille's jackknife (§5.5): f_jack = f_n - (n-1)(mean_i f_{-i} -
    f_n).  `estimator` maps parameters to the statistic; `indices`
    defaults to every remaining row (pass a subsample for speed)."""
    n = ds.n_remaining
    if indices is None:
        indices = ds.remaining_indices
    f_n = np.asarray(estimator(history.final_params))
    f_loo = [np.asarray(estimator(p)) for p in leave_one_out_models(
        objective, history, ds, indices, cfg, device=device)]
    bias = (n - 1) * (np.mean(f_loo, axis=0) - f_n)
    return {"estimate": f_n, "bias": bias, "corrected": f_n - bias}


@dataclass
class ConformalSet:
    lower: np.ndarray
    upper: np.ndarray
    coverage_level: float


def cross_conformal(objective: Objective, history: TrainingHistory,
                    ds: Dataset,
                    predict_fn: Callable[[Any, np.ndarray], np.ndarray],
                    x_test: np.ndarray, K: int = 5, alpha: float = 0.1,
                    cfg: Optional[DeltaGradConfig] = None, seed: int = 0,
                    device=None) -> ConformalSet:
    """Vovk's cross-conformal predictive intervals (§5.6).

    Splits the rows into K folds; for each fold, deletes it with DeltaGrad
    and takes the out-of-fold residuals; the interval at x is the
    alpha-calibrated union of f_{-S_k}(x) ± R_i."""
    cfg = cfg or DeltaGradConfig()
    rng = np.random.default_rng(seed)
    folds = np.array_split(rng.permutation(ds.n), K)
    all_centers, all_res = [], []
    for fold in folds:
        params, _ = deltagrad_retrain(objective, history, ds, fold, cfg,
                                      mode="delete", device=device)
        preds = predict_fn(params, ds.columns["x"][fold])
        all_res.extend(np.abs(ds.columns["y"][fold].astype(np.float64)
                              - preds).tolist())
        all_centers.append(predict_fn(params, x_test))
    all_res = np.sort(np.asarray(all_res))
    q = all_res[min(len(all_res) - 1,
                    int(np.ceil((1 - alpha) * (len(all_res) + 1))))]
    centers = np.stack(all_centers)  # (K, n_test)
    return ConformalSet(lower=centers.min(0) - q, upper=centers.max(0) + q,
                        coverage_level=1 - 2 * alpha - 2 * K / ds.n)
