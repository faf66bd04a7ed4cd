"""The paper's own model family (§4.1) and its Objectives: L2-regularized
binary logistic regression (the RCV1 / HIGGS experiments), multinomial
logistic regression (MNIST / covtype), and the 2-layer ReLU network (the
MNIST^n experiment; non-convex, so DeltaGrad runs it with the Algorithm-4
guard).

Parameters are a `FlatParams`, leaves in sorted key order (logreg ``{"b",
"w"}`` with a 0-d bias, the MLP ``{"b1", "b2", "w1", "w2"}``), which is
the order jax's ``ravel_pytree`` gives the JAX package's parameter dicts.
The ``*_init`` functions draw from a torch.Generator, so their numbers
differ from the JAX package's ``jax.random`` draws; parity tests feed both
packages the same numpy arrays (`params_from_jax`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.deltagrad import Objective
from repro_torch.data.dataset import Dataset
from repro_torch.utils.tree import FlatParams, key_order


# --------------------------------------------------------------------------
# Binary logistic regression (RCV1 / HIGGS experiments)
# --------------------------------------------------------------------------


def logreg_init(d: int, generator: Optional[torch.Generator] = None,
                device=None) -> FlatParams:
    """0.01-scaled normal weights, a zero 0-d bias."""
    w = 0.01 * torch.randn(d, generator=generator)
    return FlatParams.from_tensors({"w": w, "b": torch.zeros(())},
                                   device=device)


def logreg_per_example_loss(params: Mapping[str, torch.Tensor],
                            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    y = batch["y"].float()
    # numerically stable BCE-with-logits, the reference's expression
    return (torch.clamp(logits, min=0.0) - logits * y
            + torch.log1p(torch.exp(-logits.abs())))


def logreg_objective(l2: float = 5e-3) -> Objective:
    return Objective(per_example_loss=logreg_per_example_loss, l2=l2)


def logreg_predict(params: Mapping[str, torch.Tensor],
                   x: np.ndarray) -> np.ndarray:
    p = params_to_numpy(params)
    return (np.asarray(x @ p["w"] + float(p["b"])) > 0).astype(np.int32)


def logreg_accuracy(params: Mapping[str, torch.Tensor], ds: Dataset) -> float:
    pred = logreg_predict(params, ds.columns["x"])
    return float((pred == ds.columns["y"]).mean())


# --------------------------------------------------------------------------
# Multinomial logistic regression (MNIST / covtype experiments)
# --------------------------------------------------------------------------


def multiclass_init(d: int, num_classes: int,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> FlatParams:
    w = 0.01 * torch.randn(d, num_classes, generator=generator)
    return FlatParams.from_tensors({"w": w, "b": torch.zeros(num_classes)},
                                   device=device)


def multiclass_per_example_loss(params: Mapping[str, torch.Tensor],
                                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    logz = torch.logsumexp(logits, dim=-1)
    true = logits.gather(1, batch["y"].long()[:, None])[:, 0]
    return logz - true


def multiclass_objective(l2: float = 5e-3) -> Objective:
    return Objective(per_example_loss=multiclass_per_example_loss, l2=l2)


def multiclass_accuracy(params: Mapping[str, torch.Tensor],
                        ds: Dataset) -> float:
    p = params_to_numpy(params)
    logits = ds.columns["x"] @ p["w"] + p["b"]
    return float((logits.argmax(-1) == ds.columns["y"]).mean())


# --------------------------------------------------------------------------
# 2-layer ReLU network (MNIST^n)
# --------------------------------------------------------------------------


def mlp_init(d: int, hidden: int, num_classes: int,
             generator: Optional[torch.Generator] = None,
             device=None) -> FlatParams:
    """Scaled-normal weights, zero biases.  Draws from `generator` (a
    torch.Generator on the CPU), so the numbers differ from the JAX
    package's ``mlp_init``; parity tests feed both the same numpy arrays."""
    w1 = torch.randn(d, hidden, generator=generator) / np.sqrt(d)
    w2 = torch.randn(hidden, num_classes, generator=generator) / np.sqrt(hidden)
    return FlatParams.from_tensors(
        {"w1": w1, "b1": torch.zeros(hidden), "w2": w2,
         "b2": torch.zeros(num_classes)}, device=device)


def mlp_per_example_loss(params: Mapping[str, torch.Tensor],
                         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = torch.relu(batch["x"] @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    logz = torch.logsumexp(logits, dim=-1)
    true = logits.gather(1, batch["y"].long()[:, None])[:, 0]
    return logz - true


def mlp_objective(l2: float = 1e-3) -> Objective:
    return Objective(per_example_loss=mlp_per_example_loss, l2=l2)


def mlp_accuracy(params: Mapping[str, torch.Tensor], ds: Dataset) -> float:
    p = params_to_numpy(params)
    h = np.maximum(ds.columns["x"] @ p["w1"] + p["b1"], 0)
    logits = h @ p["w2"] + p["b2"]
    return float((logits.argmax(-1) == ds.columns["y"]).mean())


# --------------------------------------------------------------------------
# Carrying weights across
# --------------------------------------------------------------------------


def params_from_jax(np_params: Mapping[str, np.ndarray], device) -> FlatParams:
    """Carry weights across: a dict of numpy arrays (e.g. the JAX package's
    parameters after ``np.asarray``) in, the port's flat-buffer dict out.
    Any of the three families; a 0-d leaf (logreg's bias) stays 0-d."""
    return FlatParams.from_tensors(np_params, device=device)


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: a dict of f32 numpy arrays, each
    of its leaf's shape (0-d for logreg's bias)."""
    return {k: params[k].detach().float().cpu().numpy() for k in key_order(params)}
