"""The paper's 2-layer ReLU network (the MNIST^n experiment; non-convex, so
DeltaGrad runs it with the Algorithm-4 guard) and its Objective.

Parameters are a `FlatParams`: ``{"b1", "b2", "w1", "w2"}`` as views into
one flat buffer, in that (sorted) order, which is the order jax's
``ravel_pytree`` gives the JAX package's parameter dict.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.deltagrad import Objective
from repro_torch.data.dataset import Dataset
from repro_torch.utils.tree import FlatParams


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


def params_from_jax(np_params: Mapping[str, np.ndarray], device) -> FlatParams:
    """Carry weights across: a dict of numpy arrays (e.g. the JAX package's
    parameters after ``np.asarray``) in, the port's flat-buffer dict out."""
    return FlatParams.from_tensors(np_params, device=device)


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: a dict of f32 numpy arrays."""
    return {k: params[k].detach().float().cpu().numpy() for k in sorted(params)}
