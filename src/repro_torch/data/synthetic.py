"""Synthetic data generators (paper-scale stand-ins for MNIST/covtype and
RCV1/HIGGS).  Deterministic in the seed: the same seed gives the same
arrays as the JAX package's generators, which draw from numpy the same way."""

from __future__ import annotations

import numpy as np

from repro_torch.data.dataset import Dataset


def binary_classification(
    n: int, d: int, seed: int = 0, margin: float = 1.0, noise: float = 0.25
) -> Dataset:
    """Linearly-separable-ish binary labels in {0, 1} (RCV1/HIGGS stand-in)."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d,)) / np.sqrt(d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = margin * (x @ w_true) + noise * rng.normal(size=(n,))
    y = (logits > 0).astype(np.int32)
    return Dataset({"x": x, "y": y})


def multiclass_classification(
    n: int, d: int, num_classes: int, seed: int = 0, noise: float = 0.5
) -> Dataset:
    """Gaussian class blobs (MNIST/covtype stand-in)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_classes, d)).astype(np.float32)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = centers[y] + noise * rng.normal(size=(n, d)).astype(np.float32)
    return Dataset({"x": x.astype(np.float32), "y": y})
