"""Synthetic data generators (paper-scale stand-ins for MNIST/covtype and
RCV1/HIGGS, and a token corpus for the LM).  Deterministic in the seed: the same seed gives the same
arrays as the JAX package's generators, which draw from numpy the same way."""

from __future__ import annotations

from typing import Tuple

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


def token_stream(n_docs: int, seq_len: int, vocab: int, seed: int = 0) -> Dataset:
    """Synthetic LM corpus: each row is one document of `seq_len` token ids.

    Tokens follow a per-document bigram chain so the LM objective has
    learnable structure (deleting documents measurably moves the model)."""
    rng = np.random.default_rng(seed)
    tokens = np.empty((n_docs, seq_len), dtype=np.int32)
    for i in range(n_docs):
        shift = rng.integers(1, vocab)
        t = rng.integers(0, vocab)
        for j in range(seq_len):
            tokens[i, j] = t
            t = (t + shift + rng.integers(0, 3)) % vocab
    return Dataset({"tokens": tokens})


def train_test_split(ds: Dataset, test_frac: float,
                     seed: int = 0) -> Tuple[Dataset, Dataset]:
    """(train, test): a seeded permutation's first ``int(n * test_frac)``
    rows are the test set, the rest the training set, each in permuted
    order."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n)
    n_test = int(ds.n * test_frac)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return (
        Dataset({k: v[train_idx] for k, v in ds.columns.items()}),
        Dataset({k: v[test_idx] for k, v in ds.columns.items()}),
    )
