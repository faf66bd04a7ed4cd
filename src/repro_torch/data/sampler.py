"""Deterministic, replayable minibatch schedule.

DeltaGrad's SGD analysis (paper §A.1.2) assumes the retraining run sees the
same minibatch sequence as the original run.  The schedule is therefore a
pure function of ``(seed, step)``.  Indices always refer to the ORIGINAL
dataset numbering; deletion is applied by masking at use time.

This is numpy only, and draws exactly as the JAX package's sampler does, so
a replay of the port and of the reference see bit-identical schedules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def batch_indices(seed: int, step: int, n: int, batch_size: int) -> np.ndarray:
    """Minibatch for `step`: `batch_size` draws without replacement from [0, n).

    When batch_size >= n this is deterministic full-batch GD (identity order).
    """
    if batch_size >= n:
        return np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    return rng.choice(n, size=batch_size, replace=False).astype(np.int64)


def addition_mask(seed: int, step: int, n: int, batch_size: int,
                  n_added: int) -> np.ndarray:
    """Which of the `n_added` new samples join the minibatch at `step`.

    Each added sample independently joins with probability batch_size/n,
    the inclusion probability of original samples."""
    if batch_size >= n:
        return np.ones(n_added, dtype=bool)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 0x5EED]))
    return rng.random(n_added) < (batch_size / float(n))


def batch_indices_all(seed: int, steps: int, n: int, batch_size: int) -> np.ndarray:
    """The full (steps, B) minibatch schedule, row t == batch_indices(seed, t)."""
    B = min(batch_size, n)
    out = np.empty((steps, B), dtype=np.int64)
    for t in range(steps):
        out[t] = batch_indices(seed, t, n, batch_size)
    return out


def addition_mask_all(seed: int, steps: int, n: int, batch_size: int,
                      n_added: int) -> np.ndarray:
    """(steps, n_added) bool; row t == addition_mask(seed, t, ...)."""
    out = np.empty((steps, n_added), dtype=bool)
    for t in range(steps):
        out[t] = addition_mask(seed, t, n, batch_size, n_added)
    return out


@dataclass
class ReplaySchedule:
    """Replay plan for one retraining run (numpy; uploaded once).

    Shapes: T = steps, B = effective batch size, R = changed-sample pad.

      idx          (T, B)  int64  replayed original minibatch indices
      kept_w       (T, B)  f32    1.0 where the row survives the edit
      changed_idx  (T, R)  int64  changed rows present in batch t, padded
      changed_w    (T, R)  f32    validity mask for changed_idx
      dB           (T,)    f32    |changed ∩ batch_t|   (add: #joining rows)
      kept         (T,)    f32    |surviving rows of batch_t|
      lr           (T,)    f32    learning rate at t
    """

    idx: np.ndarray
    kept_w: np.ndarray
    changed_idx: np.ndarray
    changed_w: np.ndarray
    dB: np.ndarray
    kept: np.ndarray
    lr: np.ndarray
    mode: str
    r_pad: int

    @property
    def steps(self) -> int:
        return self.idx.shape[0]

    @property
    def batch(self) -> int:
        return self.idx.shape[1]


def build_schedule(
    seed: int,
    steps: int,
    n: int,
    batch_size: int,
    changed_idx: np.ndarray,
    mode: str,
    r_pad: int,
    lr_at,
    idx_all: Optional[np.ndarray] = None,
    live_mask: Optional[np.ndarray] = None,
) -> ReplaySchedule:
    """Precompute every per-step quantity a DeltaGrad replay needs.

    `changed_idx` are removed rows (delete) or appended rows (add).
    `live_mask` (bool per row, True = present) masks rows deleted earlier
    out of the replayed batches; `idx_all` reuses an already-sampled
    schedule."""
    if mode not in ("delete", "add"):
        raise ValueError(f"mode must be 'delete' or 'add', got {mode!r}")
    changed_idx = np.asarray(changed_idx, dtype=np.int64)
    idx = batch_indices_all(seed, steps, n, batch_size) if idx_all is None \
        else idx_all
    T, B = idx.shape

    if live_mask is not None:
        live = live_mask[idx]
    else:
        live = np.ones((T, B), dtype=bool)

    if mode == "delete":
        overlap = np.isin(idx, changed_idx) & live
        kept_mask = live & ~overlap
        changed_rows = np.zeros((T, r_pad), dtype=np.int64)
        changed_w = np.zeros((T, r_pad), dtype=np.float32)
        for t in np.nonzero(overlap.any(axis=1))[0]:
            rows = idx[t][overlap[t]][:r_pad]
            changed_rows[t, : len(rows)] = rows
            changed_w[t, : len(rows)] = 1.0
        dB = overlap.sum(axis=1).astype(np.float32)
    else:
        joins = addition_mask_all(seed, steps, n, batch_size, len(changed_idx))
        kept_mask = live
        changed_rows = np.zeros((T, r_pad), dtype=np.int64)
        changed_w = np.zeros((T, r_pad), dtype=np.float32)
        for t in np.nonzero(joins.any(axis=1))[0]:
            rows = changed_idx[joins[t]][:r_pad]
            changed_rows[t, : len(rows)] = rows
            changed_w[t, : len(rows)] = 1.0
        dB = joins.sum(axis=1).astype(np.float32)

    if dB.max(initial=0.0) > r_pad:
        raise ValueError(
            f"removal_pad={r_pad} smaller than max per-batch overlap {dB.max()}")
    lr = np.asarray([lr_at(t) for t in range(T)], dtype=np.float32)
    return ReplaySchedule(
        idx=idx,
        kept_w=kept_mask.astype(np.float32),
        changed_idx=changed_rows,
        changed_w=changed_w,
        dB=dB,
        kept=kept_mask.sum(axis=1).astype(np.float32),
        lr=lr,
        mode=mode,
        r_pad=r_pad,
    )
