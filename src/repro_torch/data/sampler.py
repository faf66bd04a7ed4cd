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


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def build_online_schedule(
    seed: int,
    steps: int,
    n: int,
    batch_size: int,
    req,
    op: str,
    lr_at,
    live: np.ndarray,
    added_ids: np.ndarray,
    joins: Optional[np.ndarray],
    add_pad: int,
    idx_all: Optional[np.ndarray] = None,
    r_pad: Optional[int] = None,
) -> ReplaySchedule:
    """Replay plan for ONE online request (Algorithm 3, Appendix C.2): a
    single row, or a group of rows served as one replay.

    The replayed batch is extended with one column per row appended by
    earlier addition requests: columns ``[0, B)`` hold the original
    minibatch schedule, columns ``[B, B + add_pad)`` hold ``added_ids``
    (padding columns point at row 0 with weight 0).  ``kept_w`` marks
    POST-request membership; the request rows ride the ``changed`` block,
    so ``kept`` is the post-request batch size and the PRE-request size is
    ``kept + dB`` for deletions (``kept`` for additions).

    Args:
      req:       row id, or a sequence of distinct row ids (original or
                 previously added rows for delete; rows already appended to
                 the dataset for add, which take the next len(req) join
                 columns).
      op:        "delete" | "add".
      live:      bool per row id (original and added), False once deleted by
                 an earlier request.
      added_ids: (A,) rows appended by earlier add requests, in arrival
                 order (join column j belongs to added_ids[j]).
      joins:     (T, >= A [+K for add]) `addition_mask_all` columns; None
                 only when no adds are involved.
      add_pad:   width of the added-column block (>= A).
      idx_all:   reusable (T, B) original schedule.
      r_pad:     width of the changed-row block (default: the next power of
                 two of the group size).

    Draws and lays out exactly as the JAX package's function does, so both
    see bit-identical schedules."""
    if op not in ("delete", "add"):
        raise ValueError(f"op must be 'delete' or 'add', got {op!r}")
    reqs = np.atleast_1d(np.asarray(req, dtype=np.int64))
    K = len(reqs)
    if K < 1 or len(set(reqs.tolist())) != K:
        raise ValueError(f"group request must name distinct rows, got {reqs}")
    if r_pad is None:
        r_pad = _pow2(K)
    added_ids = np.asarray(added_ids, dtype=np.int64)
    A = len(added_ids)
    if add_pad < A:
        raise ValueError(f"add_pad={add_pad} below the {A} added rows")
    idx = batch_indices_all(seed, steps, n, batch_size) if idx_all is None \
        else idx_all
    T, B = idx.shape

    kept_orig = live[idx].copy()  # (T, B) originals surviving earlier requests
    changed_rows = np.zeros((T, r_pad), dtype=np.int64)
    changed_w = np.zeros((T, r_pad), dtype=np.float32)
    drop_cols: set = set()
    if op == "delete":
        col_of = {int(r): j for j, r in enumerate(added_ids)}
        req_orig = np.asarray([r for r in reqs if int(r) not in col_of],
                              dtype=np.int64)
        # group rows that were added earlier: their membership comes from
        # their join columns, not from the schedule
        pres_added = []
        for r in reqs:
            j = col_of.get(int(r))
            if j is not None:
                drop_cols.add(j)
                pres_added.append((int(r), joins[:, j] & bool(live[r])))
        hit = (np.isin(idx, req_orig) & kept_orig) if len(req_orig) \
            else np.zeros_like(kept_orig)
        kept_orig &= ~hit
        rows_any = hit.any(axis=1)
        for _, p in pres_added:
            rows_any |= p
        for t in np.nonzero(rows_any)[0]:
            rows = idx[t][hit[t]].tolist() \
                + [r for r, p in pres_added if p[t]]
            if len(rows) > r_pad:
                raise ValueError(f"r_pad={r_pad} smaller than per-batch "
                                 f"overlap {len(rows)}")
            changed_rows[t, : len(rows)] = rows
            changed_w[t, : len(rows)] = 1.0
    else:
        if joins is None or joins.shape[1] < A + K:
            raise ValueError(f"add requests need {A + K} join columns")
        changed_rows[:, :K] = reqs  # constant: the new rows themselves
        changed_w[:, :K] = joins[:, A:A + K].astype(np.float32)
    dB = changed_w.sum(axis=1)

    if add_pad:
        add_cols = np.zeros((T, add_pad), dtype=np.float32)
        add_rows = np.zeros(add_pad, dtype=np.int64)
        add_rows[:A] = added_ids
        for j in range(A):
            if j in drop_cols or not live[added_ids[j]]:
                continue  # deleted rows (and the request rows) drop out
            add_cols[:, j] = joins[:, j]
        idx_ext = np.concatenate(
            [idx, np.broadcast_to(add_rows, (T, add_pad))], axis=1)
        kept_w = np.concatenate([kept_orig.astype(np.float32), add_cols],
                                axis=1)
    else:
        idx_ext = idx
        kept_w = kept_orig.astype(np.float32)

    lr = np.asarray([lr_at(t) for t in range(T)], dtype=np.float32)
    return ReplaySchedule(
        idx=idx_ext,
        kept_w=kept_w,
        changed_idx=changed_rows,
        changed_w=changed_w,
        dB=dB.astype(np.float32),
        kept=kept_w.sum(axis=1).astype(np.float32),
        lr=lr,
        mode=op,
        r_pad=r_pad,
    )
