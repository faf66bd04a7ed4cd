"""In-memory dataset with deletion/addition bookkeeping.

A Dataset is a dict of equal-leading-dimension numpy arrays ("columns", e.g.
``{"x": (n, d), "y": (n,)}``).  Deletion never re-indexes: removed rows keep
their original index and are masked out at batch-assembly time, which is what
makes DeltaGrad's schedule replay well-defined.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class Dataset:
    def __init__(self, columns: Dict[str, np.ndarray]):
        if not columns:
            raise ValueError("empty dataset")
        sizes = {k: len(v) for k, v in columns.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged columns: {sizes}")
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        self.n = next(iter(sizes.values()))
        self._device_cols: Dict[str, torch.Tensor] = {}
        self._device_key = None

    def take(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.columns.items()}

    def device_columns(self, device) -> Dict[str, torch.Tensor]:
        """Columns uploaded to `device` once (cached; refreshed after append).

        The engine gathers minibatches on the device, so the host never
        assembles per-step batches.  Integer columns go up as int64, the
        index type torch's gathers take."""
        key = (str(torch.device(device)), self.n)
        if self._device_key != key:

            def upload(v):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if not t.is_floating_point():
                    t = t.long()
                return t.to(device)

            self._device_cols = {k: upload(v) for k, v in self.columns.items()}
            self._device_key = key
        return self._device_cols

    def __len__(self) -> int:
        return self.n

    def append(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """Physically append new rows; returns their indices."""
        m = len(next(iter(rows.values())))
        for k in self.columns:
            self.columns[k] = np.concatenate([self.columns[k], np.asarray(rows[k])])
        new_idx = np.arange(self.n, self.n + m, dtype=np.int64)
        self.n += m
        return new_idx

    def padded_batch(self, idx: np.ndarray, pad_to: int):
        """(columns, weights) with rows gathered by `idx`, padded to `pad_to`.

        Padding repeats row 0 with weight 0 so batch shapes stay fixed."""
        k = len(idx)
        if k > pad_to:
            raise ValueError(f"{k} rows do not fit a batch of {pad_to}")
        full_idx = np.concatenate([idx, np.zeros(pad_to - k, dtype=np.int64)])
        weights = np.concatenate(
            [np.ones(k, dtype=np.float32), np.zeros(pad_to - k, dtype=np.float32)])
        return self.take(full_idx), weights
