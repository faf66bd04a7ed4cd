"""Compatibility facade over `core.session.UnlearnerSession`.

The primary serving surface is the session and its request plan
(`core/session.py`).  `Unlearner` keeps the pre-session method set as a
THIN shim: every call, batch `delete()`/`add()` and the `stream_*`
methods alike, goes through the session's one serving algorithm, whose
engine rewrites the cached path after each replay, so batch and stream
requests interleave without losing the engine's state.

    unl.delete(idx) / unl.add(rows)     one coalesced group replay each
    unl.stream_delete / stream_add /    serial Algorithm-3 streams
      stream
    unl.params                          current model (flushes, syncs)
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

# Re-exports: the historical import site for these names.
from repro_torch.core.deltagrad import (  # noqa: F401
    DeltaGradConfig,
    Objective,
    RetrainStats,
    baseline_retrain,
    deltagrad_retrain,
    sgd_train_with_cache,
)
from repro_torch.core.online import OnlineEngine, OnlineStats  # noqa: F401
from repro_torch.core.session import (  # noqa: F401
    RequestHandle,
    UnlearnerConfig,
    UnlearnerSession,
    UnlearnRequest,
    UnlearnResponse,
)
from repro_torch.data.dataset import Dataset


class Unlearner:
    """Thin compatibility shim: every method delegates to one
    `UnlearnerSession` on `device` (None: the card)."""

    def __init__(self, objective: Objective, params0, dataset: Dataset,
                 config: UnlearnerConfig, device=None):
        self.session = UnlearnerSession(objective, params0, dataset, config,
                                        device=device)

    # -- session state passthrough ------------------------------------------

    @property
    def objective(self) -> Objective:
        return self.session.objective

    @property
    def dataset(self) -> Dataset:
        return self.session.dataset

    @property
    def config(self) -> UnlearnerConfig:
        return self.session.config

    @property
    def params0(self):
        return self.session.params0

    @property
    def history(self):
        return self.session.history

    @property
    def params(self):
        """Current model (forces pending session work, synchronises)."""
        return self.session.params

    @property
    def log(self) -> List[Dict]:
        return self.session.log

    @property
    def _online(self) -> Optional[OnlineEngine]:
        """The session's engine (None until the first request): batch and
        stream requests share it."""
        return self.session._engine

    # -- phase 1 -------------------------------------------------------------

    def fit(self):
        return self.session.fit()

    # -- phase 2: batch requests, ONE coalesced group replay each ------------

    def delete(self, indices) -> RetrainStats:
        t0 = time.perf_counter()
        stats = self.session.delete(list(indices)).result().stats[0]
        stats.wall_time_s = time.perf_counter() - t0
        return stats

    def add(self, rows: Dict[str, np.ndarray]) -> RetrainStats:
        t0 = time.perf_counter()
        stats = self.session.add(data=rows).result().stats[0]
        stats.wall_time_s = time.perf_counter() - t0
        return stats

    # -- phase 2': online request streams (serial Algorithm 3) ---------------

    def stream_delete(self, requests: Sequence[int]) -> OnlineStats:
        return self.session.stream_delete(list(requests))

    def stream_add(self, rows: Dict[str, np.ndarray]) -> OnlineStats:
        """Append `rows` and insert them one request at a time."""
        return self.session.stream_add(rows)

    def stream(self, requests: Sequence) -> OnlineStats:
        """Mixed online stream: ``(op, row)`` pairs; add rows must already
        be appended (e.g. via `dataset.append`)."""
        for r in requests:
            if not isinstance(r, (tuple, list)):
                raise TypeError(
                    f"stream() takes (op, row) pairs, got {r!r}; use "
                    "stream_delete()/stream_add() for single-op streams")
        return self.session.serve_stream(
            [(op, int(row)) for op, row in requests])

    # -- reference: exact retraining (BaseL) ----------------------------------

    def baseline(self, indices, mode: str = "delete"):
        return self.session.baseline(indices, mode=mode)
