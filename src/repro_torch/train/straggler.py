"""Straggler detection and mitigation hooks (host-side bookkeeping).

The port's copy of the JAX package's ``train/straggler.py``, which is pure
Python:

  * `StepTimer` — per-step wall times over a sliding window, with
    percentiles;
  * `StragglerPolicy` — flags hosts whose step time exceeds
    ``tolerance x median`` for `patience` consecutive steps, and gives the
    gradient scale when the flagged hosts' microbatches are skipped
    (``deadline_skip``: re-weighted by the contributing count, unbiased
    under random assignment).

A timed step must end in a device sync (the train CLI reads the loss back
inside the timed region), or the timer measures the launch queue.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


@dataclass
class StepTimer:
    window: int = 50
    times: Deque[float] = field(default_factory=deque)
    _start: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = time.perf_counter() - self._start
        self.times.append(dt)
        while len(self.times) > self.window:
            self.times.popleft()
        self._start = None
        return dt

    def percentile(self, q: float) -> float:
        if not self.times:
            return 0.0
        xs = sorted(self.times)
        i = min(len(xs) - 1, int(q * len(xs)))
        return xs[i]


@dataclass
class StragglerPolicy:
    tolerance: float = 1.5  # x median
    patience: int = 3
    _strikes: Dict[int, int] = field(default_factory=dict)

    def observe(self, host_times: Dict[int, float]) -> List[int]:
        """host_id -> step time; returns hosts flagged for mitigation."""
        if not host_times:
            return []
        xs = sorted(host_times.values())
        median = xs[len(xs) // 2]
        flagged = []
        for host, t in host_times.items():
            if median > 0 and t > self.tolerance * median:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes.get(host, 0) >= self.patience:
                flagged.append(host)
        return flagged

    def reweight(self, n_contributing: int, n_total: int) -> float:
        """Gradient scale when deadline-skipping stragglers' microbatches."""
        if not 0 < n_contributing <= n_total:
            raise ValueError(f"reweight({n_contributing}, {n_total}): need "
                             "0 < n_contributing <= n_total")
        return n_total / n_contributing
