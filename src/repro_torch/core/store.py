"""Where the replay reads the history from.

`ResidentStore` serves a device-resident history whole: every approx
segment runs at once and reads its (w_t, g_t) rows in place.  Streamed and
sharded stores come with later slices, behind the same three methods.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.history import TrainingHistory


class ResidentStore:
    kind = "resident"

    def __init__(self, history: TrainingHistory):
        self.history = history
        self.W, self.G = history.stacked_view()

    def span_end(self, t: int, t2: int) -> int:
        return t2  # the whole path is resident; never split a segment

    def window(self, a: int, b: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(W, G, offset): step t's rows are W[t - offset], G[t - offset]."""
        return self.W, self.G, 0

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.W[t], self.G[t]

    def hbm_high_water(self) -> int:
        return self.history.nbytes()
