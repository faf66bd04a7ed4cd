"""The optimization-path cache (w_t, g_t) of the original training run.

This slice keeps the path device-resident: two (T, p) f32 tensors, the
rows in the flat parameter order of `utils.tree.FlatParams`, written by the
recording loop and read by the replay.  The host and disk tiers and the
compressing codecs of the JAX package come with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.utils.tree import FlatParams


@dataclass
class HistoryMeta:
    """Everything needed to replay the original training run."""

    n: int  # dataset size during original training
    batch_size: int  # B (== n for deterministic GD)
    seed: int  # sampler seed
    steps: int  # T
    lr_schedule: Tuple[Tuple[int, float], ...]  # piecewise-constant (from_step, lr)
    momentum: float = 0.0  # heavy-ball; not ported yet (the engine raises)

    def lr_at(self, t: int) -> float:
        lr = self.lr_schedule[0][1]
        for start, value in self.lr_schedule:
            if t >= start:
                lr = value
        return lr


class TrainingHistory:
    """Per-step (w_t, g_t) cache, stacked on the device."""

    def __init__(self, meta: HistoryMeta):
        self.meta = meta
        self.W: Optional[torch.Tensor] = None  # (T, p)
        self.G: Optional[torch.Tensor] = None  # (T, p)
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.final_params: Optional[FlatParams] = None

    def __len__(self) -> int:
        return 0 if self.W is None else self.W.shape[0]

    def set_stacked(self, W: torch.Tensor, G: torch.Tensor,
                    final_params: FlatParams) -> None:
        """Adopt (W, G), the recording loop's (T, p) buffers, as the cache."""
        if W.shape != G.shape or W.dim() != 2:
            raise ValueError(f"W {tuple(W.shape)} and G {tuple(G.shape)} "
                             "must be equal (T, p)")
        self.W, self.G = W, G
        self.shapes = dict(final_params.shapes)
        self.final_params = final_params

    def stacked_view(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.W is None:
            raise ValueError("stacked_view() on an empty history")
        return self.W, self.G

    def entry(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_t, g_t) as flat row views."""
        if not 0 <= t < len(self):
            raise IndexError(f"history entry {t} of {len(self)}")
        return self.W[t], self.G[t]

    def params_at(self, t: int) -> FlatParams:
        return FlatParams(self.entry(t)[0].clone(), self.shapes)

    @property
    def device(self) -> torch.device:
        return self.W.device

    def nbytes(self) -> int:
        return 0 if self.W is None else 2 * self.W.numel() * self.W.element_size()
