"""The paper's 2-layer ReLU network (MNIST^n experiment, §4.1).

784 inputs, 300 hidden units, 10 classes (p = 238,510), L2 1e-3, lr 0.2 ->
0.1 after 10 iterations, deterministic GD, DeltaGrad run with the
Algorithm-4 non-convex guard (T0 = 2, first quarter of iterations as
burn-in, curvature threshold 1e-8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PaperMLPConfig:
    name: str = "paper-mlp"
    d_in: int = 784
    d_model: int = 300  # hidden width
    vocab: int = 10  # classes
    l2: float = 1e-3
    lr_schedule: Tuple[Tuple[int, float], ...] = ((0, 0.2), (10, 0.1))
    period: int = 2  # T0
    history_size: int = 2  # m
    guard: bool = True
    curvature_eps: float = 1e-8
    source: str = "DeltaGrad ICML 2020 §4.1 (MNIST^n)"

    def burn_in(self, steps: int) -> int:
        """j0: the first quarter of the iterations run explicitly."""
        return steps // 4

    @property
    def n_params(self) -> int:
        h, c = self.d_model, self.vocab
        return self.d_in * h + h + h * c + c


CONFIG = PaperMLPConfig()
