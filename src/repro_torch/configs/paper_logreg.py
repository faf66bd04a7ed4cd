"""The paper's own primary benchmark model: L2-regularized logistic
regression (RCV1 / HIGGS / MNIST / covtype experiments, §4.1).

Not an LM: built by `models.simple` (``logreg_*``, ``multiclass_*``) and
registered here so it can be looked up by name, with the same fields as
the JAX package's entry.  `RECIPE` carries §4.1's hyper-parameters: L2
5e-3, lr 0.1, and the RCV1 defaults T0 = 10, j0 = 10, m = 2.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="paper-logreg",
        family="simple",
        n_layers=0,
        d_model=0,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=2,
        mlp="none",
        source="DeltaGrad ICML 2020 §4.1",
        notes="hyperparams: l2=5e-3, lr=0.1, T0=10, j0=10, m=2 (RCV1)",
    )
)


@dataclass(frozen=True)
class PaperLogregRecipe:
    l2: float = 5e-3
    lr: float = 0.1
    period: int = 10  # T0
    burn_in: int = 10  # j0
    history_size: int = 2  # m


RECIPE = PaperLogregRecipe()
