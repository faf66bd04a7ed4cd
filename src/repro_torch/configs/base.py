"""The model configuration, for the dense GQA token decoders.

The port's copy of the JAX package's ``configs/base.py:ModelConfig``: the
same field names and defaults (a test holds them field by field against
the reference's InternLM2 entry).  The fields of the other families (MLA,
MoE, SSM, xLSTM, enc-dec, frontends) wait for the model families that read
them; `models.transformer.layout_of` raises for a config that needs them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | vlm (the GQA token decoders ported) | simple
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    attention: str = "gqa"
    mlp: str = "swiglu"  # swiglu | relu_sq | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # repeating block pattern of a hybrid stack; None: n_layers x ("attn",)
    layout_unit: Optional[Tuple[str, ...]] = None
    attn_window: int = 0  # sliding window of attention layers; 0 = full
    frontend: str = "tokens"
    notes: str = ""
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        defaults for a dense stack), with `overrides` on top."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            d_head=16,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
