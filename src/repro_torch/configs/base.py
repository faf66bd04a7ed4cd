"""The model and shape configurations, for the GQA token decoders, the
MoE family, multi-head latent attention (MLA), the Mamba2 hybrid stack,
xLSTM and the encoder-decoder family (Whisper).

The port's copy of the JAX package's ``configs/base.py``: `ModelConfig`,
`MLAConfig`, `MoEConfig`, `SSMConfig`, `XLSTMConfig` and `ShapeConfig`
with the same field names and defaults (tests hold them field by field
against the reference's entries).  An encoder-decoder config has
``family="audio"`` and ``n_encoder_layers`` encoder layers beside its
``n_layers`` decoder layers (`models.encdec`); ``frontend="frames"``
feeds precomputed frame embeddings in place of token embeddings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 60
    top_k: int = 4
    d_expert: int = 1408  # per-expert FFN hidden
    num_shared: int = 4  # shared experts (always-on)
    d_shared: int = 5632  # shared-expert FFN hidden (total)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # the reference's two routes to the slot ranks ("onehot" cumsum,
    # "sort" argsort); they give the same ranks, and the port computes
    # both by one stable sort (`models.moe`)
    dispatch: str = "onehot"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    conv_kernel: int = 4  # read by nothing, in the reference as here


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | vlm | moe | hybrid | ssm | audio (enc-dec) | simple
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    attention: str = "gqa"  # gqa | mla
    mlp: str = "swiglu"  # swiglu | relu_sq | gelu | moe | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # repeating block pattern of a hybrid stack, e.g. ("mamba2",) * 5 +
    # ("attn_shared",) or ("mlstm", "slstm"); None: n_layers x ("attn",)
    layout_unit: Optional[Tuple[str, ...]] = None
    # enc-dec (whisper): encoder layers use bidirectional attention
    n_encoder_layers: int = 0
    attn_window: int = 0  # sliding window of attention layers; 0 = full
    frontend: str = "tokens"  # "tokens" | "frames" (precomputed embeddings)
    notes: str = ""
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        defaults: a dense stack, for MLA ranks 32 / 16 and head dims of 8,
        for MoE 8 experts, top-2, for an SSM d_state, head_dim and chunk
        16, a hybrid or xLSTM stack cut to one unit, and an
        encoder-decoder to 2 encoder layers), with `overrides` on top."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            d_head=16,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
        )
        if self.mla:
            small["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=8, v_head_dim=8,
            )
        if self.moe:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, d_expert=32,
                num_shared=min(self.moe.num_shared, 2), d_shared=64,
            )
        if self.ssm:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16
            )
        if self.layout_unit:
            small["n_layers"] = len(self.layout_unit)  # one repeating unit
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """A cell's input shape: ``seq_len`` tokens (for an encoder-decoder
    also its frames) of ``global_batch`` rows, for the ``kind`` train,
    prefill, decode or long_decode."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")
