"""Chameleon-34B backbone [arXiv:2405.09818; unverified-tier].

Early-fusion multimodal decoder: 48L, d_model 8192, 64 heads / 8 KV (GQA),
d_ff 22016, vocab 65536 (text + VQ image codes in ONE token space).  The VQ
image tokenizer is a STUB — `input_specs()` supplies fused token ids, which
is exactly what early fusion means for the backbone.  Chameleon's published
training fix (QK-norm) is enabled.  long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=65536,
        mlp="swiglu",
        qk_norm=True,
        rope_theta=10000.0,
        source="arXiv:2405.09818",
        notes="early fusion = plain decoder over fused token space; "
              "VQ frontend stubbed.",
    )
)
