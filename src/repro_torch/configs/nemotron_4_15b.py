"""Nemotron-4 15B [arXiv:2402.16819; unverified-tier].

32L, d_model 6144, 48 heads / 8 KV (GQA), d_ff 24576, vocab 256000,
squared-ReLU MLP, RoPE.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab=256_000,
        mlp="relu_sq",
        rope_theta=10000.0,
        source="arXiv:2402.16819",
        notes="squared-ReLU FFN; long_500k skipped (full attention).",
    )
)
