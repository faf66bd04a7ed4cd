"""Qwen3-32B [hf:Qwen/Qwen3-8B family scaling; hf-tier].

64L, d_model 5120, 64 heads / 8 KV (GQA), head_dim 128, d_ff 25600,
vocab 151936, QK-RMSNorm.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=25600,
        vocab=151_936,
        mlp="swiglu",
        qk_norm=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-32B",
        notes="qk_norm per-head RMSNorm; long_500k skipped (full attention).",
    )
)
