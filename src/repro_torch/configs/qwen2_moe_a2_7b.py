"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf-tier].

24L, d_model 2048, 16 heads (MHA: kv=16), vocab 151936.  MoE FFN: 60 routed
experts (top-4, d_expert 1408) + 4 shared experts (shared intermediate 5632).
The reference's entry, field for field.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=151_936,
        mlp="moe",
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            d_expert=1408,
            num_shared=4,
            d_shared=5632,
            capacity_factor=1.25,
        ),
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        notes="60e not divisible by model axis -> TP on d_expert; "
              "long_500k skipped (full attention).",
    )
)
