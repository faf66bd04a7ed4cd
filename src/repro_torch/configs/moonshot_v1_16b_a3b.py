"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf-tier].

The reference's dims: 48L, d_model 2048, 16 heads (kv=16), vocab 163840,
MoE FFN 64 routed experts (top-6, d_expert 1408) + shared experts (2 x
1408).  These dims total 28.9B params (4.8B active); the HF 16B checkpoint
uses 27 layers.  The reference's entry, field for field.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=163_840,
        mlp="moe",
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_expert=1408,
            num_shared=2,
            d_shared=2816,
            capacity_factor=1.25,
        ),
        rope_theta=50_000.0,
        source="hf:moonshotai/Moonlight-16B-A3B",
        notes="64e divisible by 16 -> expert-parallel; "
              "long_500k skipped (full attention).",
    )
)
