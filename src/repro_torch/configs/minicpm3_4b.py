"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf-tier]: a dense decoder with
multi-head latent attention.

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448.  MLA ranks from the
public HF config: q_lora_rank 768, kv_lora_rank 256, qk_nope 64 / qk_rope
32, v_head 64.  The reference's entry, field for field.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab=73448,
        attention="mla",
        mla=MLAConfig(
            q_lora_rank=768,
            kv_lora_rank=256,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        mlp="swiglu",
        rope_theta=10000.0,
        source="hf:openbmb/MiniCPM3-4B",
        notes="MLA latent KV cache; long_500k skipped (full softmax attention).",
    )
)
