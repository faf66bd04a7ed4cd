"""InternLM2-1.8B [arXiv:2403.17297; hf:internlm/internlm2-1_8b].

24L, d_model 2048, 16 heads / 8 KV (GQA, d_head 128), d_ff 8192, vocab
92544, SwiGLU, RMSNorm, RoPE theta 1e6, untied lm_head.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92544,
        mlp="swiglu",
        rope_theta=1_000_000.0,
        source="arXiv:2403.17297 / hf:internlm/internlm2-1_8b",
        notes="long_500k skipped (full attention).",
    )
)
