"""Zamba2-7B [arXiv:2411.15242; unverified-tier]: a Mamba2 +
shared-attention hybrid.

d_model 3584, 32 heads (shared attention block), d_ff 14336, vocab 32000,
ssm_state 64.  Public description: a stack of Mamba2 blocks with a SHARED
full transformer block applied periodically.  Realized, as in the
reference, as 13 units of (5 x mamba2 + 1 shared-attn) = 78 mixer blocks
(the published "81 layers" counts sub-blocks differently; the source is
unverified-tier, the deviation noted).

The shared attention block keeps one parameter set and a KV cache per
occurrence, a 4096-token sliding-window ring at long context, so the
decode state stays O(window) while the Mamba2 state is O(1).

Realized parameter count: 5.5B (the published 7.4B includes
per-invocation LoRA adapters on the shared blocks and a second
alternating shared block, which this realization folds into one shared
block; unverified-tier source).  The reference's entry, field for field.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=78,  # 13 x (5 mamba2 + 1 shared attn)
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab=32000,
        mlp="swiglu",
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                      chunk=128),
        layout_unit=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                     "attn_shared"),
        attn_window=4096,
        rope_theta=10000.0,
        source="arXiv:2411.15242",
        notes="shared attention params, per-occurrence KV caches; "
              "long_500k runs (hybrid).",
    )
)
