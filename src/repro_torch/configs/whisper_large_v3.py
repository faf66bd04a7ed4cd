"""Whisper-large-v3 backbone [arXiv:2212.04356; unverified-tier].

Encoder-decoder, d_model 1280, 20 heads of 64 (MHA), d_ff 5120, GELU,
vocab 51866, 32 encoder + 32 decoder layers (whisper-large's published
layout).  The conv audio frontend is a stub: the batch carries
precomputed frame embeddings (B, S_enc, d_model), 1500 a 30 s window
after the convolutions.  RMSNorm and RoPE stand in for LayerNorm and
learned positions, as in the reference (`models.encdec`).

Realized parameter count: 1,600,990,720 (the embedding and the head
66,388,480 each; an encoder layer 19,663,360, a decoder layer 26,218,240
with its cross-attention); 224,542,720 at 2 encoder + 2 decoder layers.
The reference's entry, field for field.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,  # decoder layers; + n_encoder_layers below
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        mlp="gelu",
        n_encoder_layers=32,
        frontend="frames",
        rope_theta=10000.0,
        source="arXiv:2212.04356",
        notes="enc-dec; conv frontend stubbed to precomputed frames; "
              "long_500k skipped (full attention).",
    )
)
