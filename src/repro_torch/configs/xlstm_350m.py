"""xLSTM-350M [arXiv:2405.04517; unverified-tier].

24 blocks alternating mLSTM / sLSTM (1:1), d_model 1024, 4 heads,
vocab 50304.  d_ff=0: xLSTM blocks carry their own up-projections
(mLSTM pf=2, sLSTM gated-MLP pf=4/3), so a block is its pre-norm and its
mixer, with no FFN.

Realized parameter count: 443,057,248 (the embedding and the head
51,511,296 each; an mLSTM block 18,893,832, an sLSTM block 9,442,304).
The reference's entry, field for field.
"""

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.configs.registry import register

CONFIG = register(
    ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        mlp="none",
        xlstm=XLSTMConfig(proj_factor_mlstm=2.0, proj_factor_slstm=4.0 / 3.0),
        layout_unit=("mlstm", "slstm"),
        source="arXiv:2405.04517",
        notes="mLSTM trained with the chunkwise-parallel form; sLSTM via scan; "
              "long_500k runs (recurrent).",
    )
)
