"""The assigned input-shape cells (LM family: seq_len x global_batch), the
reference's four, registered under the same names."""

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import register_shape

TRAIN_4K = register_shape(
    ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256, kind="train")
)
PREFILL_32K = register_shape(
    ShapeConfig(name="prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
)
DECODE_32K = register_shape(
    ShapeConfig(name="decode_32k", seq_len=32_768, global_batch=128, kind="decode")
)
LONG_500K = register_shape(
    ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1, kind="long_decode")
)
