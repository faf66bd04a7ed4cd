"""Hardware constants for the roofline model.

The port's one card is the NVIDIA H100 SXM5 80GB; every number below is
from NVIDIA's H100 Tensor Core GPU datasheet (SXM5 column, dense, no
sparsity).  ``nvidia-smi --query-gpu=name,power.limit`` names the card
this port is measured on ``NVIDIA H100 80GB HBM3, 700.00 W``: the
datasheet's peaks hold at that 700 W limit, and a card capped lower runs
below them under load.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float  # per card, FLOP/s (tensor cores, dense)
    peak_flops_f32: float  # per card, FLOP/s (CUDA cores, no tensor cores)
    hbm_bw: float  # per card, B/s
    link_bw: float  # per card, B/s (NVLink, both directions summed)
    hbm_bytes: float  # per card


H100_SXM5_80GB = HwSpec(
    name="h100_sxm5_80gb",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    hbm_bw=3.35e12,
    link_bw=900e9,
    hbm_bytes=80e9,
)
