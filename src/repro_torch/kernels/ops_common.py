"""Operand checks shared by the kernel wrappers."""

from __future__ import annotations

from typing import Sequence

import torch

DTYPES = (torch.float32, torch.bfloat16)


def check_vectors(name: str, ts: Sequence[torch.Tensor]) -> None:
    """Contiguous 1-D tensors of one shape, storage dtype and device."""
    first = ts[0]
    if first.dim() != 1 or first.dtype not in DTYPES:
        raise ValueError(f"{name}: want 1-D f32 or bf16, got "
                         f"{tuple(first.shape)} {first.dtype}")
    for t in ts:
        if (t.shape != first.shape or t.dtype != first.dtype
                or t.device != first.device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: operands must be contiguous and alike, got "
                f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in ts]}")


def on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the wrapper computes the plain version), True
    for a tensor on the current CUDA device (the wrapper launches its
    kernel); anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: operands on {t.device}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    return True
