"""The flash attention forward the model calls, in the model's layout.

q (B, Sq, H, D), k and v (B, Sk, Hkv, D), all contiguous and alike in
dtype (f32 or bf16) and device; the output is (B, Sq, H, D) in q's dtype.
On the CPU this is `attention_ref` (on the transposed operands); on the
card, ``csrc/flash_attention.cu``, which reads the (B, S, H, D) layout
through strides and masks ragged tails, so nothing is padded or
transposed: bf16 on the wgmma instance (TMA loads, so its operands are
16-byte aligned with strides in multiples of 8 elements), f32 on FMAs.
The mma.sync instance that the wgmma one replaced stays reachable only
through ``kernel.flash_attention_mma``, as the yardstick that chip_smoke.py
and the cuda-marked tests hold it against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ops_common import DTYPES, on_card

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instances
BLOCK = 128  # the reference wrapper's default block, for its contract


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B, Sq, H, D) and k, v "
                         f"(B, Sk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (H must be a multiple "
                         "of Hkv)")
    for t in (q, k, v):
        if (t.dtype != q.dtype or q.dtype not in DTYPES
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                "flash_attention: operands must be contiguous f32 or bf16 of "
                "one dtype and device, got "
                f"{[(t.dtype, str(t.device), t.is_contiguous()) for t in (q, k, v)]}")
    # the reference wrapper's contract (ops.py): only causal attention may
    # have a sequence that is not a whole number of blocks
    bq, bk = min(BLOCK, Sq), min(BLOCK, Sk)
    if not causal and (Sq % bq or Sk % bk):
        raise ValueError("flash_attention: non-causal requires block-aligned "
                         f"shapes, got Sq={Sq} Sk={Sk}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, H, D)."""
    _check(q, k, v, causal)
    if not on_card("flash_attention", q):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2),
                             causal=causal).transpose(1, 2).contiguous()
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel copies 16-byte "
                         "chunks; its operands must be 16-byte aligned")
    out = torch.empty_like(q)
    K.flash_attention(q, k, v, out, causal)
    attention.launches += 1
    return out


attention.launches = 0
