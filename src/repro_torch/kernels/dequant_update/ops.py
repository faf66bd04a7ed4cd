"""The fused dequantize wrappers the engine calls (any p, one launch over
all leaves, no padding).

A row arrives encoded: ``q`` (p,) int8 or bf16, an optional f32 ``scale``
(n_leaves,) with the leaves' offsets ``bounds`` = (0, e_1, ..., p), and an
optional f32 keyframe ``base`` (p,).  w, bv and g_changed are f32 (p,).
On the CPU each wrapper is its plain version in `ref.py`; on the card it
launches ``csrc/dequant_update.cu``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.dequant_update import kernel as K
from repro_torch.kernels.dequant_update.ref import (dequant_sub_ref,
                                                    dequant_update_ref)
from repro_torch.kernels.ops_common import check_vectors, on_card

Q_DTYPES = (torch.int8, torch.bfloat16)

# the leaves' end offsets on each device, made once per layout: the kernel
# reads them with the scale row, and a host->device copy per call would
# cost a stall per step
_ENDS: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}


def _device_ends(bounds: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    key = (device, bounds)
    ends = _ENDS.get(key)
    if ends is None:
        ends = _ENDS[key] = torch.tensor(bounds[1:], dtype=torch.int64,
                                         device=device)
    return ends


def _check(name: str, w: torch.Tensor, q: torch.Tensor, f32s,
           scale: Optional[torch.Tensor], bounds: Optional[Sequence[int]]
           ) -> Optional[Tuple[int, ...]]:
    """Checks every operand; returns the bounds as a tuple (None without a
    scale)."""
    check_vectors(name, [w, *f32s])
    if w.dtype != torch.float32:
        raise ValueError(f"{name}: w, bv, g_changed and base must be f32, "
                         f"got {w.dtype}")
    if (q.shape != w.shape or q.dtype not in Q_DTYPES or q.device != w.device
            or not q.is_contiguous()):
        raise ValueError(f"{name}: q must be contiguous int8 or bf16 shaped "
                         f"like w {tuple(w.shape)}, got {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    if scale is None:
        return None
    bounds = tuple(int(b) for b in bounds or ())
    if (scale.dim() != 1 or scale.dtype != torch.float32
            or scale.device != w.device or not scale.is_contiguous()
            or len(bounds) != scale.numel() + 1 or bounds[0] != 0
            or bounds[-1] != w.numel()
            or any(b < a for a, b in zip(bounds, bounds[1:]))):
        raise ValueError(
            f"{name}: want a contiguous f32 scale per leaf on {w.device} and "
            f"leaf offsets (0, ..., {w.numel()}), got scale "
            f"{tuple(scale.shape)} {scale.dtype} on {scale.device}, bounds "
            f"{bounds}")
    return bounds


def dequant_update(w: torch.Tensor, q: torch.Tensor, bv: torch.Tensor,
                   g_changed: torch.Tensor, lr: float, n: float, dB: float,
                   sign: float, scale: Optional[torch.Tensor],
                   bounds: Optional[Sequence[int]],
                   base: Optional[torch.Tensor] = None,
                   with_g: bool = False):
    """w - lr*(n*(g + bv) - sign*dB*g_changed)/max(n - sign*dB, 1) with
    g = q*scale (+ base) decoded in registers; with ``with_g``, (w -
    lr*g_est, g_est) for that estimate g_est, as `fused_update.ops.update`."""
    f32s = [bv, g_changed] + ([] if base is None else [base])
    bounds = _check("dequant_update", w, q, f32s, scale, bounds)
    lr, n, dB, sign = float(lr), float(n), float(dB), float(sign)
    if not on_card("dequant_update", w):
        return dequant_update_ref(w, q, bv, g_changed, lr, n, dB, sign, scale,
                                  bounds, base, with_g)
    ends = None if scale is None else _device_ends(bounds, w.device)
    out = torch.empty_like(w)
    g_out = torch.empty_like(w) if with_g else None
    K.dequant_update(w, q, bv, g_changed, base, scale, ends, out, g_out, lr, n,
                     dB, sign)
    dequant_update.launches += 1
    return (out, g_out) if with_g else out


def dequant_sub(w: torch.Tensor, q: torch.Tensor,
                scale: Optional[torch.Tensor], bounds: Optional[Sequence[int]],
                base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w - (q*scale (+ base)): the L-BFGS direction input v = w - w_t with
    the cached parameters consumed encoded."""
    bounds = _check("dequant_sub", w, q, [] if base is None else [base],
                    scale, bounds)
    if not on_card("dequant_sub", w):
        return dequant_sub_ref(w, q, scale, bounds, base)
    ends = None if scale is None else _device_ends(bounds, w.device)
    out = torch.empty_like(w)
    K.dequant_sub(w, q, base, scale, ends, out)
    dequant_sub.launches += 1
    return out


dequant_update.launches = 0
dequant_sub.launches = 0
