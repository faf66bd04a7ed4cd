"""Plain PyTorch versions of the fused dequantize kernels, on the flat vector.

An encoded history row is ``q`` (p,) int8 or bf16, with an optional f32
``scale`` row of one value per leaf (``bounds`` gives the leaves' offsets
in the flat order, ``(0, e_1, ..., p)``) and an optional f32 keyframe
``base`` (the delta codecs).  `dequant_ref` is THE decode expression,

    q.float() * scale (+ base)      one rounded multiply, then one add,

and every read path of the port uses it: the history's `entry`, the
streamed windows' `decode_window` / `decode_row`, and the plain versions
below.  The CUDA kernels round the same two operations apart, which is
what makes kernel-mode and fetch-mode replays bitwise identical.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.fused_update.ref import deltagrad_update_ref


def expand_scale(scale: torch.Tensor, bounds: Sequence[int]) -> torch.Tensor:
    """Per-leaf scales (..., n_leaves) spread over their leaves (..., p)."""
    if scale.shape[-1] != len(bounds) - 1:
        raise ValueError(f"{scale.shape[-1]} scales for {len(bounds) - 1} "
                         "leaves")
    lead = scale.shape[:-1]
    return torch.cat([scale[..., i:i + 1].expand(*lead, b - a)
                      for i, (a, b) in enumerate(zip(bounds, bounds[1:]))],
                     dim=-1)


def dequant_ref(q: torch.Tensor, scale: Optional[torch.Tensor] = None,
                bounds: Optional[Sequence[int]] = None,
                base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q * scale (+ base)`` in f32, for one row (p,) or a window (L, p)
    with scales (L, n_leaves) and bases (L, p)."""
    x = q.float()
    if scale is not None:
        x = x * expand_scale(scale, bounds)
    if base is not None:
        x = x + base
    return x


def dequant_update_ref(w: torch.Tensor, q: torch.Tensor, bv: torch.Tensor,
                       g_changed: torch.Tensor, lr: float, n: float,
                       dB: float, sign: float,
                       scale: Optional[torch.Tensor],
                       bounds: Optional[Sequence[int]],
                       base: Optional[torch.Tensor] = None,
                       with_g: bool = False):
    """`deltagrad_update_ref` with the cached-gradient operand supplied
    encoded (decoded on the fly)."""
    return deltagrad_update_ref(w, dequant_ref(q, scale, bounds, base), bv,
                                g_changed, lr, n, dB, sign, with_g)


def dequant_sub_ref(w: torch.Tensor, q: torch.Tensor,
                    scale: Optional[torch.Tensor],
                    bounds: Optional[Sequence[int]],
                    base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``v = w - dequant(w_t)``, the L-BFGS direction input."""
    return w - dequant_ref(q, scale, bounds, base)
