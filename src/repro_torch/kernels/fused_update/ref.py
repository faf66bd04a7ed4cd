"""Plain PyTorch version of the fused leave-r-out DeltaGrad update."""

from __future__ import annotations

import torch


def deltagrad_update_ref(w: torch.Tensor, g_cached: torch.Tensor,
                         bv: torch.Tensor, g_changed: torch.Tensor,
                         lr: float, n: float, dB: float,
                         sign: float) -> torch.Tensor:
    """w - lr/(n - sign*dB) * ( n*(g_cached + bv) - sign*dB*g_changed ).

    Paper eq. (2)/(S7): sign=+1 deletion, sign=-1 addition.  f32 math at
    w's storage dtype; lr/n/dB/sign are Python scalars."""
    denom = max(n - sign * dB, 1.0)
    num = n * (g_cached.float() + bv.float()) - (sign * dB) * g_changed.float()
    return (w.float() - lr * num / denom).to(w.dtype)
