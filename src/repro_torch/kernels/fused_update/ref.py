"""Plain PyTorch version of the fused leave-r-out DeltaGrad update."""

from __future__ import annotations

import torch


def deltagrad_update_ref(w: torch.Tensor, g_cached: torch.Tensor,
                         bv: torch.Tensor, g_changed: torch.Tensor,
                         lr: float, n: float, dB: float, sign: float,
                         with_g: bool = False):
    """w - lr/(n - sign*dB) * ( n*(g_cached + bv) - sign*dB*g_changed ).

    Paper eq. (2)/(S7): sign=+1 deletion, sign=-1 addition.  f32 math at
    w's storage dtype; lr/n/dB/sign are Python scalars.  With ``with_g``
    (the online request, which rewrites the history with the estimate)
    it returns (w - lr*g, g) for the estimate g = (n*(g_cached + bv) -
    sign*dB*g_changed) / (n - sign*dB)."""
    denom = max(n - sign * dB, 1.0)
    num = n * (g_cached.float() + bv.float()) - (sign * dB) * g_changed.float()
    if with_g:
        g = num / denom
        return (w.float() - lr * g).to(w.dtype), g.to(w.dtype)
    return (w.float() - lr * num / denom).to(w.dtype)
