"""Plain PyTorch versions of the fused L-BFGS kernels."""

from __future__ import annotations

import torch


def multidot_ref(dW: torch.Tensor, dG: torch.Tensor, v: torch.Tensor):
    """All Gram/dot terms of the compact L-BFGS system, in f32.

    dW, dG: (m, p); v: (p,).  Returns sw (m,m) = dW dW^T, sy (m,m) =
    dW dG^T, wv (m,) = dW v, gv (m,) = dG v."""
    dWf, dGf, vf = dW.float(), dG.float(), v.float()
    return dWf @ dWf.T, dWf @ dGf.T, dWf @ vf, dGf @ vf


def rank_update_ref(dW: torch.Tensor, dG: torch.Tensor, v: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
    """Bv = sigma * v - a @ dW - b @ dG (rank-2m correction), at v's dtype."""
    out = (sigma.float() * v.float() - a.float() @ dW.float()
           - b.float() @ dG.float())
    return out.to(v.dtype)
