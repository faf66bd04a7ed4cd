"""The fused DeltaGrad update the engine calls (any p, no padding)."""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update.ref import deltagrad_update_ref
from repro_torch.kernels.ops_common import check_vectors, on_card


def update(w: torch.Tensor, g_cached: torch.Tensor, bv: torch.Tensor,
           g_changed: torch.Tensor, lr: float, n: float, dB: float,
           sign: float, with_g: bool = False):
    """w - lr*(n*(g_cached + bv) - sign*dB*g_changed)/max(n - sign*dB, 1);
    with ``with_g``, (w - lr*g, g) for that estimate g (the online request
    rewrites the history with it).

    Four 1-D tensors of one shape, dtype (f32 or bf16) and device.  On the
    CPU this is `deltagrad_update_ref`; on the card, the CUDA kernel."""
    check_vectors("fused_update", [w, g_cached, bv, g_changed])
    lr, n, dB, sign = float(lr), float(n), float(dB), float(sign)
    if not on_card("fused_update", w):
        return deltagrad_update_ref(w, g_cached, bv, g_changed, lr, n, dB,
                                    sign, with_g)
    out = torch.empty_like(w)
    g_out = torch.empty_like(w) if with_g else None
    K.deltagrad_update(w, g_cached, bv, g_changed, out, g_out, lr, n, dB, sign)
    update.launches += 1
    return (out, g_out) if with_g else out


update.launches = 0
