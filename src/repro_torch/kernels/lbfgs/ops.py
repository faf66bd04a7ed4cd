"""The wrappers the engine calls: multidot, rank_update, and B v chained
from them around the plain 2m x 2m solve.  Any m from 1 to 8 and any p;
the kernels mask the ragged edge, so nothing is padded."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.lbfgs import compact_coeffs
from repro_torch.kernels.lbfgs import kernel as K
from repro_torch.kernels.lbfgs.ref import multidot_ref, rank_update_ref
from repro_torch.kernels.ops_common import check_vectors, on_card

MAX_M = 8


def _check_history(name: str, dW: torch.Tensor, dG: torch.Tensor,
                   v: torch.Tensor) -> int:
    if dW.dim() != 2 or not 1 <= dW.shape[0] <= MAX_M:
        raise ValueError(f"{name}: dW must be (m, p) with 1 <= m <= {MAX_M}, "
                         f"got {tuple(dW.shape)}")
    check_vectors(name, [v])
    for t in (dW, dG):
        if (t.shape != dW.shape or t.shape[1] != v.shape[0]
                or t.dtype != v.dtype or t.device != v.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: dW, dG must be contiguous (m, p) like v, got "
                f"{[(tuple(x.shape), x.dtype, str(x.device)) for x in (dW, dG, v)]}")
    return dW.shape[0]


def multidot(dW: torch.Tensor, dG: torch.Tensor, v: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sw, sy, wv, gv) = (dW dW^T, dW dG^T, dW v, dG v) in f32."""
    m = _check_history("multidot", dW, dG, v)
    if not on_card("multidot", v):
        return multidot_ref(dW, dG, v)
    p = v.shape[0]
    n_terms = m * (m + 1) // 2 + m * m + 2 * m
    partials = torch.empty((K.multidot_blocks(p), n_terms), dtype=torch.float32,
                           device=v.device)
    out = torch.empty(2 * m * m + 2 * m, dtype=torch.float32, device=v.device)
    K.multidot(dW, dG, v, partials, out)
    multidot.launches += 1
    mm = m * m
    return (out[:mm].view(m, m), out[mm:2 * mm].view(m, m),
            out[2 * mm:2 * mm + m], out[2 * mm + m:])


def rank_update(dW: torch.Tensor, dG: torch.Tensor, v: torch.Tensor,
                a: torch.Tensor, b: torch.Tensor,
                sigma: torch.Tensor) -> torch.Tensor:
    """sigma*v - a dW - b dG at v's dtype; a, b (m,), sigma 0-d, on v's
    device (they stay there: no host sync)."""
    m = _check_history("rank_update", dW, dG, v)
    if a.shape != (m,) or b.shape != (m,) or sigma.dim() != 0:
        raise ValueError(f"rank_update: want a, b ({m},) and a 0-d sigma, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(sigma.shape)}")
    if not on_card("rank_update", v):
        return rank_update_ref(dW, dG, v, a, b, sigma)
    coefs = torch.cat([a.float(), b.float(), sigma.float().reshape(1)])
    if coefs.device != v.device:
        raise ValueError(f"rank_update: coefficients on {coefs.device}, "
                         f"operands on {v.device}")
    out = torch.empty_like(v)
    K.rank_update(dW, dG, v, coefs, out)
    rank_update.launches += 1
    return out


def lbfgs_hvp_fused(dW: torch.Tensor, dG: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """B v: one multidot pass, the plain compact solve, one rank_update pass."""
    sw, sy, wv, gv = multidot(dW, dG, v)
    c = compact_coeffs(sw, sy, wv, gv)
    return rank_update(dW, dG, v, c.a, c.b, c.sigma)


multidot.launches = 0
rank_update.launches = 0
