"""Limited-memory BFGS quasi-Hessian, compact representation.

DeltaGrad (Algorithm 1, line "L-BFGS") needs ``B_t v`` for
``v = w^I_t - w_t``, where ``B_t`` is the BFGS matrix of the last ``m``
pairs ``dw_k = w^I_{j_k} - w_{j_k}``, ``dg_k = grad(w^I_{j_k}) -
grad(w_{j_k})``.  With ``S = [dw_0 .. dw_{m-1}]``, ``Y = [dg_0 ..
dg_{m-1}]`` and ``B_0 = sigma I`` (Byrd, Nocedal & Schnabel 1994, Thm 2.3;
the paper's Algorithm 2):

    B v = sigma v - [sigma S, Y] M^{-1} [sigma S^T v; Y^T v],
    M   = [[sigma S^T S, L], [L^T, -D]],

with ``D = diag(S^T Y)`` and ``L`` the strictly-lower part of ``S^T Y``.
The port keeps the pairs as flat (m, p) tensors.  The two passes over p
are the `kernels.lbfgs` kernels, and B v is `kernels.lbfgs.ops.
lbfgs_hvp_fused`; the 2m x 2m solve between them stays plain torch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch


class CompactCoeffs(NamedTuple):
    """Coefficients of the rank-2m correction: Bv = sigma*v - a dW - b dG."""

    sigma: torch.Tensor  # 0-d
    a: torch.Tensor  # (m,) coefficients on the dW rows (already include sigma)
    b: torch.Tensor  # (m,) coefficients on the dG rows


def compact_coeffs(sw: torch.Tensor, sy: torch.Tensor, wv: torch.Tensor,
                   gv: torch.Tensor) -> CompactCoeffs:
    """Solve the 2m x 2m compact system.

    sw = S^T S, sy = S^T Y (m, m); wv = S^T v, gv = Y^T v (m,).  The solve
    skips the singularity check (``solve_ex``), which would cost a host
    sync per approx step; a singular system gives non-finite coefficients
    that the Algorithm-4 guard then reports."""
    m = sw.shape[0]
    diag_sy = torch.diagonal(sy)
    # B_0 = sigma I with sigma from the most recent pair (paper Alg. 2 line 21)
    last = sw[-1, -1]
    sigma = diag_sy[-1] / torch.where(last == 0, torch.ones_like(last), last)
    ell = torch.tril(sy, diagonal=-1)
    top = torch.cat([sigma * sw, ell], dim=1)
    bot = torch.cat([ell.T, -torch.diag(diag_sy)], dim=1)
    mid = torch.cat([top, bot], dim=0)
    rhs = torch.cat([sigma * wv, gv])
    q = torch.linalg.solve_ex(mid, rhs, check_errors=False).result
    return CompactCoeffs(sigma=sigma, a=sigma * q[:m], b=q[m:])


class LbfgsBuffer:
    """Fixed-capacity ring of flat (dw, dg) pairs, newest last.

    Admission is the convexity check DeltaGrad uses for non-convex models
    (paper Appendix C.3): a pair enters only if ``<dg, dw> >=
    curvature_eps * <dw, dw>`` and ``<dw, dw> > 0``.  The caller passes the
    two inner products as Python floats (one host sync per explicit step).
    """

    def __init__(self, capacity: int, curvature_eps: float = 0.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.curvature_eps = float(curvature_eps)
        self._dws: List[torch.Tensor] = []
        self._dgs: List[torch.Tensor] = []
        self._stacked: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.rejected = 0
        self.admitted = 0

    def __len__(self) -> int:
        return len(self._dws)

    def add_pair(self, dw: torch.Tensor, dg: torch.Tensor, curv: float,
                 ss: float) -> bool:
        """Returns True if the pair was admitted."""
        if ss <= 0.0 or curv < self.curvature_eps * ss:
            self.rejected += 1
            return False
        self._dws.append(dw)
        self._dgs.append(dg)
        if len(self._dws) > self.capacity:
            self._dws.pop(0)
            self._dgs.pop(0)
        self._stacked = None
        self.admitted += 1
        return True

    def stacked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dW, dG), each (len, p) and contiguous; cached between admissions."""
        if not self._dws:
            raise ValueError("LbfgsBuffer.stacked called with no admitted pairs")
        if self._stacked is None:
            self._stacked = (torch.stack(self._dws), torch.stack(self._dgs))
        return self._stacked
