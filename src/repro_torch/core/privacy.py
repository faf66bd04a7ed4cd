"""ε-approximate deletion via the Laplace mechanism (paper §5.1, App. B.1).

DeltaGrad guarantees ``||w^{I*} - w^{U*}|| <= delta_0`` (Theorem 7
constants); adding iid Laplace(delta/eps) noise per coordinate with
``delta >= sqrt(p) * delta_0`` makes the released DeltaGrad model an
ε-approximate deletion in the sense of Definition 3.

This module also carries the Gaussian mechanism of the descent-to-delete
algorithm (Neel et al. 2020): there the deviation bound is an L2 ball, so
calibrated Gaussian noise gives (ε, δ)-indistinguishability from the
retrained-and-noised release.

The calibration (`DeletionBoundConstants.delta0`, `gaussian_sigma`,
`empirical_epsilon`) is the JAX package's arithmetic in Python floats.
The publishers draw ONE flat noise vector over ``params.flat``, in its
dtype and on its device, from the caller's `torch.Generator`; the draws
cannot reproduce ``jax.random``'s, so tests hold them statistically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from repro_torch.utils.tree import FlatParams, key_order


@dataclass
class DeletionBoundConstants:
    """Problem constants entering the paper's delta_0 bound (App. B.1)."""

    mu: float  # strong convexity
    L: float  # smoothness
    c0: float  # Hessian Lipschitz constant
    c2: float  # per-sample gradient bound
    lr: float  # eta
    n: int
    r: int
    m: int = 2  # L-BFGS history
    c1: float = 0.2  # strong-independence constant (paper: ~0.2 on MNIST)

    def delta0(self) -> float:
        """Upper bound on ||w^{U*} - w^{I*}||: the paper's §5.1 display."""
        n, r = float(self.n), float(self.r)
        M1 = 2.0 * self.c2 / self.mu
        e = (self.L * (self.L + 1.0)) / (self.mu * 1.0)  # K1 ~ O(1) absorbed in c1
        A = self.c0 * math.sqrt(self.m) * ((1.0 + e) ** self.m - 1.0) / self.c1 + self.c0
        denom_c = 0.5 * self.mu - (r / (n - r)) * self.mu - self.c0 * M1 * r / (2.0 * n)
        if denom_c <= 0:
            raise ValueError(
                "r/n too large for the privacy bound (denominator <= 0); "
                "the epsilon-approximate-deletion guarantee needs r << n"
            )
        num = (M1 * r / (n - r)) * (A * M1 * (r / n) / (0.5 - r / n))
        return num / (self.lr * denom_c ** 2)


@dataclass
class PrivacyConfig:
    """Certified-deletion knobs shared by every registered algorithm.

    eps/delta are the published guarantee targets; mu/L/c0/c2/c1 are the
    objective's regularity constants (strong convexity, smoothness, Hessian
    Lipschitz, per-sample gradient bound, strong independence).  ``mu=None``
    resolves to the objective's l2 coefficient, the only convexity the
    regularized losses guarantee unconditionally."""

    eps: float = 1.0
    delta: float = 1e-5  # Gaussian-mechanism delta (Laplace uses delta=0)
    mu: Optional[float] = None
    L: float = 1.0
    c0: float = 1.0
    c2: float = 1.0
    c1: float = 0.2
    m: int = 2

    def resolve_mu(self, l2: float) -> float:
        mu = self.mu if self.mu is not None else l2
        if mu <= 0:
            raise ValueError(
                "privacy bounds need strong convexity: set PrivacyConfig.mu "
                "or use an l2-regularized objective")
        return float(mu)

    def constants(self, lr: float, n: int, r: int,
                  l2: float = 0.0) -> DeletionBoundConstants:
        return DeletionBoundConstants(
            mu=self.resolve_mu(l2), L=self.L, c0=self.c0, c2=self.c2,
            lr=float(lr), n=int(n), r=int(r), m=self.m, c1=self.c1)


def num_params(params: Mapping[str, torch.Tensor]) -> int:
    return sum(params[k].numel() for k in key_order(params))


def _noise_publish(generator: torch.Generator, params: FlatParams,
                   scale: float, dist: str) -> FlatParams:
    """params + scale * noise, one flat draw in the buffer's dtype on its
    device.  Laplace(1) by the inverse CDF on u ~ U(-1, 1), the lower end
    excluded (as ``jax.random.laplace`` draws it): -sign(u) log1p(-|u|)."""
    flat = params.flat
    if dist == "laplace":
        u = torch.rand(flat.shape, generator=generator, dtype=flat.dtype,
                       device=flat.device) * 2.0 - 1.0
        u = u.clamp(min=torch.finfo(flat.dtype).eps - 1.0)
        noise = -torch.sign(u) * torch.log1p(-u.abs())
    else:
        noise = torch.randn(flat.shape, generator=generator, dtype=flat.dtype,
                            device=flat.device)
    return params.with_flat(flat + scale * noise)


def laplace_publish(generator: torch.Generator, params: FlatParams,
                    eps: float, delta0: float) -> FlatParams:
    """Add iid Laplace(delta/eps) noise per coordinate, delta = sqrt(p)*delta0.

    Deterministic under the generator's state: all randomness flows from
    the caller's generator, which the draw advances."""
    p = num_params(params)
    return _noise_publish(generator, params, math.sqrt(p) * delta0 / eps,
                          "laplace")


def gaussian_sigma(bound: float, eps: float, delta: float) -> float:
    """Gaussian-mechanism noise scale for an L2 sensitivity `bound`:
    sigma = bound * sqrt(2 ln(1.25/delta)) / eps (Dwork & Roth Thm A.1)."""
    if not 0 < delta < 1:
        raise ValueError(f"gaussian mechanism needs 0 < delta < 1, got {delta}")
    return float(bound) * math.sqrt(2.0 * math.log(1.25 / delta)) / float(eps)


def gaussian_publish(generator: torch.Generator, params: FlatParams,
                     sigma: float) -> FlatParams:
    """Add iid N(0, sigma^2) noise per coordinate (descent-to-delete's
    publication step), under the contract of `laplace_publish`."""
    return _noise_publish(generator, params, float(sigma), "gaussian")


def empirical_epsilon(w_i: Mapping[str, torch.Tensor],
                      w_u: Mapping[str, torch.Tensor], eps: float,
                      delta0: float, p: int) -> float:
    """Achieved log-density-ratio bound: eps * ||w_I - w_U||_1 / (sqrt(p)*delta0).

    <= eps whenever the theoretical bound holds; a diagnostic."""
    l1 = 0.0
    for k in key_order(w_i):
        l1 += float(torch.sum(torch.abs(w_i[k] - w_u[k])))
    return eps * l1 / (math.sqrt(p) * delta0)
