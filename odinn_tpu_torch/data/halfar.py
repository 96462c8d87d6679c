"""Halfar analytical SIA dome solutions (validation ground truth).

The generalized Halfar similarity solution of the flat-bed SIA equation with
Glen exponent ``n`` and optional mass balance M = (λ/t)·H (Bueler et al.
2005):

    H(r, t) = H₀ (t/t₀)^{-α} [ 1 − ((t/t₀)^{-β} r/R₀)^{(n+1)/n} ]₊^{n/(2n+1)}

    α = (2 − (n+1)λ) / (5n+3),   β = (1 + (2n+1)λ) / (5n+3)
    t₀ = (β/Γ) ((2n+1)/(n+1))ⁿ R₀^{n+1} / H₀^{2n+1},   Γ = 2A(ρg)ⁿ/(n+2)

At t = t₀ the dome has maximal height H₀ and margin radius R₀.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["HalfarParameters", "Halfar", "halfar_t0"]


@dataclass(frozen=True)
class HalfarParameters:
    """Parameters of the generalized Halfar dome."""

    lam: float = 0.0       # λ mass-balance coefficient, M = (λ/t) H
    R0: float = 2000.0     # margin radius at t₀ [m]
    H0: float = 400.0      # dome height at t₀ [m]
    A: float = 1.1e-17     # Glen creep coefficient [Pa⁻ⁿ yr⁻¹]
    n: float = 3.0         # Glen exponent
    rho: float = 900.0
    g: float = 9.81


def _gamma(A, n, rho, g):
    return 2.0 * A * (rho * g) ** n / (n + 2.0)


def halfar_t0(p: HalfarParameters) -> float:
    """Characteristic time t₀ at which the dome has profile (H₀, R₀)."""
    n, lam = p.n, p.lam
    beta = (1.0 + (2.0 * n + 1.0) * lam) / (5.0 * n + 3.0)
    gam = _gamma(p.A, n, p.rho, p.g)
    return (beta / gam) * ((2.0 * n + 1.0) / (n + 1.0)) ** n * (
        p.R0 ** (n + 1.0) / p.H0 ** (2.0 * n + 1.0)
    )


def Halfar(p: HalfarParameters):
    """Return ``(halfar_fn, t0)`` with ``halfar_fn(x, y, t) -> H`` on tensors;
    time runs on the solution's intrinsic clock."""
    t0 = halfar_t0(p)
    n, lam = p.n, p.lam
    alpha = (2.0 - (n + 1.0) * lam) / (5.0 * n + 3.0)
    beta = (1.0 + (2.0 * n + 1.0) * lam) / (5.0 * n + 3.0)

    def halfar_fn(x, y, t):
        r = torch.sqrt(x ** 2 + y ** 2)
        tr = t / t0
        xi = tr ** (-beta) * r / p.R0
        core = torch.clamp(1.0 - xi ** ((n + 1.0) / n), min=0.0)
        return p.H0 * tr ** (-alpha) * core ** (n / (2.0 * n + 1.0))

    return halfar_fn, t0
