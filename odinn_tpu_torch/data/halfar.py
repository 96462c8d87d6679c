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

__all__ = ["HalfarParameters", "Halfar", "halfar_solution", "halfar_velocity", "halfar_t0"]


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


def halfar_solution(r, t, h0, r0, A, n, physical, lam: float = 0.0):
    """The Halfar dome at the radii ``r`` (a tensor) and intrinsic time
    ``t``: the dome has profile (h₀, r₀) at t = t₀(A, n, h₀, r₀)."""
    p = HalfarParameters(lam=lam, R0=r0, H0=h0, A=A, n=n, rho=physical.rho, g=physical.g)
    fn, _ = Halfar(p)
    return fn(r, torch.zeros_like(r), t)


def halfar_velocity(p: HalfarParameters):
    """``vel_fn(x, y, t) -> (vx, vy)``, the dome's surface velocity on a
    flat bed:

        V_s = −Γꜛ Hⁿ⁺¹ |∇H|ⁿ⁻¹ ∇H,   Γꜛ = 2A(ρg)ⁿ/(n+1)

    with the radial thickness gradient taken analytically."""
    t0 = halfar_t0(p)
    n, lam = p.n, p.lam
    alpha = (2.0 - (n + 1.0) * lam) / (5.0 * n + 3.0)
    beta = (1.0 + (2.0 * n + 1.0) * lam) / (5.0 * n + 3.0)
    gam_up = 2.0 * p.A * (p.rho * p.g) ** n / (n + 1.0)

    def vel_fn(x, y, t):
        r = torch.sqrt(x ** 2 + y ** 2)
        tr = t / t0
        xi = tr ** (-beta) * r / p.R0
        core = torch.clamp(1.0 - xi ** ((n + 1.0) / n), min=0.0)
        H = p.H0 * tr ** (-alpha) * core ** (n / (2.0 * n + 1.0))
        # dH/dr = H₀ tr^{-α} · n/(2n+1) · core^{n/(2n+1)-1} · (−(n+1)/n ξ^{1/n}) · tr^{-β}/R₀
        eps = 1e-12
        dHdr = torch.where(
            (core > 0.0) & (r > 0.0),
            p.H0 * tr ** (-alpha) * (n / (2.0 * n + 1.0))
            * torch.clamp(core, min=eps) ** (n / (2.0 * n + 1.0) - 1.0)
            * (-(n + 1.0) / n) * torch.clamp(xi, min=eps) ** (1.0 / n) * tr ** (-beta) / p.R0,
            torch.zeros_like(r),
        )
        vmag = gam_up * H ** (n + 1.0) * torch.abs(dHdr) ** (n - 1.0)
        rx = torch.where(r > 0.0, x / torch.clamp(r, min=eps), torch.zeros_like(r))
        ry = torch.where(r > 0.0, y / torch.clamp(r, min=eps), torch.zeros_like(r))
        return -vmag * dHdr * rx, -vmag * dHdr * ry

    return vel_fn
