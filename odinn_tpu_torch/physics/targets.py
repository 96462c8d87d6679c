"""Diffusivity targets: the algebra mapping law values to the SIA diffusivity.

Notation:
    Γ_noA = 2 (ρg)ⁿ / (n+2)      (creep prefactor, without A)
    Γꜛ_noA = 2 (ρg)ⁿ / (n+1)     (surface-velocity prefactor)
    S_slide = C (ρg)^{p−q}       (sliding prefactor)

A-target diffusivity:
    D = S_slide H̄^{p−q+1} |∇S|^{p−1} + A Γ_noA H̄^{n+2} |∇S|^{n−1}

Only the A target is ported; the hybrid and pure-D targets come with the NN
laws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["ATarget", "gamma_no_A", "gamma_up_no_A", "sliding_prefactor"]


def _pow(x, e):
    """xᵉ. A Python integer-valued exponent is an integer power (multiplies);
    a tensor exponent pins zero-base cells to 0 so that the log in the
    exponent's derivative never sees 0."""
    if isinstance(e, (int, float)):
        return x ** int(e) if float(e).is_integer() else x ** e
    pos = x > 0.0
    return torch.where(pos, x, torch.ones_like(x)) ** e * pos


def gamma_no_A(n, rho, g):
    """Γ without A: 2(ρg)ⁿ/(n+2)."""
    return 2.0 * (rho * g) ** n / (n + 2.0)


def gamma_up_no_A(n, rho, g):
    """Γꜛ without A: 2(ρg)ⁿ/(n+1)."""
    return 2.0 * (rho * g) ** n / (n + 1.0)


def sliding_prefactor(C, p, q, rho, g):
    """S_slide = C(ρg)^{p−q}."""
    return C * (rho * g) ** (p - q)


@dataclass(frozen=True)
class ATarget:
    """Learn the creep coefficient A."""

    name: str = "A"

    def diffusivity(self, vals, hbar, grad_s, phys):
        rho, g = phys.rho, phys.g
        n, A, C, p, q = vals.n, vals.A, vals.C, vals.p, vals.q
        slide = sliding_prefactor(C, p, q, rho, g) * _pow(hbar, p - q + 1.0) * _pow(grad_s, p - 1.0)
        creep = A * gamma_no_A(n, rho, g) * _pow(hbar, n + 2.0) * _pow(grad_s, n - 1.0)
        return slide + creep

    def d_diffusivity_dH(self, vals, hbar, grad_s, phys):
        """∂D/∂H̄."""
        rho, g = phys.rho, phys.g
        n, A, C, p, q = vals.n, vals.A, vals.C, vals.p, vals.q
        slide = ((p - q + 1.0) * sliding_prefactor(C, p, q, rho, g) * _pow(hbar, p - q)
                 * _pow(grad_s, p - 1.0))
        creep = (A * gamma_no_A(n, rho, g) * (n + 2.0) * _pow(hbar, n + 1.0)
                 * _pow(grad_s, n - 1.0))
        return slide + creep

    def d_diffusivity_dgradS(self, vals, hbar, grad_s, phys):
        """β = ∂D/∂|∇S| / |∇S|, so that ∂D/∂∇Sᵢ = β·∇Sᵢ."""
        rho, g = phys.rho, phys.g
        n, A, C, p, q = vals.n, vals.A, vals.C, vals.p, vals.q
        slide = (sliding_prefactor(C, p, q, rho, g) * (p - 1.0) * _pow(hbar, p - q + 1.0)
                 * _pow(grad_s, p - 3.0))
        creep = (A * gamma_no_A(n, rho, g) * (n - 1.0) * _pow(hbar, n + 2.0)
                 * _pow(grad_s, n - 3.0))
        return slide + creep

    def velocity_up(self, vals, hbar, grad_s, phys):
        """Velocityꜛ: surface-velocity prefactor, V = −Velocityꜛ·∇S."""
        rho, g = phys.rho, phys.g
        n, A, C, p, q = vals.n, vals.A, vals.C, vals.p, vals.q
        slide = (
            sliding_prefactor(C, p, q, rho, g)
            * (p - q + 2.0)
            * _pow(hbar, p - q + 1.0)
            * _pow(grad_s, n - 1.0)
        )
        creep = A * gamma_up_no_A(n, rho, g) * _pow(hbar, n + 1.0) * _pow(grad_s, n - 1.0)
        return slide + creep
