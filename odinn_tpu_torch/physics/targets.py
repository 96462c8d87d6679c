"""Diffusivity targets: the algebra mapping law values to the SIA diffusivity.

Notation:
    Γ_noA = 2 (ρg)ⁿ / (n+2)      (creep prefactor, without A)
    Γꜛ_noA = 2 (ρg)ⁿ / (n+1)     (surface-velocity prefactor)
    S_slide = C (ρg)^{p−q}       (sliding prefactor)

The targets:

- ``ATarget`` learns the creep coefficient A:
  D = S_slide H̄^{p−q+1} |∇S|^{p−1} + A Γ_noA H̄^{n+2} |∇S|^{n−1};
- ``DHybridTarget`` learns the hybrid diffusivity Y = NN(T, H̄), in place
  of A·Γ, with optionally decoupled exponents n_H and n_∇S;
- ``DPureTarget`` learns the diffusive velocity U = NN(H̄, |∇S|): D = H̄·U;
- ``CappedTarget`` wraps any of them in the smooth cap
  D ← max_D·tanh(D/max_D).

Only the A target has closed-form partials ∂D/∂H̄ and ∂D/∂|∇S| (the hand-
written adjoints take autograd through the others at fixed law values),
and only the A target is the fused kernels' configuration: the others take
the generic stencil chain on either device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ATarget", "DHybridTarget", "DPureTarget", "CappedTarget", "gamma_no_A",
           "gamma_up_no_A", "sliding_prefactor", "cap_D", "get_target"]


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


def cap_D(D, max_D):
    """Smooth cap of the diffusivity: max_D·tanh(D/max_D)."""
    return max_D * torch.tanh(D / max_D)


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


@dataclass(frozen=True)
class DHybridTarget:
    """Learn the hybrid diffusivity Y = NN(T, H̄):

        D = S_slide H̄^{p−q+1} |∇S|^{p−1} + Y Γ_noA H̄^{n_H+2} |∇S|^{n_∇S−1}

    where n_H and n_∇S (default n) decouple the thickness and slope
    exponents from Glen's n."""

    name: str = "D_hybrid"

    def diffusivity(self, vals, hbar, grad_s, phys):
        rho, g = phys.rho, phys.g
        n, C, p, q, Y = vals.n, vals.C, vals.p, vals.q, vals.Y
        n_H = vals.n_H if vals.n_H is not None else n
        n_gs = vals.n_gradS if vals.n_gradS is not None else n
        slide = sliding_prefactor(C, p, q, rho, g) * _pow(hbar, p - q + 1.0) * _pow(grad_s, p - 1.0)
        hybrid = Y * gamma_no_A(n, rho, g) * _pow(hbar, n_H + 2.0) * _pow(grad_s, n_gs - 1.0)
        return slide + hybrid

    def velocity_up(self, vals, hbar, grad_s, phys):
        """Velocityꜛ: D/H̄ taken from the depth average to the surface by
        (n+2)/(n+1). The slide term raises H̄ and |∇S| by plain powers."""
        rho, g = phys.rho, phys.g
        n, C, p, q, Y = vals.n, vals.C, vals.p, vals.q, vals.Y
        n_H = vals.n_H if vals.n_H is not None else n
        n_gs = vals.n_gradS if vals.n_gradS is not None else n
        slide = (
            sliding_prefactor(C, p, q, rho, g)
            * (p - q + 2.0)
            * hbar ** (p - q + 1.0)
            * grad_s ** (p - 1.0)
        )
        hybrid = Y * gamma_up_no_A(n, rho, g) * _pow(hbar, n_H + 1.0) * _pow(grad_s, n_gs - 1.0)
        return slide + hybrid


@dataclass(frozen=True)
class DPureTarget:
    """Learn the diffusive velocity U = NN(H̄, |∇S|): D = H̄·U."""

    name: str = "D"

    def diffusivity(self, vals, hbar, grad_s, phys):
        return hbar * vals.U

    def velocity_up(self, vals, hbar, grad_s, phys):
        """Velocityꜛ = U / f, f the surface-velocity factor. The reference
        looks f up on the physical parameters, which hold none (it is a
        simulation parameter), so f is 1 there and here."""
        return vals.U


@dataclass(frozen=True)
class CappedTarget:
    """A target with the smooth diffusivity cap D ← max_D·tanh(D/max_D)
    (``SIA2DModel.max_D``). It exposes no closed-form partials, so the
    hand-written adjoints take autograd through the capped expression, and
    it is never the fused kernels' configuration (they have no cap)."""

    inner: Any
    max_D: float

    @property
    def name(self) -> str:
        return self.inner.name

    def diffusivity(self, vals, hbar, grad_s, phys):
        return cap_D(self.inner.diffusivity(vals, hbar, grad_s, phys), self.max_D)

    def velocity_up(self, vals, hbar, grad_s, phys):
        return self.inner.velocity_up(vals, hbar, grad_s, phys)


def get_target(name: str):
    """The target of a name: "A", "D_hybrid" or "D"."""
    return {"A": ATarget(), "D_hybrid": DHybridTarget(), "D": DPureTarget()}[name]
