"""Adjoint-method and VJP-flavor taxonomy.

Adjoint methods: :class:`JaxAdjoint` (reverse-mode autograd through the
solve, ``grad="jax"``), :class:`DiscreteAdjoint` (the exact stage-level
transpose of the forward integrator), :class:`ContinuousAdjoint` (the
reverse-time λ solve and a Gauss–Legendre θ contraction) and
:class:`DummyAdjoint` (a random gradient for pipeline testing: the
trainer takes it, or ``grad="dummy"``, as the JAX package does, and as
there ``grad_fn`` is not read). VJP flavors:
:class:`DiscreteVJP` (hand-written stencil transposes),
:class:`ContinuousVJP` (differentiate-then-discretize), :class:`AutoVJP`
(autograd of the RHS) and :class:`NoVJP` (zero).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "AutoVJP",
    "DiscreteVJP",
    "ContinuousVJP",
    "NoVJP",
    "JaxAdjoint",
    "DiscreteAdjoint",
    "ContinuousAdjoint",
    "DummyAdjoint",
]


# --------------------------- VJP flavors -----------------------------------

@dataclass(frozen=True)
class AutoVJP:
    """VJP of the discretized RHS by reverse-mode autograd."""

    name: str = "auto"


@dataclass(frozen=True)
class DiscreteVJP:
    """Hand-written pullback of the discretized RHS via stencil transposes
    (:mod:`odinn_tpu_torch.inverse.vjps`)."""

    name: str = "discrete"


@dataclass(frozen=True)
class ContinuousVJP:
    """Differentiate-then-discretize VJP: the adjoint PDE
    dλ = ∇·(D∇λ) − ∂D/∂H ⟨∇S,∇λ⟩ + ∇·(∂D/∂∇H ⟨∇S,∇λ⟩) discretized directly."""

    name: str = "continuous"


@dataclass(frozen=True)
class NoVJP:
    """Zero VJP, e.g. to leave the mass balance out of the adjoint."""

    name: str = "none"


# --------------------------- Adjoint methods -------------------------------

@dataclass(frozen=True)
class JaxAdjoint:
    """Reverse-mode autograd through the solve (``grad="jax"``), the oracle
    of the manual adjoints."""

    name: str = "jax"


@dataclass(frozen=True)
class DiscreteAdjoint:
    """The discrete adjoint: each substep of the forward integrator is
    transposed stage by stage, its stages rematerialised inside each save
    interval."""

    VJP_method: Any = field(default_factory=DiscreteVJP)
    MB_VJP: Any = field(default_factory=AutoVJP)
    substeps: Any = None    # reverse substeps per saved interval (None → solver.substeps)
    name: str = "discrete"


@dataclass(frozen=True)
class ContinuousAdjoint:
    """The continuous adjoint: the reverse-time λ ODE solved adaptively,
    then a Gauss–Legendre contraction of θ's cotangent over the span."""

    VJP_method: Any = field(default_factory=ContinuousVJP)
    MB_VJP: Any = field(default_factory=AutoVJP)
    n_quadrature: int = 60
    substeps: int = 10      # the first reverse step is the interval over this
    rtol: float = 1e-6      # reverse λ-solve relative tolerance
    atol: float = 1e-8      # reverse λ-solve absolute tolerance
    dtmax: Optional[float] = None   # max reverse step; None = interval length
    # "hermite": cubic-Hermite interpolation of H(t) (slope Ḣ = f(H, t)) in
    # the reverse λ ODE and of both H(t) and λ(t) (slope λ̇ = −(∂f/∂H)ᵀλ) in
    # the quadrature; "linear" is the piecewise-linear fallback
    interpolation: str = "hermite"
    name: str = "continuous"


@dataclass(frozen=True)
class DummyAdjoint:
    """Random or user gradient for pipeline testing."""

    grad_fn: Optional[Any] = None
    name: str = "dummy"
