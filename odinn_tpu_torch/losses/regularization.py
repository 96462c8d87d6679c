"""Regularization terms (the Tikhonov / Laplacian family).

- :func:`laplacian` — ∇², the staggered double difference with a zero
  boundary ring, and its exact transpose :func:`laplacian_vjp` (kept for the
  hand-written adjoints and tested against autograd);
- ``TikhonovRegularization``         — Σ_mask (∇²a)²;
- ``InitialThicknessRegularization`` — Tikhonov on the trainable H₀ at t₀;
- ``VelocityRegularization``         — Tikhonov on |V|(H, θ);
- ``RheologyRegularization``         — Tikhonov on the tanh-bounded gridded A;
- ``DiffusivityRegularization``      — Tikhonov on D (declared, not defined).

Each term has a ``kind``: "initial" terms are evaluated once per solve,
"transient" ones per tstop. On a stacked batch every term sums over the
last two (grid) axes, giving one value per glacier; the spacings may be
per-glacier (n_g,) tensors, which broadcast as (n_g, 1, 1) columns.
Autograd supplies every backward.

On a row-sharded batch (``ctx.glacier.row_shard``) the Laplacian of a grid
field takes one ghost row on each side, and an erosion mask of the state
its distance in ghost rows (``parallel.spatial``); their grid sums are
own-row partials. A term that reads θ alone (``reads_grid = False``,
``RheologyRegularization``) is whole on every rank of a row group, and the
trainer counts it on row rank 0 only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F


__all__ = [
    "laplacian",
    "laplacian_vjp",
    "TikhonovRegularization",
    "InitialThicknessRegularization",
    "VelocityRegularization",
    "RheologyRegularization",
    "DiffusivityRegularization",
]

_GRID = (-2, -1)


def _grid(v):
    """A spacing as a value that broadcasts against grids: a tensor of one
    value per glacier gains two trailing axes; a number stays a number."""
    return v.reshape(v.shape + (1, 1)) if isinstance(v, torch.Tensor) else v


def laplacian(a, dx, dy):
    """∇²a on the interior, zero on the boundary ring."""
    dx2, dy2 = _grid(dx) ** 2, _grid(dy) ** 2
    d2x = (a[..., 2:, 1:-1] - 2.0 * a[..., 1:-1, 1:-1] + a[..., :-2, 1:-1]) / dx2
    d2y = (a[..., 1:-1, 2:] - 2.0 * a[..., 1:-1, 1:-1] + a[..., 1:-1, :-2]) / dy2
    return F.pad(d2x + d2y, (1, 1, 1, 1))


def laplacian_vjp(lam, a, dx, dy):
    """⟨λ, ∇²·⟩'s pullback: the exact transpose of :func:`laplacian` (the
    ring of ``lam`` is ignored; ``a`` gives only the shape)."""
    dx2, dy2 = _grid(dx) ** 2, _grid(dy) ** 2
    c = lam[..., 1:-1, 1:-1]
    centre = F.pad(c, (1, 1, 1, 1))
    out = torch.zeros_like(a)
    out = out + F.pad(c, (1, 1, 2, 0)) / dx2 - 2.0 * centre / dx2 + F.pad(c, (1, 1, 0, 2)) / dx2
    out = out + F.pad(c, (2, 0, 1, 1)) / dy2 - 2.0 * centre / dy2 + F.pad(c, (0, 2, 1, 1)) / dy2
    return out


def _laplacian_on(a, dx, dy, shard):
    """∇²a, on a row shard through the slab of halo 1."""
    if shard is None:
        return laplacian(a, dx, dy)
    return shard.crop(laplacian(shard.halo_rows(a, 1), dx, dy), 1)


@dataclass(frozen=True)
class TikhonovRegularization:
    """Σ_mask (∇²a)²; ``shard``: the row shard ``a``'s rows belong to."""

    distance: int = 3

    def __call__(self, a, dx, dy, mask, shard=None):
        m = mask.to(a.dtype)
        return torch.sum(m * _laplacian_on(a, dx, dy, shard) ** 2, dim=_GRID)

    def residual(self, a, dx, dy, mask, shard=None):
        """√m·∇²a: Σ_grid r² equals :meth:`__call__`."""
        m = mask.to(a.dtype)
        return torch.sqrt(m) * _laplacian_on(a, dx, dy, shard)


def _shard(ctx):
    from odinn_tpu_torch.parallel.spatial import row_shard_of

    return row_shard_of(ctx.glacier)


def _everywhere(a):
    return torch.ones(a.shape, dtype=torch.bool, device=a.device)


@dataclass(frozen=True)
class InitialThicknessRegularization:
    """Tikhonov on the initial thickness H₀ (the filtered trainable one when
    the model has an initial condition). kind="initial": evaluated once per
    glacier and loss evaluation, on ``H_pred`` = H₀."""

    reg: Any = field(default_factory=TikhonovRegularization)
    t0: float = None   # informational; evaluated at the solve's start
    kind: str = "initial"

    def __call__(self, ctx, H_pred, t):
        return self.reg(H_pred, ctx.dx, ctx.dy, _everywhere(H_pred), _shard(ctx))

    def residuals(self, ctx, H_pred, t):
        return (self.reg.residual(H_pred, ctx.dx, ctx.dy, _everywhere(H_pred), _shard(ctx)),)


@dataclass(frozen=True)
class VelocityRegularization:
    """Tikhonov on |V|(H, θ) inside the glacier. kind="transient"."""

    reg: Any = field(default_factory=TikhonovRegularization)
    components: str = "abs"
    distance: int = 3
    kind: str = "transient"

    def _speed_and_mask(self, ctx, H_pred, t):
        if self.components != "abs":
            raise NotImplementedError(f"VelocityRegularization components {self.components}")
        from odinn_tpu_torch.parallel.spatial import in_glacier

        _, _, v = ctx.velocity_fn(H_pred, t)
        return v, in_glacier(H_pred, self.distance, _shard(ctx)) & (v > 0.0)

    def __call__(self, ctx, H_pred, t):
        v, mask = self._speed_and_mask(ctx, H_pred, t)
        return self.reg(v, ctx.dx, ctx.dy, mask, _shard(ctx))

    def residuals(self, ctx, H_pred, t):
        v, mask = self._speed_and_mask(ctx, H_pred, t)
        return (self.reg.residual(v, ctx.dx, ctx.dy, mask, _shard(ctx)),)


@dataclass(frozen=True)
class RheologyRegularization:
    """Tikhonov on the tanh-bounded gridded A of
    ``LawA_inversion(scalar=False)``: a = min_A + (max_A − min_A)·(tanh θ_A + 1)/2
    for the context's glaciers. kind="initial"."""

    reg: Any = field(default_factory=TikhonovRegularization)
    min_A: float = 8.5e-20
    max_A: float = 8e-17
    kind: str = "initial"
    reads_grid = False        # θ's whole grid: counted once over a row group

    def _rheology(self, ctx):
        raw = ctx.theta["A"][ctx.glacier_idx]
        return self.min_A + (self.max_A - self.min_A) * (torch.tanh(raw) + 1.0) / 2.0

    def __call__(self, ctx, H_pred, t):
        a = self._rheology(ctx)
        return self.reg(a, ctx.dx, ctx.dy, _everywhere(a))

    def residuals(self, ctx, H_pred, t):
        a = self._rheology(ctx)
        return (self.reg.residual(a, ctx.dx, ctx.dy, _everywhere(a)),)


@dataclass(frozen=True)
class DiffusivityRegularization:
    """Declared for parity; its loss is defined nowhere, so calling it
    raises."""

    reg: Any = field(default_factory=TikhonovRegularization)
    kind: str = "transient"

    def __call__(self, ctx, H_pred, t):
        raise NotImplementedError("DiffusivityRegularization's loss is not defined")
