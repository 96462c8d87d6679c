"""Empirical loss functions: the masked L2 and log-ratio losses, the
thickness and velocity losses and their weighted sums.

Every loss sums over the last two (grid) axes, so one call on a stacked
batch with a (n_g,) normalization gives the (n_g,) per-glacier losses, and
on one glacier a number. Masking multiplies by the mask, so shapes are
fixed. Autograd supplies every backward.

On a row-sharded batch (``ctx.glacier.row_shard``) every grid sum is a
partial over the rank's own rows, which the trainer's all-reduce adds up;
where a nonlinearity follows a grid sum (the velocity loss's speed scale)
the sum is taken over the row group first (``parallel.spatial.rows_sum``),
and the thickness loss's erosion mask is formed on the reference's static
slab.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple

import torch

from odinn_tpu_torch.core.glacier import is_in_glacier

__all__ = [
    "L2Sum",
    "LogSum",
    "LossH",
    "LossV",
    "LossHV",
    "MultiLoss",
    "LossContext",
    "simple_loss",
    "simple_residual",
    "backward_simple_loss",
    "loss_uses_velocity",
    "term_kind",
]

_GRID = (-2, -1)


@dataclass(frozen=True)
class L2Sum:
    """Masked L2 loss: Σ_mask (a − b)² / normalization."""

    distance: int = 3


@dataclass(frozen=True)
class LogSum:
    """Log-ratio loss: Σ_mask log²((a+ϵ)/(b+ϵ)) / normalization."""

    distance: int = 3
    eps: float = 0.1


def simple_loss(cfg, a, b, mask, normalization):
    """Forward of the simple losses; ``mask`` is a boolean tensor."""
    m = mask.to(a.dtype)
    if isinstance(cfg, L2Sum):
        return torch.sum(m * (a - b) ** 2, dim=_GRID) / normalization
    if isinstance(cfg, LogSum):
        r = torch.log((torch.clamp(a, min=0.0) + cfg.eps) / (torch.clamp(b, min=0.0) + cfg.eps))
        return torch.sum(m * r ** 2, dim=_GRID) / normalization
    raise TypeError(f"unknown simple loss {cfg!r}")


def simple_residual(cfg, a, b, mask, normalization):
    """Residual form: r with Σ_grid r² == :func:`simple_loss`; a batch's
    ``normalization`` is a (n_g,) tensor broadcast over the grid."""
    m = mask.to(a.dtype)
    if isinstance(normalization, torch.Tensor) and normalization.ndim == 1:
        normalization = normalization[:, None, None]
    w = torch.sqrt(m / normalization)
    if isinstance(cfg, L2Sum):
        return w * (a - b)
    if isinstance(cfg, LogSum):
        return w * torch.log((torch.clamp(a, min=0.0) + cfg.eps)
                             / (torch.clamp(b, min=0.0) + cfg.eps))
    raise TypeError(f"unknown simple loss {cfg!r}")


def backward_simple_loss(cfg, a, b, mask, normalization):
    """∂ :func:`simple_loss` / ∂a, per cell (the reference's
    ``backward_loss``); a batch's ``normalization`` is a (n_g,) tensor
    broadcast over the grid."""
    m = mask.to(a.dtype)
    if isinstance(normalization, torch.Tensor) and normalization.ndim == 1:
        normalization = normalization[:, None, None]
    if isinstance(cfg, L2Sum):
        return 2.0 * m * (a - b) / normalization
    if isinstance(cfg, LogSum):
        ap = torch.clamp(a, min=0.0) + cfg.eps
        bp = torch.clamp(b, min=0.0) + cfg.eps
        grad = 2.0 * m * torch.log(ap / bp) / ap / normalization
        return grad * (a > 0.0)
    raise TypeError(f"unknown simple loss {cfg!r}")


@dataclass(frozen=True)
class LossH:
    """Ice-thickness loss."""

    loss: Any = field(default_factory=L2Sum)

    def __call__(self, ctx, H_pred, t):
        if ctx.H_ref is None:
            return torch.zeros((), dtype=H_pred.dtype, device=H_pred.device)
        mask = ctx.ref_mask(self.loss.distance)
        return simple_loss(self.loss, H_pred, ctx.H_ref, mask, ctx.normalization)

    def residuals(self, ctx, H_pred, t):
        if ctx.H_ref is None:
            return ()
        mask = ctx.ref_mask(self.loss.distance)
        return (simple_residual(self.loss, H_pred, ctx.H_ref, mask, ctx.normalization),)


@dataclass(frozen=True)
class LossV:
    """Surface-velocity loss. ``component``: "xy" compares (Vx, Vy), "abs"
    compares |V|; with ``scale_loss`` the loss is divided by the mean
    reference speed."""

    loss: Any = field(default_factory=L2Sum)
    component: str = "xy"
    scale_loss: bool = True

    def __call__(self, ctx, H_pred, t):
        if ctx.V_ref is None:
            return torch.zeros((), dtype=H_pred.dtype, device=H_pred.device)
        vx, vy, vabs = ctx.velocity_fn(H_pred, t)
        mask = ctx.V_ref > 0.0
        if self.component == "xy":
            l = (simple_loss(self.loss, vx, ctx.Vx_ref, mask, ctx.normalization)
                 + simple_loss(self.loss, vy, ctx.Vy_ref, mask, ctx.normalization))
        elif self.component == "abs":
            l = simple_loss(self.loss, vabs, ctx.V_ref, mask, ctx.normalization)
        else:
            raise ValueError(f"unknown velocity component {self.component!r}")
        if self.scale_loss:
            l = l / self._speed_scale(ctx, mask, vx.dtype)
        return l

    def _speed_scale(self, ctx, mask, dtype):
        from odinn_tpu_torch.parallel.spatial import row_shard_of, rows_sum

        m = mask.to(dtype)
        shard = row_shard_of(ctx.glacier)
        mean_speed = torch.sqrt(
            rows_sum(torch.sum(m * (ctx.Vx_ref ** 2 + ctx.Vy_ref ** 2), dim=_GRID), shard)
            / torch.clamp(rows_sum(torch.sum(m, dim=_GRID), shard), min=1.0))
        return torch.clamp(mean_speed, min=1e-12)

    def residuals(self, ctx, H_pred, t):
        if ctx.V_ref is None:
            return ()
        vx, vy, vabs = ctx.velocity_fn(H_pred, t)
        mask = ctx.V_ref > 0.0
        s = 1.0
        if self.scale_loss:
            s = torch.sqrt(1.0 / self._speed_scale(ctx, mask, vx.dtype))
            if s.ndim == 1:
                s = s[:, None, None]
        if self.component == "xy":
            return (s * simple_residual(self.loss, vx, ctx.Vx_ref, mask, ctx.normalization),
                    s * simple_residual(self.loss, vy, ctx.Vy_ref, mask, ctx.normalization))
        if self.component == "abs":
            return (s * simple_residual(self.loss, vabs, ctx.V_ref, mask, ctx.normalization),)
        raise ValueError(f"unknown velocity component {self.component!r}")


@dataclass(frozen=True)
class LossHV:
    """LossH + scaling·LossV."""

    hLoss: Any = field(default_factory=LossH)
    vLoss: Any = field(default_factory=LossV)
    scaling: float = 1.0

    def __call__(self, ctx, H_pred, t):
        return self.hLoss(ctx, H_pred, t) + self.scaling * self.vLoss(ctx, H_pred, t)

    def residuals(self, ctx, H_pred, t):
        s = self.scaling ** 0.5
        return self.hLoss.residuals(ctx, H_pred, t) + tuple(
            s * r for r in self.vLoss.residuals(ctx, H_pred, t))


@dataclass(frozen=True)
class MultiLoss:
    """Weighted sum Σ λᵢ·lossᵢ."""

    terms: Tuple[Any, ...] = ()
    weights: Tuple[float, ...] = ()

    def __post_init__(self):
        if len(self.terms) != len(self.weights):
            raise ValueError("MultiLoss terms and weights must have equal length")

    def __call__(self, ctx, H_pred, t):
        total = 0.0
        for w, term in zip(self.weights, self.terms):
            total = total + w * term(ctx, H_pred, t)
        return total


def loss_uses_velocity(cfg) -> bool:
    """Whether a loss configuration compares velocities."""
    if isinstance(cfg, (LossV, LossHV)):
        return True
    if isinstance(cfg, MultiLoss):
        return any(loss_uses_velocity(t) for t in cfg.terms)
    return False


@dataclass(frozen=True)
class LossContext:
    """Per-tstop loss inputs: references, the velocity diagnostic and the
    normalization, for one glacier or a stacked batch."""

    H_ref: Any = None
    V_ref: Any = None
    Vx_ref: Any = None
    Vy_ref: Any = None
    velocity_fn: Any = None
    normalization: Any = 1.0
    theta: Any = None
    glacier_idx: Any = None
    glacier: Any = None
    dx: Any = None
    dy: Any = None
    H_ref_ext: Any = None     # H_ref on a row shard's static slab

    def ref_mask(self, distance: int):
        """The cells at least ``distance`` pixels inside the reference
        thickness's margin (``is_in_glacier``); on a row shard, eroded on the
        reference's static slab, then cut to the own rows."""
        if self.H_ref_ext is None:
            return is_in_glacier(self.H_ref, distance)
        from odinn_tpu_torch.parallel.spatial import in_glacier

        return in_glacier(self.H_ref_ext, distance, self.glacier.row_shard, static=True)


def term_kind(term) -> str:
    """Evaluation cadence of a loss term: "transient" (per tstop,
    Δt-weighted), "initial" (once, at solve start), "aggregate" (once, on the
    trajectory)."""
    return getattr(term, "kind", "transient")
