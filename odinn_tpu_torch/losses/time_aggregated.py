"""Time-aggregated losses: terms that are no ∫ℓ(H(t))dt.

- ``LossDhdt`` — the mean thickness-change rate between two dates against
  an observed dh/dt map;
- ``LossAvgV`` — the Δt-weighted mean surface speed over an interval
  against one (annual) velocity map.

kind = "aggregate": the loss pipeline calls these once per solve with the
whole saved trajectory (T, …, nx, ny), time first, and the tstops. On a
stacked batch the observation dates are (n_g,) tensors, one per glacier,
and each glacier reads its own saves. Each loss assembles (pred, ref, mask)
in one helper shared by ``__call__`` and ``residuals``, so the loss and its
residual form cannot drift apart. Autograd supplies every backward. On a
row-sharded batch the sums are own-row partials, the dh/dt mask's erosion
takes its distance in ghost rows of the state, and the velocity diagnostic
its one ghost row (``parallel.spatial``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from odinn_tpu_torch.losses.losses import L2Sum, simple_loss, simple_residual

__all__ = ["LossDhdt", "LossAvgV"]


def _times(tstops, device):
    return torch.as_tensor(tstops, dtype=torch.float64).to(device)


def _grid(v, dtype):
    """Per-glacier values (n_g,) as (n_g, 1, 1) columns in ``dtype``."""
    v = v.to(dtype)
    return v.reshape(v.shape + (1, 1))


def _state_at(traj, tstops, t):
    """The trajectory's state at time ``t`` by linear interpolation between
    the saves around it (clipped to the first and last interval). ``t`` is
    a number or a 0-dim tensor for the whole of ``traj[k]``, or an (n_g,)
    tensor, one time per glacier of a (T, n_g, nx, ny) trajectory."""
    ts = _times(tstops, traj.device)
    tt = torch.as_tensor(t, dtype=torch.float64).to(traj.device)
    flat = tt.reshape(-1)
    idx = torch.clamp(torch.searchsorted(ts, flat, right=True) - 1, 0, ts.shape[0] - 2)
    t0, t1 = ts[idx], ts[idx + 1]
    w = torch.where(t1 > t0, (flat - t0) / torch.where(t1 > t0, t1 - t0, torch.ones_like(t0)),
                    torch.zeros_like(t0))
    if tt.ndim == 0:
        w = w.to(traj.dtype)[0]
        return (1.0 - w) * traj[idx[0]] + w * traj[idx[0] + 1]
    g = torch.arange(flat.shape[0], device=traj.device)
    return _grid(1.0 - w, traj.dtype) * traj[idx, g] + _grid(w, traj.dtype) * traj[idx + 1, g]


@dataclass(frozen=True)
class LossDhdt:
    """((H(t₂) − H(t₁))/(t₂ − t₁) − dh/dt_obs)² inside the glacier."""

    loss: Any = field(default_factory=L2Sum)
    kind: str = "aggregate"

    def _pred(self, ctx, traj, tstops):
        """(pred, ref, mask), or None when no dh/dt observation is attached."""
        dd = ctx.glacier.dhdt_data
        if dd is None:
            return None
        h1 = _state_at(traj, tstops, dd.t1)
        h2 = _state_at(traj, tstops, dd.t2)
        span = dd.t2 - dd.t1
        span = _grid(span, traj.dtype) if span.ndim else span.to(traj.dtype)
        pred = (h2 - h1) / span
        from odinn_tpu_torch.parallel.spatial import in_glacier, row_shard_of

        return pred, dd.dhdt, in_glacier(h2, self.loss.distance, row_shard_of(ctx.glacier))

    def __call__(self, ctx, traj, tstops):
        pm = self._pred(ctx, traj, tstops)
        if pm is None:
            return torch.zeros((), dtype=traj.dtype, device=traj.device)
        return simple_loss(self.loss, *pm, ctx.normalization)

    def residuals(self, ctx, traj, tstops):
        """Residual blocks whose Σ‖·‖² equals :meth:`__call__`."""
        pm = self._pred(ctx, traj, tstops)
        if pm is None:
            return ()
        return (simple_residual(self.loss, *pm, ctx.normalization),)


@dataclass(frozen=True)
class LossAvgV:
    """Δt-weighted mean surface speed over [date1, date2] (the whole span
    when a date is missing) against one observed speed map: each save
    interval that ends inside the dates weighs its length, and the speed is
    the velocity diagnostic at the interval's end."""

    loss: Any = field(default_factory=L2Sum)
    kind: str = "aggregate"

    def _pred(self, ctx, traj, tstops):
        """(v_avg, v_ref, mask), or None when no velocity map is attached."""
        vd = ctx.glacier.velocity_data
        if vd is None:
            return None
        ts = _times(tstops, traj.device)
        v_ref = vd.vabs.select(-3, 0) if vd.vabs.ndim == traj.ndim else vd.vabs
        t1 = ts[0] if vd.date1 is None else torch.as_tensor(vd.date1, dtype=torch.float64)
        t2 = ts[-1] if vd.date2 is None else torch.as_tensor(vd.date2, dtype=torch.float64)
        t1, t2 = (x.to(traj.device).unsqueeze(-1) for x in (t1, t2))
        ends = ts[1:]
        w = torch.diff(ts) * ((ends >= t1) & (ends <= t2))
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
        speeds = ctx.velocity_fn(traj[1:], float(ts[0]))[2]
        w = w.to(traj.dtype)
        if w.ndim == 1:
            v_avg = torch.tensordot(w, speeds, dims=1)
        else:                                   # (n_g, T−1) weights, (T−1, n_g, …) speeds
            v_avg = torch.einsum("gk,kg...->g...", w, speeds)
        return v_avg, v_ref, v_ref > 0.0

    def __call__(self, ctx, traj, tstops):
        pm = self._pred(ctx, traj, tstops)
        if pm is None:
            return torch.zeros((), dtype=traj.dtype, device=traj.device)
        return simple_loss(self.loss, *pm, ctx.normalization)

    def residuals(self, ctx, traj, tstops):
        """Residual blocks whose Σ‖·‖² equals :meth:`__call__`."""
        pm = self._pred(ctx, traj, tstops)
        if pm is None:
            return ()
        return (simple_residual(self.loss, *pm, ctx.normalization),)
