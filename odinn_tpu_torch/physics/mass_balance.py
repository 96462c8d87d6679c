"""Surface mass balance: the temperature-index model, and the step that
applies it or an MLP model (``models.mb_machine.CustomMLP``).

- the monthly climate is downscaled to the glacier surface with a lapse-rate
  gradient: T₂D(m) = T_ref(m) + ∇T(m)·(S − ref_hgt)
- melt = DDF · Σ_m PDD(m) over the trailing window (positive degree-days)
- acc  = acc_factor · Σ_m snow(m)
- the MB mask ((H>0 ∧ MB<0) ∨ (H>10 ∧ MB≥0)) gates application, and MB is
  clipped so that H + MB ≥ 0.

Works on one glacier or a stacked batch: climate series are then
(n_g, n_months) and per-glacier scalars (n_g,).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TImodel1", "downscale_2d_climate", "compute_mb", "apply_mb_mask", "mb_timestep",
           "validate_model_simulation_compatibility"]

_DAYS_PER_MONTH = 30.44


@dataclass(frozen=True)
class TImodel1:
    """Temperature-index mass-balance model: DDF in m ice °C⁻¹ day⁻¹,
    acc_factor a multiplier on solid precipitation."""

    DDF: float = 7.0e-3
    acc_factor: float = 1.0


def _trail(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a`` with k trailing singleton axes."""
    return a.reshape(a.shape + (1,) * k)


def _shifted_time(t, step, dtype: torch.dtype) -> float:
    """t − step rounded as the state dtype computes it: a float32 solve
    forms the month-window index from float32 times."""
    npt = np.float32 if dtype == torch.float32 else np.float64
    if isinstance(t, torch.Tensor):
        t = t.item()
    return float(npt(t) - npt(step))


def downscale_2d_climate(climate, S):
    """The monthly reference-height temperatures downscaled to the surface
    ``S``: T₂D(m) = T_ref(m) + ∇T(m)·(S − ref_hgt), shaped (n_months, nx,
    ny), or (n_g, n_months, nx, ny) for a batch."""
    return _trail(climate.temp, 2) + _trail(climate.gradient, 2) * (
        S.unsqueeze(-3) - _trail(torch.as_tensor(climate.ref_hgt), 3))


def compute_mb(mb: TImodel1, climate, S, t, step):
    """Mass balance accumulated over the window (t−step, t], per cell [m ice].

    The window is the ``round(step·12)`` months starting at
    m0 = round((t − step − t_start)·12), computed in the state dtype with
    round-half-even and clipped to the series.
    """
    n_m = climate.temp.shape[-1]
    n_win = max(int(round(float(step) * 12.0)), 1)
    m0 = torch.round((_shifted_time(t, step, S.dtype) - climate.t_start) * 12.0)
    m0 = m0.to(torch.long).clamp(0, n_m - n_win)
    idx = m0[..., None] + torch.arange(n_win, device=m0.device)

    def window(series):
        return torch.take_along_dim(series, idx, dim=-1)

    temp_w, grad_w, snow_w = window(climate.temp), window(climate.gradient), window(climate.snow)
    t2d = _trail(temp_w, 2) + _trail(grad_w, 2) * (
        S.unsqueeze(-3) - _trail(climate.ref_hgt, 3))
    pdd = torch.clamp(t2d, min=0.0) * _DAYS_PER_MONTH      # degree-days per month
    melt = mb.DDF * torch.sum(pdd, dim=-3)
    acc = mb.acc_factor * torch.sum(snow_w, dim=-1)
    return _trail(acc, 2) - melt


def apply_mb_mask(H, MB):
    """Masked, clipped MB application; returns (H_new, MB_applied)."""
    mask = ((H > 0.0) & (MB < 0.0)) | ((H > 10.0) & (MB >= 0.0))
    mb_eff = torch.where(mask, MB, torch.zeros_like(MB))
    mb_eff = torch.maximum(mb_eff, -H)
    return H + mb_eff, mb_eff


def mb_timestep(H, glacier, mb, t, step):
    """The MB step at time t over the window (t−step, t]; returns the new
    thickness in H's dtype. ``mb`` is a ``TImodel1`` or an MLP model with
    ``compute_mb_field`` (``models.mb_machine.CustomMLP``), whose MB comes
    in its parameters' dtype and is cast to H's here."""
    H_pos = torch.where(H > 0.0, H, torch.zeros_like(H))
    S = glacier.B.to(H.dtype) + H_pos
    if hasattr(mb, "compute_mb_field"):
        MB = mb.compute_mb_field(glacier.climate, S, t, step).to(H.dtype)
    else:
        MB = compute_mb(mb, glacier.climate, S, t, step).to(H.dtype)
    H_new, _ = apply_mb_mask(H_pos, MB)
    return H_new


def validate_model_simulation_compatibility(model, params) -> None:
    """Raises when ``simulation.use_MB`` asks for a mass balance the model
    lacks; warns when the model's mass balance will be ignored."""
    if params.simulation.use_MB and model.mass_balance is None:
        raise ValueError("use_MB=True but the model has no mass-balance component")
    if not params.simulation.use_MB and model.mass_balance is not None:
        import warnings

        warnings.warn("mass-balance model provided but use_MB=False; it will be ignored")
