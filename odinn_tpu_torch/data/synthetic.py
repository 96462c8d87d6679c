"""Synthetic glacier construction: Halfar domes on a flat bed and dummy
climates, for solver validation with no data dependency."""

from __future__ import annotations

import math
from typing import Optional

import torch

from odinn_tpu_torch.core.device import resolve_device
from odinn_tpu_torch.core.glacier import Climate2D, DummyClimate2D, Glacier
from odinn_tpu_torch.data.halfar import Halfar, HalfarParameters

__all__ = ["halfar_glacier", "monthly_dummy_climate"]


def halfar_glacier(
    nx: int = 96,
    ny: int = 96,
    dx: float = 50.0,
    dy: float = 50.0,
    r0: float = 1000.0,
    h0: float = 500.0,
    A: float = 8e-19,
    n: float = 3.0,
    temp: float = -10.0,
    t_ic: float = 5.0,
    rho: float = 900.0,
    g: float = 9.81,
    rgi_id: str = "halfar",
    climate=None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> Glacier:
    """A flat-bed glacier whose H₀ is the Halfar dome at intrinsic time
    ``t_ic``, built in float64 and returned in ``dtype`` on ``device``
    (None: the CUDA card)."""
    dev = resolve_device(device)
    f64 = torch.float64
    fn, _ = Halfar(HalfarParameters(R0=r0, H0=h0, A=A, n=n, rho=rho, g=g))
    xs = torch.tensor([(i - nx / 2) * dx for i in range(nx)], dtype=f64)
    ys = torch.tensor([(j - ny / 2) * dy for j in range(ny)], dtype=f64)
    x, y = torch.meshgrid(xs, ys, indexing="ij")
    H0 = fn(x, y, t_ic)
    if climate is None:
        climate = DummyClimate2D(
            longterm_temps_scalar=torch.tensor(temp, dtype=f64),
            longterm_temps_gridded=torch.full((nx, ny), temp, dtype=f64),
        )
    g_ = Glacier(
        H0=H0,
        B=torch.zeros_like(H0),
        dx=torch.tensor(dx, dtype=f64),
        dy=torch.tensor(dy, dtype=f64),
        A=torch.tensor(A, dtype=f64),
        C=torch.tensor(0.0, dtype=f64),
        n=torch.tensor(n, dtype=f64),
        mask=torch.ones_like(H0),
        coords_x=xs,
        coords_y=ys,
        climate=climate,
        rgi_id=rgi_id,
    )
    return g_.to(dev, dtype)


def monthly_dummy_climate(
    t_start: float,
    n_months: int,
    temp_mean: float = -5.0,
    temp_amplitude: float = 8.0,
    snow_monthly: float = 0.05,
    gradient: float = -0.0065,
    ref_hgt: float = 2000.0,
    longterm_temp: float = -10.0,
    nx: Optional[int] = None,
    ny: Optional[int] = None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> Climate2D:
    """A seasonal monthly climate series for MB testing."""
    dev = resolve_device(device)
    f64 = torch.float64
    months = torch.arange(n_months, dtype=f64)
    temp = temp_mean + temp_amplitude * torch.sin(2.0 * math.pi * (months / 12.0))
    gridded = None
    if nx is not None and ny is not None:
        gridded = torch.full((nx, ny), longterm_temp, dtype=f64)
    clim = Climate2D(
        t_start=torch.tensor(t_start, dtype=f64),
        temp=temp,
        gradient=torch.full((n_months,), gradient, dtype=f64),
        snow=torch.full((n_months,), snow_monthly, dtype=f64),
        ref_hgt=torch.tensor(ref_hgt, dtype=f64),
        longterm_temps_scalar=torch.tensor(longterm_temp, dtype=f64),
        longterm_temps_gridded=gridded,
    )
    return Glacier(climate=clim).to(dev, dtype).climate
