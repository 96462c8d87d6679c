"""Glacier, climate and observation containers.

Frozen dataclasses of tensors. A single glacier holds ``(nx, ny)`` grids and
0-dim scalars; a stacked batch (:func:`stack_glaciers`) holds the same fields
with a leading glacier axis, every glacier padded to the largest grid. That
leading axis is the batch dimension every solver in the port runs over, and
``rgi_id`` stacks to a tuple.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from odinn_tpu_torch.core.device import resolve_device

__all__ = [
    "DummyClimate2D",
    "Climate2D",
    "ThicknessData",
    "SurfaceVelocityData",
    "regrid_velocity_data",
    "DhdtData",
    "Glacier",
    "map_tensors",
    "per_glacier_column",
    "pad_glacier",
    "stack_glaciers",
    "loss_normalization",
    "is_in_glacier",
]


def map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """Apply ``fn`` to every tensor field of a (nested) container dataclass."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


def _batch_mean(a: torch.Tensor, keep: int) -> torch.Tensor:
    """Mean over all axes after the first ``keep`` ones."""
    return a.reshape(a.shape[:keep] + (-1,)).mean(-1)


@dataclass(frozen=True)
class DummyClimate2D:
    """Synthetic climate with constant long-term temperature [°C]."""

    longterm_temps_scalar: Optional[torch.Tensor] = None   # () or (n_years,)
    longterm_temps_gridded: Optional[torch.Tensor] = None  # (nx, ny) or (n_years, nx, ny)

    def avg_scalar_temp(self, t, batched: bool = False):
        return _batch_mean(self.longterm_temps_scalar, 1 if batched else 0)

    def avg_gridded_temp(self, t, batched: bool = False):
        g = self.longterm_temps_gridded
        return g if g.ndim == 2 + batched else g.mean(dim=int(batched))


@dataclass(frozen=True)
class Climate2D:
    """Monthly climate series on a fixed monthly grid starting at ``t_start``."""

    t_start: Optional[torch.Tensor] = None      # () float year of series start
    temp: Optional[torch.Tensor] = None         # (n_months,) temp at ref height [°C]
    gradient: Optional[torch.Tensor] = None     # (n_months,) lapse rate [°C/m]
    snow: Optional[torch.Tensor] = None         # (n_months,) solid precipitation [m w.e.]
    ref_hgt: Optional[torch.Tensor] = None      # () reference altitude [m]
    longterm_temps_scalar: Optional[torch.Tensor] = None
    longterm_temps_gridded: Optional[torch.Tensor] = None

    avg_scalar_temp = DummyClimate2D.avg_scalar_temp
    avg_gridded_temp = DummyClimate2D.avg_gridded_temp

    def month_index(self, t):
        """Index of the month that holds float-year time ``t``, clamped to
        the series (a long tensor; per glacier for a batch)."""
        t_start = torch.as_tensor(self.t_start)
        idx = torch.floor((torch.as_tensor(t, dtype=t_start.dtype, device=t_start.device)
                           - t_start) * 12.0 + 1e-9).to(torch.long)
        return torch.clamp(idx, 0, self.temp.shape[-1] - 1)


@dataclass(frozen=True)
class ThicknessData:
    """Observed ice-thickness time series."""

    t: Optional[torch.Tensor] = None        # (n_obs,)
    H: Optional[torch.Tensor] = None        # (n_obs, nx, ny)


@dataclass(frozen=True)
class SurfaceVelocityData:
    """Observed surface-velocity data."""

    t: Optional[torch.Tensor] = None
    vx: Optional[torch.Tensor] = None
    vy: Optional[torch.Tensor] = None
    vabs: Optional[torch.Tensor] = None
    x: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None
    date1: Optional[torch.Tensor] = None
    date2: Optional[torch.Tensor] = None
    is_grid_glacier_aligned: bool = True


def _linear_taps(c: torch.Tensor, src: torch.Tensor):
    """Fractional indices of the points ``c`` on the uniform grid ``src``,
    as (lower index, upper index, weight of the upper, inside): the upper
    index is clamped to the grid, so a point on the last node reads no
    element past the edge (its upper weight is 0)."""
    frac = (c - src[0]) / (src[1] - src[0])
    n = src.shape[0]
    inside = (frac >= 0.0) & (frac <= n - 1.0)
    base = torch.floor(frac)
    lo = base.clamp(0, n - 1).to(torch.long)
    hi = (lo + 1).clamp(max=n - 1)
    return lo, hi, frac - base, inside


def regrid_velocity_data(vd: SurfaceVelocityData, glacier) -> SurfaceVelocityData:
    """Bilinearly regrid a velocity datacube onto the glacier grid (one
    glacier, ``coords_x``/``coords_y`` of its cell centers). Cells outside
    the datacube's footprint get 0, which the V_ref > 0 loss masks drop.

    A plain gather: the four neighbours of every glacier cell, for all
    frames of ``vx``, ``vy`` and ``vabs`` in one pass, on the cube's
    device in its dtype. Inside the footprint this is
    ``map_coordinates(order=1, mode="constant")``."""
    if vd.is_grid_glacier_aligned:
        return vd
    if vd.x is None or vd.y is None:
        raise ValueError("regridding requires the datacube x/y coordinates")
    gx = glacier.coords_x.to(device=vd.x.device, dtype=vd.x.dtype)
    gy = glacier.coords_y.to(device=vd.y.device, dtype=vd.y.dtype)
    x0, x1, wx, in_x = _linear_taps(gx, vd.x)
    y0, y1, wy, in_y = _linear_taps(gy, vd.y)
    fields = [f for f in (vd.vx, vd.vy, vd.vabs) if f is not None]
    stack = torch.cat(fields)                       # (frames of every field, nx_src, ny_src)
    wx, wy = wx.to(stack.dtype)[:, None], wy.to(stack.dtype)[None, :]
    x0, x1, y0, y1 = x0[:, None], x1[:, None], y0[None, :], y1[None, :]
    out = ((1.0 - wx) * (1.0 - wy) * stack[:, x0, y0] + (1.0 - wx) * wy * stack[:, x0, y1]
           + wx * (1.0 - wy) * stack[:, x1, y0] + wx * wy * stack[:, x1, y1])
    out = out * (in_x[:, None] & in_y[None, :]).to(stack.dtype)
    parts = iter(out.split([f.shape[0] for f in fields]))
    return dataclasses.replace(
        vd,
        vx=next(parts) if vd.vx is not None else None,
        vy=next(parts) if vd.vy is not None else None,
        vabs=next(parts) if vd.vabs is not None else None,
        x=glacier.coords_x,
        y=glacier.coords_y,
        is_grid_glacier_aligned=True,
    )


@dataclass(frozen=True)
class DhdtData:
    """Observed mean dh/dt between two dates."""

    t1: Optional[torch.Tensor] = None
    t2: Optional[torch.Tensor] = None
    dhdt: Optional[torch.Tensor] = None     # (nx, ny) [m/yr]


@dataclass(frozen=True)
class Glacier:
    """A 2-D glacier, or a stacked batch of them (leading glacier axis).

    Grids are laid out ``(nx, ny)`` with x first. ``dx``/``dy`` are
    per-glacier scalars, so a batch may mix resolutions. ``glacier_ids``
    holds, for a batch gathered from a larger one, each glacier's index in
    the original batch, which selects its entries of per-glacier θ; None
    means 0 … n_g − 1. ``row_shard`` is set on a rank's block of grid rows
    (``parallel.spatial.RowShard``): its grids are then the own rows.
    """

    H0: Optional[torch.Tensor] = None           # (nx, ny) initial thickness [m]
    B: Optional[torch.Tensor] = None            # (nx, ny) bedrock elevation [m]
    dx: Optional[torch.Tensor] = None           # () grid spacing x [m]
    dy: Optional[torch.Tensor] = None           # () grid spacing y [m]
    A: Optional[torch.Tensor] = None            # () default creep coefficient
    C: Optional[torch.Tensor] = None            # () default sliding coefficient
    n: Optional[torch.Tensor] = None            # () default Glen exponent
    mask: Optional[torch.Tensor] = None         # (nx, ny) 1 inside the unpadded domain
    coords_x: Optional[torch.Tensor] = None     # (nx,) cell-center x [m]
    coords_y: Optional[torch.Tensor] = None     # (ny,) cell-center y [m]
    climate: Any = None                         # DummyClimate2D | Climate2D
    thickness_data: Optional[ThicknessData] = None
    velocity_data: Optional[SurfaceVelocityData] = None
    dhdt_data: Optional[DhdtData] = None
    npix: Optional[torch.Tensor] = None         # () pre-padding nx·ny
    glacier_ids: Optional[torch.Tensor] = None  # (n_g,) rows of θ's per-glacier entries
    rgi_id: Any = "synthetic"
    row_shard: Any = None                       # parallel.spatial.RowShard, or None

    @property
    def nx(self) -> int:
        return self.H0.shape[-2]

    @property
    def ny(self) -> int:
        return self.H0.shape[-1]

    @property
    def is_batched(self) -> bool:
        return self.H0.ndim == 3

    @property
    def S(self) -> torch.Tensor:
        """Surface elevation B + H₀."""
        return self.B + self.H0

    def replace(self, **kw) -> "Glacier":
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype: Optional[torch.dtype] = None) -> "Glacier":
        """Move every tensor to ``device`` and cast floating tensors to
        ``dtype`` (each left as it is when None)."""
        def conv(a):
            if dtype is not None and a.is_floating_point():
                a = a.to(dtype)
            return a if device is None else a.to(device)

        return map_tensors(self, conv)


def per_glacier_column(glacier: Glacier, x):
    """One value per glacier of a stacked batch, a (n_g,) tensor, as a
    (n_g, 1, 1) column that broadcasts against the batch's grids; anything
    else (a single glacier's value, a number, a grid) is returned as is."""
    if glacier.is_batched and isinstance(x, torch.Tensor) and x.ndim == 1:
        return x.reshape(-1, 1, 1)
    return x


def _pad_edge(a: torch.Tensor, px: int, py: int) -> torch.Tensor:
    """Edge-replicate the last two axes by (px, py) cells at the far end."""
    if px:
        a = torch.cat([a, a[..., -1:, :].expand(*a.shape[:-2], px, a.shape[-1])], dim=-2)
    if py:
        a = torch.cat([a, a[..., :, -1:].expand(*a.shape[:-1], py)], dim=-1)
    return a


def _pad_zero(a: torch.Tensor, px: int, py: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, py, 0, px))


def pad_glacier(g: Glacier, nx: int, ny: int) -> Glacier:
    """Zero-dynamics pad a glacier to grid (nx, ny): padding cells get H₀ = 0,
    edge-replicated bedrock and mask = 0, so the RHS is zero there and the
    padded solve equals the unpadded one on the interior."""
    px, py = nx - g.nx, ny - g.ny
    if px < 0 or py < 0:
        raise ValueError(f"target grid ({nx},{ny}) smaller than glacier ({g.nx},{g.ny})")
    if px == 0 and py == 0:
        return g

    def pad_series(a):
        return None if a is None else _pad_zero(a, px, py)

    mask = _pad_zero(g.mask if g.mask is not None else torch.ones_like(g.H0), px, py)
    td = g.thickness_data
    if td is not None:
        td = ThicknessData(t=td.t, H=pad_series(td.H))
    vd = g.velocity_data
    if vd is not None:
        vd = dataclasses.replace(vd, vx=pad_series(vd.vx), vy=pad_series(vd.vy),
                                 vabs=pad_series(vd.vabs))
    dd = g.dhdt_data
    if dd is not None:
        dd = dataclasses.replace(dd, dhdt=_pad_zero(dd.dhdt, px, py))
    clim = g.climate
    if clim is not None and getattr(clim, "longterm_temps_gridded", None) is not None:
        clim = dataclasses.replace(
            clim, longterm_temps_gridded=_pad_edge(clim.longterm_temps_gridded, px, py))

    def pad_coords(c, k):
        return None if c is None else torch.cat([c, c[-1:].expand(k)])

    return g.replace(
        H0=_pad_zero(g.H0, px, py),
        B=_pad_edge(g.B, px, py),
        mask=mask,
        coords_x=pad_coords(g.coords_x, px),
        coords_y=pad_coords(g.coords_y, py),
        climate=clim,
        thickness_data=td,
        velocity_data=vd,
        dhdt_data=dd,
    )


def _stack(objs):
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(objs)
    if dataclasses.is_dataclass(first):
        if any(type(o) is not type(first) for o in objs):
            raise ValueError("cannot stack glaciers with different container types")
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(o, f.name) for o in objs])
            for f in dataclasses.fields(first) if f.init
        })
    if any(o != first for o in objs):
        raise ValueError(f"static fields differ across the batch: {objs!r}")
    return first


def stack_glaciers(glaciers: Sequence[Glacier], device=None) -> Glacier:
    """Stack glaciers into one batch with a leading glacier axis, padded to
    the largest (nx, ny) of the set, on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    nx = max(g.nx for g in glaciers)
    ny = max(g.ny for g in glaciers)
    rgi_ids = tuple(g.rgi_id for g in glaciers)
    padded = []
    for g in glaciers:
        # loss normalization keeps the ORIGINAL pixel count
        npix = g.npix if g.npix is not None else torch.tensor(
            float(g.nx * g.ny), dtype=torch.float64)
        gp = pad_glacier(g, nx, ny).replace(rgi_id=rgi_ids, npix=npix)
        if gp.mask is None:
            raise ValueError("glacier missing mask")
        padded.append(gp.to(dev))
    return _stack(padded)


def loss_normalization(glacier: Glacier) -> torch.Tensor:
    """Per-glacier loss normalization: the pre-padding pixel count when known,
    else nx·ny of the grid."""
    if glacier.npix is not None:
        return glacier.npix.to(torch.float64)
    return torch.tensor(float(glacier.H0.shape[-2] * glacier.H0.shape[-1]),
                        dtype=torch.float64, device=glacier.H0.device)


def is_in_glacier(H: torch.Tensor, distance: int) -> torch.Tensor:
    """Mask of cells at least ``distance`` pixels inside the glacier margin:
    the H > 0 mask eroded by a (2·distance+1)² minimum, with cells beyond
    the grid's edge counting as inside. Leading axes are a batch."""
    if distance <= 0:
        return H > 0.0
    inside = (H > 0.0).to(H.dtype)
    flat = inside.reshape(-1, 1, *H.shape[-2:])
    padded = torch.nn.functional.pad(flat, (distance,) * 4, value=1.0)
    eroded = -torch.nn.functional.max_pool2d(-padded, 2 * distance + 1, stride=1)
    return eroded.reshape(H.shape) > 0.5
