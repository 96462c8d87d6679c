"""Glacier data: RGI-style preprocessed rasters onto the device.

Two on-disk layouts, the JAX package's (``odinn_tpu.data.rgi``), so either
package reads what the other wrote:

1. **OGGM glacier directories**: ``<prepro_dir>/<rgi_id>/gridded_data.nc``
   (and ``climate_historical.nc``), read through
   :mod:`odinn_tpu_torch.data.netcdf`, which needs ``h5py``; a bare
   ``<rgi_id>.nc`` is read as gridded data.
2. **One ``.npz`` per glacier** (:func:`write_glacier_npz` writes it), read
   with numpy alone::

    <prepro_dir>/<rgi_id>.npz with arrays:
      H0 (nx, ny)        initial ice thickness [m]
      B  (nx, ny)        bedrock elevation [m]
      dx, dy ()          grid spacing [m]
      coords_x (nx,), coords_y (ny,)
      longterm_temp ()   mean long-term air temperature [°C]
      temp (n_months,), gradient (n_months,), snow (n_months,)   monthly series
      ref_hgt (), t_start ()
      optional: A (), C (), n ()

:func:`initialize_glaciers` coarsens each glacier by
``params.simulation.grid_scaling_factor`` (block means), attaches velocity
datacubes (regridding a cube on its own grid onto the glacier), all in
float64 on ``device`` (None: the CUDA card), and casts to ``dtype`` at the
end. The containers are made by
:func:`odinn_tpu_torch.convert.glacier_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from odinn_tpu_torch.convert import glacier_from_numpy, to_numpy
from odinn_tpu_torch.core.device import resolve_device
from odinn_tpu_torch.core.glacier import (
    Glacier, SurfaceVelocityData, map_tensors, regrid_velocity_data)

__all__ = [
    "get_rgi_paths",
    "initialize_glaciers",
    "write_glacier_npz",
    "fake_multi_datacube",
    "generate_synthetic_rgi_dir",
    "generate_synthetic_oggm_dir",
]

_PREPRO_ENV = "ODINN_TPU_PREPRO_DIR"


def get_rgi_paths(prepro_dir: Optional[str] = None) -> Dict[str, str]:
    """rgi_id → file path under the preprocessing directory (``prepro_dir``,
    else ``$ODINN_TPU_PREPRO_DIR``, else ``./data/prepro``)."""
    root = prepro_dir or os.environ.get(_PREPRO_ENV, os.path.join(os.getcwd(), "data", "prepro"))
    if not os.path.isdir(root):
        return {}
    paths: Dict[str, str] = {}
    for f in sorted(os.listdir(root)):
        full = os.path.join(root, f)
        if f.endswith((".npz", ".nc")):
            paths[os.path.splitext(f)[0]] = full
        elif os.path.isdir(full) and os.path.exists(os.path.join(full, "gridded_data.nc")):
            paths[f] = os.path.join(full, "gridded_data.nc")
    return paths


def _downscale(a, k: int):
    """Block means of k × k cells over the last two axes (numpy or torch),
    the remainder rows and columns dropped."""
    if k <= 1:
        return a
    nx, ny = (a.shape[-2] // k) * k, (a.shape[-1] // k) * k
    blocks = a[..., :nx, :ny].reshape(*a.shape[:-2], nx // k, k, ny // k, k)
    if isinstance(a, torch.Tensor):
        return blocks.mean(dim=(-3, -1))
    return blocks.mean(axis=(-3, -1))


def _down1d(v, k: int):
    """Means of k consecutive coordinates (numpy or torch)."""
    if v is None or k <= 1:
        return v
    m = (v.shape[0] // k) * k
    return v[:m].reshape(-1, k).mean(-1)


def _attach_velocity(g: Glacier, vd) -> Glacier:
    """Attach a velocity datacube, a path (read through the NetCDF layer)
    or a container, on the glacier's device in its dtype; a cube on its
    own grid is regridded onto the glacier there."""
    dev, dtype = g.H0.device, g.H0.dtype
    if isinstance(vd, str):
        from odinn_tpu_torch.data.netcdf import load_velocity_nc

        vd = load_velocity_nc(vd, device=dev, dtype=dtype)
    else:
        vd = map_tensors(vd, lambda a: a.to(device=dev, dtype=dtype))
    return g.replace(velocity_data=regrid_velocity_data(vd, g))


def _downscale_glacier(g: Glacier, k: int) -> Glacier:
    """Coarsen a loaded glacier by ``k``: block means of the rasters, means
    of k coordinates, dx and dy times k, the mask where more than half a
    block is inside. Every grid-aligned attachment is coarsened with it
    (gridded long-term temperatures, thickness, velocity and dh/dt
    observations), so losses and gridded-temperature laws keep their
    shapes; an unaligned velocity cube raises (regrid it first)."""
    if k <= 1:
        return g
    clim = g.climate
    if clim is not None and getattr(clim, "longterm_temps_gridded", None) is not None:
        clim = dataclasses.replace(
            clim, longterm_temps_gridded=_downscale(clim.longterm_temps_gridded, k))
    td = g.thickness_data
    if td is not None and td.H is not None:
        td = dataclasses.replace(td, H=_downscale(td.H, k))
    vd = g.velocity_data
    if vd is not None and vd.vx is not None:
        if not vd.is_grid_glacier_aligned:
            raise ValueError(
                "grid_scaling_factor > 1 with an unaligned velocity datacube: "
                "regrid onto the glacier first (core.glacier.regrid_velocity_data)"
            )
        vd = dataclasses.replace(
            vd, vx=_downscale(vd.vx, k), vy=_downscale(vd.vy, k),
            vabs=None if vd.vabs is None else _downscale(vd.vabs, k),
            x=_down1d(vd.x, k), y=_down1d(vd.y, k))
    dd = g.dhdt_data
    if dd is not None and dd.dhdt is not None:
        dd = dataclasses.replace(dd, dhdt=_downscale(dd.dhdt, k))
    return g.replace(
        H0=_downscale(g.H0, k),
        B=_downscale(g.B, k),
        mask=(_downscale(g.mask, k) > 0.5).to(g.H0.dtype),
        dx=g.dx * k,
        dy=g.dy * k,
        coords_x=_down1d(g.coords_x, k),
        coords_y=_down1d(g.coords_y, k),
        climate=clim,
        thickness_data=td,
        velocity_data=vd,
        dhdt_data=dd,
    )


def _load_npz(path: str, rid: str, k: int, dev) -> Glacier:
    """One ``.npz`` glacier, coarsened by ``k``, in float64 on ``dev``."""
    with np.load(path) as z:
        H0 = _downscale(z["H0"], k)
        nx, ny = H0.shape
        dx, dy = float(z["dx"]) * k, float(z["dy"]) * k
        longterm = float(z["longterm_temp"])
        climate = {"longterm_temps_scalar": np.float64(longterm),
                   "longterm_temps_gridded": np.full((nx, ny), longterm)}
        if "temp" in z.files:
            climate.update(t_start=np.float64(z["t_start"]), temp=z["temp"],
                           gradient=z["gradient"], snow=z["snow"],
                           ref_hgt=np.float64(z["ref_hgt"]))
        fields = {
            "H0": H0,
            "B": _downscale(z["B"], k),
            "dx": np.float64(dx),
            "dy": np.float64(dy),
            "A": np.float64(z["A"] if "A" in z.files else 4e-17),
            "C": np.float64(z["C"] if "C" in z.files else 0.0),
            "n": np.float64(z["n"] if "n" in z.files else 3.0),
            "mask": np.ones_like(H0),
            "coords_x": _down1d(z["coords_x"], k) if "coords_x" in z.files
            else np.arange(nx) * dx,
            "coords_y": _down1d(z["coords_y"], k) if "coords_y" in z.files
            else np.arange(ny) * dy,
            "climate": climate,
        }
    return glacier_from_numpy(fields, rid, device=dev, dtype=torch.float64)


def initialize_glaciers(
    rgi_ids: Sequence[str], params, prepro_dir: Optional[str] = None,
    velocity_datacubes=None, device=None, dtype: torch.dtype = torch.float64,
) -> List[Glacier]:
    """Load glaciers from preprocessed files onto ``device`` (None: the
    CUDA card) in ``dtype``. The paths come from ``prepro_dir`` when given,
    else ``params.simulation.rgi_paths`` (a dict from :func:`get_rgi_paths`
    or a directory), else ``$ODINN_TPU_PREPRO_DIR``.
    ``velocity_datacubes`` maps rgi_id → a cube (a ``.nc`` path or a
    :class:`SurfaceVelocityData`), attached after the coarsening. Loading,
    coarsening and regridding run in float64 on the device; the cast to
    ``dtype`` comes last."""
    dev = resolve_device(device)
    rp = getattr(params.simulation, "rgi_paths", None)
    if prepro_dir is None and rp is not None:
        paths = dict(rp) if isinstance(rp, dict) else get_rgi_paths(str(rp))
    else:
        paths = get_rgi_paths(prepro_dir)
    k = params.simulation.grid_scaling_factor
    out = []
    for rid in rgi_ids:
        if rid not in paths:
            raise FileNotFoundError(
                f"no preprocessed file for {rid}; set ${_PREPRO_ENV} or write the "
                "preprocessed files (write_glacier_npz / netcdf.write_glacier_nc)"
            )
        if paths[rid].endswith(".nc"):
            from odinn_tpu_torch.data.netcdf import load_glacier_nc

            climate_path = os.path.join(os.path.dirname(paths[rid]), "climate_historical.nc")
            g = load_glacier_nc(paths[rid], climate_path=climate_path, rgi_id=rid,
                                device=dev, dtype=torch.float64)
            g = _downscale_glacier(g, k)
        else:
            g = _load_npz(paths[rid], rid, k, dev)
        if velocity_datacubes is not None and rid in velocity_datacubes:
            g = _attach_velocity(g, velocity_datacubes[rid])
        out.append(g.to(dtype=dtype))
    return out


def write_glacier_npz(path: str, glacier: Glacier, longterm_temp: float) -> None:
    """Write one glacier in the ``.npz`` layout (see the module doc)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {name: to_numpy(getattr(glacier, name))
               for name in ("H0", "B", "dx", "dy", "coords_x", "coords_y", "A", "C", "n")}
    payload["longterm_temp"] = np.asarray(longterm_temp)
    clim = glacier.climate
    if getattr(clim, "temp", None) is not None:
        payload.update({name: to_numpy(getattr(clim, name))
                        for name in ("temp", "gradient", "snow", "ref_hgt", "t_start")})
    np.savez_compressed(path, **payload)


def _synthetic_glaciers(n: int, nx: int, ny: int, seed: int, region: str):
    """The synthetic dataset's glaciers: Halfar domes of random dx over
    random long-term temperatures, each with 6 years of monthly climate
    from 2010, drawn from numpy's ``default_rng(seed)`` as the JAX
    package draws them; on the CPU in float64."""
    from odinn_tpu_torch.data.synthetic import halfar_glacier, monthly_dummy_climate

    rng = np.random.default_rng(seed)
    for i in range(n):
        temp = float(rng.uniform(-25.0, -12.0))
        clim = monthly_dummy_climate(2010.0, 72, longterm_temp=temp, nx=nx, ny=ny,
                                     device="cpu")
        yield temp, halfar_glacier(nx=nx, ny=ny, dx=float(rng.uniform(80, 150)), temp=temp,
                                   climate=clim, rgi_id=f"RGI60-{region}.{i:05d}",
                                   device="cpu")


def generate_synthetic_rgi_dir(dirpath: str, n: int = 4, nx: int = 64, ny: int = 64,
                               seed: int = 0) -> List[str]:
    """Write a synthetic preprocessed dataset of ``.npz`` glaciers; returns
    their rgi_ids."""
    ids = []
    for temp, g in _synthetic_glaciers(n, nx, ny, seed, "99"):
        write_glacier_npz(os.path.join(dirpath, f"{g.rgi_id}.npz"), g, temp)
        ids.append(g.rgi_id)
    return ids


def generate_synthetic_oggm_dir(dirpath: str, n: int = 2, nx: int = 64, ny: int = 64,
                                seed: int = 0) -> List[str]:
    """Write a synthetic preprocessed dataset in the OGGM glacier-directory
    layout (needs ``h5py``); returns the rgi_ids."""
    from odinn_tpu_torch.data.netcdf import write_glacier_nc

    ids = []
    for temp, g in _synthetic_glaciers(n, nx, ny, seed, "11"):
        write_glacier_nc(dirpath, g, temp)
        ids.append(g.rgi_id)
    return ids


def fake_multi_datacube(glacier: Glacier, tstops, noise: float = 0.0, seed: int = 0):
    """A surface-velocity datacube made from the glacier's own diagnostic
    velocity (its default A, C, n), one frame per tstop, on the glacier's
    device; with ``noise`` > 0, normal noise of that scale is added to vx,
    drawn in float64 on the host from a ``torch.Generator`` seeded
    ``seed``."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.physics.sia2d import ValuesFn, default_values, v_from_h
    from odinn_tpu_torch.physics.targets import ATarget

    vx, vy, v = v_from_h(glacier.H0, glacier.B, glacier.dx, glacier.dy,
                         ValuesFn(default_values(glacier)), ATarget(), PhysicalParameters())
    tstops = torch.as_tensor(tstops, device=glacier.H0.device)
    reps = tstops.shape[0]
    vx, vy, v = (a.unsqueeze(0).repeat(reps, 1, 1) for a in (vx, vy, v))
    if noise > 0:
        gen = torch.Generator().manual_seed(seed)
        draw = torch.randn(vx.shape, generator=gen, dtype=torch.float64)
        vx = vx + noise * draw.to(device=vx.device, dtype=vx.dtype)
    return SurfaceVelocityData(t=tstops, vx=vx, vy=vy, vabs=v)
