"""NetCDF-4 I/O through ``h5py``, and OGGM/Gungnir glacier directories.

NetCDF-4 files are HDF5 files, so a small ``h5py`` reader and writer cover
the real-data workflow with no netCDF4/xarray stack:

- :func:`read_netcdf` / :func:`write_netcdf`: generic NetCDF-4 access
  (dimension scales, ``_FillValue``, ``scale_factor``/``add_offset`` CF
  unpacking, global and per-variable attributes);
- :func:`load_glacier_nc`: an OGGM ``gridded_data.nc`` (surface DEM
  ``topo``, a thickness product, ``glacier_mask``, Millan velocity mosaics,
  Hugonnet dh/dt) plus ``climate_historical.nc`` (monthly temperature,
  lapse rate and precipitation at ``ref_hgt``) → a :class:`Glacier`;
- :func:`write_glacier_nc`, :func:`load_velocity_nc`,
  :func:`write_velocity_nc`: the producer side and the velocity datacubes.

The on-disk format is the JAX package's (``odinn_tpu.data.netcdf``), so a
file written by either package reads in the other. Arrays are read in
float64; the containers are made by
:func:`odinn_tpu_torch.convert.glacier_from_numpy` on ``device`` (None:
the CUDA card) in ``dtype``.

Axis convention: NetCDF rasters are stored ``(y, x)`` (CF order); glacier
grids are ``(nx, ny)`` with x first, so rasters are transposed on the way
in and out.

``h5py`` is imported inside the functions that read or write a file: a
machine without it can import this module, and loads ``.npz`` glaciers
(:mod:`odinn_tpu_torch.data.rgi`) without it.
"""

from __future__ import annotations

import datetime as _dt
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from odinn_tpu_torch.convert import glacier_from_numpy, to_numpy
from odinn_tpu_torch.utils.time_utils import datetime_to_floatyear

__all__ = [
    "read_netcdf",
    "write_netcdf",
    "load_glacier_nc",
    "write_glacier_nc",
    "load_velocity_nc",
    "write_velocity_nc",
    "parse_cf_time",
]

# OGGM gridded_data.nc thickness products, in preference order
_THICKNESS_VARS = (
    "consensus_ice_thickness",
    "millan_ice_thickness",
    "distributed_thickness",
    "thickness",
)


def _unpack(ds) -> np.ndarray:
    """CF-unpack one HDF5 dataset: fill values → NaN, scale/offset applied."""
    a = np.asarray(ds[()])
    attrs = ds.attrs
    if a.dtype.kind in "fiu":
        fill = attrs.get("_FillValue", attrs.get("missing_value", None))
        if fill is not None and a.dtype.kind == "f":
            a = np.where(np.isclose(a, np.asarray(fill, a.dtype)), np.nan, a)
        scale = attrs.get("scale_factor", None)
        offset = attrs.get("add_offset", None)
        if scale is not None or offset is not None:
            a = a.astype(np.float64)
            if scale is not None:
                a = a * float(np.asarray(scale).ravel()[0])
            if offset is not None:
                a = a + float(np.asarray(offset).ravel()[0])
    return a


def _np(x) -> np.ndarray:
    return to_numpy(x).astype(np.float64)


def _attr_to_py(v) -> Any:
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        if v.size == 1:
            return _attr_to_py(v.ravel()[0])
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def read_netcdf(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict[str, Any]],
                                    Dict[str, Any]]:
    """Read a NetCDF-4 (HDF5) file: ``(variables, var_attrs, global_attrs)``.

    Pure dimension scales that carry no data (netCDF's "dimension without
    variable") are skipped."""
    import h5py

    variables: Dict[str, np.ndarray] = {}
    var_attrs: Dict[str, Dict[str, Any]] = {}
    with h5py.File(path, "r") as f:
        global_attrs = {k: _attr_to_py(v) for k, v in f.attrs.items()}

        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            nm = obj.attrs.get("NAME", b"")
            if isinstance(nm, bytes) and nm.startswith(b"This is a netCDF dimension"):
                return
            key = name.split("/")[-1]
            variables[key] = _unpack(obj)
            var_attrs[key] = {
                k: _attr_to_py(v)
                for k, v in obj.attrs.items()
                if not k.startswith(("_Netcdf4", "CLASS", "NAME", "DIMENSION_LIST",
                                     "REFERENCE_LIST"))
            }

        f.visititems(visit)
    return variables, var_attrs, global_attrs


def write_netcdf(
    path: str,
    variables: Dict[str, Tuple[Tuple[str, ...], np.ndarray]],
    coords: Dict[str, np.ndarray],
    var_attrs: Optional[Dict[str, Dict[str, Any]]] = None,
    global_attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a NetCDF-4-compatible HDF5 file. ``variables`` maps name →
    (dim names, array); ``coords`` maps dim name → coordinate array, stored
    as an HDF5 dimension scale (netCDF-4's encoding of a coordinate)."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    var_attrs = var_attrs or {}
    with h5py.File(path, "w") as f:
        for k, v in (global_attrs or {}).items():
            f.attrs[k] = v
        scales = {}
        for dim, cvals in coords.items():
            d = f.create_dataset(dim, data=np.asarray(cvals))
            d.make_scale(dim)
            scales[dim] = d
            for k, v in var_attrs.get(dim, {}).items():
                d.attrs[k] = v
        for name, (dims, arr) in variables.items():
            if name in scales:
                continue
            d = f.create_dataset(name, data=np.asarray(arr))
            for ax, dim in enumerate(dims):
                if dim in scales:
                    d.dims[ax].attach_scale(scales[dim])
            for k, v in var_attrs.get(name, {}).items():
                d.attrs[k] = v


_CF_TIME_RE = re.compile(
    r"^\s*(day|hour|minute|second|month|year)s?\s+since\s+"
    r"(\d{1,4})-(\d{1,2})-(\d{1,2})", re.IGNORECASE,
)


def parse_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    """CF time values and units → float years: "days/hours/minutes/seconds
    since Y-M-D" exactly, by datetime arithmetic; "months/years since
    Y-M-D" on the calendar grid."""
    m = _CF_TIME_RE.match(units)
    if m is None:
        raise ValueError(f"unsupported CF time units: {units!r}")
    unit = m.group(1).lower()
    y0, mo0, d0 = int(m.group(2)), int(m.group(3)), int(m.group(4))
    vals = np.asarray(values, np.float64)
    if unit == "year":
        return y0 + (mo0 - 1) / 12.0 + vals
    if unit == "month":
        months = (y0 * 12 + (mo0 - 1)) + vals
        return months / 12.0
    epoch = _dt.datetime(y0, mo0, d0)
    seconds = {"day": 86400.0, "hour": 3600.0, "minute": 60.0, "second": 1.0}[unit] * vals
    return np.asarray(
        [datetime_to_floatyear(epoch + _dt.timedelta(seconds=float(s))) for s in seconds]
    )


def _grid_spacing(c: np.ndarray, name: str) -> float:
    d = np.diff(np.asarray(c, np.float64))
    if d.size == 0:
        raise ValueError(f"coordinate {name!r} has fewer than 2 points")
    mean = float(np.mean(d))
    # tolerate single-precision coordinate storage (~1e-7 relative per value,
    # amplified by differencing); projected OGGM grids are uniform by design
    if not np.allclose(d, mean, rtol=1e-3, atol=1e-3 * abs(mean)):
        raise ValueError(f"coordinate {name!r} is not uniformly spaced")
    return float(abs(mean))


def load_glacier_nc(
    gridded_path: str,
    climate_path: Optional[str] = None,
    rgi_id: Optional[str] = None,
    thickness_var: Optional[str] = None,
    device=None,
    dtype: Optional[torch.dtype] = torch.float64,
):
    """OGGM ``gridded_data.nc`` (and ``climate_historical.nc`` when it
    exists) → a :class:`~odinn_tpu_torch.core.glacier.Glacier` on
    ``device`` (None: the CUDA card) in ``dtype``.

    The bedrock is ``topo − thickness``. Missing pieces fall back as the
    JAX package's loader does: the glacier mask to H > 0, the lapse rate to
    −0.0065 °C/m, solid precipitation to ``prcp``/1000 (mm → m w.e.), the
    long-term temperature to the series mean (the ``longterm_temp``
    attribute wins) or, with no climate file, to the attribute or −15 °C,
    and A, C, n to 4e-17, 0 and 3."""
    vs, va, ga = read_netcdf(gridded_path)

    def raster(name):
        # CF (y, x) → (nx, ny)
        a = np.asarray(vs[name], np.float64)
        return np.nan_to_num(a, nan=0.0).T

    if "topo" not in vs:
        raise ValueError(f"{gridded_path}: no 'topo' DEM variable — not an OGGM gridded_data file")
    S = raster("topo")

    tvar = thickness_var or next((v for v in _THICKNESS_VARS if v in vs), None)
    if tvar is None:
        raise ValueError(
            f"{gridded_path}: no ice-thickness product (looked for {_THICKNESS_VARS})"
        )
    H0 = np.maximum(raster(tvar), 0.0)
    mask = raster("glacier_mask") if "glacier_mask" in vs else (H0 > 0).astype(np.float64)
    H0 = H0 * (mask > 0)
    B = S - H0

    cx = np.asarray(vs.get("x", np.arange(S.shape[0])), np.float64)
    cy = np.asarray(vs.get("y", np.arange(S.shape[1])), np.float64)
    dx = _grid_spacing(cx, "x")
    dy = _grid_spacing(cy, "y")
    nx, ny = H0.shape

    if climate_path is not None and os.path.exists(climate_path):
        cvs, cva, cga = read_netcdf(climate_path)
        t_units = cva.get("time", {}).get("units", "months since 1900-01-01")
        t_years = parse_cf_time(np.asarray(cvs["time"]), str(t_units))
        temp = np.asarray(cvs["temp"], np.float64)
        grad = np.asarray(cvs.get("gradient", np.full_like(temp, -0.0065)), np.float64)
        # OGGM stores total precipitation [kg m-2 == mm w.e.]; the TI model
        # takes m w.e.
        if "snow" in cvs:
            snow = np.asarray(cvs["snow"], np.float64)
        else:
            snow = np.asarray(cvs.get("prcp", np.zeros_like(temp)), np.float64) / 1000.0
        ref_hgt = float(cga.get("ref_hgt", cva.get("temp", {}).get("ref_hgt", 0.0)))
        # the preprocessed long-term temperature (what the T → A laws read);
        # the monthly series' mean only as a fallback
        longterm = float(ga["longterm_temp"]) if "longterm_temp" in ga else float(np.mean(temp))
        climate = {"t_start": np.float64(t_years[0]), "temp": temp, "gradient": grad,
                   "snow": snow, "ref_hgt": np.float64(ref_hgt)}
    else:
        longterm = float(ga.get("longterm_temp", -15.0))
        climate = {}
    climate.update(longterm_temps_scalar=np.float64(longterm),
                   longterm_temps_gridded=np.full((nx, ny), longterm))

    fields: Dict[str, Any] = {
        "H0": H0, "B": B, "dx": np.float64(dx), "dy": np.float64(dy),
        "A": np.float64(ga.get("A", 4e-17)), "C": np.float64(ga.get("C", 0.0)),
        "n": np.float64(ga.get("n", 3.0)), "mask": (mask > 0).astype(np.float64),
        "coords_x": cx, "coords_y": cy, "climate": climate,
    }
    if "millan_vx" in vs and "millan_vy" in vs:
        vx = raster("millan_vx")[None]
        vy = raster("millan_vy")[None]
        vabs = raster("millan_v")[None] if "millan_v" in vs else np.sqrt(vx**2 + vy**2)
        # Millan et al. 2022 mosaics are nominally 2017-2018 composites
        fields["velocity_data"] = {"t": np.asarray([float(ga.get("millan_date", 2017.5))]),
                                   "vx": vx, "vy": vy, "vabs": vabs}
    if "hugonnet_dhdt" in vs:
        fields["dhdt_data"] = {"t1": np.float64(ga.get("hugonnet_t1", 2000.0)),
                               "t2": np.float64(ga.get("hugonnet_t2", 2020.0)),
                               "dhdt": raster("hugonnet_dhdt")}
    rid = rgi_id or str(ga.get("rgi_id", os.path.basename(os.path.dirname(gridded_path))
                               or "unknown"))
    return glacier_from_numpy(fields, rid, device=device, dtype=dtype)


def write_glacier_nc(dirpath: str, glacier, longterm_temp: float) -> str:
    """Write an OGGM-layout glacier directory (``gridded_data.nc`` and,
    with a monthly climate, ``climate_historical.nc``) from one glacier;
    returns the directory."""
    gdir = os.path.join(dirpath, glacier.rgi_id)
    os.makedirs(gdir, exist_ok=True)
    H0, B, mask = _np(glacier.H0), _np(glacier.B), _np(glacier.mask)
    write_netcdf(
        os.path.join(gdir, "gridded_data.nc"),
        variables={
            "topo": (("y", "x"), (B + H0).T),          # (nx, ny) → CF (y, x)
            "consensus_ice_thickness": (("y", "x"), H0.T),
            "glacier_mask": (("y", "x"), mask.T),
        },
        coords={"x": _np(glacier.coords_x), "y": _np(glacier.coords_y)},
        var_attrs={
            "topo": {"units": "m", "long_name": "DEM topography"},
            "consensus_ice_thickness": {"units": "m"},
            "x": {"units": "m"}, "y": {"units": "m"},
        },
        global_attrs={
            "rgi_id": glacier.rgi_id,
            "longterm_temp": float(longterm_temp),
            "A": float(glacier.A), "C": float(glacier.C), "n": float(glacier.n),
        },
    )
    clim = glacier.climate
    if getattr(clim, "temp", None) is not None:
        t0 = float(clim.t_start)
        temp = _np(clim.temp)
        write_netcdf(
            os.path.join(gdir, "climate_historical.nc"),
            variables={
                "temp": (("time",), temp),
                "gradient": (("time",), _np(clim.gradient)),
                "prcp": (("time",), _np(clim.snow) * 1000.0),
            },
            coords={"time": np.arange(temp.shape[-1], dtype=np.float64)},
            var_attrs={
                # total-months divmod: month arithmetic on int(t0) gives
                # month 13 for t0 fractions >= 23/24 (an invalid CF epoch)
                "time": {
                    "units": "months since {}-{:02d}-01".format(
                        int(round(t0 * 12)) // 12, int(round(t0 * 12)) % 12 + 1),
                    "calendar": "standard",
                },
                "temp": {"units": "degC"},
                "prcp": {"units": "kg m-2"},
            },
            global_attrs={"ref_hgt": float(clim.ref_hgt)},
        )
    return gdir


def load_velocity_nc(path: str, device=None, dtype: Optional[torch.dtype] = torch.float64):
    """A velocity datacube ``.nc`` → a
    :class:`~odinn_tpu_torch.core.glacier.SurfaceVelocityData` on
    ``device`` (None: the CUDA card) in ``dtype``.

    The cube holds ``vx``/``vy`` (and optionally ``v``) with dims
    (time, y, x), a CF ``time`` coordinate (each product's mid-date),
    optional ``date1``/``date2`` interval bounds and ``x``/``y`` projected
    coordinates. A cube on its own grid (``is_grid_glacier_aligned`` false)
    is regridded onto a glacier by
    :func:`odinn_tpu_torch.core.glacier.regrid_velocity_data`."""
    vs, va, ga = read_netcdf(path)
    if "vx" not in vs or "vy" not in vs:
        raise ValueError(f"{path}: velocity cube needs 'vx' and 'vy' variables")

    def cube(name):
        a = np.asarray(vs[name], np.float64)
        return np.nan_to_num(a, nan=0.0).transpose(0, 2, 1)   # (t, y, x) → (t, x, y)

    vx, vy = cube("vx"), cube("vy")
    t_units = str(va.get("time", {}).get("units", "years since 0-01-01"))

    def times(name):
        return parse_cf_time(np.asarray(vs[name]), t_units) if name in vs else None

    cube_fields = {
        "t": times("time"), "vx": vx, "vy": vy,
        "vabs": cube("v") if "v" in vs else np.sqrt(vx**2 + vy**2),
        "x": np.asarray(vs["x"], np.float64) if "x" in vs else None,
        "y": np.asarray(vs["y"], np.float64) if "y" in vs else None,
        "date1": times("date1"), "date2": times("date2"),
        "is_grid_glacier_aligned": bool(ga.get("is_grid_glacier_aligned", False)),
    }
    return glacier_from_numpy({"velocity_data": cube_fields}, None, device=device,
                              dtype=dtype).velocity_data


def write_velocity_nc(path: str, vd, t_units: str = "years since 0-01-01") -> None:
    """Write a velocity datacube in the layout :func:`load_velocity_nc`
    reads."""
    def frames(a):
        return _np(a).transpose(0, 2, 1)

    variables = {"vx": (("time", "y", "x"), frames(vd.vx)),
                 "vy": (("time", "y", "x"), frames(vd.vy))}
    if vd.vabs is not None:
        variables["v"] = (("time", "y", "x"), frames(vd.vabs))
    coords = {"time": _np(vd.t)}
    if vd.x is not None:
        coords["x"] = _np(vd.x)
        coords["y"] = _np(vd.y)
    write_netcdf(
        path, variables=variables, coords=coords,
        var_attrs={"time": {"units": t_units}, "vx": {"units": "m yr-1"},
                   "vy": {"units": "m yr-1"}},
        global_attrs={"is_grid_glacier_aligned": int(bool(vd.is_grid_glacier_aligned))},
    )
