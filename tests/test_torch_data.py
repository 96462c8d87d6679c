"""odinn_tpu_torch's data layer against odinn_tpu: the time utilities, the
NetCDF-4 reader and writer (each package reading the other's files), the
preprocessed-directory loader with its coarsening and velocity cubes, and
the bilinear regrid. Float64 on the CPU; tolerances per test.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import (
    DhdtData as JDhdt, SurfaceVelocityData as JVel, ThicknessData as JThick,
    regrid_velocity_data as j_regrid)
from odinn_tpu.data import netcdf as jnc, rgi as jrgi
from odinn_tpu_torch.core.glacier import SurfaceVelocityData, regrid_velocity_data
from odinn_tpu_torch.data import netcdf as tnc, rgi as trgi
from odinn_tpu_torch.utils import time_utils as tt
from tests.torch_parity import CPU, assert_rel, carry_glacier, np64

TSPAN = (2010.0, 2012.0)


def _params(P, k=1):
    return P.Parameters(simulation=P.SimulationParameters(grid_scaling_factor=k, tspan=TSPAN))


def _fields(obj, prefix=""):
    """Every array field of a (nested) container of either package, by
    dotted name, as float64 numpy; static and None fields left out."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or f.name in ("rgi_id", "glacier_ids", "npix") or isinstance(v, (bool, str)):
            continue
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = np64(v)
    return out


def _assert_same_glacier(port, jax_g, rtol, what=""):
    pf, jf = _fields(port), _fields(jax_g)
    assert set(pf) == set(jf), (what, sorted(set(pf) ^ set(jf)))
    assert type(port.climate).__name__ == type(jax_g.climate).__name__
    assert port.rgi_id == jax_g.rgi_id
    for k in jf:
        if np.abs(jf[k]).max() == 0.0:
            assert np.array_equal(pf[k], jf[k]), (what, k)
        else:
            assert_rel(pf[k], jf[k], rtol, f"{what} {k}")
    vd_p, vd_j = port.velocity_data, jax_g.velocity_data
    if vd_j is not None:
        assert vd_p.is_grid_glacier_aligned == vd_j.is_grid_glacier_aligned


# ---------------------------------------------------------------------------
# time_utils
# ---------------------------------------------------------------------------

def test_time_utils_match_jax():
    """tests/test_features.py::test_time_utils's values, exactly."""
    from odinn_tpu.utils import time_utils as jt

    for dt in (datetime.datetime(2015, 7, 2), datetime.datetime(2000, 12, 31, 23),
               datetime.datetime(2016, 2, 29, 12, 30)):
        t = tt.datetime_to_floatyear(dt)
        assert t == jt.datetime_to_floatyear(dt)
        assert tt.floatyear_to_datetime(t) == jt.floatyear_to_datetime(t)
        assert tt.partial_year(t) == jt.partial_year(t)
    t = tt.datetime_to_floatyear(datetime.datetime(2015, 7, 2))
    assert 2015.45 < t < 2015.55
    back = tt.floatyear_to_datetime(t)
    assert back.year == 2015 and back.month == 7
    ts = [0.0, 0.5, 1.0, 1.0]
    for q in (0.5, 0.3, 0.75, 1.0, -2.0):
        assert int(tt.ind_from_t(torch.tensor(ts), q)) == int(jt.ind_from_t(jnp.asarray(ts), q))
        assert bool(tt.stop_condition_tstops(q, torch.tensor(ts))) == bool(
            jt.stop_condition_tstops(q, jnp.asarray(ts)))
    assert bool(tt.stop_condition_tstops(0.5, torch.tensor(ts)))
    assert not bool(tt.stop_condition_tstops(0.3, torch.tensor(ts)))
    t_obs = np.array([2009.5, 2010.0, 2011.25, 2012.0 + 1e-10, 2013.0])
    np.testing.assert_array_equal(tt.t_data(SurfaceVelocityData(t=torch.from_numpy(t_obs)), TSPAN),
                                  jt.t_data(JVel(t=jnp.asarray(t_obs)), TSPAN))


# ---------------------------------------------------------------------------
# netcdf
# ---------------------------------------------------------------------------

def test_oggm_dir_written_by_jax_loads_in_the_port(tmp_path):
    """JAX's synthetic OGGM directory read by the port's loader: every field
    equal to JAX's load_glacier_nc."""
    ids = jrgi.generate_synthetic_oggm_dir(str(tmp_path), n=2, nx=24, ny=32, seed=3)
    for rid in ids:
        grid = str(tmp_path / rid / "gridded_data.nc")
        clim = str(tmp_path / rid / "climate_historical.nc")
        ref = jnc.load_glacier_nc(grid, climate_path=clim)
        out = tnc.load_glacier_nc(grid, climate_path=clim, device=CPU)
        _assert_same_glacier(out, ref, 1e-15, rid)
        assert out.H0.dtype == torch.float64 and out.climate.temp.shape == (72,)
        # no climate file: the dummy climate with the attribute's temperature
        _assert_same_glacier(tnc.load_glacier_nc(grid, device=CPU), jnc.load_glacier_nc(grid),
                             1e-15, rid + " no climate")


def test_port_written_oggm_dir_loads_in_jax(tmp_path):
    """The reverse: the port writes (write_glacier_nc, its synthetic
    generator), the JAX package reads."""
    ids = trgi.generate_synthetic_oggm_dir(str(tmp_path), n=2, nx=24, ny=32, seed=3)
    assert ids == [f"RGI60-11.{i:05d}" for i in range(2)]
    g = trgi.initialize_glaciers(ids[:1], _params(TP), prepro_dir=str(tmp_path), device=CPU)[0]
    for rid in ids:
        grid = str(tmp_path / rid / "gridded_data.nc")
        clim = str(tmp_path / rid / "climate_historical.nc")
        _assert_same_glacier(tnc.load_glacier_nc(grid, climate_path=clim, device=CPU),
                             jnc.load_glacier_nc(grid, climate_path=clim), 1e-15, rid)
    # a glacier with a t_start late in a month (the CF epoch's month arithmetic)
    g = g.replace(climate=dataclasses.replace(g.climate, t_start=torch.tensor(2010.99)),
                  rgi_id="late")
    tnc.write_glacier_nc(str(tmp_path), g, -11.0)
    back = jnc.load_glacier_nc(str(tmp_path / "late" / "gridded_data.nc"),
                               climate_path=str(tmp_path / "late" / "climate_historical.nc"))
    assert float(back.climate.t_start) == 2011.0
    assert_rel(back.H0, g.H0, 1e-15)


def test_cf_packed_file_reads_the_same(tmp_path):
    """_FillValue, scale_factor/add_offset and attributes of every kind, read
    by both packages' read_netcdf."""
    import h5py

    path = str(tmp_path / "packed.nc")
    with h5py.File(path, "w") as f:
        f.attrs["title"] = b"packed"
        f.attrs["vec"] = np.array([1.0, 2.0])
        f.attrs["one"] = np.array([7], np.int32)
        d = f.create_dataset("v", data=np.array([1.0, -9999.0, 3.0]))
        d.attrs["_FillValue"] = -9999.0
        p = f.create_dataset("packed", data=np.array([0, 1, 2], np.int16))
        p.attrs["scale_factor"] = 0.5
        p.attrs["add_offset"] = 10.0
        m = f.create_dataset("missing", data=np.array([5.0, 1e20], np.float32))
        m.attrs["missing_value"] = np.float32(1e20)
    vs, va, ga = tnc.read_netcdf(path)
    jvs, jva, jga = jnc.read_netcdf(path)
    assert ga == jga and va == jva and set(vs) == set(jvs)
    for k in jvs:
        np.testing.assert_array_equal(vs[k], jvs[k])
    assert np.isnan(vs["v"][1]) and vs["v"][0] == 1.0
    np.testing.assert_allclose(vs["packed"], [10.0, 10.5, 11.0])
    assert np.isnan(vs["missing"][1])
    # the generic writer: each package's file read by the other
    x, y = np.linspace(0.0, 900.0, 10), np.linspace(0.0, 450.0, 5)
    field = np.arange(50, dtype=np.float64).reshape(5, 10)
    for w, r in ((tnc, jnc), (jnc, tnc)):
        out = str(tmp_path / f"generic_{w.__name__.split('.')[0]}.nc")
        w.write_netcdf(out, variables={"field": (("y", "x"), field)}, coords={"x": x, "y": y},
                       var_attrs={"field": {"units": "m"}}, global_attrs={"title": "rt"})
        vs, va, ga = r.read_netcdf(out)
        np.testing.assert_array_equal(vs["field"], field)
        np.testing.assert_array_equal(vs["x"], x)
        assert va["field"]["units"] == "m" and ga["title"] == "rt"


@pytest.mark.parametrize("values, units", [
    (np.array([0.0, 365.0, 59.5]), "days since 2000-01-01"),
    (np.array([0.0, 6.0, 12.0, 13.5]), "months since 2010-01-01"),
    (np.array([0.0, 2.5, -1.0]), "years since 1990-07-01"),
    (np.array([24.0, 36.0]), "hours since 1999-12-31"),
    (np.array([90.0]), "minutes since 2001-03-01"),
    (np.array([3600.0]), "seconds since 2001-03-01 00:00:00"),
])
def test_parse_cf_time_matches_jax(values, units):
    np.testing.assert_array_equal(tnc.parse_cf_time(values, units),
                                  jnc.parse_cf_time(values, units))


def test_parse_cf_time_refuses_unknown_units():
    with pytest.raises(ValueError):
        tnc.parse_cf_time(np.array([0.0]), "fortnights since 2000-01-01")


def test_velocity_cube_both_ways(tmp_path):
    """A velocity cube with date bounds: the port writes and JAX reads, JAX
    writes and the port reads, each field equal."""
    rng = np.random.default_rng(4)
    vx = 10.0 + rng.random((2, 7, 9))
    kw = dict(t=np.array([2010.5, 2011.5]), vx=vx, vy=2.0 * vx, vabs=np.sqrt(5.0) * vx,
              x=np.linspace(-300.0, 300.0, 7), y=np.linspace(0.0, 800.0, 9),
              date1=np.array([2010.0, 2011.0]), date2=np.array([2011.0, 2012.0]))
    port_cube = SurfaceVelocityData(**{k: torch.from_numpy(v) for k, v in kw.items()},
                                    is_grid_glacier_aligned=False)
    jax_cube = JVel(**{k: jnp.asarray(v) for k, v in kw.items()}, is_grid_glacier_aligned=False)
    tnc.write_velocity_nc(str(tmp_path / "p.nc"), port_cube)
    jnc.write_velocity_nc(str(tmp_path / "j.nc"), jax_cube)
    for name in ("p.nc", "j.nc"):
        out = tnc.load_velocity_nc(str(tmp_path / name), device=CPU)
        ref = jnc.load_velocity_nc(str(tmp_path / name))
        assert not out.is_grid_glacier_aligned and not ref.is_grid_glacier_aligned
        for f in ("t", "vx", "vy", "vabs", "x", "y"):
            np.testing.assert_array_equal(np64(getattr(out, f)), np64(getattr(ref, f)))
        assert out.date1 is None and ref.date1 is None     # the writers keep no bounds
        np.testing.assert_allclose(np64(out.vx), vx, rtol=1e-15)


# ---------------------------------------------------------------------------
# rgi
# ---------------------------------------------------------------------------

def test_synthetic_rgi_dir_arrays_match_jax(tmp_path):
    ids_j = jrgi.generate_synthetic_rgi_dir(str(tmp_path / "j"), n=2, nx=24, ny=28, seed=1)
    ids_t = trgi.generate_synthetic_rgi_dir(str(tmp_path / "t"), n=2, nx=24, ny=28, seed=1)
    assert ids_t == ids_j
    for rid in ids_j:
        with np.load(tmp_path / "j" / f"{rid}.npz") as zj, \
                np.load(tmp_path / "t" / f"{rid}.npz") as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                assert zt[k].shape == zj[k].shape, k
                assert_rel(zt[k], zj[k], 1e-12, f"{rid} {k}")


def _cubes(ids, glaciers, pkg):
    """One unaligned 2-frame cube per glacier on its own 11 × 13 grid over
    the footprint (its last node on the glacier's last column), in either
    package."""
    rng = np.random.default_rng(7)
    out = {}
    for rid, g in zip(ids, glaciers):
        cx, cy = np64(g.coords_x), np64(g.coords_y)
        kw = dict(t=np.array([2010.5, 2011.5]), vx=rng.random((2, 11, 13)) * 20.0,
                  x=np.linspace(cx[0] + 40.0, cx[-1] + 120.0, 11),
                  y=np.linspace(cy[0] - 60.0, cy[-1], 13))
        kw.update(vy=-kw["vx"], vabs=np.abs(kw["vx"]))
        if pkg == "jax":
            out[rid] = JVel(**{k: jnp.asarray(v) for k, v in kw.items()},
                            is_grid_glacier_aligned=False)
        else:
            out[rid] = SurfaceVelocityData(**{k: torch.from_numpy(v) for k, v in kw.items()},
                                           is_grid_glacier_aligned=False)
    return out


def test_initialize_glaciers_matches_jax(tmp_path):
    """Both layouts at grid_scaling_factor 2, velocity cubes by object (npz)
    and by path (nc), held to JAX's; float32 is the float64 load cast."""
    npz_ids = jrgi.generate_synthetic_rgi_dir(str(tmp_path / "npz"), n=2, nx=40, ny=36, seed=2)
    nc_ids = jrgi.generate_synthetic_oggm_dir(str(tmp_path / "nc"), n=2, nx=40, ny=36, seed=2)
    for layout, ids in (("npz", npz_ids), ("nc", nc_ids)):
        root = str(tmp_path / layout)
        plain = jrgi.initialize_glaciers(ids, _params(JP, 2), prepro_dir=root)
        cubes_j, cubes_t = _cubes(ids, plain, "jax"), _cubes(ids, plain, "torch")
        if layout == "nc":
            for rid in ids:
                path = str(tmp_path / f"{rid}_cube.nc")
                jnc.write_velocity_nc(path, cubes_j[rid])
                cubes_j[rid] = cubes_t[rid] = path
        ref = jrgi.initialize_glaciers(ids, _params(JP, 2), prepro_dir=root,
                                       velocity_datacubes=cubes_j)
        out = trgi.initialize_glaciers(ids, _params(TP, 2), prepro_dir=root,
                                       velocity_datacubes=cubes_t, device=CPU)
        for g_t, g_j in zip(out, ref):
            assert g_t.H0.shape == (20, 18)
            assert g_t.velocity_data.vx.shape == (2, 20, 18)
            inside = np64(g_t.velocity_data.vx) > 0
            assert inside.any() and not inside.all()   # cells outside the footprint
            _assert_same_glacier(g_t, g_j, 1e-12, layout)
        f32 = trgi.initialize_glaciers(ids, _params(TP, 2), prepro_dir=root,
                                       velocity_datacubes=cubes_t, device=CPU,
                                       dtype=torch.float32)
        for a, b in zip(f32, out):
            assert a.H0.dtype == torch.float32 and a.velocity_data.vx.dtype == torch.float32
            for k, v in _fields(b).items():
                np.testing.assert_array_equal(_fields(a)[k], v.astype(np.float32))
    # the paths from params.simulation.rgi_paths, and a missing glacier
    p = dataclasses.replace(_params(TP), simulation=dataclasses.replace(
        _params(TP).simulation, rgi_paths=trgi.get_rgi_paths(str(tmp_path / "npz"))))
    assert trgi.initialize_glaciers(npz_ids[:1], p, device=CPU)[0].H0.shape == (40, 36)
    assert trgi.get_rgi_paths(str(tmp_path / "nc")) == jrgi.get_rgi_paths(str(tmp_path / "nc"))
    with pytest.raises(FileNotFoundError):
        trgi.initialize_glaciers(["RGI60-00.00000"], p, device=CPU)


def test_downscale_glacier_with_every_attachment(tmp_path):
    """_downscale_glacier on a glacier carrying gridded temperatures and
    thickness, velocity and dh/dt observations, against JAX's; and its
    ValueError on an unaligned cube (tests/test_netcdf.py:194's case)."""
    from odinn_tpu.data.rgi import _downscale_glacier as j_down
    from odinn_tpu_torch.data.rgi import _downscale_glacier as t_down

    ids = jrgi.generate_synthetic_oggm_dir(str(tmp_path), n=1, nx=26, ny=30, seed=7)
    g = jrgi.initialize_glaciers(ids, _params(JP), prepro_dir=str(tmp_path))[0]
    nx, ny = g.H0.shape
    rng = np.random.default_rng(3)
    g = g.replace(
        thickness_data=JThick(t=jnp.asarray([2010.0, 2011.0]),
                              H=jnp.stack([g.H0, g.H0 * 1.1])),
        velocity_data=JVel(t=jnp.asarray([2010.0, 2010.5, 2011.0]),
                           vx=jnp.asarray(rng.random((3, nx, ny))),
                           vy=jnp.asarray(rng.random((3, nx, ny))), vabs=None,
                           x=g.coords_x, y=g.coords_y),
        dhdt_data=JDhdt(t1=jnp.asarray(2010.0), t2=jnp.asarray(2011.0),
                        dhdt=jnp.asarray(rng.standard_normal((nx, ny)))),
    )
    tg = carry_glacier(g)
    for k in (1, 2, 3):
        out, ref = t_down(tg, k), j_down(g, k)
        assert out.H0.shape == (nx // k, ny // k)
        assert out.velocity_data.vabs is None
        _assert_same_glacier(out, ref, 1e-12, f"k={k}")
    g3 = tg.replace(velocity_data=dataclasses.replace(tg.velocity_data,
                                                      is_grid_glacier_aligned=False))
    with pytest.raises(ValueError, match="regrid"):
        t_down(g3, 2)


def test_fake_multi_datacube():
    """The glacier's own diagnostic velocity against JAX's; the noise is a
    torch.Generator draw of the same scale, repeatable by seed."""
    from odinn_tpu.data.synthetic import halfar_glacier

    g = halfar_glacier(nx=24, ny=24, dx=100.0, temp=-15.0)
    ts = np.array([2010.0, 2010.5, 2011.0])
    ref = jrgi.fake_multi_datacube(g, jnp.asarray(ts))
    out = trgi.fake_multi_datacube(carry_glacier(g), torch.from_numpy(ts))
    for f in ("t", "vx", "vy", "vabs"):
        assert_rel(getattr(out, f), getattr(ref, f), 1e-12, f)
    a = trgi.fake_multi_datacube(carry_glacier(g), torch.from_numpy(ts), noise=0.5, seed=3)
    b = trgi.fake_multi_datacube(carry_glacier(g), torch.from_numpy(ts), noise=0.5, seed=3)
    assert torch.equal(a.vx, b.vx) and torch.equal(a.vy, out.vy)
    assert 0.3 < float((a.vx - out.vx).std()) < 0.7


# ---------------------------------------------------------------------------
# regrid
# ---------------------------------------------------------------------------

def test_regrid_velocity_data_matches_jax():
    """Glacier cells on the cube's first and last rows and columns, inside,
    between and outside its footprint, against map_coordinates."""
    from odinn_tpu.core.glacier import Glacier as JGlacier

    rng = np.random.default_rng(11)
    xs, ys = np.linspace(0.0, 1000.0, 9), np.linspace(-500.0, 700.0, 13)
    gx = np.concatenate([[-50.0, 0.0, 1e-9], np.linspace(60.0, 990.0, 20), [1000.0, 1001.0]])
    gy = np.concatenate([[-500.0], np.linspace(-480.0, 699.0, 17), [700.0, 900.0]])
    v = rng.random((3, 9, 13)) * 30.0
    j_cube = JVel(t=jnp.arange(3.0), vx=jnp.asarray(v), vy=jnp.asarray(2.0 * v),
                  vabs=jnp.asarray(v + 1.0), x=jnp.asarray(xs), y=jnp.asarray(ys),
                  is_grid_glacier_aligned=False)
    jg = JGlacier(H0=jnp.zeros((gx.size, gy.size)), coords_x=jnp.asarray(gx),
                  coords_y=jnp.asarray(gy))
    ref = j_regrid(j_cube, jg)
    t_cube = SurfaceVelocityData(**{k: torch.from_numpy(np.array(getattr(j_cube, k)))
                                    for k in ("t", "vx", "vy", "vabs", "x", "y")},
                                 is_grid_glacier_aligned=False)
    out = regrid_velocity_data(t_cube, carry_glacier(jg))
    assert out.is_grid_glacier_aligned
    for f in ("vx", "vy", "vabs", "x", "y"):
        assert_rel(getattr(out, f), getattr(ref, f), 1e-12, f)
    vx = np64(out.vx)
    # the last node reads the cube's last row exactly; outside is 0
    np.testing.assert_allclose(vx[:, -2, 0], v[:, -1, 0], rtol=1e-15)
    np.testing.assert_allclose(vx[:, 1, -2], v[:, 0, -1], rtol=1e-15)
    assert (vx[:, 0] == 0).all() and (vx[:, -1] == 0).all() and (vx[:, :, -1] == 0).all()
    # aligned cubes pass through; coordinates are required
    assert regrid_velocity_data(out, carry_glacier(jg)) is out
    with pytest.raises(ValueError):
        regrid_velocity_data(dataclasses.replace(t_cube, x=None), carry_glacier(jg))
