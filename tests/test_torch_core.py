"""odinn_tpu_torch core: parameters, glacier containers, synthetic data,
state carried from the JAX package, device guards and import hygiene.

Float64 on the CPU, inputs handed to both packages as numpy.
"""

import ast
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import odinn_tpu.core.glacier as jglacier
import odinn_tpu.core.params as jparams
import odinn_tpu.data.synthetic as jsyn
import odinn_tpu_torch.core.glacier as tglacier
import odinn_tpu_torch.core.params as tparams
import odinn_tpu_torch.data.synthetic as tsyn
from odinn_tpu_torch.convert import glacier_from_numpy, theta_from_numpy
from tests.torch_parity import CPU, assert_rel, carry_glacier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12


@pytest.mark.parametrize("name", [
    "PhysicalParameters", "SimulationParameters", "SolverParameters",
    "Hyperparameters", "UDEParameters", "InversionParameters",
])
def test_params_defaults_match(name):
    jcls, tcls = getattr(jparams, name), getattr(tparams, name)
    jf = {f.name: f.default for f in dataclasses.fields(jcls)}
    tf = {f.name: f.default for f in dataclasses.fields(tcls)}
    assert jf == tf


def test_composite_parameters_and_dtype():
    p = tparams.Parameters()
    assert p.physical == tparams.PhysicalParameters()
    assert p.replace(solver=tparams.SolverParameters(solver="SI")).solver.solver == "SI"
    assert tparams.torch_dtype(p.simulation.float_dtype) == torch.float64
    assert tparams.torch_dtype("float32") == torch.float32


def test_halfar_glacier_matches():
    kw = dict(nx=40, ny=36, dx=110.0, dy=90.0, temp=-17.0, A=5e-19)
    jg = jsyn.halfar_glacier(**kw)
    tg = tsyn.halfar_glacier(**kw, device=CPU)
    for name in ("H0", "B", "dx", "dy", "A", "C", "n", "mask", "coords_x", "coords_y"):
        assert_rel(getattr(tg, name), getattr(jg, name), RTOL, name)
    assert_rel(tg.climate.longterm_temps_gridded, jg.climate.longterm_temps_gridded, RTOL)
    assert tg.H0.dtype == torch.float64 and tg.rgi_id == jg.rgi_id
    assert tsyn.halfar_glacier(nx=8, ny=8, device=CPU, dtype=torch.float32).H0.dtype == torch.float32


def test_monthly_dummy_climate_matches():
    jc = jsyn.monthly_dummy_climate(2010.0, 30, temp_amplitude=6.0, nx=12, ny=10)
    tc = tsyn.monthly_dummy_climate(2010.0, 30, temp_amplitude=6.0, nx=12, ny=10, device=CPU)
    for f in dataclasses.fields(jc):
        assert_rel(getattr(tc, f.name), getattr(jc, f.name), RTOL, f.name)


def _mixed_glaciers(mod, **dev):
    clim = mod.monthly_dummy_climate(5.0, 14, nx=30, ny=26, **dev)
    return [
        mod.halfar_glacier(nx=30, ny=26, dx=100.0, temp=-12.0, rgi_id="a", climate=clim, **dev),
        mod.halfar_glacier(nx=24, ny=32, dx=80.0, temp=-20.0, rgi_id="b",
                           climate=mod.monthly_dummy_climate(5.0, 14, nx=24, ny=32, **dev), **dev),
    ]


def test_stack_glaciers_pads_like_jax():
    jb = jglacier.stack_glaciers(_mixed_glaciers(jsyn))
    tb = tglacier.stack_glaciers(_mixed_glaciers(tsyn, device=CPU), device=CPU)
    assert tb.rgi_id == jb.rgi_id == ("a", "b")
    assert tb.is_batched and tuple(tb.H0.shape) == (2, 30, 32)
    for name in ("H0", "B", "mask", "dx", "coords_x", "coords_y", "npix"):
        assert_rel(getattr(tb, name), getattr(jb, name), RTOL, name)
    for name in ("temp", "t_start", "longterm_temps_gridded"):
        assert_rel(getattr(tb.climate, name), getattr(jb.climate, name), RTOL, name)
    assert_rel(tglacier.loss_normalization(tb), jglacier.loss_normalization(jb), RTOL)


def test_convert_carries_a_jax_batch():
    jb = jglacier.stack_glaciers(_mixed_glaciers(jsyn))
    tb = carry_glacier(jb)
    assert isinstance(tb.climate, tglacier.Climate2D)
    assert tb.rgi_id == jb.rgi_id
    for name in ("H0", "B", "dx", "dy", "A", "n", "mask", "npix"):
        assert_rel(getattr(tb, name), getattr(jb, name), 0.0, name)
    assert_rel(tb.climate.temp, jb.climate.temp, 0.0)
    dummy = glacier_from_numpy(
        {"H0": np.ones((3, 3)), "climate": {"longterm_temps_scalar": np.asarray(-5.0),
                                             "longterm_temps_gridded": None}},
        "x", device=CPU, dtype=torch.float32)
    assert isinstance(dummy.climate, tglacier.DummyClimate2D)
    assert dummy.H0.dtype == torch.float32


def test_convert_theta_tree():
    rng = np.random.default_rng(0)
    tree = {"A": rng.normal(size=(3,)), "nn": [{"W": rng.normal(size=(2, 4)), "b": np.zeros(4)}],
            "IC": None}
    out = theta_from_numpy(tree, device=CPU)
    assert out["IC"] is None and isinstance(out["nn"], list)
    np.testing.assert_array_equal(out["nn"][0]["W"].numpy(), tree["nn"][0]["W"])
    assert out["A"].dtype == torch.float64
    assert theta_from_numpy(tree, device=CPU, dtype=torch.float32)["A"].dtype == torch.float32


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from odinn_tpu_torch.laws.laws import ConstantA
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.simulation.prediction import Prediction, forward_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tsyn.halfar_glacier(nx=8, ny=8, device=CPU)
    batch = tglacier.stack_glaciers([g], device=CPU)
    model = Model(iceflow=SIA2DModel(A=ConstantA(1e-17)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forward_batch(None, batch, model, tparams.Parameters(), [0.0, 1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.halfar_glacier(nx=8, ny=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tglacier.stack_glaciers([g])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prediction(model=model, glaciers=[g], parameters=tparams.Parameters())


def test_chip_smoke_alone_prints_no_result(tmp_path):
    """Copied into an empty directory (no package beside it) and, here,
    without a CUDA card, chip_smoke.py exits non-zero with nothing on
    stdout."""
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def _port_sources():
    root = os.path.join(REPO, "odinn_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "profile_epoch.py")
    yield os.path.join(REPO, "profile_exchange.py")
    yield os.path.join(REPO, "profile_lm_step.py")
    yield os.path.join(REPO, "profile_jvp.py")
    yield os.path.join(REPO, "profile_plane.py")
    yield os.path.join(REPO, "profile_rows.py")
    yield os.path.join(REPO, "profile_tolerance.py")
    yield os.path.join(REPO, "profile_vjp.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            text = fh.read()
        if not path.endswith(".py"):
            # a CUDA source: nothing it includes comes from the JAX package
            for n, line in enumerate(text.splitlines(), 1):
                if re.match(r'\s*#\s*include\s*[<"](jax|xla|odinn_tpu/)', line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{n} includes {line.strip()}")
            continue
        tree = ast.parse(text, filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "odinn_tpu", "flax", "optax", "orbax"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}")
    assert not bad, "\n".join(bad)
    assert sum(1 for _ in _port_sources()) > 20
    scanned = set(_port_sources())
    for module in ("utils/flatten.py", "parallel/mesh.py", "simulation/ensemble.py",
                   "simulation/eki.py", "inverse/uncertainty.py", "data/rgi.py",
                   "data/netcdf.py", "models/mb_machine.py", "utils/io.py", "utils/memory.py",
                   "utils/logging.py", "utils/plotting.py", "utils/time_utils.py", "api.py",
                   "parallel/multiprocess.py", "parallel/mp_worker.py", "parallel/spatial.py",
                   "csrc/si_plane.cu", "csrc/si_step.cu", "csrc/sia_common.cuh"):
        assert os.path.join(REPO, "odinn_tpu_torch", module) in scanned, module
    assert os.path.join(REPO, "profile_plane.py") in scanned
