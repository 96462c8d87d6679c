"""The forward main path of odinn_tpu_torch against odinn_tpu:
``forward_batch`` for SI, SI2 and compensated SSPRK3 with monthly mass
balance on a JAX batch carried across, ``run_prediction`` with velocities,
and a replay of the recorded golden trajectories built with the port's own
constructors.
"""

import os

import numpy as np
import pytest
import torch

import odinn_tpu.core.params as jp
import odinn_tpu_torch.core.params as tp
from tests.torch_parity import CPU, assert_rel, carry_glacier

TSPAN = (5.0, 5.5)
NX, N_G = 24, 3
_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "golden_trajectories.npz")

ROWS = {
    "SI": dict(substeps=1, solver="SI", cg_iters=6),
    "SI2": dict(substeps=1, solver="SI2", cg_iters=6, cg_iters_predictor=6),
    "SSPRK3_compensated": dict(substeps=3, solver="SSPRK3", compensated=True),
}


def _params(mod, use_velocities=False, **solver_kw):
    return mod.Parameters(
        physical=mod.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=mod.SimulationParameters(tspan=TSPAN, use_MB=True, step_MB=1.0 / 12.0,
                                            use_velocities=use_velocities),
        solver=mod.SolverParameters(step=1.0 / 12.0, **solver_kw),
    )


def _jax_batch():
    from odinn_tpu.core.glacier import stack_glaciers
    from odinn_tpu.data.synthetic import halfar_glacier, monthly_dummy_climate

    n_months = int(round((TSPAN[1] - TSPAN[0]) * 12)) + 2
    gl = []
    for i, t in enumerate(np.linspace(-25.0, -13.0, N_G)):
        clim = monthly_dummy_climate(TSPAN[0], n_months, temp_mean=-4.0,
                                     longterm_temp=float(t), nx=NX, ny=NX)
        gl.append(halfar_glacier(nx=NX, ny=NX, dx=100.0, dy=100.0, r0=700.0, temp=float(t),
                                 rgi_id=f"bench-{i}", climate=clim))
    return stack_glaciers(gl)


def _models():
    import odinn_tpu.laws.laws as jl
    import odinn_tpu.models.model as jm
    import odinn_tpu.physics.mass_balance as jmb
    import odinn_tpu_torch.laws.laws as tl
    import odinn_tpu_torch.models.model as tm
    import odinn_tpu_torch.physics.mass_balance as tmb

    return (jm.Model(iceflow=jm.SIA2DModel(A=jl.CuffeyPaterson(), n_value=3.0),
                     mass_balance=jmb.TImodel1()),
            tm.Model(iceflow=tm.SIA2DModel(A=tl.CuffeyPaterson(), n_value=3.0),
                     mass_balance=tmb.TImodel1()))


@pytest.mark.parametrize("row", list(ROWS))
def test_forward_batch_matches_jax(row):
    from odinn_tpu.simulation.prediction import forward_batch as j_forward
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = _jax_batch()
    tb = carry_glacier(jb)
    jmodel, tmodel = _models()
    ref = j_forward(None, jb, jmodel, _params(jp, **ROWS[row]), j_tstops(TSPAN, 1 / 12))
    out = forward_batch(None, tb, tmodel, _params(tp, **ROWS[row]), build_tstops(TSPAN, 1 / 12),
                        device=CPU)
    assert tuple(out.shape) == (N_G, 7, NX, NX)
    assert_rel(out, ref, 1e-10, row)


@pytest.mark.parametrize("row", list(ROWS))
def test_forward_batch_float32_matches_jax(row):
    """The main path's dtype. Both packages solve in float32 and differ only
    at float32 roundoff: the JAX package forms D with float64 law values
    before its cast (x64 on) and its dt with a rounded reciprocal of the
    substep count (ROADMAP Queue 3), so 1e-6 relative, about 8 ulps. The
    port's float32 error against the JAX float64 run is no worse than twice
    the JAX package's own."""
    import jax
    import jax.numpy as jnp

    from odinn_tpu.simulation.prediction import forward_batch as j_forward
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = _jax_batch()
    jb32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
                        jb)
    jmodel, tmodel = _models()
    ref32 = j_forward(None, jb32, jmodel, _params(jp, **ROWS[row]), j_tstops(TSPAN, 1 / 12))
    ref64 = j_forward(None, jb, jmodel, _params(jp, **ROWS[row]), j_tstops(TSPAN, 1 / 12))
    out = forward_batch(None, carry_glacier(jb32), tmodel, _params(tp, **ROWS[row]),
                        build_tstops(TSPAN, 1 / 12), device=CPU)
    assert out.dtype == torch.float32
    assert_rel(out, ref32, 1e-6, row)
    scale = float(np.abs(np.asarray(ref64)).max())
    err_port = float(np.abs(out.double().numpy() - np.asarray(ref64)).max()) / scale
    err_jax = float(np.abs(np.asarray(ref32, np.float64) - np.asarray(ref64)).max()) / scale
    assert err_port <= 2.0 * err_jax, (err_port, err_jax)


def test_run_prediction_with_velocities_matches_jax():
    from odinn_tpu.simulation.prediction import Prediction as JPred, run_prediction as j_run
    from odinn_tpu_torch.simulation.prediction import Prediction, run_prediction

    jb = _jax_batch()
    jmodel, tmodel = _models()
    ref = j_run(JPred(model=jmodel, glaciers=jb,
                      parameters=_params(jp, use_velocities=True, **ROWS["SI"])))
    pred = Prediction(model=tmodel, glaciers=carry_glacier(jb),
                      parameters=_params(tp, use_velocities=True, **ROWS["SI"]), device=CPU)
    out = run_prediction(pred)
    assert pred.results is out
    for key in ("H", "Vx", "Vy", "V"):
        assert_rel(out[key], ref[key], 1e-10, key)
    np.testing.assert_array_equal(out["t"].numpy(), np.asarray(ref["t"]))


def _golden_cases():
    """tests/data/make_golden.py's four cases, built with the port."""
    from odinn_tpu_torch.core.params import (
        Parameters, PhysicalParameters, SimulationParameters, SolverParameters)
    from odinn_tpu_torch.data.synthetic import halfar_glacier, monthly_dummy_climate
    from odinn_tpu_torch.laws.laws import ConstantA, CuffeyPaterson
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.physics.mass_balance import TImodel1

    tspan = (5.0, 6.0)
    clim = monthly_dummy_climate(5.0, 24, longterm_temp=-18.0, nx=48, ny=48, device=CPU)
    g_mb = halfar_glacier(nx=48, ny=48, dx=110.0, temp=-18.0, climate=clim, rgi_id="golden-mb",
                          device=CPU)
    g = halfar_glacier(nx=48, ny=48, dx=110.0, temp=-18.0, rgi_id="golden", device=CPU)

    def mk_params(solver, use_mb, **kw):
        return Parameters(
            physical=PhysicalParameters(),
            simulation=SimulationParameters(tspan=tspan, use_MB=use_mb),
            solver=SolverParameters(step=1.0 / 12.0, solver=solver, **kw),
        )

    mb = TImodel1(DDF=6.0e-3, acc_factor=1.2e-3)
    return {
        "rk4_noMB": (mk_params("RK4", False, substeps=20), g,
                     Model(iceflow=SIA2DModel(A=ConstantA(6.0e-18)))),
        "rk4_MB": (mk_params("RK4", True, substeps=20), g_mb,
                   Model(iceflow=SIA2DModel(A=ConstantA(6.0e-18)), mass_balance=mb)),
        "rkc_noMB": (mk_params("RKC", False, rkc_stages=16), g,
                     Model(iceflow=SIA2DModel(A=ConstantA(6.0e-18)))),
        "si_MB": (mk_params("SI", True, cg_iters=30), g_mb,
                  Model(iceflow=SIA2DModel(A=CuffeyPaterson()), mass_balance=mb)),
    }


@pytest.mark.parametrize("case", ["rk4_noMB", "rk4_MB", "rkc_noMB", "si_MB"])
def test_golden_trajectory_replay(case):
    """The recorded float64 trajectories, replayed through the port's
    forward_batch on a batch of one, at tests/test_golden.py's tolerance."""
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.simulation.prediction import forward_batch
    from odinn_tpu_torch.simulation.solver import build_tstops

    params, glacier, model = _golden_cases()[case]
    with np.load(_FIXTURE) as z:
        ref_traj = z[f"{case}_traj"]
        ref_tstops = z[f"{case}_tstops"]
    tstops = build_tstops(params.simulation.tspan, params.solver.step)
    np.testing.assert_allclose(tstops.numpy(), ref_tstops, rtol=0, atol=1e-12)
    traj = forward_batch(None, stack_glaciers([glacier], device=CPU), model, params, tstops,
                         device=CPU)[0].numpy()
    assert traj.shape == ref_traj.shape
    np.testing.assert_allclose(traj, ref_traj, rtol=1e-10, atol=1e-8, err_msg=case)
