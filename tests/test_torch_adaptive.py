"""odinn_tpu_torch's adaptive BS3(2) forward and ``substeps="auto"`` sizing
against odinn_tpu.

The JAX package vmaps one ``lax.while_loop`` per glacier; the port steps the
stacked batch with one step-size controller per glacier. On the same inputs
(float64, the CPU) the trajectories agree to 1e-10 relative, each glacier's
accepted steps per interval are equal and the recorded steps agree to
1e-12 years; the calibrated substep and PCG counts are JAX's integers exactly,
and the staleness guard re-sizes at the same iterations to the same counts.
In float32 both packages round differently (the controller's power, the
error norm's sum), so the final state is held to 1e-5 relative and the
accepted totals to 2 %.
"""

import dataclasses

import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from tests.torch_parity import CPU, assert_rel, carry_glacier

TSPAN = (5.0, 5.0 + 3.0 / 12.0)     # 3 monthly intervals
TEMPS = (-30.0, -18.0, -8.0)        # Cuffey-Paterson A spans ~30x: unequal step counts


def _params(P, tspan=TSPAN, use_mb=False, **solver_kw):
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=tspan, use_MB=use_mb, step_MB=1.0 / 12.0,
                                          use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, **solver_kw),
        UDE=P.UDEParameters(grad="jax"))


def _jax_batch(nx=32, temps=TEMPS, tspan=TSPAN):
    from odinn_tpu.core.glacier import stack_glaciers
    from odinn_tpu.data.synthetic import halfar_glacier, monthly_dummy_climate

    n_months = int(round((tspan[1] - tspan[0]) * 12)) + 2
    return stack_glaciers([
        halfar_glacier(nx=nx, ny=nx, dx=120.0, dy=120.0, r0=1200.0, h0=300.0, temp=t,
                       rgi_id=f"ad{i}",
                       climate=monthly_dummy_climate(tspan[0], n_months, temp_mean=-4.0,
                                                     longterm_temp=t, nx=nx, ny=nx))
        for i, t in enumerate(temps)])


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


def _jax_adaptive(jb, jmodel, jparams, tstops, cap):
    """The JAX package's vmapped adaptive forward: (traj, naccs, dts)."""
    import jax
    import jax.numpy as jnp

    from odinn_tpu.simulation.prediction import forward_glacier as j_fwd

    idxs = jnp.arange(jb.H0.shape[0])
    return jax.jit(jax.vmap(lambda g, i: j_fwd(None, g, i, jmodel, jparams, tstops,
                                               _return_stats=True, _return_dts=cap)))(jb, idxs)


@pytest.mark.parametrize("use_mb", [False, True], ids=["no_mb", "mb"])
def test_integrate_adaptive_matches_jax_vmap(use_mb):
    """Three glaciers whose A differ ~30x take different step counts; the
    batch-level controller reproduces each one's vmapped while_loop: the
    trajectory, the accepted steps per interval and the step record. With
    the mass balance the FSAL derivative is re-evaluated after every
    interval's callback, as in the JAX package."""
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import forward_glacier
    from odinn_tpu_torch.simulation.solver import build_tstops, integrate_adaptive

    jb = _jax_batch()
    jmodel, tmodel = _models()
    kw = dict(adaptive=True, reltol=1e-6)
    cap = 64
    j_traj, j_nacc, j_dts = _jax_adaptive(jb, jmodel, _params(JP, use_mb=use_mb, **kw),
                                          j_tstops(TSPAN, 1 / 12), cap)
    j_nacc = np.asarray(j_nacc)
    assert j_nacc.max() < cap
    assert len(set(j_nacc.sum(axis=1).tolist())) == len(TEMPS), j_nacc

    integrate_adaptive.rhs_evals = integrate_adaptive.host_reads = 0
    record = {}
    traj, nacc, dts = forward_glacier(None, carry_glacier(jb), tmodel,
                                      _params(TP, use_mb=use_mb, **kw),
                                      build_tstops(TSPAN, 1 / 12), _return_stats=True,
                                      _return_dts=cap, _record=record)
    assert_rel(traj.movedim(0, 1), np.asarray(j_traj), 1e-10, "trajectory")
    np.testing.assert_array_equal(nacc.numpy(), j_nacc)
    # the steps in years, to 1e-12 years: a truncated last step t1 − t
    # carries the roundoff of the t it completes
    np.testing.assert_allclose(dts.numpy(), np.asarray(j_dts), rtol=0, atol=1e-12)
    # the batch takes as many trial steps in an interval as its slowest
    # glacier; every trial is 3 RHS evaluations of the whole batch
    trials = record["trials"].numpy()
    assert (trials >= nacc.numpy()).all()
    n_int = trials.shape[1]
    per_interval = trials.max(axis=0)
    assert integrate_adaptive.rhs_evals == 1 + 3 * per_interval.sum() + (n_int if use_mb else 0)
    assert integrate_adaptive.host_reads == per_interval.sum() + n_int


def test_integrate_adaptive_on_a_lone_glacier():
    """A lone (nx, ny) glacier is a batch of one: the same steps and the
    same trajectory as the stacked batch holding only it."""
    from odinn_tpu.core.glacier import stack_glaciers
    from odinn_tpu.data.synthetic import halfar_glacier
    from odinn_tpu_torch.simulation.prediction import forward_glacier
    from odinn_tpu_torch.simulation.solver import build_tstops

    _, tmodel = _models()
    jg = halfar_glacier(nx=32, ny=32, dx=120.0, dy=120.0, r0=1200.0, h0=300.0, temp=-18.0)
    p = _params(TP, adaptive=True, reltol=1e-6)
    ts = build_tstops(TSPAN, 1 / 12)
    H, nacc = forward_glacier(None, carry_glacier(jg), tmodel, p, ts, _return_stats=True)
    batch_H, batch_nacc = forward_glacier(None, carry_glacier(stack_glaciers([jg])), tmodel, p,
                                          ts, _return_stats=True)
    assert tuple(H.shape) == (4, 32, 32) and tuple(nacc.shape) == (3,)
    assert torch.equal(nacc, batch_nacc[0])
    assert_rel(H, batch_H[:, 0], 1e-14, "trajectory")


def test_reltol_controls_forward_error():
    """tests/test_adaptive.py's contract on the port: tightening reltol
    tightens the solution against a converged fixed-step oracle and raises
    the accepted step count, and each tolerance's counts are JAX's."""
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import forward_batch, forward_glacier
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = _jax_batch(temps=(-15.0,))
    tb = carry_glacier(jb)
    jmodel, tmodel = _models()
    ts = build_tstops(TSPAN, 1 / 12)
    ref = forward_batch(None, tb, tmodel, _params(TP, solver="RK4", substeps=200), ts,
                        device=CPU)[:, -1]
    scale = float(ref.abs().max())
    out = {}
    for reltol in (1e-3, 1e-8):
        traj, nacc = forward_glacier(None, tb, tmodel, _params(TP, adaptive=True, reltol=reltol),
                                     ts, _return_stats=True)
        _, j_nacc, _ = _jax_adaptive(jb, jmodel, _params(JP, adaptive=True, reltol=reltol),
                                     j_tstops(TSPAN, 1 / 12), 1)
        np.testing.assert_array_equal(nacc.numpy(), np.asarray(j_nacc))
        out[reltol] = (float((traj[-1] - ref).abs().max()) / scale, int(nacc.sum()))
    (err_loose, n_loose), (err_tight, n_tight) = out[1e-3], out[1e-8]
    assert err_tight < err_loose / 5, out
    assert err_tight < 1e-6, out
    assert n_tight > n_loose


def test_float32_adaptive_matches_jax():
    """The card's dtype: both packages control in float32 and round the
    controller's power and the error norm's sum differently."""
    import jax
    import jax.numpy as jnp

    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import forward_glacier
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = _jax_batch()
    jb32 = jax.tree.map(lambda x: x.astype(jnp.float32)
                        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating) else x,
                        jb)
    jmodel, tmodel = _models()
    kw = dict(adaptive=True, reltol=1e-4)
    j_traj, j_nacc, _ = _jax_adaptive(jb32, jmodel, _params(JP, use_mb=True, **kw),
                                      j_tstops(TSPAN, 1 / 12), 1)
    traj, nacc = forward_glacier(None, carry_glacier(jb32), tmodel, _params(TP, use_mb=True, **kw),
                                 build_tstops(TSPAN, 1 / 12), _return_stats=True)
    assert traj.dtype == torch.float32
    assert_rel(traj[-1], np.asarray(j_traj)[:, -1], 1e-5, "final state")
    total, j_total = int(nacc.sum()), int(np.asarray(j_nacc).sum())
    assert abs(total - j_total) <= 0.02 * j_total, (total, j_total)


def _spy(monkeypatch, name):
    """Calls of odinn_tpu_torch.simulation.prediction.``name`` (looked up
    there by resolve_substeps) and their results, still computed."""
    import odinn_tpu_torch.simulation.prediction as tpred

    real, seen = getattr(tpred, name), []

    def spy(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(tpred, name, spy)
    return seen


@pytest.mark.parametrize("solver,reltol", [("SSPRK3", 1e-4), ("SSPRK3", 1e-7), ("RK4", 1e-5)])
def test_calibrate_substeps_matches_jax(solver, reltol, monkeypatch):
    """resolve_substeps sizes the explicit solvers' substeps by
    calibrate_substeps, once, to JAX's integer."""
    from odinn_tpu.simulation.prediction import calibrate_substeps as j_calibrate
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import resolve_substeps
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = _jax_batch()
    jmodel, tmodel = _models()
    kw = dict(solver=solver, substeps="auto", reltol=reltol)
    want = j_calibrate(None, jb, jmodel, _params(JP, **kw), j_tstops(TSPAN, 1 / 12))
    tb, ts = carry_glacier(jb), build_tstops(TSPAN, 1 / 12)
    seen = _spy(monkeypatch, "calibrate_substeps")
    assert resolve_substeps(_params(TP, **kw), tb, tmodel, None, ts).solver.substeps == want
    assert seen == [want]


@pytest.mark.parametrize("solver,reltol", [("SI", 3e-3), ("SI2", 1e-4)])
def test_calibrate_substeps_si_matches_jax(solver, reltol, monkeypatch):
    """Richardson step-halving sizes substeps, cg_iters and the predictor's
    budget to JAX's integers: calibrate_substeps_si, called once by
    resolve_substeps, returns them and resolve_substeps sets them."""
    from odinn_tpu.simulation.prediction import calibrate_substeps_si as j_calibrate
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.prediction import resolve_substeps
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = _jax_batch(nx=24, temps=TEMPS[:2])
    jmodel, tmodel = _models()
    kw = dict(solver=solver, substeps="auto", reltol=reltol)
    want = j_calibrate(None, jb, jmodel, _params(JP, **kw), j_tstops(TSPAN, 1 / 12))
    tb, ts = carry_glacier(jb), build_tstops(TSPAN, 1 / 12)
    seen = _spy(monkeypatch, "calibrate_substeps_si")
    p = resolve_substeps(_params(TP, **kw), tb, tmodel, None, ts).solver
    assert seen == [tuple(want)]
    assert (p.substeps, p.cg_iters, p.cg_iters_predictor) == tuple(want)


def test_refusals_match_jax():
    """The JAX package's refusals, with their types: an unresolved "auto"
    or replay schedule in a direct solve, adaptive training, and an
    adaptive solve of a periodic law."""
    from odinn_tpu.simulation.inversion import Inversion as JInversion, train_ude as j_train
    from odinn_tpu.simulation.prediction import forward_glacier as j_fwd
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.simulation.inversion import Inversion, train_ude
    from odinn_tpu_torch.simulation.prediction import forward_glacier
    from odinn_tpu_torch.simulation.solver import build_tstops

    jb = _jax_batch(nx=24, temps=TEMPS[:1])
    jmodel, tmodel = _models()
    tb, ts, jts = carry_glacier(jb), build_tstops(TSPAN, 1 / 12), j_tstops(TSPAN, 1 / 12)
    for kw, match in ((dict(substeps="auto"), "resolve_substeps"),
                      (dict(adaptive="replay"), "resolve_replay")):
        with pytest.raises(ValueError, match=match):
            j_fwd(None, jb, 0, jmodel, _params(JP, **kw), jts)
        with pytest.raises(ValueError, match=match):
            forward_glacier(None, tb, tmodel, _params(TP, **kw), ts)

    p_ad = dict(adaptive=True, reltol=1e-6)
    with pytest.raises(ValueError, match="forward-only"):
        j_train(JInversion(model=jmodel, glaciers=jb, parameters=_params(JP, **p_ad)))
    with pytest.raises(ValueError, match="forward-only"):
        train_ude(Inversion(model=tmodel, glaciers=tb, parameters=_params(TP, **p_ad),
                            device=CPU))

    law = dataclasses.replace(tmodel.iceflow.A, callback_freq=1.0 / 12.0)
    periodic = dataclasses.replace(tmodel, iceflow=dataclasses.replace(tmodel.iceflow, A=law))
    with pytest.raises(NotImplementedError, match="adaptive does not support periodic"):
        forward_glacier(None, tb, periodic, _params(TP, **p_ad), ts)


def test_substeps_auto_staleness_guard_matches_jax():
    """tests/test_adaptive.py's staleness-guard setting, cut to size (32²
    at the same extent, 3 months, SSPRK3 at reltol 1e-3, A from near min_A
    towards a truth of 8e-18, Adam 7 + 1 epochs). The first stage outgrows
    its sizing twice; each time both packages rewind to the best iterate and
    double the substeps (6 → 12 → 24) at the same iterations, and the
    stage's losses agree to 1e-9. (The uncut setting, 48², 6 months, a
    truth of 2e-17 and 10 + 5 epochs, re-sizes three times, to 48, and
    took ~140 s.)

    The second stage's start differs, and the JAX package's is the stale
    one: its stage-end evaluation of the last iterate (and its final one)
    is ``jax.jit`` of the loss function it first traced at 6 substeps,
    which the jit cache hands back after the re-sizing, so it evaluates the
    last iterate at the old count and may start the stage from an earlier
    iterate. The port evaluates at 24 substeps and starts from the last
    iterate, whose loss is the lowest of the stage."""
    import jax.numpy as jnp

    from odinn_tpu.core.glacier import stack_glaciers as j_stack
    from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
    from odinn_tpu.laws.laws import ConstantA as JConstantA, LawA_inversion as JLawA_inversion
    from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
    from odinn_tpu.simulation.inversion import Inversion as JInversion, train_ude as j_train
    from odinn_tpu.simulation.prediction import generate_ground_truth as j_truth
    from odinn_tpu.simulation.solver import build_tstops as j_tstops
    from odinn_tpu_torch.laws.laws import LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.simulation.inversion import Inversion, train_ude

    tspan = (5.0, 5.25)

    def params(P):
        return P.Parameters(
            physical=P.PhysicalParameters(min_A=2e-19, max_A=4e-17),
            simulation=P.SimulationParameters(tspan=tspan, use_MB=False, use_velocities=False),
            solver=P.SolverParameters(step=1.0 / 12.0, solver="SSPRK3", substeps="auto",
                                      reltol=1e-3),
            hyper=P.Hyperparameters(optimizer=("adam", "adam"), learning_rate=(0.3, 0.1),
                                    epochs=(7, 1), batch_size=4),
            UDE=P.UDEParameters(grad="jax"))

    g = j_halfar(nx=32, ny=32, dx=120.0, temp=-15.0, A=8e-19)
    jp = params(JP)
    (g_obs,) = j_truth([g], jp, JModel(iceflow=JSIA2DModel(A=JConstantA(8e-18))),
                       j_tstops(tspan, 1.0 / 12.0), store=("H",))
    jinv = JInversion(model=JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True))),
                      glaciers=[g_obs], parameters=jp)
    jinv.theta = {"A": jnp.asarray([-2.0])}
    jres = j_train(jinv)

    tp = params(TP)
    inv = Inversion(model=Model(iceflow=SIA2DModel(A=LawA_inversion(tp, scalar=True))),
                    glaciers=carry_glacier(j_stack([g_obs])), parameters=tp, device=CPU,
                    theta={"A": torch.tensor([-2.0], dtype=torch.float64)})
    res = train_ude(inv)
    bumps = res.stats.substeps_bumps
    assert bumps == jres.stats.substeps_bumps == [(3, 6, 12), (6, 12, 24)]
    assert inv.parameters.solver.substeps == jinv.parameters.solver.substeps == 24
    first = 7 + bumps[-1][0]           # the first stage's recorded iterations
    assert_rel(np.asarray(res.stats.losses[:first]), np.asarray(jres.stats.losses[:first]),
               1e-9, "first stage's losses")
    assert np.isfinite(res.stats.losses).all() and len(res.stats.losses) == first + 1
    assert res.stats.losses[first] <= min(res.stats.losses[:first])
