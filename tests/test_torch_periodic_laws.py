"""odinn_tpu_torch's periodic laws (callback_freq > 0) and the capped
diffusivity against odinn_tpu's (the port of tests/test_periodic_laws.py).

A periodic law is re-evaluated every round(callback_freq / step) save
intervals from the evolving state, after the interval's mass balance, by
the interval loop of ``forward_glacier``, whose SI substeps are cold-started
at H and whose explicit substeps are never compensated. Held here, float64
on the CPU, two 32² Halfar glaciers on a 1500 m bed with a warm monthly
climate, 6 monthly intervals, the laws refreshed every 2:

- the gridded periodic C of tests/test_periodic_laws.py (from CPDD over the
  evolving surface) through RK4, RKC and SI (PCG-6), mass balance on and
  off, against the JAX package's ``forward_glacier`` at 1e-10, compensated
  RK4 too (the loop ignores compensation, as the JAX package's does);
- a periodic per-glacier A, which the fused kernels take (their table
  rebuilt after each refresh; their plain versions on the CPU, counted): the
  table route equals the generic route (the same law on the staggered
  grid) and JAX at 1e-10 through SI and RKC, and differs from the law
  frozen at the start;
- the loss gradient by autograd (trainable periodic C, generic; trainable
  periodic A, through the fused SI and RKC steps) against ``jax.grad`` at
  1e-9;
- the refusals: periodic laws with SI2, with an adaptive solve, and under
  the manual adjoints, each naming its reason;
- the capped forward (``max_D``) against JAX at 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.laws.inputs as JI
import odinn_tpu.laws.laws as JL
import odinn_tpu.ops.stencils as jst
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.laws.inputs as TI
import odinn_tpu_torch.laws.laws as TL
import odinn_tpu_torch.ops.stencils as tst
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.data.synthetic import monthly_dummy_climate as j_climate
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.physics.mass_balance import TImodel1 as JTImodel1
from odinn_tpu.simulation.inversion import batch_transient_loss as j_loss
from odinn_tpu.simulation.prediction import forward_glacier as j_forward
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.physics.mass_balance import TImodel1
from odinn_tpu_torch.physics.targets import CappedTarget
from odinn_tpu_torch.simulation.inversion import (
    Inversion, assemble_tstops, batch_transient_loss, run_inversion)
from odinn_tpu_torch.simulation.prediction import forward_glacier
from tests.torch_parity import (
    CPU, assert_rel, carry_glacier, count_kernel_plain_versions, tree_rel_err, tree_to_port)

A = 5e-18
TSPAN = (5.0, 5.5)
FREQ = 2.0 / 12.0
N_INT = 6


def _params(P, solver="RK4", use_mb=False, grad="jax", **solver_kw):
    kw = dict(step=1.0 / 12.0, substeps=10, solver=solver, rkc_stages=8, cg_iters=6)
    kw.update(solver_kw)
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=use_mb, step_MB=1.0 / 12.0,
                                          use_velocities=False),
        solver=P.SolverParameters(**kw),
        UDE=P.UDEParameters(grad=grad))


@pytest.fixture(scope="module")
def batch():
    gl = []
    for i, tm in enumerate((3.0, 1.0)):
        clim = j_climate(5.0, 24, temp_mean=tm, nx=32, ny=32)
        g = j_halfar(nx=32, ny=32, dx=130.0, temp=-15.0, A=A, climate=clim, rgi_id=f"p{i}")
        gl.append(g.replace(B=jnp.full_like(g.B, 1500.0)))
    jb = j_stack(gl)
    return jb, carry_glacier(jb)


def _c_law(law_cls, inputs, sigmoid, avg, callback_freq=FREQ, trainable=False):
    """tests/test_periodic_laws.py's C from CPDD, on the staggered grid."""

    def apply_fn(theta, inp):
        scale = theta["C"] if trainable else 1e-19
        return scale * sigmoid(avg(inp["CPDD"]) / 200.0 - 2.0)

    return law_cls(slot="C", apply_fn=apply_fn, inputs=(inputs.CPDD(window=0.25),),
                   callback_freq=callback_freq, trainable=trainable, name="periodicC",
                   init_theta=None)


def _c_models(use_mb, trainable=False):
    jc = _c_law(JL.Law, JI, jax.nn.sigmoid, jst.avg, trainable=trainable)
    tc = _c_law(TL.Law, TI, torch.sigmoid, tst.avg, trainable=trainable)
    return (JModel(iceflow=JSIA2DModel(A=JL.ConstantA(A), C=jc),
                   mass_balance=JTImodel1() if use_mb else None),
            Model(iceflow=SIA2DModel(A=TL.ConstantA(A), C=tc),
                  mass_balance=TImodel1() if use_mb else None))


def _a_law(law_cls, inputs, mean, sigmoid, grid=False, callback_freq=FREQ, trainable=False):
    """A periodic per-glacier A: A₀·(1 + 0.5·σ(mean CPDD / 1000 − 1)), or
    the same value on every staggered cell (``grid``)."""

    def apply_fn(theta, inp):
        cpdd = inp["CPDD"]
        a0 = theta["A"][inp["glacier_idx"]] if trainable else A
        val = a0 * (1.0 + 0.5 * sigmoid(mean(cpdd) / 1000.0 - 1.0))
        if grid:
            val = val.reshape(val.shape + (1, 1)) * torch.ones_like(cpdd[..., 1:, 1:])
        return val

    return law_cls(slot="A", apply_fn=apply_fn, inputs=(inputs.CPDD(window=1.0),),
                   callback_freq=callback_freq, trainable=trainable, name="periodicA")


def _a_models(grid=False, callback_freq=FREQ, trainable=False):
    ja = _a_law(JL.Law, JI, jnp.mean, jax.nn.sigmoid, callback_freq=callback_freq,
                trainable=trainable)
    ta = _a_law(TL.Law, TI, lambda c: c.mean(dim=(-2, -1)), torch.sigmoid, grid=grid,
                callback_freq=callback_freq, trainable=trainable)
    return (JModel(iceflow=JSIA2DModel(A=ja, n_value=3.0)),
            Model(iceflow=SIA2DModel(A=ta, n_value=3.0)))


def _j_traj(jtheta, jb, jm, jp):
    ts = j_tstops(TSPAN, 1.0 / 12.0)
    return jax.vmap(lambda g, i: j_forward(jtheta, g, i, jm, jp, ts))(jb, jnp.arange(2))


def _t_traj(ttheta, tb, tm, tp):
    return forward_glacier(ttheta, tb, tm, tp, j_tstops(TSPAN, 1.0 / 12.0)).movedim(0, 1)


@pytest.mark.parametrize("use_mb", [False, True])
@pytest.mark.parametrize("solver", ["RK4", "RK4 compensated", "RKC", "SI"])
def test_gridded_periodic_c_matches_jax(batch, solver, use_mb):
    jb, tb = batch
    comp = solver.endswith("compensated")
    solver = solver.split()[0]
    # SI at one step a month, where PCG-6 is inexact: a warm-started CG
    # would leave JAX's cold-started steps
    kw = dict(substeps=1) if solver == "SI" else {}
    jp, tp = _params(JP, solver, use_mb, **kw), _params(TP, solver, use_mb, **kw)
    jm, tm = _c_models(use_mb)
    j_traj = _j_traj(None, jb, jm, jp)
    t_traj = _t_traj(None, tb, tm, tp)
    assert_rel(t_traj, j_traj, 1e-10, f"{solver} MB={use_mb} trajectory")
    if comp:    # the loop ignores compensation, bit for bit
        tp_c = _params(TP, solver, use_mb, compensated=True)
        assert torch.equal(_t_traj(None, tb, tm, tp_c), t_traj)
    # the refresh matters; the first interval precedes it
    frozen = Model(iceflow=SIA2DModel(A=TL.ConstantA(A), C=dataclasses.replace(
        tm.iceflow.C, callback_freq=0.0)), mass_balance=tm.mass_balance)
    f_traj = _t_traj(None, tb, frozen, tp)
    assert float((f_traj[:, -1] - t_traj[:, -1]).abs().max()) > 1e-9 * float(
        t_traj.abs().max())
    # the frozen SI solve warm-starts its CG (integrate_semi_implicit), the
    # periodic loop's steps start cold: PCG-6 leaves them ~2e-12 apart
    assert_rel(f_traj[:, :2], t_traj[:, :2], 1e-14 if solver != "SI" else 1e-10,
               "before the first refresh")


@pytest.mark.parametrize("solver", ["SI", "RKC"])
def test_periodic_table_route_matches_generic_route(batch, solver, monkeypatch):
    """The loop resolves its laws afresh after each refresh, so the kernels'
    table follows the refreshed A (a table cached across refreshes would
    drive the next interval with the last one's values)."""
    jb, tb = batch
    jp, tp = _params(JP, solver), _params(TP, solver)
    jm, tm = _a_models()
    _, tm_grid = _a_models(grid=True)
    counts = count_kernel_plain_versions(monkeypatch)
    table = _t_traj(None, tb, tm, tp)
    kernel = "odinn_tpu_torch.ops.cuda.si_kernel._forward" if solver == "SI" else \
        "odinn_tpu_torch.ops.cuda.rkc_kernel._forward"
    assert counts == {kernel: N_INT * 10}, counts
    counts.clear()
    generic = _t_traj(None, tb, tm_grid, tp)
    assert counts == {}, counts
    assert_rel(table, generic, 1e-10, f"{solver} table route against the generic route")
    assert_rel(table, _j_traj(None, jb, jm, jp), 1e-10, f"{solver} table route against JAX")
    _, frozen = _a_models(callback_freq=0.0)
    f_traj = _t_traj(None, tb, frozen, tp)
    assert float((f_traj[:, -1] - table[:, -1]).abs().max()) > 1e-9 * float(table.abs().max())


@pytest.mark.parametrize("inner", [False, True])
def test_periodic_resolver_is_built_at_the_start_and_after_each_refresh(batch, inner,
                                                                        monkeypatch):
    """Without inner laws the interval loop builds its resolver (and with it
    the kernels' table) at the first interval and after each refresh only;
    with an inner law, whose static inputs are read at the interval start,
    at every interval."""
    import odinn_tpu_torch.simulation.prediction as prediction

    _, tb = batch
    tp = _params(TP, "RK4", substeps=2)
    _, tm = _a_models()
    if inner:
        y = TL.Law(slot="Y", apply_fn=lambda th, inp: torch.full_like(inp["Hbar"], 1e-18),
                   inputs=(TI.HbarInput(),), callback_freq=None, trainable=False, name="Y")
        tm = Model(iceflow=SIA2DModel(A=tm.iceflow.A, Y=y, n_value=3.0))
    built = []
    make = prediction.make_values_fn
    monkeypatch.setattr(prediction, "make_values_fn",
                        lambda *a, **kw: built.append(a[3]) or make(*a, **kw))
    traj = _t_traj(None, tb, tm, tp)
    assert torch.isfinite(traj).all()
    starts = [float(t) for t in j_tstops(TSPAN, 1.0 / 12.0)[:-1]]
    # FREQ is 2 intervals: refreshes after intervals 2 and 4 of 6
    want = starts if inner else [starts[0], starts[2], starts[4]]
    assert built == pytest.approx(want), built


@pytest.fixture(scope="module")
def observed(batch):
    """The batch with a thickness series from a constant A (JAX)."""
    jb, _ = batch
    jp = _params(JP, "SI")
    ts = j_tstops(TSPAN, 1.0 / 12.0)
    gl = [jax.tree.map(lambda x: x[i], jb) for i in range(2)]
    gl = [g.replace(rgi_id=f"o{i}") for i, g in enumerate(gl)]
    gl = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JL.ConstantA(3e-18))), ts,
                        store=("H",))
    jo = j_stack(gl)
    return jo, carry_glacier(jo)


@pytest.mark.parametrize("case", ["C RK4", "A SI", "A RKC"])
def test_periodic_gradient_matches_jax(observed, case, monkeypatch):
    jb, tb = observed
    kind, solver = case.split()
    jp, tp = _params(JP, solver, substeps=2), _params(TP, solver, substeps=2)
    if kind == "C":
        jm, tm = _c_models(False, trainable=True)
        jtheta = {"C": jnp.asarray(1e-19)}
    else:
        jm, tm = _a_models(trainable=True)
        jtheta = {"A": jnp.asarray([2e-18, 4e-18])}
    ts = j_tstops(TSPAN, 1.0 / 12.0)
    jval, jgrad = jax.value_and_grad(lambda th: j_loss(th, jb, jm, jp, ts))(jtheta)
    counts = count_kernel_plain_versions(monkeypatch)
    ttheta = tree_to_port(jtheta)
    leaf = ttheta[kind].requires_grad_(True)
    tval = batch_transient_loss(ttheta, tb, tm, tp, assemble_tstops(tp, tb))
    tgrad = {kind: torch.autograd.grad(tval, leaf)[0]}
    assert abs(float(tval.detach()) - float(jval)) <= 1e-10 * abs(float(jval))
    err = tree_rel_err(tgrad, jgrad)
    assert err <= 1e-9, f"{case}: gradient relative error {err:.3e}"
    assert float(tgrad[kind].abs().min()) > 0.0
    if kind == "A":   # through the fused steps (their plain versions here)
        step = "si_kernel._forward" if solver == "SI" else "rkc_kernel._forward"
        assert counts.get(f"odinn_tpu_torch.ops.cuda.{step}", 0) == N_INT * 2 * (
            1 if solver == "SI" else 2), counts       # RKC: its backward rematerialises


def test_periodic_laws_are_refused_where_unsupported(batch):
    _, tb = batch
    _, tm = _c_models(False)
    ts = j_tstops(TSPAN, 1.0 / 12.0)
    with pytest.raises(NotImplementedError, match="SI2"):
        forward_glacier(None, tb, tm, _params(TP, "SI2"), ts)
    with pytest.raises(NotImplementedError, match="adaptive does not support periodic"):
        forward_glacier(None, tb, tm, _params(TP, "RK4", adaptive=True), ts)
    _, ta = _a_models(trainable=True)
    for grad in ("discrete", "continuous"):
        inv = Inversion(model=ta, glaciers=tb, parameters=_params(TP, "SI", grad=grad),
                        theta={"A": torch.tensor([2e-18, 4e-18], dtype=torch.float64)},
                        device=CPU)
        with pytest.raises(NotImplementedError, match="grad='jax'"):
            make_adjoint_value_and_grad(inv, flavor=grad)
        with pytest.raises(NotImplementedError, match="periodic laws"):
            run_inversion(inv)


def test_capped_forward_matches_jax():
    """max_D keeps the solve finite at a large A; the uncapped solve at one
    substep blows up (tests/test_periodic_laws.py::test_capped_diffusivity)."""
    jg = j_halfar(nx=32, ny=32, dx=130.0, temp=-15.0, A=8e-18)
    tg = carry_glacier(jg)
    jp, tp = _params(JP), _params(TP)
    jm = JModel(iceflow=JSIA2DModel(A=JL.ConstantA(8e-18), max_D=1e5))
    tm = Model(iceflow=SIA2DModel(A=TL.ConstantA(8e-18), max_D=1e5))
    assert isinstance(tm.target, CappedTarget)
    ts = j_tstops(TSPAN, 1.0 / 12.0)
    t_traj = forward_glacier(None, tg, tm, tp, ts)
    assert torch.isfinite(t_traj).all()
    assert_rel(t_traj, j_forward(None, jg, 0, jm, jp, ts), 1e-10, "capped trajectory")
    free = Model(iceflow=SIA2DModel(A=TL.ConstantA(8e-18)))
    bad = forward_glacier(None, tg, free, _params(TP, substeps=1), ts)[-1]
    assert (~torch.isfinite(bad)).any() or float(bad.abs().max()) > 1e6
