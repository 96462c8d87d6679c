"""odinn_tpu_torch's continuous adjoint, the adjoints with mass balance and
velocity losses, and ``run_inversion(grad="discrete")``, against odinn_tpu.

The same two 24² glaciers of different A as ``test_torch_adjoints.py``,
3 monthly intervals, float64 on the CPU; loss to 1e-10 and θ-gradient to
1e-9 relative. ``ContinuousAdjoint`` × {ContinuousVJP, DiscreteVJP} ×
{hermite, linear} is held to the JAX package's
``glacier_adjoint_value_and_grad``, run per glacier (what its
``make_adjoint_value_and_grad`` vmaps and sums), whose reverse BS3(2) steps
are counted per glacier and interval: the port keeps one step controller
per glacier and must take the same steps. Then the discrete adjoint with
the monthly TImodel1 mass balance (discrete and autograd MB pullback), the
continuous adjoint with it, the discrete adjoint with LossHV, and three
Adam steps of ``run_inversion(grad="discrete")`` against the JAX package's
``train_ude``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import odinn_tpu.core.params as JP
import odinn_tpu.inverse.adjoint_types as JA
import odinn_tpu.simulation.solver as j_solver
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.inverse.adjoint_types as TA
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar, monthly_dummy_climate
from odinn_tpu.inverse.gradient import (
    gauss_legendre_nodes as j_gauss_legendre, glacier_adjoint_value_and_grad as j_glacier_vg,
    make_adjoint_value_and_grad as j_adjoint_vg)
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson
from odinn_tpu.losses.losses import LossHV as JLossHV, MultiLoss as JMultiLoss
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.physics.mass_balance import TImodel1 as JTImodel1
from odinn_tpu.simulation.inversion import (
    Inversion as JInversion, assemble_tstops as j_assemble, run_inversion as j_run_inversion)
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.inverse.gradient import gauss_legendre_nodes, make_adjoint_value_and_grad
from odinn_tpu_torch.losses.losses import LossHV, MultiLoss
from odinn_tpu_torch.physics.mass_balance import TImodel1
from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion
from tests.test_torch_adjoints import (  # noqa: F401 (problem: the shared fixture)
    _leaves, _models, _params, assert_matches, problem)
from tests.torch_parity import CPU, assert_rel, carry_glacier

TSPAN = (5.0, 5.0 + 3.0 / 12.0)


def _jax_per_glacier(problem, jp, jadjoint, monkeypatch):
    """(loss, grads, steps) of the JAX package's glacier_adjoint_value_and_grad
    summed over the glaciers; steps[g][k] counts glacier g's reverse BS3(2)
    steps in the k-th interval from the last."""
    truth, _, jtheta, _ = problem
    starts = []
    real = j_solver._bs32_step

    def counted(f, y, t, dt, k1):
        jax.debug.callback(lambda tau: starts.append(float(tau)), t)
        return real(f, y, t, dt, k1)

    monkeypatch.setattr(j_solver, "_bs32_step", counted)
    jm = _models(jp, _params(TP, "RK4", "jax"))[0]
    ts = j_assemble(jp, truth)
    quad = j_gauss_legendre(float(ts[0]), float(ts[-1]), jadjoint.n_quadrature)
    fn = jax.jit(lambda th, g, i: j_glacier_vg(th, g, i, jm, jp, ts, jadjoint, quad))
    tsn = np.asarray(ts)
    loss, grads, steps = 0.0, None, []
    for i in range(truth.H0.shape[0]):
        starts.clear()
        val, g = fn(jtheta, jax.tree.map(lambda x: x[i], truth), i)
        jax.effects_barrier()
        loss += float(val)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        # a step starting at τ ∈ [−t_j, −t_{j−1}) belongs to interval j
        steps.append([sum(1 for tau in starts if -tsn[j] <= tau < -tsn[j - 1])
                      for j in range(len(tsn) - 1, 0, -1)])
    return loss, grads, steps


@pytest.mark.parametrize("interpolation", ["hermite", "linear"])
@pytest.mark.parametrize("vjp", ["continuous", "discrete"])
def test_continuous_adjoint_matches_jax(problem, vjp, interpolation, monkeypatch):
    jf, tf = {"continuous": (JA.ContinuousVJP(), TA.ContinuousVJP()),
              "discrete": (JA.DiscreteVJP(), TA.DiscreteVJP())}[vjp]
    jadj = JA.ContinuousAdjoint(VJP_method=jf, interpolation=interpolation)
    tadj = TA.ContinuousAdjoint(VJP_method=tf, interpolation=interpolation)
    jp, tp = _params(JP, "RK4", jadj), _params(TP, "RK4", tadj)
    jloss, jgrads, jsteps = _jax_per_glacier(problem, jp, jadj, monkeypatch)
    _, batch, _, ttheta = problem
    tm = _models(jp, tp)[1]
    vg = make_adjoint_value_and_grad(Inversion(model=tm, glaciers=batch, parameters=tp,
                                               theta=ttheta, device=CPU), flavor="continuous")
    tval, tgrad = vg(ttheta)
    assert_matches((jloss, jgrads), (tval, tgrad), f"continuous {vjp} {interpolation}")
    steps = vg.record["reverse_steps"]            # [interval from the last][glacier]
    assert [list(s) for s in zip(*steps)] == jsteps
    assert vg.record["host_syncs"] == sum(max(s) for s in steps) + len(steps)
    assert min(min(s) for s in steps) >= 1


def test_gauss_legendre_nodes_match_jax():
    x, w = gauss_legendre_nodes(5.0, 7.0, 12)
    jx, jw = j_gauss_legendre(5.0, 7.0, 12)
    assert_rel(x, jx, 1e-15)
    assert_rel(w, jw, 1e-15)
    assert abs(float(np.sum(w)) - 2.0) < 1e-14


@pytest.fixture(scope="module")
def mb_problem(problem):
    """The two glaciers on a flat bed at 1800 m with a monthly climate and
    the monthly TImodel1 mass balance; thickness and velocity ground truth."""
    jp = _mb_params(JP, "jax")
    gl = [j_halfar(nx=24, ny=24, dx=200.0, h0=150.0, r0=1600.0, temp=t,
                   climate=monthly_dummy_climate(5.0, 12, temp_mean=-1.0, longterm_temp=t,
                                                 nx=24, ny=24),
                   rgi_id=f"g{i}") for i, t in enumerate((-27.0, -32.0))]
    gl = [g.replace(B=jnp.full_like(g.B, 1800.0)) for g in gl]
    truth = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson()),
                                          mass_balance=JTImodel1()),
                           j_tstops(TSPAN, 1.0 / 12.0), store=("H", "V"))
    truth = j_stack(truth)
    return truth, carry_glacier(truth)


def _mb_params(P, adjoint, loss=None, velocities=False):
    p = _params(P, "RK4", adjoint)
    return p.replace(
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=True, step_MB=1.0 / 12.0,
                                          use_velocities=velocities),
        UDE=dataclasses.replace(p.UDE, empirical_loss_function=loss))


def _mb_run(problem, mb_problem, jadj, tadj, flavor, loss=None):
    jtruth, tbatch = mb_problem
    velocities = loss is not None
    jp = _mb_params(JP, jadj, loss and JMultiLoss((JLossHV(),), (1.0,)), velocities)
    tp = _mb_params(TP, tadj, loss and MultiLoss((LossHV(),), (1.0,)), velocities)
    jp = jp.replace(UDE=dataclasses.replace(jp.UDE, grad=jadj))
    jm, tm = _models(jp, tp)
    jm = dataclasses.replace(jm, mass_balance=JTImodel1())
    tm = dataclasses.replace(tm, mass_balance=TImodel1())
    _, _, jtheta, ttheta = problem
    jval, jgrad = j_adjoint_vg(JInversion(model=jm, glaciers=jtruth, parameters=jp,
                                          theta=jtheta), flavor=flavor)(jtheta)
    tval, tgrad = make_adjoint_value_and_grad(
        Inversion(model=tm, glaciers=tbatch, parameters=tp, theta=ttheta, device=CPU),
        flavor=flavor)(ttheta)
    return (jval, jgrad), (tval, tgrad)


@pytest.mark.parametrize("mb_vjp", ["discrete", "auto"])
def test_discrete_adjoint_with_mb_matches_jax(problem, mb_problem, mb_vjp):
    """The MB pullback injected at every monthly MB boundary, by the
    analytic TImodel1 mask algebra or by autograd."""
    jf, tf = {"discrete": (JA.DiscreteVJP(), TA.DiscreteVJP()),
              "auto": (JA.AutoVJP(), TA.AutoVJP())}[mb_vjp]
    out = _mb_run(problem, mb_problem, JA.DiscreteAdjoint(MB_VJP=jf),
                  TA.DiscreteAdjoint(MB_VJP=tf), "discrete")
    assert_matches(*out, f"discrete + MB {mb_vjp}")


def test_continuous_adjoint_with_mb_matches_jax(problem, mb_problem):
    out = _mb_run(problem, mb_problem, JA.ContinuousAdjoint(VJP_method=JA.DiscreteVJP()),
                  TA.ContinuousAdjoint(VJP_method=TA.DiscreteVJP()), "continuous")
    assert_matches(*out, "continuous + MB")


def test_discrete_adjoint_loss_hv_matches_jax(problem, mb_problem):
    """LossHV: the velocity term's θ cotangent joins the adjoint's."""
    out = _mb_run(problem, mb_problem, JA.DiscreteAdjoint(), TA.DiscreteAdjoint(), "discrete",
                  loss="HV")
    assert_matches(*out, "discrete + LossHV")


def test_run_inversion_discrete_follows_train_ude(problem):
    """Three Adam steps of run_inversion(grad="discrete") through the SI
    solve: the losses and the trained θ of the JAX package's train_ude."""
    truth, batch, jtheta, ttheta = problem

    def params(P):
        p = _params(P, "SI", "discrete")
        return p.replace(hyper=P.Hyperparameters(optimizer=("adam",), learning_rate=(0.05,),
                                                 epochs=(3,), batch_size=2))

    jp, tp = params(JP), params(TP)
    jm, tm = _models(jp, tp)
    jres = j_run_inversion(JInversion(model=jm, glaciers=truth, parameters=jp, theta=jtheta))
    tinv = Inversion(model=tm, glaciers=batch, parameters=tp, theta=ttheta, device=CPU)
    tres = run_inversion(tinv)
    assert len(tres.stats.losses) == 3
    assert_rel(np.asarray(tres.stats.losses), np.asarray(jres.stats.losses), 1e-9, "losses")
    assert tres.stats.losses[-1] < tres.stats.losses[0]
    assert tres.stats.gradients == 3
    for a, b in zip(_leaves(tinv.theta), _leaves(jres.stats.theta)):
        assert_rel(a, np.asarray(b), 1e-9, "θ")
