"""The gradient modes odinn_tpu_torch adds in this slice against the JAX
package's: ``grad="forward"`` (one ``torch.autograd.forward_ad`` solve per
θ leaf, through the kernels' tangent rules: their plain versions on the
CPU) against ``grad="forward"`` of ``odinn_tpu.simulation.inversion`` and
the port's autograd, and ``grad="dummy"``. Float64, 2 glaciers on 16²
planes, 3 monthly intervals.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson
from odinn_tpu.laws.laws import LawA_inversion as JLawA_inversion
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.simulation import inversion as jinv
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.laws.laws import LawA_inversion as TLawA_inversion
from odinn_tpu_torch.models.model import Model as TModel
from odinn_tpu_torch.models.model import SIA2DModel as TSIA2DModel
from odinn_tpu_torch.simulation import inversion as tinv
from odinn_tpu_torch.simulation.results import TrainingStats
from tests.torch_parity import CPU, assert_rel, carry_glacier, theta_to_port

TSPAN = (5.0, 5.25)


def _params(P, solver, grad="forward"):
    """tests/test_gradients.py::test_forward_mode_gradient_matches_ad's
    setting cut to 16² at the same 4.2 km extent and 3 months: RK4 at 6
    substeps (its 32² at 12, the same Courant number), or SI at PCG-6."""
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=6 if solver == "RK4" else 1,
                                  solver=solver, cg_iters=6),
        hyper=P.Hyperparameters(),
        UDE=P.UDEParameters(grad=grad))


@pytest.fixture(scope="module")
def truth():
    jp = _params(JP, "RK4")
    gl = [j_halfar(nx=16, ny=16, dx=260.0, temp=t, rgi_id=f"f{i}")
          for i, t in enumerate((-15.0, -22.0))]
    return j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())),
                          j_tstops(TSPAN, 1.0 / 12.0), store=("H",))


@pytest.mark.parametrize("solver", ["RK4", "SI"])
def test_forward_mode_gradient_matches_ad(truth, solver):
    """The port of tests/test_gradients.py::test_forward_mode_gradient_matches_ad
    with an SI row at PCG-6 beside RK4: grad="forward" of the classical
    per-glacier A at θ + 0.08 equals the JAX package's grad="forward"
    (RK4: also reverse-mode AD, in both packages) to 1e-9. Through SI at
    PCG-6 forward mode takes custom_linear_solve's tangent solve and
    reverse mode its transpose solve, two contracts that meet only where
    PCG has converged; there the port's forward gradient is held to JAX's
    forward gradient, and its reverse one to JAX's reverse one. NN/gridded
    θ is refused with a remedy."""
    jp, tp = _params(JP, solver), _params(TP, solver)
    jmodel = JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True)))
    inv = jinv.Inversion(model=jmodel, glaciers=truth, parameters=jp)
    jtheta = jax.tree.map(lambda x: x + 0.08, inv.theta)
    val_f, g_f = jax.jit(jinv._make_grad_fn(inv, None))(jtheta, inv.glaciers)
    ts = jinv.assemble_tstops(jp, inv.glaciers)
    val_r, g_r = jax.jit(jax.value_and_grad(
        lambda th: jinv.batch_transient_loss(th, inv.glaciers, jmodel, jp, ts)))(jtheta)

    tmodel = TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True)))
    batch = carry_glacier(inv.glaciers)
    tinvn = tinv.Inversion(model=tmodel, glaciers=batch, parameters=tp, device=CPU)
    theta = theta_to_port(jtheta)
    stats = TrainingStats()
    vg = tinv._make_grad_fn(tinvn, None, stats)
    val, (grad,) = vg(theta, batch)
    assert stats.solves == 1 and stats.gradients == 0
    assert_rel(val, float(val_f), 1e-12, "loss")
    assert_rel(grad, np.asarray(g_f["A"]), 1e-9, "forward gradient")
    tts = tinv.assemble_tstops(tp, batch)
    leaf = theta["A"].clone().requires_grad_(True)
    (g_ad,) = torch.autograd.grad(tinv.batch_transient_loss({"A": leaf}, batch, tmodel, tp, tts),
                                  leaf)
    assert_rel(g_ad, np.asarray(g_r["A"]), 1e-9, "reverse gradient")
    if solver == "RK4":
        assert_rel(grad, g_ad, 1e-9, "forward against reverse")
        np.testing.assert_allclose(float(val_f), float(val_r), rtol=1e-12)
    with pytest.raises(ValueError, match="per-glacier SCALAR"):
        vg({"A": torch.zeros((2, 4, 4), dtype=torch.float64)}, batch)


def test_dummy_gradient(truth):
    """grad="dummy" (and a DummyAdjoint): the loss of the solve, and
    standard-normal draws of θ's shapes and dtype, the same at every call
    (a torch.Generator seeded 0; not JAX's numbers)."""
    from odinn_tpu_torch.inverse.adjoint_types import DummyAdjoint

    for grad in ("dummy", DummyAdjoint()):
        tp = _params(TP, "SI", grad=grad)
        tmodel = TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True)))
        batch = carry_glacier(j_stack(truth) if isinstance(truth, list) else truth)
        inv = tinv.Inversion(model=tmodel, glaciers=batch, parameters=tp, device=CPU)
        vg = tinv._make_grad_fn(inv, lambda th, b: tinv.batch_transient_loss(
            th, b, tmodel, tp, tinv.assemble_tstops(tp, b)), TrainingStats())
        val, (g,) = vg(inv.theta, batch)
        _, (g2,) = vg({"A": inv.theta["A"] + 1.0}, batch)
        assert torch.equal(g, g2)
        assert g.shape == inv.theta["A"].shape and g.dtype == inv.theta["A"].dtype
        want = torch.randn(g.shape, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float64)
        assert torch.equal(g, want)
        with torch.no_grad():
            assert_rel(val, tinv.batch_transient_loss(inv.theta, batch, tmodel, tp,
                                                      tinv.assemble_tstops(tp, batch)),
                       0.0, "loss")
        p = dataclasses.replace(tp.hyper, optimizer="adam", learning_rate=0.01, epochs=2)
        inv.parameters = tp.replace(hyper=p)
        assert np.isfinite(tinv.run_inversion(inv).stats.losses).all()
