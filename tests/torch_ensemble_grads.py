"""The problem shared by tests/test_torch_ensemble_grads*.py:
``multistart_train`` under every gradient mode of the JAX package's
``_make_grad_fn``, JAX's run against the port's. Float64, 2 restarts × 2
Halfar glaciers on 24² planes (tests/test_ensemble.py's), SI at PCG-6, 3
two-month intervals, 3 Adam epochs at 0.08, from JAX's explicit θ stack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.inverse.adjoint_types import ContinuousAdjoint as JContinuousAdjoint
from odinn_tpu.inverse.adjoint_types import DiscreteAdjoint as JDiscreteAdjoint
from odinn_tpu.inverse.adjoint_types import DiscreteVJP as JDiscreteVJP
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson
from odinn_tpu.laws.laws import LawA as JLawA
from odinn_tpu.laws.laws import LawA_inversion as JLawA_inversion
from odinn_tpu.losses.losses import LossH as JLossH
from odinn_tpu.losses.losses import MultiLoss as JMultiLoss
from odinn_tpu.losses.regularization import InitialThicknessRegularization as JITR
from odinn_tpu.models.initial_condition import InitialCondition as JInitialCondition
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.models.model import init_theta as j_init_theta
from odinn_tpu.models.nn import NeuralNetwork as JNN
from odinn_tpu.models.nn import default_architecture as j_arch
from odinn_tpu.simulation import ensemble as jens
from odinn_tpu.simulation.inversion import Inversion as JInversion
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.inverse.adjoint_types import ContinuousAdjoint as TContinuousAdjoint
from odinn_tpu_torch.inverse.adjoint_types import DiscreteAdjoint as TDiscreteAdjoint
from odinn_tpu_torch.inverse.adjoint_types import DiscreteVJP as TDiscreteVJP
from odinn_tpu_torch.laws.laws import LawA as TLawA
from odinn_tpu_torch.laws.laws import LawA_inversion as TLawA_inversion
from odinn_tpu_torch.losses.losses import LossH as TLossH
from odinn_tpu_torch.losses.losses import MultiLoss as TMultiLoss
from odinn_tpu_torch.losses.regularization import InitialThicknessRegularization as TITR
from odinn_tpu_torch.models.initial_condition import InitialCondition as TInitialCondition
from odinn_tpu_torch.models.model import Model as TModel
from odinn_tpu_torch.models.model import SIA2DModel as TSIA2DModel
from odinn_tpu_torch.models.nn import NeuralNetwork as TNN
from odinn_tpu_torch.models.nn import default_architecture as t_arch
from odinn_tpu_torch.simulation import ensemble as tens
from odinn_tpu_torch.simulation import inversion as tinv
from odinn_tpu_torch.utils.flatten import stack_to_rows, tree_leaves
from tests.torch_parity import assert_rel, carry_glacier, tree_to_port

TSPAN = (5.0, 5.5)
N_RESTARTS = 2
EPOCHS = 3
J_ADJOINTS = (JDiscreteAdjoint, JContinuousAdjoint, JDiscreteVJP)
T_ADJOINTS = (TDiscreteAdjoint, TContinuousAdjoint, TDiscreteVJP)


def grad_mode(mode, adjoints):
    """``mode`` in one package (its ``adjoints`` classes): a string, or an
    adjoint instance ("DiscreteAdjoint", "ContinuousAdjoint(DiscreteVJP)")."""
    discrete, continuous, discrete_vjp = adjoints
    if mode == "DiscreteAdjoint":
        return discrete()
    if mode == "ContinuousAdjoint(DiscreteVJP)":
        return continuous(VJP_method=discrete_vjp())
    return mode


def params(P, grad, optimizer=("adam",), lr=(0.08,), epochs=(EPOCHS,), loss=None):
    """tests/test_ensemble.py's setting at PCG-6: SI, 3 two-month
    intervals, Adam at 0.08."""
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, test_mode=True),
        solver=P.SolverParameters(step=1.0 / 6.0, substeps=1, solver="SI", cg_iters=6),
        hyper=P.Hyperparameters(optimizer=optimizer, learning_rate=lr, epochs=epochs,
                                batch_size=8),
        UDE=P.UDEParameters(grad=grad, target="A", empirical_loss_function=loss))


def make_truth():
    """(JAX batch, port batch): tests/test_ensemble.py's two glaciers with
    Cuffey–Paterson ground truth of H."""
    jp = params(JP, "jax")
    gl = [j_halfar(nx=24, ny=24, dx=150.0, temp=t, rgi_id=f"ms-{i}")
          for i, t in enumerate((-18.0, -12.0))]
    gl = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())),
                        j_tstops(TSPAN, jp.solver.step), store=("H",))
    jb = j_stack(gl)
    return jb, carry_glacier(jb)


def models(kind, jp, tp):
    """(JAX model, port model): per-glacier scalar A, A = NN(T), or the
    scalar A with a trainable H₀ (Zang1980 filter, Farinotti2019 start)."""
    if kind == "nn":
        return (JModel(iceflow=JSIA2DModel(A=JLawA(JNN(j_arch(1, light=True), seed=0), jp))),
                TModel(iceflow=TSIA2DModel(A=TLawA(TNN(t_arch(1, light=True)), tp))))
    if kind == "ic":
        return (JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True)),
                       initial_condition=JInitialCondition(filter="Zang1980")),
                TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True)),
                       initial_condition=TInitialCondition(filter="Zang1980")))
    return (JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True))),
            TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True))))


def jax_thetas(kind, jmodel, jb, jp):
    """JAX's θ stack of 2 restarts: NN draws of seeds 0 and 1; per-glacier
    A from ``init_restarts``; with H₀, restart 1 is θ₀ with A moved by 0.3
    and H₀'s θ by 2 % (``init_restarts``' jitter of a 24² thickness field
    makes the continuous adjoint's reverse solve take thousands of steps,
    in both packages)."""
    if kind == "nn":
        arch = j_arch(1, light=True)
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[
            j_init_theta(JModel(iceflow=JSIA2DModel(A=JLawA(JNN(arch, seed=k), jp))), jb)
            for k in range(N_RESTARTS)])
    theta0 = j_init_theta(jmodel, jb)
    if kind == "ic":
        theta1 = {"A": theta0["A"] + 0.3, "IC": theta0["IC"] * 1.02}
        return jax.tree.map(lambda *xs: jnp.stack(xs), theta0, theta1)
    return jens.init_restarts(theta0, N_RESTARTS, 0.5, seed=1)


def problem(kind, mode, truth, **kw):
    """(JAX inversion, port inversion, JAX θ stack) of a case; ``kw`` goes
    to :func:`params`."""
    jb, tb = truth
    jl = tl = None
    if kind == "ic":
        jl = JMultiLoss((JLossH(), JITR()), (1.0, 1e-12))
        tl = TMultiLoss((TLossH(), TITR()), (1.0, 1e-12))
    jp = params(JP, grad_mode(mode, J_ADJOINTS), loss=jl, **kw)
    tp = params(TP, grad_mode(mode, T_ADJOINTS), loss=tl, **kw)
    jmodel, tmodel = models(kind, jp, tp)
    return (JInversion(model=jmodel, glaciers=jb, parameters=jp),
            tinv.Inversion(model=tmodel, glaciers=tb, parameters=tp, device="cpu"),
            jax_thetas(kind, jmodel, jb, jp))


def rows_jax(stack):
    return np.asarray(jax.vmap(lambda th: jax.flatten_util.ravel_pytree(th)[0])(stack))


def assert_multistart_matches(ms, jms, what):
    """Loss curves, final losses, winner and θ stack, 1e-8."""
    assert ms.losses.shape == jms.losses.shape == (N_RESTARTS, EPOCHS)
    assert_rel(ms.losses, np.asarray(jms.losses), 1e-8, f"{what} loss curves")
    assert_rel(ms.final_losses, np.asarray(jms.final_losses), 1e-8, f"{what} final losses")
    assert ms.best_idx == jms.best_idx
    assert_rel(stack_to_rows(ms.thetas), rows_jax(jms.thetas), 1e-8, f"{what} final θ")


def run_both(kind, mode, truth):
    """JAX's ``multistart_train`` and the port's on JAX's θ stack, held to
    each other (1e-8); returns (port result, port inversion, port stack)."""
    jinv, inv, jthetas = problem(kind, mode, truth)
    jms = jens.multistart_train(jinv, thetas=jthetas)
    stack = tree_to_port(jthetas)
    ms = tens.multistart_train(inv, thetas=stack)
    assert_multistart_matches(ms, jms, f"{mode} {kind}")
    for a, b in zip(tree_leaves(inv.theta), tree_leaves(ms.best_theta)):
        assert torch.equal(a, b)
    return ms, inv, stack


def single_start_curves(inv, stack):
    """Each restart's loss curve by a single-start ``train_ude`` from its θ."""
    curves = []
    for k in range(N_RESTARTS):
        one = tinv.Inversion(model=inv.model, glaciers=inv.glaciers, parameters=inv.parameters,
                             theta=tens.member_theta(stack, k), device="cpu")
        curves.append(tinv.train_ude(one).stats.losses)
    return np.asarray(curves)


def assert_restarts_are_single_starts(kind, mode, truth):
    """Each folded restart's curve equals a single-start ``train_ude`` from
    its θ under the mode: 1e-12."""
    _, inv, jthetas = problem(kind, mode, truth)
    stack = tree_to_port(jthetas)
    ms = tens.multistart_train(inv, thetas=stack)
    assert_rel(ms.losses, single_start_curves(inv, stack), 1e-12, f"{mode} {kind} restarts")
    return ms
