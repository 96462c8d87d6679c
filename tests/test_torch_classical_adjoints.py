"""odinn_tpu_torch's manual adjoints with a classical inversion's loss
terms and trainable H₀, against odinn_tpu's.

θ = {A (per glacier, ``LawA_inversion``), IC (H₀ = σ(θ_IC), Zang1980)}
with ``InitialThicknessRegularization`` (an initial-state term, evaluated
once at t₀ and pulled back through θ and H₀(θ)) or with ``LossDhdt`` (an
aggregate term, whose trajectory cotangent at every save, save 0 included,
joins the sweep): ``make_adjoint_value_and_grad`` of DiscreteAdjoint ×
{Euler, RKC, SI, SI2} and of ContinuousAdjoint against the JAX package's,
loss to 1e-10 and each θ leaf to 1e-9 relative; two 24² glaciers, 3
monthly intervals at 2 substeps, float64 on the CPU. The IC gradient is
λ(t₀)·σ′(θ_IC), so it checks the λ each sweep hands back. Then chunked
accumulation over gathered sub-batches, which must keep each glacier's θ
rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.inverse.adjoint_types as JA
import odinn_tpu.laws.laws as JL
import odinn_tpu.losses.regularization as JR
import odinn_tpu.losses.time_aggregated as JT
import odinn_tpu.models.initial_condition as JIC
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.inverse.adjoint_types as TA
import odinn_tpu_torch.laws.laws as TL
import odinn_tpu_torch.losses.regularization as TR
import odinn_tpu_torch.losses.time_aggregated as TT
import odinn_tpu_torch.models.initial_condition as TIC
from odinn_tpu.inverse.gradient import make_adjoint_value_and_grad as j_adjoint_vg
from odinn_tpu.losses.losses import LossH as JLossH, MultiLoss as JMultiLoss
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.simulation.inversion import Inversion as JInversion
from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
from odinn_tpu_torch.losses.losses import LossH, MultiLoss
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.simulation.inversion import (
    Inversion, _make_grad_fn, assemble_tstops, batch_transient_loss)
from odinn_tpu_torch.simulation.results import TrainingStats
from tests.torch_parity import (
    CPU, assert_rel, assert_tree_rel, classical_params, classical_truth, theta_to_port)


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    """XLA:CPU flushes subnormal results to zero and PyTorch on the CPU does
    not; the dh/dt loss's mask (H > 0 at t₂) reads the subnormal values the
    semi-implicit step leaves on a few ice-free cells. Both flush here."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def problem():
    jb, tb = classical_truth(store=("H", "dhdt"))
    th = JIC.InitialCondition(filter="Zang1980").init_theta(jb)
    noise = 4.0 * np.random.default_rng(0).standard_normal(th.shape)
    jtheta = {"A": jnp.asarray([0.3, -0.2]), "IC": th + jnp.asarray(noise) * (jb.H0 > 0.0)}
    return jb, tb, jtheta


def _losses(which):
    if which == "initial":
        return (JMultiLoss((JLossH(), JR.InitialThicknessRegularization()), (1.0, 1e-2)),
                MultiLoss((LossH(), TR.InitialThicknessRegularization()), (1.0, 1e-2)))
    return (JMultiLoss((JLossH(), JT.LossDhdt()), (1.0, 0.5)),
            MultiLoss((LossH(), TT.LossDhdt()), (1.0, 0.5)))


def _models(jp, tp):
    return (JModel(iceflow=JSIA2DModel(A=JL.LawA_inversion(jp), n_value=3.0),
                   initial_condition=JIC.InitialCondition(filter="Zang1980")),
            Model(iceflow=SIA2DModel(A=TL.LawA_inversion(tp), n_value=3.0),
                  initial_condition=TIC.InitialCondition(filter="Zang1980")))


CASES = [("Euler", "discrete"), ("RKC", "discrete"), ("SI", "discrete"), ("SI2", "discrete"),
         ("SI", "continuous")]


@pytest.mark.parametrize("which", ["initial", "aggregate"])
@pytest.mark.parametrize("solver,flavor", CASES)
def test_adjoint_with_terms_and_ic_matches_jax(problem, solver, flavor, which):
    jb, tb, jtheta = problem
    jl, tl = _losses(which)
    jadj, tadj = ((JA.DiscreteAdjoint(), TA.DiscreteAdjoint()) if flavor == "discrete"
                  else (JA.ContinuousAdjoint(), TA.ContinuousAdjoint()))
    jp = classical_params(JP, solver, grad=jadj, loss=jl)
    tp = classical_params(TP, solver, grad=tadj, loss=tl)
    jm, tm = _models(jp, tp)
    jval, jgrad = j_adjoint_vg(JInversion(model=jm, glaciers=jb, parameters=jp, theta=jtheta),
                               flavor=flavor)(jtheta)
    ttheta = theta_to_port(jtheta)
    tinv = Inversion(model=tm, glaciers=tb, parameters=tp, theta=ttheta, device=CPU)
    tval, tgrad = make_adjoint_value_and_grad(tinv, flavor=flavor)(ttheta)
    assert_rel(tval, jval, 1e-10, f"{solver} {flavor} {which} loss")
    assert_tree_rel(tgrad, jgrad, 1e-9, f"{solver} {flavor} {which} gradient")
    assert float(tgrad["IC"].abs().max()) > 0.0 and float(tgrad["A"].abs().min()) > 0.0


@pytest.mark.parametrize("grad", ["jax", "discrete"])
def test_chunked_gradient_keeps_each_glaciers_theta(problem, grad):
    """hyper.grad_accum_chunks = 2 runs each glacier as its own gathered
    sub-batch: its glacier_ids select its rows of θ_A and θ_IC, so the sum
    equals the full batch's value and gradient."""
    jb, tb, jtheta = problem
    jl, tl = _losses("aggregate")
    tp = classical_params(TP, "SI", grad=grad, loss=tl)
    _, tm = _models(tp, tp)
    ttheta = {k: v.requires_grad_(True) for k, v in theta_to_port(jtheta).items()}
    tstops = assemble_tstops(tp, tb)
    out = []
    for chunks in (1, 2):
        inv = Inversion(model=tm, glaciers=tb, theta=ttheta, device=CPU,
                        parameters=tp.replace(hyper=dataclasses.replace(
                            tp.hyper, grad_accum_chunks=chunks)))
        vg = _make_grad_fn(inv, lambda th, b: batch_transient_loss(th, b, tm, tp, tstops),
                           TrainingStats())
        out.append(vg(ttheta, tb))
    (v1, g1), (v2, g2) = out
    assert_rel(v2, v1, 1e-12, "loss")
    for a, b in zip(g2, g1):
        assert_rel(a, b, 1e-12, "gradient")
