"""odinn_tpu_torch's ``multistart_train`` under the discrete adjoint
(``grad="discrete"`` and a ``DiscreteAdjoint`` instance) against the JAX
package's, whose restart ``vmap`` runs ``_make_grad_fn`` for every
member (tests/torch_ensemble_grads.py's problem: float64, 2 restarts × 2
glaciers on 24², SI at PCG-6, 3 Adam epochs, from JAX's θ stack). The
loss curves, final losses, winner and θ stack agree to 1e-8; the port
folds the members into the kernels' glacier axis. A trainable initial
condition trains member by member, also beside fixed laws, as single
starts do (1e-12), and LBFGS refines the winner after discrete Adam. The
continuous adjoint is in ``test_torch_ensemble_grads_continuous*.py``,
forward mode and the dummy gradient in
``test_torch_ensemble_grads_fwd.py``, and restart k against a single
start from θ_k under every mode in
``test_torch_ensemble_grads_restarts.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from odinn_tpu_torch.laws.laws import ConstantA
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.simulation import ensemble as tens
from odinn_tpu_torch.simulation import inversion as tinv
from tests.torch_ensemble_grads import (
    EPOCHS, make_truth, problem, run_both, single_start_curves)
from tests.torch_parity import assert_rel, tree_to_port


@pytest.fixture(scope="module")
def truth():
    return make_truth()


@pytest.mark.parametrize("kind", ["per_glacier_A", "nn"])
def test_multistart_matches_jax(truth, kind):
    """JAX's run against the port's (1e-8); every restart's loss falls."""
    ms, _, _ = run_both(kind, "discrete", truth)
    assert np.all(ms.losses[:, -1] < ms.losses[:, 0])


def test_adjoint_instance_is_the_string(truth):
    """``DiscreteAdjoint()`` trains the restarts as ``grad="discrete"``:
    the same curves and θ stack, bitwise."""
    runs = []
    for mode in ("discrete", "DiscreteAdjoint"):
        _, inv, jthetas = problem("per_glacier_A", mode, truth)
        runs.append(tens.multistart_train(inv, thetas=tree_to_port(jthetas)))
    assert np.array_equal(runs[0].losses, runs[1].losses)
    assert torch.equal(runs[0].thetas["A"], runs[1].thetas["A"])


def test_trainable_initial_condition_matches_jax(truth):
    """θ = {A, H₀}: JAX's run against the port's (1e-8), whose adjoint adds
    member k's λ₀σ′ into θ_IC[k]; each restart is its single start
    (1e-12), and H₀ trains."""
    ms, inv, stack = run_both("ic", "discrete", truth)
    assert_rel(ms.losses, single_start_curves(inv, stack), 1e-12, "H₀ restarts")
    assert not torch.equal(ms.thetas["IC"][1], stack["IC"][1])


def test_trainable_initial_condition_beside_fixed_laws(truth):
    """θ = {H₀} alone (a fixed A): no law depends on θ, so the fused
    table's θ pullback is zero, and the discrete adjoint trains each
    restart's H₀ as its single start does (1e-12)."""
    _, inv, jthetas = problem("ic", "discrete", truth)
    model = Model(iceflow=SIA2DModel(A=ConstantA(6.5e-18)),
                  initial_condition=inv.model.initial_condition)
    inv = tinv.Inversion(model=model, glaciers=inv.glaciers, parameters=inv.parameters,
                         device="cpu")
    stack = {"IC": tree_to_port(jthetas)["IC"]}
    ms = tens.multistart_train(inv, thetas=stack)
    assert_rel(ms.losses, single_start_curves(inv, stack), 1e-12, "H₀ restarts")
    assert np.all(ms.losses[:, -1] < ms.losses[:, 0])


def test_refine_top_k_lbfgs_after_discrete_adam(truth):
    """Discrete Adam on 2 restarts, then LBFGS on the best one through
    ``train_ude`` under the discrete adjoint: the refined survivor equals
    that LBFGS stage from its Adam iterate (1e-12), and the installed θ
    evaluates to the reported loss."""
    _, inv, jthetas = problem("per_glacier_A", "discrete", truth,
                              optimizer=("adam", "lbfgs"), lr=(0.08, 1.0), epochs=(EPOCHS, 2))
    ms = tens.multistart_train(inv, thetas=tree_to_port(jthetas), refine_top_k=1)
    assert list(ms.refined_idxs) == [int(np.argmin(ms.final_losses))]
    assert np.isfinite(ms.refined_losses).all()
    p = inv.parameters
    lbfgs = p.replace(hyper=dataclasses.replace(p.hyper, optimizer=("lbfgs",),
                                                learning_rate=(1.0,), epochs=(2,)))
    one = tinv.Inversion(model=inv.model, glaciers=inv.glaciers, parameters=lbfgs,
                         theta=tens.member_theta(ms.thetas, int(ms.refined_idxs[0])),
                         device="cpu")
    tinv.train_ude(one)
    ts = tinv.assemble_tstops(p, inv.glaciers)
    with torch.no_grad():
        ref = float(tinv.batch_transient_loss(one.theta, inv.glaciers, inv.model, p, ts))
        val = float(tinv.batch_transient_loss(inv.theta, inv.glaciers, inv.model, p, ts))
    assert_rel(ms.refined_losses[0], ref, 1e-12, "refined loss")
    assert_rel(val, ms.best_loss, 1e-12, "installed θ")
    assert ms.best_loss <= np.min(ms.final_losses)
