"""odinn_tpu_torch's D-target and capped-target models against odinn_tpu's
(the port of tests/test_d_targets.py).

The hybrid-D target (``LawY``, Y = NN(T, H̄)), the pure-D target (``LawU``,
D = H̄·NN(H̄, |∇S|)) and the capped A target (``SIA2DModel.max_D`` on a
per-glacier ``LawA_inversion``): the forward solve through RK4, SSPRK3,
RKC, SI and SI2 against the JAX package's ``forward_glacier`` at 1e-10,
the loss's autograd gradient (RK4, SI) against ``jax.grad`` of
``batch_transient_loss`` at 1e-9 (loss at 1e-10), and a 3-epoch
``run_inversion`` (Adam, SI) whose losses equal ``train_ude``'s to 1e-8
relative. The manual adjoints are in test_torch_d_target_adjoints.py.

Two 24² glaciers with Cuffey–Paterson ground truth, 3 monthly intervals at
2 substeps (RKC s = 6, SI PCG-10), float64 on the CPU; NNs of
``default_architecture(2, light=True)`` with tests/test_d_targets.py's
bounds, but U's postscale bound ``U_MAX`` (``tests/torch_parity.py``).
None of these models is the fused kernels' configuration: the kernels'
plain versions are counted and must not run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.laws.laws as TL
from odinn_tpu.simulation.inversion import Inversion as JInversion, run_inversion as j_run
from odinn_tpu.simulation.prediction import forward_glacier as j_forward
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.models.model import Model, SIA2DModel
from odinn_tpu_torch.physics.targets import CappedTarget, DHybridTarget, DPureTarget
from odinn_tpu_torch.simulation.inversion import Inversion, run_inversion
from odinn_tpu_torch.simulation.prediction import forward_glacier
from tests.torch_parity import (
    CLASSICAL_TSPAN, CPU, D_KINDS, assert_rel, classical_params, classical_truth,
    count_kernel_plain_versions, d_target_models, d_target_problem, d_target_theta,
    jax_d_value_and_grad, port_d_value_and_grad, tree_rel_err, tree_to_port)


@pytest.fixture(scope="module")
def truth():
    return classical_truth()


@pytest.mark.parametrize("solver", ["RK4", "SSPRK3", "RKC", "SI", "SI2"])
@pytest.mark.parametrize("kind", D_KINDS)
def test_forward_matches_jax(truth, kind, solver, monkeypatch):
    jb, tb = truth
    jp, tp, jm, tm = d_target_problem(kind, solver)
    jtheta = d_target_theta(kind, jm, jb)
    ts = j_tstops(CLASSICAL_TSPAN, 1.0 / 12.0)
    j_traj = jax.vmap(lambda g, i: j_forward(jtheta, g, i, jm, jp, ts))(jb, jnp.arange(2))
    counts = count_kernel_plain_versions(monkeypatch)
    t_traj = forward_glacier(tree_to_port(jtheta), tb, tm, tp, ts).movedim(0, 1)
    assert_rel(t_traj, j_traj, 1e-10, f"{kind} {solver} trajectory")
    assert counts == {}, f"{kind} {solver}: a kernel's plain version ran: {counts}"
    assert isinstance(tm.target, {"Y": DHybridTarget, "U": DPureTarget,
                                  "capped": CappedTarget}[kind])
    if kind == "capped":   # the cap bites: the uncapped model's solve differs
        free = Model(iceflow=SIA2DModel(A=TL.LawA_inversion(tp), n_value=3.0))
        f_traj = forward_glacier(tree_to_port(jtheta), tb, free, tp, ts).movedim(0, 1)
        assert float((f_traj - t_traj).abs().max()) > 1e-6 * float(t_traj.abs().max())


@pytest.mark.parametrize("solver", ["RK4", "SI"])
@pytest.mark.parametrize("kind", D_KINDS)
def test_autograd_gradient_matches_jax(truth, kind, solver):
    jb, tb = truth
    jtheta, jval, jgrad = jax_d_value_and_grad(kind, solver, "jax", jb)
    tval, tgrad = port_d_value_and_grad(kind, solver, "jax", tb, jtheta)
    assert abs(tval - jval) <= 1e-10 * abs(jval)
    err = tree_rel_err(tgrad, jgrad)
    assert err <= 1e-9, f"{kind} {solver}: gradient relative error {err:.3e}"


@pytest.mark.parametrize("kind", D_KINDS)
def test_run_inversion_losses_match_train_ude(truth, kind):
    jb, tb = truth
    hyper = dict(optimizer=("adam",), learning_rate=(0.02,), epochs=(3,))
    jp = classical_params(JP, "SI", **hyper)
    tp = classical_params(TP, "SI", **hyper)
    jm, tm = d_target_models(kind, jp, tp)
    jtheta = d_target_theta(kind, jm, jb)
    j_stats = j_run(JInversion(model=jm, glaciers=jb, parameters=jp, theta=jtheta)).stats
    t_stats = run_inversion(Inversion(model=tm, glaciers=tb, parameters=tp,
                                      theta=tree_to_port(jtheta), device=CPU)).stats
    assert len(t_stats.losses) == len(j_stats.losses) == 3
    assert_rel(np.asarray(t_stats.losses), np.asarray(j_stats.losses), 1e-8, f"{kind} losses")
    assert t_stats.losses[-1] < t_stats.losses[0]
