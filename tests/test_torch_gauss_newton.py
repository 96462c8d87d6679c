"""odinn_tpu_torch's Gauss–Newton / Levenberg–Marquardt trainer against the
JAX package's (``odinn_tpu.inverse.gauss_newton``, the LM stage of
``simulation.inversion.train_ude``): the per-glacier residuals, CG in θ
space with restarts, the refusals and ``gn_glacier_norm``'s recorded
losses (the Hutchinson diagonal and the LM loss trace are in
``test_torch_lm_trace.py`` and ``test_torch_lm_trace_rk4.py``). Float64,
2 glaciers on 16² planes, 3 monthly intervals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.inverse import gauss_newton as jgn
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson
from odinn_tpu.laws.laws import LawA as JLawA
from odinn_tpu.laws.laws import LawA_inversion as JLawA_inversion
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.models.nn import NeuralNetwork as JNN
from odinn_tpu.models.nn import default_architecture as j_arch
from odinn_tpu.simulation import inversion as jinv
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.inverse import gauss_newton as tgn
from odinn_tpu_torch.laws.laws import LawA as TLawA
from odinn_tpu_torch.laws.laws import LawA_inversion as TLawA_inversion
from odinn_tpu_torch.models.model import Model as TModel
from odinn_tpu_torch.models.model import SIA2DModel as TSIA2DModel
from odinn_tpu_torch.models.nn import NeuralNetwork as TNN
from odinn_tpu_torch.models.nn import default_architecture as t_arch
from odinn_tpu_torch.simulation import inversion as tinv
from tests.torch_parity import CPU, assert_rel, carry_glacier, tree_rel_err, tree_to_port

TSPAN = (5.0, 5.25)


def _params(P, solver="RK4", optimizer=("lm",), lr=(1e-3,), epochs=(3,), loss=None, **hyper):
    """The JAX test's setting (tests/test_gauss_newton.py::make_setup) cut
    to 16² at the same 4.3 km extent and 3 months: RK4 at 8 substeps (the
    NN's initial A is stable there), or SI at PCG-6."""
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, test_mode=True),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=8 if solver == "RK4" else 1,
                                  solver=solver, cg_iters=6),
        hyper=P.Hyperparameters(optimizer=optimizer, learning_rate=lr, epochs=epochs,
                                batch_size=8, **hyper),
        UDE=P.UDEParameters(grad="jax", target="A", empirical_loss_function=loss))


@pytest.fixture(scope="module")
def truth():
    """Two 16² Halfar glaciers (JAX) with Cuffey–Paterson ground truth of H
    and V."""
    jp = _params(JP)
    jp = jp.replace(simulation=dataclasses.replace(jp.simulation, use_velocities=True))
    gl = [j_halfar(nx=16, ny=16, dx=270.0, temp=t, rgi_id=f"gn-{i}")
          for i, t in enumerate((-15.0, -22.0))]
    return j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())),
                          j_tstops(TSPAN, 1.0 / 12.0), store=("H", "V"))


def _models(jp, tp, nn=True):
    if nn:
        return (JModel(iceflow=JSIA2DModel(A=JLawA(JNN(j_arch(1, light=True), seed=0), jp))),
                TModel(iceflow=TSIA2DModel(A=TLawA(TNN(t_arch(1, light=True)), tp))))
    return (JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True))),
            TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True))))


def _residual_case(truth, loss_j, loss_t, velocities=False, dhdt=False, solver="RK4"):
    """(JAX residuals, port residuals, port loss) at the JAX NN's initial θ."""
    from odinn_tpu.core.glacier import DhdtData
    from odinn_tpu.models.model import init_theta

    jp, tp = _params(JP, solver, loss=loss_j), _params(TP, solver, loss=loss_t)
    if not velocities:
        truth = [g.replace(velocity_data=None) for g in truth]
    if dhdt:
        truth = [g.replace(dhdt_data=DhdtData(t1=jnp.asarray(5.0), t2=jnp.asarray(5.25),
                                              dhdt=jnp.zeros_like(g.H0))) for g in truth]
    jbatch = j_stack(truth)
    jmodel, tmodel = _models(jp, tp)
    jtheta = init_theta(jmodel, jbatch)
    ts = jinv.assemble_tstops(jp, jbatch)
    r_j = jgn.make_residual_fn(jmodel, jp, ts)(jtheta, jbatch)
    batch, theta = carry_glacier(jbatch), tree_to_port(jtheta)
    tts = tinv.assemble_tstops(tp, batch)
    r_t = tgn.make_residual_fn(tmodel, tp, tts)(theta, batch)
    return r_j, r_t, tinv.batch_transient_loss(theta, batch, tmodel, tp, tts)


def test_residual_squares_to_loss(truth):
    """The port of tests/test_gauss_newton.py::test_residual_squares_to_loss:
    one (n_g, R) row per glacier, Σr² the loss; and the residuals are the
    JAX package's, element for element. 1e-10."""
    r_j, r_t, loss = _residual_case(truth, None, None)
    assert r_t.shape == tuple(np.shape(r_j)) and r_t.shape[0] == 2
    assert_rel(torch.sum(r_t * r_t), loss.detach(), 1e-10, "Σr²")
    assert_rel(r_t, r_j, 1e-10, "residuals")


def _cases():
    import odinn_tpu.losses.losses as JL
    import odinn_tpu.losses.regularization as JR
    import odinn_tpu.losses.time_aggregated as JT
    import odinn_tpu_torch.losses.losses as TL
    import odinn_tpu_torch.losses.regularization as TR
    import odinn_tpu_torch.losses.time_aggregated as TT

    return {
        "HV": (lambda L, R, T: L.MultiLoss((L.LossHV(),), (1.0,)), dict(velocities=True)),
        "log": (lambda L, R, T: L.MultiLoss((L.LossH(loss=L.LogSum()),), (1.0,)), {}),
        "dhdt-tikhonov": (lambda L, R, T: L.MultiLoss(
            (L.LossH(), T.LossDhdt(), R.InitialThicknessRegularization()), (1.0, 0.5, 1e-6)),
            dict(dhdt=True)),
        "V-abs": (lambda L, R, T: L.MultiLoss((L.LossV(component="abs", scale_loss=True),),
                                              (1.0,)), dict(velocities=True)),
    }, (JL, JR, JT), (TL, TR, TT)


@pytest.mark.parametrize("case", ["HV", "log", "dhdt-tikhonov", "V-abs"])
def test_residual_parity_hv_log_dhdt_tikhonov(truth, case):
    """The port of test_residual_parity_hv_log_dhdt_tikhonov: LossHV (xy
    velocities, scale_loss), LogSum thickness, LossDhdt with the Tikhonov
    H₀ term, |V| — the residuals equal the JAX package's and square-sum to
    the loss. 1e-10."""
    cases, jmods, tmods = _cases()
    make, kw = cases[case]
    r_j, r_t, loss = _residual_case(truth, make(*jmods), make(*tmods), **kw)
    assert float(loss) > 0.0
    assert_rel(torch.sum(r_t * r_t), loss.detach(), 1e-10, "Σr²")
    assert_rel(r_t, r_j, 1e-10, "residuals")


@pytest.mark.parametrize("restarts", [1, 2, 3])
@pytest.mark.parametrize("iters", [4, 40])
def test_cg_tree_matches_jax(iters, restarts):
    """_cg_tree on a fixed ill-conditioned SPD operator (κ ~ 1e6), with a
    Jacobi preconditioner and exact-residual restarts, iterate for iterate
    against the JAX package's: 1e-12 before convergence (4 iterations);
    after it (40) the iterations only churn rounding, which κ amplifies
    (measured ≤ 2.6e-11), so 1e-9, and both solve the system to 1e-8."""
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    a = q @ np.diag(np.logspace(0, 6, 6)) @ q.T
    b = rng.standard_normal(6)
    minv = 1.0 / np.diag(a)
    want = jgn._cg_tree(lambda v: {"x": jnp.asarray(a) @ v["x"]}, {"x": jnp.asarray(b)}, iters,
                        minv={"x": jnp.asarray(minv)}, restarts=restarts)["x"]
    at = torch.from_numpy(a)
    got = tgn._cg_tree(lambda v: {"x": at @ v["x"]}, {"x": torch.from_numpy(b)}, iters,
                       minv={"x": torch.from_numpy(minv)}, restarts=restarts)["x"]
    assert_rel(got, want, 1e-12 if iters == 4 else 1e-9, "x")
    if iters == 40:
        np.testing.assert_allclose(got.numpy(), np.linalg.solve(a, b), rtol=1e-8)


def _jax_probes(jtheta, n, key=jax.random.PRNGKey(0)):
    """The Rademacher probes of the JAX package's diag_estimate at ``key``."""
    leaves, tdef = jax.tree.flatten(jtheta)
    out = []
    for k in jax.random.split(key, n):
        ks = jax.random.split(k, len(leaves))
        out.append(jax.tree.unflatten(tdef, [jax.random.rademacher(kk, l.shape, l.dtype)
                                             for kk, l in zip(ks, leaves)]))
    return out


def _lm_problem(truth, solver):
    """(JAX θ, batch, residual map; port batch, residual map) of the
    classical per-glacier A."""
    from odinn_tpu.models.model import init_theta

    jp, tp = _params(JP, solver), _params(TP, solver)
    jbatch = j_stack([g.replace(velocity_data=None) for g in truth])
    jmodel, tmodel = _models(jp, tp, nn=False)
    jtheta = init_theta(jmodel, jbatch)
    jres = jgn.make_residual_fn(jmodel, jp, jinv.assemble_tstops(jp, jbatch))
    batch = carry_glacier(jbatch)
    tres = tgn.make_residual_fn(tmodel, tp, tinv.assemble_tstops(tp, batch))
    return jtheta, jbatch, jres, batch, tres


def test_lm_rejects_minibatching(truth):
    """LM stages need the full batch (the JAX package's ValueError)."""
    jp, tp = _params(JP), _params(TP)
    tp = tp.replace(hyper=dataclasses.replace(tp.hyper, batch_size=1))
    _, tmodel = _models(jp, tp)
    inv = tinv.Inversion(model=tmodel, glaciers=carry_glacier(j_stack(truth)), parameters=tp,
                         device=CPU)
    with pytest.raises(ValueError, match="full-batch"):
        tinv.run_inversion(inv)


def test_lm_rejects_unsupported_losses(truth):
    """A term with no least-squares residual form raises with a remedy."""

    class OddLoss:
        kind = "transient"

        def __call__(self, ctx, H_pred, t):
            return torch.sum(H_pred) ** 3

    tp = _params(TP, loss=TP.UDEParameters().empirical_loss_function)
    tp = tp.replace(UDE=TP.UDEParameters(grad="jax", target="A",
                                         empirical_loss_function=tinv.MultiLoss(
                                             (OddLoss(),), (1.0,))))
    _, tmodel = _models(_params(JP), tp)
    batch = carry_glacier(j_stack(truth))
    theta = tmodel.iceflow.A.init_theta(batch, torch.float64)
    resid = tgn.make_residual_fn(tmodel, tp, tinv.assemble_tstops(tp, batch))
    with pytest.raises(NotImplementedError, match="grad='jax'"):
        resid({"A": theta}, batch)


def test_glacier_norm_lm_records_unnormalized_losses(truth):
    """With gn_glacier_norm the LM stage weights each glacier's rows by its
    inverse loss but records the true loss: each LM record is the true
    loss of the θ recorded with it, the trace continues Adam's scale, and
    the final loss is the trace's least (the port of the JAX test)."""
    tp = _params(TP, "SI", optimizer=("adam", "lm"), lr=(0.05, 1e-2), epochs=(3, 2),
                 gn_glacier_norm=True, gn_cg_iters=5)
    _, tmodel = _models(_params(JP), tp, nn=False)
    batch = carry_glacier(j_stack([g.replace(velocity_data=None) for g in truth]))
    inv = tinv.Inversion(model=tmodel, glaciers=batch, parameters=tp, device=CPU)
    res = tinv.train_ude(inv, record_theta_hist=True)
    L = np.asarray(res.stats.losses)
    assert L.shape[0] == 3 + 3
    assert L[3] <= L[2] * 10.0
    assert res.stats.final_loss <= L.min() * (1 + 1e-6)
    tts = tinv.assemble_tstops(tp, batch)
    for k in (3, 5):
        th = {key: torch.from_numpy(v) for key, v in res.stats.theta_hist[k].items()}
        with torch.no_grad():
            true = float(tinv.batch_transient_loss(th, batch, tmodel, tp, tts))
        assert abs(L[k] - true) <= 1e-12 * true
    assert all(t > 0 for t in res.stats.time_per_iter[3:])
    assert len(set(res.stats.time_per_iter[3:])) == 1
