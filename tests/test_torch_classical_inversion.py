"""odinn_tpu_torch's classical inversion against odinn_tpu's.

The per-glacier laws (``LawA_inversion``, ``LawC_inversion``,
``LawN_inversion``, scalar and gridded) and the NN sliding law ``LawC``;
``forward_batch`` from a trainable initial condition and with a different
Glen n per glacier; ``batch_transient_loss`` with initial-state and
time-aggregated terms and its autograd gradient against ``jax.grad``,
through the SI (fused step) and RKC (fused step) solves; and three Adam
steps of ``run_inversion`` (trainable H₀; gridded A with
``RheologyRegularization``) against the JAX package's ``train_ude``.
Two 24² Halfar glaciers, 3 monthly intervals, float64 on the CPU; loss to
1e-10 and gradients to 1e-9 relative unless a test says otherwise.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu.laws.laws as JL
import odinn_tpu.losses.regularization as JR
import odinn_tpu.losses.time_aggregated as JT
import odinn_tpu.models.initial_condition as JIC
import odinn_tpu_torch.core.params as TP
import odinn_tpu_torch.laws.laws as TL
import odinn_tpu_torch.losses.regularization as TR
import odinn_tpu_torch.losses.time_aggregated as TT
import odinn_tpu_torch.models.initial_condition as TIC
from odinn_tpu.losses.losses import LossH as JLossH, MultiLoss as JMultiLoss
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.models.nn import NeuralNetwork as JNeuralNetwork, default_architecture as j_arch
from odinn_tpu.simulation.inversion import (
    Inversion as JInversion, batch_transient_loss as j_loss, run_inversion as j_run_inversion)
from odinn_tpu.simulation.prediction import forward_batch as j_forward_batch
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.convert import mlp_from_numpy
from odinn_tpu_torch.inverse.vjps import rhs_with_theta
from odinn_tpu_torch.losses.losses import LossH, MultiLoss
from odinn_tpu_torch.models.model import Model, SIA2DModel, init_theta
from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
from odinn_tpu_torch.ops.cuda import si_kernel
from odinn_tpu_torch.simulation.inversion import (
    Inversion, assemble_tstops, batch_transient_loss, run_inversion)
from odinn_tpu_torch.simulation.prediction import forward_batch
from tests.torch_parity import (
    CLASSICAL_TSPAN, CPU, MAX_C, assert_rel, assert_tree_rel, carry_glacier, classical_params,
    classical_truth, per_glacier_const_law, theta_to_port)

TSTOPS = j_tstops(CLASSICAL_TSPAN, 1.0 / 12.0)


@pytest.fixture(scope="module", autouse=True)
def flush_denormals():
    """XLA:CPU flushes subnormal results to zero, PyTorch on the CPU keeps
    them: the semi-implicit step leaves values of ~1e-320 on a few ice-free
    cells that the JAX package's step leaves at 0, and the dh/dt loss's
    mask (H > 0 at t₂) reads them. Both packages flush here."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def truth():
    """Cuffey–Paterson ground truth with thickness, dh/dt and the annual
    mean-velocity product."""
    return classical_truth(store=("H", "dhdt", "avgV"))


def _ic_theta(jbatch, filt="Zang1980", seed=0):
    """θ_IC: the Farinotti start of the JAX package, moved by smooth noise
    on the ice."""
    th = JIC.InitialCondition(filter=filt).init_theta(jbatch)
    noise = 4.0 * np.random.default_rng(seed).standard_normal(th.shape)
    return th + jnp.asarray(noise) * (jbatch.H0 > 0.0)


# ---------------------------------------------------------------------------
# Laws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("law,scalar", [("A", True), ("A", False), ("C", True), ("C", False),
                                        ("n", True)])
def test_inversion_laws_match_jax(truth, law, scalar):
    """The law's value for a subset of glaciers (glacier_idx) and its
    init_theta's shape, against the JAX law."""
    jb, tb = truth
    jp, tp = classical_params(JP), classical_params(TP)
    if law == "n":
        jlaw, tlaw = JL.LawN_inversion(jp), TL.LawN_inversion(tp)
    else:
        jlaw = getattr(JL, f"Law{law}_inversion")(jp, scalar=scalar)
        tlaw = getattr(TL, f"Law{law}_inversion")(tp, scalar=scalar)
    assert (tlaw.slot, tlaw.name, tlaw.trainable, tlaw.callback_freq) == (
        jlaw.slot, jlaw.name, jlaw.trainable, jlaw.callback_freq)
    shape = tuple(jlaw.init_theta(jb).shape)
    th0 = tlaw.init_theta(tb)
    assert tuple(th0.shape) == shape and th0.dtype == torch.float64 and not th0.any()
    assert tlaw.init_theta([carry_glacier(jb)], torch.float32).dtype == torch.float32
    raw = np.random.default_rng(1).standard_normal(shape) * 2.0
    idx = np.array([1, 0, 1])
    out = tlaw.apply({law: torch.from_numpy(raw)}, {"glacier_idx": torch.from_numpy(idx)})
    ref = jlaw.apply({law: jnp.asarray(raw)}, {"glacier_idx": jnp.asarray(idx)})
    assert_rel(out, ref, 1e-12, f"Law{law}_inversion")


def test_law_c_wiring():
    """LawC (NN sliding law): its staggered-grid value in [min_C, max_C] and
    the gradient of Σ(RHS)² with respect to its MLP, against the JAX
    package's (the port of tests/test_trainable_cn.py::test_nn_c_law_wiring)."""
    from odinn_tpu.data.synthetic import halfar_glacier, monthly_dummy_climate
    from odinn_tpu.inverse.vjps import rhs_with_theta as j_rhs
    from odinn_tpu.laws.laws import eval_law as j_eval_law
    from odinn_tpu_torch.laws.laws import eval_law

    clim = monthly_dummy_climate(4.0, 24, temp_mean=2.0, nx=24, ny=24)
    g = halfar_glacier(nx=24, ny=24, dx=170.0, temp=-15.0, A=6.5e-18, climate=clim)
    g = g.replace(B=g.B + 1500.0 + 40.0 * jnp.sin(g.coords_x / 400.0)[:, None])
    jp, tp = classical_params(JP), classical_params(TP)
    arch = j_arch(2, light=True)
    jlaw = JL.LawC(JNeuralNetwork(arch, seed=7), jp)
    tlaw = TL.LawC(NeuralNetwork(default_architecture(2, light=True)), tp)
    jtheta = {"C": JNeuralNetwork(arch, seed=7).init()}
    ttheta = {"C": mlp_from_numpy([{k: np.asarray(v) for k, v in layer.items()}
                                   for layer in jtheta["C"]], device=CPU)}
    tg = carry_glacier(g)
    c_ref = j_eval_law(jlaw, jtheta, g, state=g.H0, t=5.0)
    c_val = eval_law(tlaw, ttheta, tg, state=tg.H0, t=5.0)
    assert tuple(c_val.shape) == (23, 23)
    assert 0.0 <= float(c_val.min()) and float(c_val.max()) <= MAX_C
    assert_rel(c_val, c_ref, 1e-12, "C")

    jmodel = JModel(iceflow=JSIA2DModel(A=JL.ConstantA(6.5e-18), C=jlaw))
    tmodel = Model(iceflow=SIA2DModel(A=TL.ConstantA(6.5e-18), C=tlaw))
    jgrad = jax.grad(lambda th: jnp.sum(j_rhs(g.H0, th, g, 0, jmodel, jp, 5.0) ** 2))(jtheta)
    leaves = [layer[k].requires_grad_(True) for layer in ttheta["C"] for k in ("w", "b")]
    val = torch.sum(rhs_with_theta(tg.H0, ttheta, tg, tmodel, tp, 5.0) ** 2)
    grads = torch.autograd.grad(val, leaves)
    for a, b in zip(grads, [layer[k] for layer in jgrad["C"] for k in ("w", "b")]):
        assert_rel(a, np.asarray(b), 1e-9, "∂/∂θ_C")
    assert max(float(a.abs().max()) for a in grads) > 0.0


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["IC SI", "IC RKC", "per-glacier n SI"])
def test_forward_batch_matches_jax(truth, case, monkeypatch):
    """forward_batch from H₀ = σ(θ_IC), and with LawN_inversion giving each
    glacier its own n (the SI step's exponents are numbers, so the batch
    takes the unfused path; the fused step is not called)."""
    jb, tb = truth
    solver = case.split()[-1]
    jp, tp = classical_params(JP, solver), classical_params(TP, solver)
    calls = []
    real = si_kernel._forward
    monkeypatch.setattr(si_kernel, "_forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    if case.startswith("IC"):
        jic, tic = (JIC.InitialCondition(filter="Zang1980"),
                    TIC.InitialCondition(filter="Zang1980"))
        jm = JModel(iceflow=JSIA2DModel(A=JL.LawA_inversion(jp), n_value=3.0),
                    initial_condition=jic)
        tm = Model(iceflow=SIA2DModel(A=TL.LawA_inversion(tp), n_value=3.0),
                   initial_condition=tic)
        jtheta = {"A": jnp.asarray([0.3, -0.2]), "IC": _ic_theta(jb)}
    else:
        jm = JModel(iceflow=JSIA2DModel(
            A=per_glacier_const_law(JL.Law, "A", (2e-18, 1e-18), jax=True),
            n=JL.LawN_inversion(jp)))
        tm = Model(iceflow=SIA2DModel(A=per_glacier_const_law(TL.Law, "A", (2e-18, 1e-18)),
                                      n=TL.LawN_inversion(tp)))
        jtheta = {"n": jnp.asarray([-0.4, 0.5])}
    ref = j_forward_batch(jtheta, jb, jm, jp, TSTOPS)
    out = forward_batch(theta_to_port(jtheta), tb, tm, tp, TSTOPS, device=CPU)
    assert_rel(out, ref, 1e-10, case)
    if case.startswith("IC"):
        assert_rel(out[:, 0], JIC.sigma_zang(jtheta["IC"]), 1e-12, "H(t₀)")
    assert len(calls) == (6 if case == "IC SI" else 0)


# ---------------------------------------------------------------------------
# The loss and its gradient
# ---------------------------------------------------------------------------

def _loss_pair(which):
    if which == "initial":
        return (JMultiLoss((JLossH(), JR.InitialThicknessRegularization()), (1.0, 1e-2)),
                MultiLoss((LossH(), TR.InitialThicknessRegularization()), (1.0, 1e-2)))
    return (JMultiLoss((JLossH(), JT.LossDhdt(), JT.LossAvgV()), (1.0, 0.5, 0.2)),
            MultiLoss((LossH(), TT.LossDhdt(), TT.LossAvgV()), (1.0, 0.5, 0.2)))


@pytest.mark.parametrize("solver", ["SI", "RKC"])
@pytest.mark.parametrize("which", ["initial", "aggregate"])
def test_batch_transient_loss_with_terms_matches_jax(truth, solver, which):
    """θ = {A (per glacier), IC}: the loss with its initial-state (Tikhonov
    on H₀) or aggregate (dh/dt, mean velocity) terms and its autograd
    gradient against jax.value_and_grad."""
    jb, tb = truth
    jl, tl = _loss_pair(which)
    jp, tp = classical_params(JP, solver, loss=jl), classical_params(TP, solver, loss=tl)
    jm = JModel(iceflow=JSIA2DModel(A=JL.LawA_inversion(jp), n_value=3.0),
                initial_condition=JIC.InitialCondition(filter="Zang1980"))
    tm = Model(iceflow=SIA2DModel(A=TL.LawA_inversion(tp), n_value=3.0),
               initial_condition=TIC.InitialCondition(filter="Zang1980"))
    jtheta = {"A": jnp.asarray([0.3, -0.2]), "IC": _ic_theta(jb)}
    ts = j_tstops(CLASSICAL_TSPAN, 1.0 / 12.0)
    val_j, grad_j = jax.value_and_grad(lambda th: j_loss(th, jb, jm, jp, ts))(jtheta)
    ttheta = {k: v.requires_grad_(True) for k, v in theta_to_port(jtheta).items()}
    tstops = assemble_tstops(tp, tb)
    np.testing.assert_allclose(tstops.numpy(), np.asarray(ts), rtol=0, atol=1e-12)
    val = batch_transient_loss(ttheta, tb, tm, tp, tstops)
    grads = torch.autograd.grad(val, list(ttheta.values()))
    assert_rel(val, val_j, 1e-10, "loss")
    assert_tree_rel(dict(zip(ttheta, grads)), grad_j, 1e-9, "gradient")
    assert float(grads[1].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["IC", "gridded A"])
def test_run_inversion_follows_train_ude(truth, case):
    """Three Adam steps of run_inversion (autograd through the SI solve):
    the losses and the trained θ of the JAX package's train_ude, with a
    trainable H₀ (+ Tikhonov on H₀) or a gridded A (+ Tikhonov on A)."""
    jb, tb = truth
    hyper = dict(optimizer=("adam",), learning_rate=(0.05,), epochs=(3,), batch_size=2)
    if case == "IC":
        jl = JMultiLoss((JLossH(), JR.InitialThicknessRegularization()), (1.0, 1e-2))
        tl = MultiLoss((LossH(), TR.InitialThicknessRegularization()), (1.0, 1e-2))
    else:
        reg = dict(min_A=8e-21, max_A=2e-18)
        # the Tikhonov term of a rough A (~1e-18 over 200 m cells) is ~3e-41:
        # weighted to the size of the thickness loss
        jl = JMultiLoss((JLossH(), JR.RheologyRegularization(**reg)), (1.0, 1e39))
        tl = MultiLoss((LossH(), TR.RheologyRegularization(**reg)), (1.0, 1e39))
    jp, tp = (classical_params(JP, "SI", loss=jl, **hyper),
              classical_params(TP, "SI", loss=tl, **hyper))
    if case == "IC":
        jm = JModel(iceflow=JSIA2DModel(A=JL.LawA_inversion(jp), n_value=3.0),
                    initial_condition=JIC.InitialCondition(filter="softplus"))
        tm = Model(iceflow=SIA2DModel(A=TL.LawA_inversion(tp), n_value=3.0),
                   initial_condition=TIC.InitialCondition(filter="softplus"))
    else:
        jm = JModel(iceflow=JSIA2DModel(A=JL.LawA_inversion(jp, scalar=False), n_value=3.0))
        tm = Model(iceflow=SIA2DModel(A=TL.LawA_inversion(tp, scalar=False), n_value=3.0))
    jinv = JInversion(model=jm, glaciers=jb, parameters=jp)
    jtheta = dict(jinv.theta)
    rough = 0.2 * np.random.default_rng(3).standard_normal(jtheta["A"].shape)
    jtheta["A"] = jtheta["A"] + 0.3 + jnp.asarray(rough)
    jinv.theta = jtheta
    jres = j_run_inversion(jinv)
    tinv = Inversion(model=tm, glaciers=tb, parameters=tp, theta=theta_to_port(jtheta),
                     device=CPU)
    assert set(init_theta(tm, tb)) == set(jtheta)
    tres = run_inversion(tinv)
    assert len(tres.stats.losses) == 3 and tres.stats.losses[-1] < tres.stats.losses[0]
    assert_rel(np.asarray(tres.stats.losses), np.asarray(jres.stats.losses), 1e-9, "losses")
    assert_tree_rel(tinv.theta, jres.stats.theta, 1e-9, "θ")
    if case == "IC":
        assert tres.stats.initial_conditions is tinv.theta["IC"]
    else:
        assert tres.stats.initial_conditions is None
