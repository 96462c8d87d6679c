"""odinn_tpu_torch's training path against odinn_tpu: the MLP and LawA
through the parameter converter, the transient loss and its gradient
through the RKC (fused step), RK4 and SI/SI2 (fused step) solves, Adam
against optax, and a
smoke inversion with the JAX package's convergence gate. Float64 on the
CPU; tolerances are stated per test.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson, LawA as JLawA
from odinn_tpu.models.model import Model as JModel, SIA2DModel as JSIA2DModel
from odinn_tpu.models.nn import (
    MLP as JMLP, NeuralNetwork as JNeuralNetwork, default_architecture as j_arch,
    mlp_apply as j_mlp_apply)
from odinn_tpu.simulation.inversion import batch_transient_loss as j_loss
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.convert import mlp_from_numpy
from odinn_tpu_torch.data.synthetic import halfar_glacier as t_halfar
from odinn_tpu_torch.laws.laws import CuffeyPaterson, LawA
from odinn_tpu_torch.losses.losses import LossH, MultiLoss
from odinn_tpu_torch.models.model import Model, SIA2DModel, init_theta
from odinn_tpu_torch.models.nn import MLP, NeuralNetwork, default_architecture, mlp_apply
from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel
from odinn_tpu_torch.simulation.inversion import (
    Inversion, assemble_tstops, batch_transient_loss, run_inversion)
from odinn_tpu_torch.simulation.prediction import generate_ground_truth
from odinn_tpu_torch.simulation.solver import build_tstops
from tests.torch_parity import CPU, assert_rel, carry_glacier

TSPAN = (5.0, 5.0 + 4.0 / 12.0)     # 4 monthly intervals


def _port_mlp(jax_params, arch=None):
    """JAX MLP parameters → numpy → the port's tree, on the CPU."""
    return mlp_from_numpy([{k: np.asarray(v) for k, v in layer.items()} for layer in jax_params],
                          arch, device=CPU)


@pytest.mark.parametrize("arch", [j_arch(1), j_arch(1, light=True),
                                  JMLP((2, 5, 4, 1), ("tanh", "gelu", "relu")),
                                  JMLP((3, 4, 2), ("identity", "softplus"))])
def test_mlp_round_trip(arch):
    """JAX MLP params → numpy → port θ gives the same mlp_apply output."""
    params = JNeuralNetwork(arch, seed=3).init()
    x = np.random.default_rng(0).standard_normal((7, arch.n_in)) * 20.0
    ref = j_mlp_apply(arch, params, jnp.asarray(x))
    t_arch = MLP(arch.widths, arch.activations)
    out = mlp_apply(t_arch, _port_mlp(params, t_arch), torch.from_numpy(x))
    assert_rel(out, ref, 1e-12)


def test_mlp_from_numpy_checks_shapes():
    params = [{k: np.asarray(v) for k, v in layer.items()}
              for layer in JNeuralNetwork(j_arch(1)).init()]
    with pytest.raises(ValueError, match="layers"):
        mlp_from_numpy(params[:-1], default_architecture(1), device=CPU)
    params[1]["w"] = params[1]["w"].T
    with pytest.raises(ValueError, match="layer 1"):
        mlp_from_numpy(params, default_architecture(1), device=CPU)


def test_init_mlp_is_glorot_from_the_generator():
    arch = default_architecture(1)
    a, b = NeuralNetwork(arch, seed=5).init(), NeuralNetwork(arch, seed=5).init()
    for la, lb, fi, fo in zip(a, b, arch.widths[:-1], arch.widths[1:]):
        assert torch.equal(la["w"], lb["w"]) and la["w"].shape == (fi, fo)
        assert float(la["w"].abs().max()) <= (6.0 / (fi + fo)) ** 0.5
        assert torch.equal(la["b"], torch.zeros(fo, dtype=torch.float64))


@pytest.mark.parametrize("head,prescale,n_fourier", [
    ("sigmoid", None, None), ("log", None, None), ("sigmoid", ((-25.0, 0.0),), None),
    ("log", ((-25.0, 0.0),), 2),
])
def test_law_a_matches(head, prescale, n_fourier):
    jp, tp = JP.Parameters(), TP.Parameters()
    arch = JMLP((2 * n_fourier, 6, 1), ("tanh", "sigmoid")) if n_fourier else j_arch(1)
    t_arch = MLP(arch.widths, arch.activations)
    kw = dict(head=head, prescale_bounds=prescale, n_fourier=n_fourier)
    jlaw = JLawA(JNeuralNetwork(arch), jp, **kw)
    tlaw = LawA(NeuralNetwork(t_arch), tp, **kw)
    jtheta = {"A": JNeuralNetwork(arch).init()}
    temps = np.array([-25.0, -19.5, -13.0, -4.0])
    ref = jlaw.apply(jtheta, {"T": jnp.asarray(temps)})
    out = tlaw.apply({"A": _port_mlp(jtheta["A"], t_arch)}, {"T": torch.from_numpy(temps)})
    assert_rel(out, ref, 1e-12)
    assert tlaw.callback_freq == 0.0 and tlaw.trainable


def _params(P, solver):
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=2e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, use_velocities=False),
        solver=solver,
        hyper=P.Hyperparameters(optimizer=("adam", "lbfgs"), learning_rate=(0.08, 1.0),
                                epochs=(12, 4)),
        UDE=P.UDEParameters(grad="jax"))


def _solvers(P, method):
    if method == "RKC":
        return P.SolverParameters(step=1.0 / 12.0, substeps=1, solver="RKC", rkc_stages=6)
    if method in ("SI", "SI2"):
        return P.SolverParameters(step=1.0 / 12.0, substeps=1, solver=method, cg_iters=10,
                                  cg_iters_predictor=4)
    return P.SolverParameters(step=1.0 / 12.0, substeps=2, solver="RK4")


@pytest.fixture(scope="module")
def truth():
    """Two 24² Halfar glaciers with Cuffey–Paterson ground truth (JAX)."""
    jp = _params(JP, _solvers(JP, "RK4"))
    gl = [j_halfar(nx=24, ny=24, dx=200.0, h0=150.0, r0=1600.0, temp=t, rgi_id=f"g{i}")
          for i, t in enumerate((-27.0, -32.0))]
    gl = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())),
                        j_tstops(TSPAN, 1.0 / 12.0), store=("H",))
    return j_stack(gl)


@pytest.mark.parametrize("method", ["RKC", "RK4", "SI", "SI2"])
def test_batch_transient_loss_value_and_grad_match(truth, method, monkeypatch):
    """Loss and θ-gradient through the whole solve against
    jax.value_and_grad of the JAX package's batch_transient_loss: 2
    glaciers, 24², 4 monthly intervals, RKC at s = 6 (each step one fused
    RKC step, its backward the stage-by-stage pullback), RK4 at 2 substeps
    (each RHS the fused RHS, its backward the RHS pullback), and SI and SI2
    at PCG-10 (predictor PCG-4; each solve one fused SI step, its backward
    one transpose solve and one pullback, the JAX package's
    implicit-function adjoint). Float64, 1e-9 relative."""
    jp, tp = _params(JP, _solvers(JP, method)), _params(TP, _solvers(TP, method))
    arch = j_arch(1)
    jmodel = JModel(iceflow=JSIA2DModel(A=JLawA(JNeuralNetwork(arch), jp)))
    jtheta = {"A": JNeuralNetwork(arch).init()}
    ts = j_tstops(TSPAN, 1.0 / 12.0)
    val_j, grad_j = jax.value_and_grad(lambda th: j_loss(th, truth, jmodel, jp, ts))(jtheta)

    steps, si_ran = [], []
    forward = rkc_kernel._forward
    monkeypatch.setattr(rkc_kernel, "_forward",
                        lambda *a, **k: steps.append(1) or forward(*a, **k))
    for name in ("_forward", "si_step_transpose_reference", "si_step_vjp_reference"):
        real = getattr(si_kernel, name)
        monkeypatch.setattr(si_kernel, name,
                            lambda *a, _r=real, _n=name, **k: si_ran.append(_n) or _r(*a, **k))
    batch = carry_glacier(truth)
    tmodel = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1)), tp)))
    ttheta = {"A": _port_mlp(jtheta["A"])}
    leaves = [layer[k].requires_grad_(True) for layer in ttheta["A"] for k in ("w", "b")]
    tstops = assemble_tstops(tp, batch)
    np.testing.assert_allclose(tstops.numpy(), np.asarray(ts), rtol=0, atol=1e-12)
    val = batch_transient_loss(ttheta, batch, tmodel, tp, tstops)
    grads = torch.autograd.grad(val, leaves)
    # the fused RKC step ran once per interval forward and once more per
    # interval to rematerialise the stages in the backward; the fused SI
    # step once per solve (one a step for SI, two for SI2), and its backward
    # once per solve: one transpose solve and one pullback, nothing
    # rematerialised
    assert len(steps) == (8 if method == "RKC" else 0)
    solves = {"SI": 4, "SI2": 8}.get(method, 0)
    assert [si_ran.count(n) for n in ("_forward", "si_step_transpose_reference",
                                      "si_step_vjp_reference")] == [solves] * 3
    assert_rel(val, val_j, 1e-9, "loss")
    jleaves = [np.asarray(layer[k]) for layer in grad_j["A"] for k in ("w", "b")]
    for g, jg in zip(grads, jleaves):
        assert_rel(g, jg, 1e-9, "gradient")
    assert float(val.detach()) > 0.0


def test_adam_matches_optax():
    """Three Adam steps on the same θ and gradients: torch.optim.Adam does
    optax.adam's update (bias-corrected, eps outside the square root)."""
    rng = np.random.default_rng(4)
    theta = {"w": rng.standard_normal((3, 4)), "b": rng.standard_normal(4)}
    grads = [{k: rng.standard_normal(v.shape) for k, v in theta.items()} for _ in range(3)]
    opt = optax.adam(0.05)
    jt = {k: jnp.asarray(v) for k, v in theta.items()}
    state = opt.init(jt)
    tt = {k: torch.tensor(v, requires_grad=True) for k, v in theta.items()}
    topt = torch.optim.Adam(list(tt.values()), lr=0.05)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jt)
        jt = optax.apply_updates(jt, upd)
        for k, p in tt.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in theta:
        assert_rel(tt[k], jt[k], 1e-10, k)


def _smoke_inversion(temps=(-17.0,), **hyper):
    tp = _params(TP, TP.SolverParameters(step=1.0 / 12.0, substeps=1, solver="RKC",
                                         rkc_stages=8))
    tp = tp.replace(physical=TP.PhysicalParameters(min_A=8e-21, max_A=8e-18),
                    simulation=dataclasses.replace(tp.simulation, tspan=(5.0, 5.5)))
    if hyper:
        tp = tp.replace(hyper=dataclasses.replace(tp.hyper, **hyper))
    glaciers = [t_halfar(nx=24, ny=24, dx=200.0, temp=t, rgi_id="smoke", device=CPU)
                for t in temps]
    glaciers = generate_ground_truth(glaciers, tp, Model(iceflow=SIA2DModel(A=CuffeyPaterson())),
                                     build_tstops((5.0, 5.5), 1.0 / 12.0), store=("H",),
                                     device=CPU)
    model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1, light=True)),
                                            tp)))
    return Inversion(model=model, glaciers=glaciers, parameters=tp, device=CPU)


def test_functional_inversion_smoke():
    """Adam then LBFGS through the fused RKC step (its plain version on the
    CPU) must gain ≥ 100×, the gate of tests/test_inversion.py's smoke
    test; 1 glacier, 24², 6 monthly intervals."""
    inv = _smoke_inversion()
    results = run_inversion(inv)
    stats = results.stats
    assert np.isfinite(stats.losses).all()
    assert stats.final_loss < 1e-2 * stats.losses[0], (stats.losses[0], stats.final_loss)
    assert stats.niter == 16 and len(stats.grad_norm_hist) == 16
    assert stats.gradients >= 16 and stats.solves > stats.gradients
    assert results.simulation["H"].shape == (1, 7, 24, 24)
    assert inv.theta["A"][0]["w"].requires_grad is False


def test_init_theta_follows_the_law():
    inv = _smoke_inversion()
    theta = init_theta(inv.model, inv.glaciers, torch.float32)
    assert [tuple(layer["w"].shape) for layer in theta["A"]] == [(1, 3), (3, 1)]
    assert theta["A"][0]["w"].dtype == torch.float32
    assert inv.theta["A"][0]["w"].dtype == torch.float64   # simulation.float_dtype


@pytest.mark.parametrize("what", ["forward", "lm", "dummy", "save", "auto", "periodic law",
                                  "hybrid-D model", "discrete D target",
                                  "DummyAdjoint", "adaptive"])
def test_unported_training_paths_name_their_slice(what):
    """The training paths that once raised, naming the slice (the
    ROADMAP.md Queue 1 item) that brought them, now run: saving (item 8)
    writes the result, which reloads to the trained θ with the run's
    metadata; a periodic law trains by autograd and the
    manual adjoints refuse it, naming grad='jax'; a Y law builds the
    hybrid-D target; a capped (D) target trains by the discrete adjoint;
    substeps="auto" is sized before training; adaptive=True is refused as
    the JAX package refuses it, forward-only; an LM stage and the dummy
    gradient (grad="dummy" or a DummyAdjoint) train; and grad="forward"
    refuses this NN θ as the JAX package does, naming per-glacier scalar
    θ."""
    from odinn_tpu_torch.inverse.adjoint_types import DummyAdjoint
    from odinn_tpu_torch.laws.laws import Law
    from odinn_tpu_torch.physics.targets import CappedTarget, DHybridTarget

    inv = _smoke_inversion(epochs=(1, 1))
    p = inv.parameters

    if what == "periodic law":
        law = dataclasses.replace(inv.model.iceflow.A, callback_freq=1.0)
        inv.model = Model(iceflow=SIA2DModel(A=law))
        assert np.isfinite(run_inversion(inv).stats.losses).all()
        inv.parameters = p.replace(UDE=dataclasses.replace(p.UDE, grad="discrete"))
        with pytest.raises(NotImplementedError, match="grad='jax'"):
            run_inversion(inv)
        return
    if what == "hybrid-D model":
        # a Y law (LawY's slot) makes the hybrid-D target
        y_law = Law(slot="Y", apply_fn=lambda th, inp: inp["Hbar"], callback_freq=None,
                    trainable=False, name="Y")
        assert isinstance(Model(iceflow=SIA2DModel(A=inv.model.iceflow.A, Y=y_law)).target,
                          DHybridTarget)
        return
    if what == "discrete D target":
        # a capped diffusivity trains by the discrete adjoint
        inv.model = Model(iceflow=SIA2DModel(A=inv.model.iceflow.A, max_D=1e5))
        assert isinstance(inv.model.target, CappedTarget)
        inv.parameters = p.replace(UDE=dataclasses.replace(p.UDE, grad="discrete"))
        assert np.isfinite(run_inversion(inv).stats.losses).all()
        return
    if what == "adaptive":
        inv.parameters = p.replace(solver=dataclasses.replace(p.solver, adaptive=True))
        with pytest.raises(ValueError, match="forward-only"):
            run_inversion(inv)
        return
    if what == "auto":
        inv.parameters = p.replace(solver=dataclasses.replace(p.solver, substeps="auto"))
        assert np.isfinite(run_inversion(inv).stats.losses).all()
        assert isinstance(inv.parameters.solver.substeps, int)
        return
    if what == "forward":
        inv.parameters = p.replace(UDE=dataclasses.replace(p.UDE, grad=what))
        with pytest.raises(ValueError, match="per-glacier SCALAR"):
            run_inversion(inv)
        return
    if what in ("dummy", "DummyAdjoint", "lm"):
        if what == "dummy":
            inv.parameters = p.replace(UDE=dataclasses.replace(p.UDE, grad=what))
        elif what == "DummyAdjoint":
            inv.parameters = p.replace(UDE=dataclasses.replace(p.UDE, grad=DummyAdjoint()))
        else:
            inv.parameters = p.replace(hyper=dataclasses.replace(
                p.hyper, optimizer=("lm",), learning_rate=(1e-3,), epochs=(1,)))
        assert np.isfinite(run_inversion(inv).stats.losses).all()
        return
    assert what == "save"
    from odinn_tpu_torch.utils.io import load_inversion_file

    with tempfile.TemporaryDirectory() as tmp:
        results = run_inversion(inv, path=tmp, file_name="smoke.pt")
        back = load_inversion_file(os.path.join(tmp, "smoke.pt"), device=CPU)
    for a, b in zip(jax.tree.leaves(back.theta), jax.tree.leaves(inv.theta)):
        assert torch.equal(a, b)
    assert back.params_meta == {"niter": 2, "final_loss": results.stats.final_loss,
                                "retcode": "Success"}
    np.testing.assert_array_equal(back.losses.numpy(), results.stats.losses)


@pytest.mark.parametrize("grad", ["jax", "discrete", "continuous"])
def test_initial_state_terms_now_train(grad):
    """The loss configurations the port refused until the loss-terms slice
    (a thickness loss with an initial-state regularization) train by
    autograd and by both hand-written adjoints: finite losses, one per
    epoch, the term's share in the loss."""
    from odinn_tpu_torch.inverse.adjoint_types import ContinuousAdjoint
    from odinn_tpu_torch.losses.regularization import InitialThicknessRegularization

    inv = _smoke_inversion(optimizer=("adam",), learning_rate=(0.08,), epochs=(2,))
    p = inv.parameters
    reg = InitialThicknessRegularization()
    inv.parameters = p.replace(UDE=dataclasses.replace(
        p.UDE, grad=ContinuousAdjoint() if grad == "continuous" else grad,
        empirical_loss_function=MultiLoss(terms=(LossH(), reg), weights=(1.0, 1e3))))
    stats = run_inversion(inv).stats
    assert stats.niter == 2 and np.isfinite(stats.losses).all()
    tstops = assemble_tstops(p, inv.glaciers)
    plain = float(batch_transient_loss(inv.theta, inv.glaciers, inv.model, p, tstops))
    with_reg = float(batch_transient_loss(inv.theta, inv.glaciers, inv.model,
                                          inv.parameters, tstops))
    assert with_reg > plain > 0.0


def test_chunked_gradient_equals_full_batch(truth):
    """hyper.grad_accum_chunks = 2 sums the exact per-chunk losses and
    gradients (each chunk a gathered sub-batch): the full-batch value and
    gradient to roundoff."""
    from odinn_tpu.simulation.inversion import gather_batch as j_gather
    from odinn_tpu_torch.simulation.inversion import _make_grad_fn, gather_batch
    from odinn_tpu_torch.simulation.results import TrainingStats

    batch = carry_glacier(truth)
    one = gather_batch(batch, [1])
    ref = j_gather(truth, jnp.asarray([1]))
    assert_rel(one.thickness_data.H, ref.thickness_data.H, 0.0)
    assert one.rgi_id == batch.rgi_id and one.H0.shape[0] == 1
    tp = _params(TP, _solvers(TP, "RKC"))
    model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1)), tp)))
    theta = {"A": [{k: v.requires_grad_(True) for k, v in layer.items()}
                   for layer in NeuralNetwork(default_architecture(1)).init()]}
    tstops = assemble_tstops(tp, batch)
    results = []
    for chunks in (1, 2):
        inv = Inversion(model=model, glaciers=batch, theta=theta, device=CPU,
                        parameters=tp.replace(hyper=dataclasses.replace(
                            tp.hyper, grad_accum_chunks=chunks)))
        stats = TrainingStats()
        vg = _make_grad_fn(inv, lambda th, b: batch_transient_loss(th, b, model, tp, tstops),
                           stats)
        results.append(vg(theta, batch))
        assert stats.gradients == chunks
    (v1, g1), (v2, g2) = results
    assert_rel(v2, v1, 1e-12)
    for a, b in zip(g2, g1):
        assert_rel(a, b, 1e-12)


def test_minibatch_adam_trains_on_subsets():
    """hyper.batch_size below the glacier count: each Adam step draws a
    subset of the batch (gather_batch), with no best-iterate tracking."""
    inv = _smoke_inversion(temps=(-17.0, -20.0), optimizer=("adam",), learning_rate=(0.08,),
                           epochs=(3,), batch_size=1)
    stats = run_inversion(inv).stats
    assert stats.niter == 3 and np.isfinite(stats.losses).all()
    assert (stats.solves, stats.gradients) == (4, 3)   # 3 steps and the final forward
    assert stats.final_loss is None


@pytest.mark.parametrize("store", [("H", "V", "dhdt"), ("avgV",)])
def test_generate_ground_truth_matches(store):
    """The observations generate_ground_truth attaches, against the JAX
    package's: thickness and velocity series, the mean dh/dt and the
    Δt-weighted annual velocity product; 2 glaciers, RK4, float64, 1e-10."""
    jp = _params(JP, _solvers(JP, "RK4"))
    tp = _params(TP, _solvers(TP, "RK4"))
    gl = [j_halfar(nx=24, ny=24, dx=200.0, h0=150.0, r0=1600.0, temp=t, rgi_id=f"v{i}")
          for i, t in enumerate((-27.0, -32.0))]
    ts = j_tstops(TSPAN, 1.0 / 12.0)
    ref = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())), ts,
                         store=store)
    out = generate_ground_truth([carry_glacier(g) for g in gl], tp,
                                Model(iceflow=SIA2DModel(A=CuffeyPaterson())),
                                build_tstops(TSPAN, 1.0 / 12.0), store=store, device=CPU)
    for r, o in zip(ref, out):
        if "H" in store:
            assert_rel(o.thickness_data.H, r.thickness_data.H, 1e-10, "H")
            np.testing.assert_allclose(o.thickness_data.t.numpy(), np.asarray(r.thickness_data.t))
        if "dhdt" in store:
            assert_rel(o.dhdt_data.dhdt, r.dhdt_data.dhdt, 1e-10, "dhdt")
        for f in ("vx", "vy", "vabs"):
            assert_rel(getattr(o.velocity_data, f), getattr(r.velocity_data, f), 1e-10, f)
        assert o.velocity_data.t.shape == np.asarray(r.velocity_data.t).shape
