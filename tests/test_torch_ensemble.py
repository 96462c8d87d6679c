"""odinn_tpu_torch's multi-start training (``simulation/ensemble.py``) and
its member fold against the JAX package's vmapped ``multistart_train``
(``odinn_tpu.simulation.ensemble``), float64, on the JAX test's problem
(tests/test_ensemble.py): 2 Halfar glaciers on 24² planes, SI at PCG-15,
3 intervals of two months.

The JAX package trains the restarts as one ``vmap`` axis; the port folds
them into the kernels' glacier axis. On the same θ stack both give the
same loss curves and final θ (1e-8 relative: Adam is optax's update in
both, the solves agree to roundoff); the fold's per-member losses and
gradients equal N separate single-start evaluations (1e-12), through SI
and RKC, with a per-glacier θ, a shared NN θ and an initial-state term
that reads θ; and the folded solve calls each kernel's plain version once
a step for all members. The LM refinement against the JAX package's is
in ``test_torch_ensemble_lm.py`` (its JAX compiles would take this file
past ~30 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odinn_tpu.core.params as JP
import odinn_tpu_torch.core.params as TP
from odinn_tpu.core.glacier import stack_glaciers as j_stack
from odinn_tpu.data.synthetic import halfar_glacier as j_halfar
from odinn_tpu.laws.laws import CuffeyPaterson as JCuffeyPaterson
from odinn_tpu.laws.laws import LawA as JLawA
from odinn_tpu.laws.laws import LawA_inversion as JLawA_inversion
from odinn_tpu.models.model import Model as JModel
from odinn_tpu.models.model import SIA2DModel as JSIA2DModel
from odinn_tpu.models.model import init_theta as j_init_theta
from odinn_tpu.models.nn import NeuralNetwork as JNN
from odinn_tpu.models.nn import default_architecture as j_arch
from odinn_tpu.simulation import ensemble as jens
from odinn_tpu.simulation.inversion import Inversion as JInversion
from odinn_tpu.simulation.prediction import generate_ground_truth as j_ground_truth
from odinn_tpu.simulation.solver import build_tstops as j_tstops
from odinn_tpu_torch.laws.laws import LawA as TLawA
from odinn_tpu_torch.laws.laws import LawA_inversion as TLawA_inversion
from odinn_tpu_torch.models.model import Model as TModel
from odinn_tpu_torch.models.model import SIA2DModel as TSIA2DModel
from odinn_tpu_torch.models.nn import NeuralNetwork as TNN
from odinn_tpu_torch.models.nn import default_architecture as t_arch
from odinn_tpu_torch.simulation import ensemble as tens
from odinn_tpu_torch.simulation import inversion as tinv
from odinn_tpu_torch.utils.flatten import stack_to_rows, tree_leaves, tree_map, tree_unflatten
from tests.torch_parity import (
    CPU, assert_rel, carry_glacier, count_kernel_plain_versions, tree_to_port)

TSPAN = (5.0, 5.5)


def _params(P, optimizer=("adam",), lr=(0.08,), epochs=(6,), solver="SI", loss=None):
    """tests/test_ensemble.py's setting: SI at PCG-15, 3 two-month
    intervals (RKC at s = 6 for the RKC fold)."""
    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=TSPAN, use_MB=False, test_mode=True),
        solver=P.SolverParameters(step=1.0 / 6.0, substeps=1, solver=solver, cg_iters=15,
                                  rkc_stages=12),
        hyper=P.Hyperparameters(optimizer=optimizer, learning_rate=lr, epochs=epochs,
                                batch_size=8),
        UDE=P.UDEParameters(grad="jax", target="A", empirical_loss_function=loss))


@pytest.fixture(scope="module")
def truth():
    """(JAX batch, port batch): the JAX test's two glaciers with
    Cuffey–Paterson ground truth of H."""
    jp = _params(JP)
    gl = [j_halfar(nx=24, ny=24, dx=150.0, temp=t, rgi_id=f"ms-{i}")
          for i, t in enumerate((-18.0, -12.0))]
    gl = j_ground_truth(gl, jp, JModel(iceflow=JSIA2DModel(A=JCuffeyPaterson())),
                        j_tstops(TSPAN, jp.solver.step), store=("H",))
    jb = j_stack(gl)
    return jb, carry_glacier(jb)


def _models(kind, jp, tp):
    if kind == "nn":
        return (JModel(iceflow=JSIA2DModel(A=JLawA(JNN(j_arch(1, light=True), seed=0), jp))),
                TModel(iceflow=TSIA2DModel(A=TLawA(TNN(t_arch(1, light=True)), tp))))
    return (JModel(iceflow=JSIA2DModel(A=JLawA_inversion(jp, scalar=True))),
            TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True))))


def _jax_thetas(kind, jmodel, jb, n, jp):
    """The JAX θ stack of ``n`` restarts: per-glacier A from
    ``init_restarts``, or NN draws of seeds 0 … n − 1 (the JAX test's)."""
    if kind == "nn":
        arch = j_arch(1, light=True)
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[
            j_init_theta(JModel(iceflow=JSIA2DModel(A=JLawA(JNN(arch, seed=k), jp))), jb)
            for k in range(n)])
    return jens.init_restarts(j_init_theta(jmodel, jb), n, 0.5, seed=1)


def _rows_jax(stack):
    return np.asarray(jax.vmap(lambda th: jax.flatten_util.ravel_pytree(th)[0])(stack))


@pytest.mark.parametrize("kind", ["per_glacier_A", "nn"])
def test_multistart_matches_jax(truth, kind):
    """The (N, epochs) loss curves, final losses, winner and final θ stack
    of 3 restarts × 6 Adam epochs, on JAX's explicit θ stack. 1e-8."""
    jb, tb = truth
    jp, tp = _params(JP), _params(TP)
    jmodel, tmodel = _models(kind, jp, tp)
    jthetas = _jax_thetas(kind, jmodel, jb, 3, jp)
    jms = jens.multistart_train(JInversion(model=jmodel, glaciers=jb, parameters=jp),
                                thetas=jthetas)
    inv = tinv.Inversion(model=tmodel, glaciers=tb, parameters=tp, device=CPU)
    ms = tens.multistart_train(inv, thetas=tree_to_port(jthetas))
    assert ms.losses.shape == jms.losses.shape == (3, 6)
    assert_rel(ms.losses, jms.losses, 1e-8, "loss curves")
    assert_rel(ms.final_losses, jms.final_losses, 1e-8, "final losses")
    assert ms.best_idx == jms.best_idx
    assert_rel(stack_to_rows(ms.thetas), _rows_jax(jms.thetas), 1e-8, "final θ")
    assert np.all(ms.losses[:, -1] < ms.losses[:, 0])
    assert ms.best_loss == ms.final_losses[ms.best_idx]
    for a, b in zip(tree_leaves(inv.theta), tree_leaves(ms.best_theta)):
        assert torch.equal(a, b)


def test_init_restarts_rules(truth):
    """Restart 0 is θ₀ exactly; each leaf's noise has the leaf's own
    population std (1 for a constant leaf) times init_scale; a seed repeats
    its draw and another seed draws another."""
    theta0 = {"A": torch.zeros(2, dtype=torch.float64),
              "w": torch.tensor([1.0, 3.0], dtype=torch.float64)}
    st = tens.init_restarts(theta0, 2000, init_scale=0.5, seed=3)
    for k in theta0:
        assert torch.equal(st[k][0], theta0[k])
        assert st[k].shape == (2000, 2) and st[k].dtype == torch.float64
    assert abs(float(torch.std(st["A"][1:])) - 0.5) < 0.03
    assert abs(float(torch.std(st["w"][1:] - theta0["w"])) - 0.5) < 0.03
    again = tens.init_restarts(theta0, 2000, init_scale=0.5, seed=3)
    other = tens.init_restarts(theta0, 2000, init_scale=0.5, seed=4)
    assert torch.equal(again["A"], st["A"]) and not torch.equal(other["A"], st["A"])


def test_select_best_skips_nan_restarts():
    """The JAX test's nan-safe winner selection."""
    assert tens.select_best([np.nan, 1.0]) == 1
    assert tens.select_best([1.0, np.nan]) == 0
    assert tens.select_best([np.inf, 3.0, 2.0, np.nan]) == 2
    with pytest.raises(FloatingPointError, match="diverged"):
        tens.select_best([np.nan, np.inf])


@pytest.mark.parametrize("stages,match", [
    ((("adam", "lbfgs"), (0.08, 1.0), (2, 2)), "Adam stages only"),
    ((("lbfgs", "adam"), (1.0, 0.08), (2, 2)), "Adam .exploration. stages FIRST"),
    ((("adam", "sgd"), (0.08, 0.1), (2, 2)), "unknown refinement stage"),
])
def test_stage_order_errors(truth, stages, match):
    """The JAX function's refusals, with its messages."""
    _, tb = truth
    tp = _params(TP, *stages)
    inv = tinv.Inversion(model=_models("A", _params(JP), tp)[1], glaciers=tb, parameters=tp,
                         device=CPU)
    with pytest.raises(ValueError, match=match):
        tens.multistart_train(inv, n_restarts=2)


def test_refine_top_k_lbfgs(truth):
    """Adam then LBFGS on the top 2 of 4 restarts, each survivor through
    train_ude's LBFGS stage: the refined winner is no worse than the Adam
    winner, and the installed θ evaluates to the reported loss."""
    _, tb = truth
    tp = _params(TP, ("adam", "lbfgs"), (0.08, 1.0), (4, 3))
    model = _models("A", _params(JP), tp)[1]
    inv = tinv.Inversion(model=model, glaciers=tb, parameters=tp, device=CPU)
    ms = tens.multistart_train(inv, n_restarts=4, seed=5, refine_top_k=2)
    assert ms.refined_idxs is not None and len(ms.refined_idxs) == 2
    assert np.isfinite(ms.refined_losses).all()
    assert ms.best_loss <= np.min(ms.final_losses)
    ts = tinv.assemble_tstops(tp, inv.glaciers)
    with torch.no_grad():
        val = float(tinv.batch_transient_loss(inv.theta, inv.glaciers, model, tp, ts))
    assert_rel(val, ms.best_loss, 1e-12, "installed θ")


def _fold_case(case, tb):
    """(model, params, θ stack of 3 members) of a fold case."""
    from odinn_tpu_torch.losses.losses import LossH, MultiLoss
    from odinn_tpu_torch.losses.regularization import RheologyRegularization

    if case == "SI per-glacier A":
        tp = _params(TP)
        model = TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=True)))
    elif case == "RKC NN":
        tp = _params(TP, solver="RKC")
        model = TModel(iceflow=TSIA2DModel(A=TLawA(TNN(t_arch(1, light=True)), tp)))
    else:   # a gridded A with a Tikhonov term on it, which reads θ
        loss = MultiLoss((LossH(), RheologyRegularization(min_A=8e-21, max_A=8e-18)),
                         (1.0, 1e-3))
        tp = _params(TP, loss=loss)
        model = TModel(iceflow=TSIA2DModel(A=TLawA_inversion(tp, scalar=False)))
    theta0 = tinv.init_theta(model, tb, torch.float64)
    return model, tp, tens.init_restarts(theta0, 3, init_scale=0.5, seed=11)


@pytest.mark.parametrize("case", ["SI per-glacier A", "RKC NN", "SI gridded A + Tikhonov"])
def test_fold_equals_separate_solves(truth, case):
    """Per-member losses of the folded batch, and the gradient of their sum
    by member, equal 3 separate single-start evaluations; the folded
    residual rows equal each member's residuals raveled. 1e-12."""
    _, tb = truth
    model, tp, stack = _fold_case(case, tb)
    ts = tinv.assemble_tstops(tp, tb)
    fold = tens.fold_members(model, tb, tp, 3)
    assert fold.batch.H0.shape[0] == 6
    leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(stack)]
    stack = tree_unflatten(stack, leaves)
    per = tens.folded_losses(stack, fold, ts)
    grads = torch.autograd.grad(per.sum(), leaves)
    with torch.no_grad():
        rows = tens.folded_residuals(stack, fold, ts)
    for k in range(3):
        th = tree_map(lambda x: x[k].detach().clone().requires_grad_(True), stack)
        loss = tinv.batch_transient_loss(th, tb, model, tp, ts)
        g = torch.autograd.grad(loss, tree_leaves(th))
        assert_rel(per[k].detach(), loss.detach(), 1e-12, f"{case} loss {k}")
        for gf, gs in zip(grads, g):
            assert_rel(gf[k], gs, 1e-12, f"{case} gradient {k}")
        with torch.no_grad():
            r = tinv.glacier_residuals(th, tb, model, tp, ts)
        assert_rel(rows[k], r.reshape(-1), 1e-12, f"{case} residuals {k}")


def test_fold_calls_each_kernel_once_a_step(truth, monkeypatch):
    """A folded multi-start Adam epoch of 4 restarts calls si_step's plain
    version (the kernel, on the CPU) once a step for all members, as a
    single start does: 3 forward steps and, in the final losses'
    evaluation, 3 more; and the pullback's once a step of the gradient."""
    _, tb = truth
    tp = _params(TP, epochs=(1,))
    model = _models("A", _params(JP), tp)[1]
    counts = count_kernel_plain_versions(monkeypatch)
    inv = tinv.Inversion(model=model, glaciers=tb, parameters=tp, device=CPU)
    tens.multistart_train(inv, n_restarts=4, seed=0)
    assert counts == {"odinn_tpu_torch.ops.cuda.si_kernel._forward": 6,
                      "odinn_tpu_torch.ops.cuda.si_kernel.si_step_vjp_reference": 3}


def test_grad_accum_chunks_fold_each_chunk(truth):
    """Under hyper.grad_accum_chunks the fold is built per chunk of glaciers
    (one graph a chunk) and the summed losses and gradients train as the
    whole batch does: the same loss curves and final θ. 1e-12."""
    import dataclasses

    _, tb = truth
    tp = _params(TP, epochs=(3,))
    model = _models("A", _params(JP), tp)[1]
    runs = []
    for chunks in (1, 2):
        p = tp.replace(hyper=dataclasses.replace(tp.hyper, grad_accum_chunks=chunks))
        inv = tinv.Inversion(model=model, glaciers=tb, parameters=p, device=CPU)
        runs.append(tens.multistart_train(inv, n_restarts=3, seed=4))
    assert_rel(runs[1].losses, runs[0].losses, 1e-12, "loss curves")
    assert_rel(stack_to_rows(runs[1].thetas), stack_to_rows(runs[0].thetas), 1e-12, "final θ")


@pytest.fixture(scope="module")
def mesh_runs(truth, tmp_path_factory):
    """``multistart_train`` and ``eki_train`` in a 2-rank gloo job on the
    CPU (``tests/torch_mesh_ranks.py``'s "ensemble" scenario), each beside
    the same run in one process: each rank's record."""
    import os
    import pickle

    from odinn_tpu_torch.parallel.multiprocess import launch_local_workers
    from tests.torch_parity import jax_to_numpy_fields

    jb, _ = truth
    d = tmp_path_factory.mktemp("ensemble_ranks")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump({"batch": jax_to_numpy_fields(jb), "rgi_id": jb.rgi_id}, fh)
    launch_local_workers(2, 1, ["ensemble", d / "in.pkl", d], timeout=120.0,
                         module="tests.torch_mesh_ranks")
    outs = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def test_mesh_of_two_devices_refused(truth, mesh_runs):
    """A mesh of two ranks (a 2-rank gloo job on the CPU) no longer refuses:
    ``multistart_train`` with 4 restarts (2 a rank) and with 3 (every rank
    runs all 3), its LBFGS and LM refinement with the glacier axis split
    (1e-10), and ``eki_train`` with 4 members (2 a rank, perturbed
    observations) and with 3 equal the single process's runs on both ranks
    (1e-12), EKI's ensemble bitwise the same on both ranks. None and a mesh
    of one device run as no mesh; a list of two devices is no mesh."""
    from odinn_tpu_torch.parallel import mesh as tmesh

    _, tb = truth
    tp = _params(TP, epochs=(1,))
    model = _models("A", _params(JP), tp)[1]
    inv = tinv.Inversion(model=model, glaciers=tb, parameters=tp, device=CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tens.multistart_train(inv, n_restarts=2, mesh=["cuda:0", "cuda:1"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmesh.set_active_mesh(["cuda:0", "cuda:1"])
    assert tmesh.active_mesh() is None
    assert tmesh.set_active_mesh(["cuda:0"]) == ["cuda:0"]
    try:
        ms = tens.multistart_train(inv, n_restarts=2)
    finally:
        tmesh.set_active_mesh(None)
    assert ms.losses.shape == (2, 1)

    for out in mesh_runs:
        for n in (4, 3):
            single, mesh = out[f"multistart_{n}"]["single"], out[f"multistart_{n}"]["mesh"]
            assert mesh["losses"].shape == single["losses"].shape == (n, 3)
            assert_rel(mesh["losses"], single["losses"], 1e-12, "loss curves")
            assert_rel(mesh["final"], single["final"], 1e-12, "final losses")
            assert mesh["best"] == single["best"]
            for a, b in zip(mesh["thetas"] + mesh["best_theta"],
                            single["thetas"] + single["best_theta"]):
                assert_rel(a, b, 1e-12, "θ")
        single, mesh = out["multistart_refine"]["single"], out["multistart_refine"]["mesh"]
        assert mesh["best"] == single["best"]
        assert_rel(mesh["refined"], single["refined"], 1e-10, "refined losses")
        for a, b in zip(mesh["best_theta"], single["best_theta"]):
            assert_rel(a, b, 1e-10, "refined θ")
        for j in (4, 3):
            single, mesh = out[f"eki_{j}"]["single"], out[f"eki_{j}"]["mesh"]
            assert mesh["misfits"].shape == single["misfits"].shape == (3, j)
            assert_rel(mesh["misfits"], single["misfits"], 1e-12, "misfits")
            for a, b in zip(mesh["thetas"], single["thetas"]):
                assert_rel(a, b, 1e-12, "ensemble")
            assert mesh["best"] == single["best"] and mesh["same_on_every_rank"]
            assert_rel(mesh["mean_loss"], single["mean_loss"], 1e-12, "mean loss")
