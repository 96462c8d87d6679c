"""odinn_tpu_torch's glacier-axis scale-out (``parallel/mesh.py``,
``train_ude(…, mesh=…)``) on a 2-rank gloo job on the CPU, against the JAX
package's mesh tests (tests/test_sharding.py) on their problem: 8 Halfar
glaciers of 24², RK4 at 8 substeps, 6 monthly intervals, float64.

The two ranks (``tests/torch_mesh_ranks.py``, started once for the module
through ``launch_local_workers``) get the JAX package's glaciers and θ as
numpy. Each splits the glacier axis, and the loss and the θ gradient are
summed by one ``all_reduce``: they equal ``jax.value_and_grad`` of the JAX
package's ``batch_transient_loss`` (1e-12, 1e-10, the JAX test's bounds),
and the explicit-collective step with one A per glacier equals JAX's
(1e-10, 1e-9). ``train_ude`` on the mesh equals the same run in one
process (losses 1e-10, θ and trajectories 1e-9) on the first 4 glaciers
over the first 3 months: by autograd over 3 (one padded lane) through the
registered mesh, and, solving by SI at PCG-10, by the discrete adjoint, by
the dummy gradient (whose draw is not summed), with minibatches of 2, and
through an Adam then a Levenberg–Marquardt stage, with θ bitwise the same
on both ranks. The LM stage runs 2 CG iterations:
CG converges in ~3 here, and iterations past it divide roundoff by
roundoff, which turns the reduction order's last bits into 3e-8 (3
iterations, 8 glaciers) to 1e-6 (4 iterations) of θ, as any other
summation order would in one process.
"""

import concurrent.futures
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odinn_tpu.core.glacier import stack_glaciers
from odinn_tpu.core.params import (
    Hyperparameters, Parameters, PhysicalParameters, SimulationParameters, SolverParameters,
    UDEParameters)
from odinn_tpu.data.synthetic import halfar_glacier
from odinn_tpu.laws.laws import CuffeyPaterson, LawA, LawA_inversion
from odinn_tpu.models.model import Model, SIA2DModel, init_theta
from odinn_tpu.models.nn import NeuralNetwork, default_architecture
from odinn_tpu.parallel.mesh import pad_batch_to as j_pad_batch_to
from odinn_tpu.simulation.inversion import batch_transient_loss
from odinn_tpu.simulation.prediction import generate_ground_truth
from odinn_tpu.simulation.solver import build_tstops
from tests.torch_mesh_ranks import TRAININGS
from tests.torch_parity import CPU, assert_rel, carry_glacier, jax_to_numpy_fields

TIMEOUT = 120.0


@pytest.fixture(scope="module")
def problem():
    """tests/test_sharding.py's problem, in the JAX package."""
    tspan = (5.0, 5.5)
    params = Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=2e-18),
        simulation=SimulationParameters(tspan=tspan, use_MB=False, use_velocities=False),
        solver=SolverParameters(step=1.0 / 12.0, substeps=8),
        hyper=Hyperparameters(optimizer="adam", learning_rate=1e-2, epochs=1),
        UDE=UDEParameters(grad="jax"),
    )
    glaciers = [halfar_glacier(nx=24, ny=24, dx=150.0, temp=float(t), rgi_id=f"s{i}")
                for i, t in enumerate(np.linspace(-25.0, -19.0, 8))]
    tstops = build_tstops(tspan, params.solver.step)
    glaciers = generate_ground_truth(glaciers, params, Model(iceflow=SIA2DModel(
        A=CuffeyPaterson())), tstops, store=("H",))
    model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1, light=True),
                                                          seed=1), params)))
    batch = stack_glaciers(glaciers)
    return params, model, batch, init_theta(model, batch), tstops


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """The two ranks' outputs (a future: the job runs while the tests
    compile the JAX package's side)."""
    from odinn_tpu_torch.parallel.multiprocess import launch_local_workers

    params, _, batch, theta, _ = problem
    theta_a = init_theta(Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True))), batch)
    d = tmp_path_factory.mktemp("mesh_ranks")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump({"batch": jax_to_numpy_fields(batch), "rgi_id": batch.rgi_id,
                     "theta": jax.tree.map(np.asarray, theta),
                     "theta_a": jax.tree.map(np.asarray, theta_a)}, fh)

    def run():
        launch_local_workers(2, 1, ["mesh", d / "in.pkl", d], timeout=TIMEOUT,
                             module="tests.torch_mesh_ranks")
        outs = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
                outs.append(pickle.load(fh))
        return outs

    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(run)
    pool.shutdown(wait=True)


def _jax_value_and_grad(model, params, batch, theta, tstops):
    val, grads = jax.jit(jax.value_and_grad(
        lambda th: batch_transient_loss(th, batch, model, params, tstops)))(theta)
    assert np.isfinite(float(val))
    return float(val), [np.asarray(g) for g in jax.tree.leaves(grads)]


def test_mesh_loss_and_gradient_match_jax(problem, ranks):
    """Both ranks' summed loss and NN gradient, by the explicit-collective
    step and by ``train_ude``'s reduced value-and-grad, equal JAX's
    single-device ``value_and_grad``: 1e-12 and 1e-10."""
    params, model, batch, theta, tstops = problem
    ref_val, ref_grads = _jax_value_and_grad(model, params, batch, theta, tstops)
    for out in ranks.result(timeout=TIMEOUT):
        for key in ("shard_map", "train_ude_vg"):
            val, grads = out[key]
            assert_rel(val, ref_val, 1e-12, f"rank {out['rank']} {key} loss")
            assert len(grads) == len(ref_grads)
            for g, r in zip(grads, ref_grads):
                assert_rel(g, r, 1e-10, f"rank {out['rank']} {key} gradient")


def test_shard_map_per_glacier_theta(problem, ranks):
    """One A per glacier: each rank keeps its rows of the gradient, and the
    rows of the two ranks are JAX's gradient (1e-9), the loss JAX's (1e-10)."""
    params, _, batch, _, tstops = problem
    model = Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True)))
    theta = init_theta(model, batch)
    ref_val, ref_grads = _jax_value_and_grad(model, params, batch, theta, tstops)
    outs = ranks.result(timeout=TIMEOUT)
    rows = [out["per_glacier"][1] for out in outs]
    assert [r.shape for r in rows] == [(4,), (4,)]
    assert_rel(np.concatenate(rows), ref_grads[0], 1e-9, "per-glacier A gradient")
    for out in outs:
        assert_rel(out["per_glacier"][0], ref_val, 1e-10, "loss")
    # shard_theta: each rank's rows of the per-glacier entry
    np.testing.assert_array_equal(np.concatenate([out["shard_theta"] for out in outs]),
                                  np.asarray(theta["A"]))


def test_gather_to_host(ranks):
    """``gather_to_host`` gives every rank every rank's rows, in rank order,
    as host numpy, through nested containers."""
    for out in ranks.result(timeout=TIMEOUT):
        assert out["is_multiprocess"]
        g = out["gathered"]
        np.testing.assert_array_equal(g["x"], np.repeat([0.0, 1.0], 2)[:, None] * np.ones(3))
        np.testing.assert_array_equal(g["y"][0], [0, 1, 2, 10, 11, 12])


def test_pad_batch_matches_jax(problem):
    """``pad_batch_to`` 5 → 8 equals JAX's field by field, and the padded
    lanes add zero loss (1e-12)."""
    from odinn_tpu_torch.parallel.mesh import pad_batch_to
    from odinn_tpu_torch.simulation import inversion as tinv
    from tests.torch_mesh_ranks import nn_model, sharding_params
    from tests.torch_parity import tree_to_port

    params, model, batch, theta, tstops = problem
    batch5 = jax.tree.map(
        lambda x: x[:5] if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == 8 else x, batch)
    jpadded, jn = j_pad_batch_to(batch5, 8)
    tpadded, tn = pad_batch_to(carry_glacier(batch5), 8)
    assert jn == tn == 5 and tpadded.H0.shape[0] == 8
    assert tpadded.glacier_ids.tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    jf = jax_to_numpy_fields(jpadded)
    checked = 0
    for name, obj in (("", tpadded), ("thickness_data.", tpadded.thickness_data)):
        fields = jf if not name else jf["thickness_data"]
        for f, v in fields.items():
            t = getattr(obj, f, None)
            if isinstance(v, np.ndarray) and isinstance(t, torch.Tensor):
                np.testing.assert_array_equal(t.numpy(), v, err_msg=name + f)
                checked += 1
    assert checked >= 8
    tp = sharding_params()
    tm = nn_model(tp)
    tth = tree_to_port(theta)
    t_ts = tinv.assemble_tstops(tp, tpadded)
    loss5 = float(tinv.batch_transient_loss(tth, carry_glacier(batch5), tm, tp, t_ts))
    loss8 = float(tinv.batch_transient_loss(tth, tpadded, tm, tp, t_ts))
    assert loss5 > 0
    assert_rel(loss8, loss5, 1e-12, "padded loss")


@pytest.mark.parametrize("i", range(len(TRAININGS)), ids=[t[0] for t in TRAININGS])
def test_train_ude_on_mesh_matches_single_process(ranks, i):
    """``train_ude`` on the 2-rank mesh: the losses (1e-10), θ and the
    gathered trajectories (1e-9) and the gradient norms (1e-10) of the
    same run in one process (on rank i % 2), θ bitwise the same on both
    ranks."""
    name = TRAININGS[i][0]
    outs = ranks.result(timeout=TIMEOUT)
    single = outs[i % 2][name]["single"]
    for out in outs:
        mesh = out[name]["mesh"]
        assert len(mesh["losses"]) == len(single["losses"]) > 0
        assert_rel(mesh["losses"], single["losses"], 1e-10, f"{name} losses")
        assert_rel(mesh["grad_norms"], single["grad_norms"], 1e-10, f"{name} gradient norms")
        for a, b in zip(mesh["theta"], single["theta"]):
            assert_rel(a, b, 1e-9, f"{name} θ")
        assert mesh["H"].shape == single["H"].shape
        assert_rel(mesh["H"], single["H"], 1e-9, f"{name} trajectories")
        assert mesh["same_on_every_rank"]
    assert outs[0]["registered_size"] == 2


def test_dummy_gradient_not_summed(ranks):
    """``grad="dummy"``: every rank draws the same normals, and the mesh
    returns that draw, not the rank count times it; the loss is summed."""
    for out in ranks.result(timeout=TIMEOUT):
        (vm, gm), (vs, gs) = out["dummy_vg_mesh"], out["dummy_vg_single"]
        assert_rel(vm, vs, 1e-12, "dummy loss")
        for a, b in zip(gm, gs):
            np.testing.assert_array_equal(a, b)


def test_run_inversion_mesh_passthrough(ranks):
    """``run_inversion(inv, mesh=…)`` trains on the mesh and returns every
    glacier's trajectory (8): the single process's forward from the trained
    θ (1e-12), the same on both ranks."""
    outs = ranks.result(timeout=TIMEOUT)
    for out in outs:
        run = out["run_inversion"]
        assert run["H"].shape[0] == 8 and run["H"].shape == run["H_single"].shape
        assert_rel(run["H"], run["H_single"], 1e-12, "trajectories")
        assert np.isfinite(run["losses"]).all()
    np.testing.assert_array_equal(outs[0]["run_inversion"]["H"], outs[1]["run_inversion"]["H"])


def test_make_mesh_and_rows_refused(ranks):
    """``make_mesh(3)`` in a job of 2 ranks raises. A (1 × 2) mesh with a
    "rows" dimension is taken: ``shard_inversion`` gives each rank its 12
    rows of the 24-row grids, ``set_active_mesh`` registers it, and
    ``train_ude`` with ``substeps="auto"`` trains on it as one process does
    (the same sizing, losses and θ at 1e-9). Outside a job,
    ``enable_multiprocessing(rows=2)`` raises the JAX package's
    ValueError."""
    from odinn_tpu_torch.api import enable_multiprocessing

    with pytest.raises(ValueError, match="rows=2 exceeds"):
        enable_multiprocessing(rows=2)
    for r, out in enumerate(ranks.result(timeout=TIMEOUT)):
        assert "needs 3 devices" in out["make_mesh_3"]
        assert out["rows_shard_inversion"] == (r * 12, r * 12 + 12, 12)
        assert out["rows_set_active_mesh"] == ("glaciers", "rows")
        runs = out["rows_train_ude"]
        assert runs["mesh"]["substeps"] == runs["single"]["substeps"]
        np.testing.assert_allclose(runs["mesh"]["losses"], runs["single"]["losses"], rtol=1e-9)
        for a, b in zip(runs["mesh"]["theta"], runs["single"]["theta"]):
            assert_rel(a, b, 1e-9, "θ")
