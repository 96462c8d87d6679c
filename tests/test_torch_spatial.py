"""odinn_tpu_torch's grid-row sharding (``parallel/spatial.py``) on a 4-rank
(2 × 2) gloo job on the CPU, against the JAX package's single-device runs
of tests/test_spatial_sharding.py's problem: 4 Halfar glaciers of 24², RK4
at 8 substeps, A = NN(T) with the light NN, float64. The JAX package's own
test holds its 2-D mesh equal to that single-device run.

The four ranks (``tests/torch_spatial_ranks.py``, started once for the
module through ``launch_local_workers``, while the JAX side compiles) get
the JAX package's glaciers and θ as numpy. Each holds 2 glaciers × 12 rows
and checks:

- placement: its own rows are the JAX ``NamedSharding`` shard of the same
  device, and ``shard_theta_spatial``'s IC rows too;
- ``RowHalo`` forward, backward and jvp against the whole plane (halos 1,
  2, 8 and 13, beyond a 12-row neighbour), and each hooked operator
  (``sia2d_rhs`` fused and generic, the velocity, one RKC step at s = 8,
  the SI step at PCG-6 with θ = 1 and ½ on the kernels' path and θ = 1 on
  the tensor code, whose VJP is the transpose solve and pullback and whose
  JVP the tangent solve): forward, VJP and JVP on the own rows against the
  unsharded call at 1e-12;
- over the first 3 months: ``batch_transient_loss``'s value and gradient
  summed over the mesh through RK4 and through SI at PCG-6 against JAX
  (1e-12 / 1e-10); ``train_ude``: Adam for 3 epochs by autograd
  through RK4 (losses 1e-9, θ 1e-7, H 1e-8), and the discrete adjoint's
  Adam 2 → LM 2 ladder through SI at PCG-6 with LM's CG kept below
  convergence (losses 1e-8, θ 1e-6), θ bitwise the same on every rank.
  The LM stage's Hutchinson probes are JAX's draw (the port's generator
  draws others, and a leaf whose diagonal sits at its floor then steps
  elsewhere along a direction the loss does not see);
- row padding: 25-row glaciers on 2 row ranks (→ 26) trained alike to the
  single process, results cropped to 25 rows;
- a term that reads θ alone counted once: the loss and gradient equal the
  single process's;
- the refusals that wait for ``ROADMAP.md`` Queue 1 item 11.

An exchange is one gloo collective, ~1.5 ms on the CPU, so the runs cover
3 months and the discrete ladder solves by SI.
"""

import concurrent.futures
import dataclasses
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
from odinn_tpu.laws.laws import CuffeyPaterson, LawA
from odinn_tpu.models.model import Model, SIA2DModel, init_theta
from odinn_tpu.models.nn import NeuralNetwork, default_architecture
from odinn_tpu.simulation.inversion import Inversion, batch_transient_loss, train_ude
from odinn_tpu.simulation.prediction import generate_ground_truth
from odinn_tpu.simulation.solver import build_tstops
from tests.test_torch_gauss_newton import _jax_probes
from tests.torch_parity import CPU, assert_rel, carry_glacier, jax_to_numpy_fields
from tests.torch_spatial_ranks import OPERATORS, TRAIN_TSPAN, TRAININGS

TIMEOUT = 240.0


def _params(tspan=(5.0, 5.5), solver=None, **kw):
    p = Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=2e-18),
        simulation=SimulationParameters(tspan=tspan, use_MB=False, use_velocities=False),
        solver=SolverParameters(step=1.0 / 12.0, substeps=8),
        hyper=Hyperparameters(optimizer="adam", learning_rate=1e-2, epochs=1),
        UDE=UDEParameters(grad="jax"))
    if solver:
        p = p.replace(solver=dataclasses.replace(p.solver, **solver))
    return p.replace(**kw)


SI6 = dict(solver="SI", substeps=1, cg_iters=6)


@pytest.fixture(scope="module")
def problem():
    """tests/test_spatial_sharding.py's problem, in the JAX package, and
    two 25-row glaciers for the row padding."""
    params = _params()
    tstops = build_tstops((5.0, 5.5), params.solver.step)
    truth = Model(iceflow=SIA2DModel(A=CuffeyPaterson()))
    glaciers = [halfar_glacier(nx=24, ny=24, dx=150.0, temp=float(t), rgi_id=f"sp{i}")
                for i, t in enumerate(np.linspace(-25.0, -19.0, 4))]
    glaciers = generate_ground_truth(glaciers, params, truth, tstops, store=("H",))
    pad = [halfar_glacier(nx=25, ny=24, dx=150.0, temp=t, rgi_id=f"pad{i}")
           for i, t in enumerate((-25.0, -20.0))]
    pad = generate_ground_truth(pad, params, truth, tstops, store=("H",))
    model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1, light=True),
                                                          seed=1), params)))
    batch = stack_glaciers(glaciers)
    return params, model, batch, init_theta(model, batch), tstops, stack_glaciers(pad)


def _jax_runs(problem):
    """The JAX package's single-device references, all at once."""
    params, model, batch, theta, tstops, _ = problem

    def vg(solver):
        p = _params(TRAIN_TSPAN, solver=solver)
        ts = build_tstops(TRAIN_TSPAN, p.solver.step)
        val, g = jax.jit(jax.value_and_grad(
            lambda th: batch_transient_loss(th, batch, model, p, ts)))(theta)
        return float(val), [np.asarray(x) for x in jax.tree.leaves(g)]

    def train(name):
        _, hyper, grad = next(t for t in TRAININGS if t[0] == name)
        p = _params(TRAIN_TSPAN, solver=SI6 if name == "discrete_lm" else None,
                    hyper=Hyperparameters(**hyper), UDE=UDEParameters(grad=grad))
        inv = Inversion(model=model, glaciers=batch, parameters=p,
                        theta=jax.tree.map(jnp.copy, theta))
        res = train_ude(inv)
        return {"losses": np.asarray(res.stats.losses),
                "theta": [np.asarray(x) for x in jax.tree.leaves(inv.theta)],
                "H": np.asarray(res.simulation["H"])}

    jobs = {"discrete_lm": (train, "discrete_lm"), "adam3": (train, "adam3"),
            "vg_rk4": (vg, {}), "vg_si6": (vg, SI6)}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(fn, arg) for k, (fn, arg) in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """The four ranks' outputs and the JAX package's references, as futures:
    the job runs while the JAX side compiles."""
    from odinn_tpu_torch.parallel.multiprocess import launch_local_workers

    _, _, batch, theta, _, pad = problem
    d = tmp_path_factory.mktemp("spatial_ranks")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump({"batch": jax_to_numpy_fields(batch), "rgi_id": batch.rgi_id,
                     "pad_batch": jax_to_numpy_fields(pad), "pad_rgi_id": pad.rgi_id,
                     "theta": jax.tree.map(np.asarray, theta),
                     "probes": [jax.tree.map(np.asarray, v) for v in _jax_probes(theta, 8)]}, fh)

    def run():
        launch_local_workers(4, 1, [d / "in.pkl", d], timeout=TIMEOUT,
                             module="tests.torch_spatial_ranks")
        outs = []
        for r in range(4):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
                outs.append(pickle.load(fh))
        return outs

    pool = concurrent.futures.ThreadPoolExecutor(2)
    yield pool.submit(run), pool.submit(_jax_runs, problem)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_runs(ranks):
    return ranks[1].result(timeout=TIMEOUT)


def _outs(ranks):
    return ranks[0].result(timeout=TIMEOUT)


class _Mesh2D:
    """A (2 × 4) mesh's shape, for the placement guard outside a job."""

    mesh_dim_names = ("glaciers", "rows")

    def size(self, dim=None):
        return (2, 4)[dim] if dim is not None else 8


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [5, 4])
def test_pad_batch_rows_matches_jax(problem, k):
    """pad_batch_rows against JAX's, field by field and exactly: 24 → 25
    rows at k = 5, the batch itself at k = 4."""
    from odinn_tpu.parallel.spatial import pad_batch_rows as j_pad
    from odinn_tpu_torch.parallel.spatial import pad_batch_rows

    _, _, batch, _, _, _ = problem
    jb, jnx = j_pad(batch, k)
    tb_in = carry_glacier(batch)
    tb, tnx = pad_batch_rows(tb_in, k)
    assert tnx == jnx == 24
    if k == 4:
        assert tb is tb_in and jb is batch
        return
    assert tb.H0.shape[-2] == 25
    for name in ("H0", "B", "mask", "npix", "coords_x"):
        a, b = getattr(tb, name), getattr(jb, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(tb.thickness_data.H.numpy(),
                                  np.asarray(jb.thickness_data.H))


def test_row_padding_guard_message(problem):
    """Grid-shaped θ under row padding raises JAX's message."""
    from odinn_tpu_torch.convert import theta_from_numpy
    from odinn_tpu_torch.parallel.spatial import shard_inversion_spatial

    _, _, batch, theta, _, _ = problem
    g25 = carry_glacier(batch)
    g25 = g25.replace(H0=torch.nn.functional.pad(g25.H0, (0, 0, 0, 1)),
                      B=torch.nn.functional.pad(g25.B, (0, 0, 0, 1)),
                      mask=torch.nn.functional.pad(g25.mask, (0, 0, 0, 1)))
    th = dict(theta_from_numpy(jax.tree.map(np.asarray, theta), device=CPU))
    th["IC"] = torch.zeros((4, 25, 24), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="spatial sharding with row padding"):
        shard_inversion_spatial(th, g25, _Mesh2D())


def test_placement_matches_jax_shards(problem, ranks):
    """Each rank's own rows of H₀ and of the observations equal the JAX
    NamedSharding shard of the same device on a (2 × 2) mesh, and
    shard_theta_spatial's IC rows equal JAX's."""
    from odinn_tpu.parallel.mesh import shard_inversion as j_shard
    from odinn_tpu.parallel.spatial import make_mesh_2d as j_mesh
    from odinn_tpu.parallel.spatial import shard_theta_spatial as j_theta

    _, _, batch, theta, _, _ = problem
    mesh = j_mesh(n_glaciers=2, n_rows=2)
    _, sb, _ = j_shard(theta, batch, mesh)
    ic = jnp.arange(4 * 24 * 24, dtype=jnp.float64).reshape(4, 24, 24)
    placed = j_theta({"IC": ic}, mesh)["IC"]

    def shard_of(arr, dev):
        return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)

    devs = list(mesh.devices.reshape(-1))
    for out in _outs(ranks):
        dev = devs[out["rank"]]
        assert out["n_orig"] == 4
        np.testing.assert_array_equal(out["H0"], shard_of(sb.H0, dev))
        np.testing.assert_array_equal(out["obs"], shard_of(sb.thickness_data.H, dev))
        np.testing.assert_array_equal(out["ic_rows"], shard_of(placed, dev))


# ---------------------------------------------------------------------------
# the primitives and the hooked operators
# ---------------------------------------------------------------------------

def test_row_halo_is_the_identity(ranks):
    """RowHalo forward, backward and jvp reproduce the whole plane's rows
    (its backward is the exact transpose), and rows_sum sums the group."""
    for out in _outs(ranks):
        for key, err in out["halo"].items():
            assert err == 0.0, (out["rank"], key, err)
        assert out["rows_sum"] == 3.0


@pytest.mark.parametrize("op", OPERATORS)
def test_hooked_operator_matches_unsharded(ranks, op):
    """The operator's own rows, its VJP and its JVP equal the unsharded
    call's at 1e-12."""
    for out in _outs(ranks):
        errs = out["operators"][op]
        for kind, err in errs.items():
            assert err <= 1e-12, (out["rank"], op, kind, err)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["vg_rk4", "vg_si6"])
def test_loss_and_gradient_match_jax(ranks, jax_runs, key):
    """batch_transient_loss's value and θ gradient, summed over the mesh,
    equal JAX's single-device ones (1e-12, 1e-10)."""
    ref_val, ref_g = jax_runs[key]
    for out in _outs(ranks):
        val, grads = out[key]
        np.testing.assert_allclose(val, ref_val, rtol=1e-12)
        for a, b in zip(grads, ref_g):
            assert_rel(a, b, 1e-10, key)


@pytest.mark.parametrize("name,tols", [("adam3", (1e-9, 1e-7, 1e-8)),
                                       ("discrete_lm", (1e-8, 1e-6, 1e-8))])
def test_train_ude_matches_jax(ranks, jax_runs, name, tols):
    """train_ude on the (2 × 2) mesh equals JAX's single-device run: losses,
    trained θ and the trajectories cropped to the original shape; θ is
    bitwise the same on every rank."""
    ref = jax_runs[name]
    outs = _outs(ranks)
    for out in outs:
        run = out[name]
        assert run["same_on_every_rank"]
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=tols[0])
        for a, b in zip(run["theta"], ref["theta"]):
            assert_rel(a, b, tols[1], f"{name} θ")
        assert run["H"].shape == ref["H"].shape
        assert_rel(run["H"], ref["H"], tols[2], f"{name} H")
    np.testing.assert_array_equal(outs[0][name]["H"], outs[3][name]["H"])


def test_row_padding_trains_alike(ranks):
    """25-row glaciers on 2 row ranks (padded to 26): losses, θ and
    trajectories equal the single process's, cropped back to 25 rows."""
    outs = _outs(ranks)
    single = outs[0]["singles"]["row_padding"]
    for out in outs:
        run = out["row_padding"]
        assert run["same_on_every_rank"]
        assert run["H"].shape == single["H"].shape and run["H"].shape[-2] == 25
        np.testing.assert_allclose(run["losses"], single["losses"], rtol=1e-10)
        for a, b in zip(run["theta"], single["theta"]):
            assert_rel(a, b, 1e-9, "θ")
        assert_rel(run["H"], single["H"], 1e-9, "H")


def test_replicated_term_counted_once(ranks):
    """A Tikhonov term on θ alone is whole on every rank of a row group and
    counted on row rank 0 only: the mesh's loss and gradient equal the
    single process's, and so does a training with it."""
    outs = _outs(ranks)
    single = outs[1]["singles"]["replicated"]
    for out in outs:
        vg = out["replicated_vg"]
        np.testing.assert_allclose(vg["mesh"][0], vg["single"][0], rtol=1e-12)
        for a, b in zip(vg["mesh"][1], vg["single"][1]):
            assert_rel(a, b, 1e-10, "θ gradient")
        np.testing.assert_allclose(out["replicated"]["losses"], single["losses"], rtol=1e-10)


@pytest.mark.parametrize("what", ["adaptive", "replay", "substeps_auto", "continuous",
                                  "laplace"])
def test_rows_refusals_name_item_11(ranks, what):
    """The tolerance contract, the continuous adjoint and the Laplace
    posterior on a rows mesh raise, naming ROADMAP.md Queue 1 item 11."""
    for out in _outs(ranks):
        assert "Queue 1 item 11" in out["refusals"][what], out["refusals"][what]
