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
- the host-driven controllers on the rows, against the JAX package in
  float64 over the same 3 months: the adaptive forward (trajectory at
  1e-10, accepted counts equal; trial counts equal to one process's) on
  the problem and on a row-padded one, held to JAX's run on
  ``pad_batch_rows(batch, 2)``, whose padded plane is the RMS denominator;
  ``calibrate_substeps`` (also row-padded) and ``calibrate_substeps_si``
  (equal results), the replay record (1e-11 years); ``train_ude`` with
  ``adaptive="replay"``, ``substeps="auto"`` (RK4 over two stages, so the
  stage-end re-probe runs on the rows, and SI) and ``grad="continuous"``
  (losses, θ and trajectories at 1e-9 / 1e-9 / 1e-8, re-sizings equal, θ
  bitwise the same on every rank); the continuous adjoint's loss and
  gradient (1e-12 / 1e-9; reverse steps equal to one process's);
  ``laplace_posterior`` of a per-glacier A on the rows, per-glacier blocks
  and dense, and ``laplace_uncertainty`` under the rows mesh (Σ 1e-8);
  gridded law values (the gridded temperature with a plane-mean factor,
  degree-days and roughness on a bumpy bed) through the forward (1e-10);
  ``make_shard_map_value_and_grad`` on the 2-D mesh (1e-12 / 1e-10).
  These are the tolerances of the single-process tests of the same
  functions (``test_torch_adaptive.py``, ``test_torch_replay.py``,
  ``test_torch_continuous_adjoint.py``, ``test_torch_uncertainty.py``).

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
from tests.torch_spatial_ranks import (
    C_MAX, CONTROLLER_TRAININGS, OPERATORS, RELTOL, SI_PROBE, SI_RELTOL, TRAIN_TSPAN, TRAININGS)

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
    return _problem()


def _problem():
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


def _grid_batch():
    """4 Halfar glaciers of 24² on a bumpy bed with a monthly climate from
    4 years (degree-days over the year before 5.0) and gridded long-term
    temperatures that vary over the rows."""
    from odinn_tpu.data.synthetic import monthly_dummy_climate

    x = np.arange(24.0)
    out = []
    for i, tm in enumerate((-25.0, -23.0, -21.0, -19.0)):
        clim = monthly_dummy_climate(4.0, 24, temp_mean=-2.0 + i, longterm_temp=tm, nx=24,
                                     ny=24)
        clim = dataclasses.replace(clim, longterm_temps_gridded=jnp.asarray(
            tm + 0.1 * x[:, None] - 0.05 * x[None, :]))
        g = halfar_glacier(nx=24, ny=24, dx=150.0, temp=tm, climate=clim, rgi_id=f"gr{i}")
        bump = 3.0 * np.sin(0.7 * (i + 1) * x)[:, None] * np.cos(0.5 * x)[None, :]
        out.append(g.replace(B=g.B + jnp.asarray(bump)))
    return stack_glaciers(out)


def _jax_gridded_model(params):
    """torch_spatial_ranks.gridded_model in the JAX package."""
    from odinn_tpu.laws import inputs as I
    from odinn_tpu.laws.laws import Law, SyntheticC, poly_A_paterson_cuffey
    from odinn_tpu.ops.stencils import avg

    a_of_t = poly_A_paterson_cuffey()

    def apply_a(theta, inp):
        T = inp["T_grid"]
        return avg(a_of_t(T) * (1.0 + 0.1 * jnp.tanh(jnp.mean(T) / 10.0)))

    law_a = Law(slot="A", apply_fn=apply_a, inputs=(I.AvgGriddedTemp(),), callback_freq=0.0,
                trainable=False, name="gridA")
    return Model(iceflow=SIA2DModel(A=law_a, C=SyntheticC(params, c_max=C_MAX)))


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
    # the controllers' references in three more processes (JAX's tracing
    # holds the GIL, so threads of one process share one core for it)
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + len(CONTROLLER_GROUPS)) as pool:
        groups = [pool.submit(_jax_controller_process, g) for g in CONTROLLER_GROUPS]
        futures = {k: pool.submit(fn, arg) for k, (fn, arg) in jobs.items()}
        out = {k: f.result() for k, f in futures.items()}
        for g in groups:
            out.update(g.result(timeout=TIMEOUT))
        return out


# the controllers' JAX references, by process, each ~20 s of JAX work
CONTROLLER_GROUPS = (
    ("train_replay", "train_auto_rk4", "adaptive", "gridded"),
    ("train_auto_si", "train_continuous", "continuous_vg"),
    ("adaptive_padded", "calibrate", "calibrate_padded", "calibrate_si", "laplace_blocks"),
)


def _jax_controller_process(names):
    """The named controller references, computed by :func:`_jax_controller_group`
    in a Python process of its own with the test configuration's JAX
    settings (``tests/conftest.py``)."""
    import subprocess
    import sys
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "out.pkl")
        code = ("import sys, pickle, tests.conftest; "
                "from tests.test_torch_spatial import _jax_controller_group as f; "
                "pickle.dump(f(sys.argv[1:-1]), open(sys.argv[-1], 'wb'))")
        subprocess.run([sys.executable, "-c", code, *names, path], cwd=root, check=True,
                       timeout=TIMEOUT, stdout=subprocess.DEVNULL)
        with open(path, "rb") as fh:
            return pickle.load(fh)


def _jax_controller_group(names):
    """The named controller references (see :func:`_jax_controller_process`)."""
    jobs = _jax_controller_jobs(_problem())
    return {k: jobs[k][0](jobs[k][1]) for k in names}


def _jax_controller_jobs(problem):
    """The JAX package's references of the controllers on the rows: its
    single-device runs, and its runs on the row-padded batch."""
    from odinn_tpu.inverse.gauss_newton import make_residual_fn
    from odinn_tpu.inverse.gradient import make_adjoint_value_and_grad
    from odinn_tpu.inverse.uncertainty import laplace_posterior
    from odinn_tpu.laws.laws import LawA_inversion
    from odinn_tpu.parallel.spatial import pad_batch_rows
    from odinn_tpu.simulation import prediction as jp
    from odinn_tpu.simulation.inversion import assemble_tstops

    _, model, batch, theta, _, pad = problem
    ts = assemble_tstops(_params(TRAIN_TSPAN), batch)
    padded, _ = pad_batch_rows(pad, 2)

    def adaptive(b):
        p = _params(TRAIN_TSPAN, solver=dict(adaptive=True, reltol=RELTOL))
        traj, naccs = jax.jit(jax.vmap(lambda g, i: jp.forward_glacier(
            theta, g, i, model, p, ts, _return_stats=True)))(b, jnp.arange(b.H0.shape[0]))
        return np.asarray(traj), np.asarray(naccs)

    def calibrate(b):
        return jp.calibrate_substeps(theta, b, model, _params(TRAIN_TSPAN,
                                                              solver=dict(reltol=RELTOL)), ts)

    def calibrate_si(_):
        return jp.calibrate_substeps_si(
            theta, batch, model, _params(TRAIN_TSPAN, solver=dict(reltol=SI_RELTOL, solver="SI")),
            ts, **SI_PROBE)

    def train(name):
        _, hyper, grad, solver = next(t for t in CONTROLLER_TRAININGS if t[0] == name)
        p = _params(TRAIN_TSPAN, solver=solver, hyper=Hyperparameters(**hyper),
                    UDE=UDEParameters(grad=grad))
        inv = Inversion(model=model, glaciers=batch, parameters=p,
                        theta=jax.tree.map(jnp.copy, theta))
        res = train_ude(inv)
        return {"losses": np.asarray(res.stats.losses),
                "theta": [np.asarray(x) for x in jax.tree.leaves(inv.theta)],
                "H": np.asarray(res.simulation["H"]),
                "bumps": list(res.stats.substeps_bumps),
                "replay_dts": np.asarray(inv.parameters.solver.replay_dts)}

    def continuous(_):
        p = _params(TRAIN_TSPAN, UDE=UDEParameters(grad="continuous"))
        inv = Inversion(model=model, glaciers=batch, parameters=p, theta=theta)
        val, g = make_adjoint_value_and_grad(inv)(theta)
        return float(val), [np.asarray(x) for x in jax.tree.leaves(g)]

    def laplace(structure):
        model_a = Model(iceflow=SIA2DModel(A=LawA_inversion(_params())))
        resid = make_residual_fn(model_a, _params(TRAIN_TSPAN), ts)
        post = laplace_posterior(init_theta(model_a, batch), batch, resid, structure=structure)
        return np.asarray(post._cov), float(post.sigma2)

    def gridded(_):
        gb, p = _grid_batch(), _params(TRAIN_TSPAN)
        m = _jax_gridded_model(p)
        return np.asarray(jax.jit(lambda b: jp.forward_batch(init_theta(m, b), b, m, p, ts))(gb))

    jobs = {"adaptive": (adaptive, batch), "adaptive_padded": (adaptive, padded),
            "calibrate": (calibrate, batch), "calibrate_padded": (calibrate, padded),
            "calibrate_si": (calibrate_si, None), "continuous_vg": (continuous, None),
            "laplace_blocks": (laplace, "per_glacier"), "gridded": (gridded, None)}
    jobs.update({f"train_{t[0]}": (train, t[0]) for t in CONTROLLER_TRAININGS})
    return jobs


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """The four ranks' outputs and the JAX package's references, as futures:
    the job runs while the JAX side compiles."""
    from odinn_tpu_torch.parallel.multiprocess import launch_local_workers

    _, _, batch, theta, _, pad = problem
    grid = _grid_batch()
    d = tmp_path_factory.mktemp("spatial_ranks")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump({"batch": jax_to_numpy_fields(batch), "rgi_id": batch.rgi_id,
                     "pad_batch": jax_to_numpy_fields(pad), "pad_rgi_id": pad.rgi_id,
                     "grid_batch": jax_to_numpy_fields(grid), "grid_rgi_id": grid.rgi_id,
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


# ---------------------------------------------------------------------------
# the host-driven controllers on the rows, against the JAX package
# ---------------------------------------------------------------------------

def _port_single(batch, theta, **solver):
    """The trial counts of the port's single-process adaptive forward of
    the JAX ``batch`` at the JAX ``theta``."""
    from odinn_tpu_torch.convert import theta_from_numpy
    from odinn_tpu_torch.simulation.inversion import assemble_tstops
    from odinn_tpu_torch.simulation.prediction import forward_glacier
    from tests.torch_spatial_ranks import nn_model, spatial_params

    p = spatial_params(TRAIN_TSPAN, solver=solver)
    tb = carry_glacier(batch)
    record = {}
    with torch.no_grad():
        forward_glacier(theta_from_numpy(jax.tree.map(np.asarray, theta), device=CPU), tb,
                        nn_model(p), p, assemble_tstops(p, tb), _return_stats=True,
                        _record=record)
    return record["trials"].numpy()


@pytest.mark.parametrize("key", ["adaptive", "adaptive_padded"])
def test_adaptive_forward_on_rows_matches_jax(problem, ranks, jax_runs, key):
    """The adaptive BS3(2) forward on the rows: each rank's own rows of the
    trajectory equal JAX's (1e-10) and the accepted steps per glacier and
    interval are equal; the padded case is held to JAX's run on the padded
    batch (26 rows), the plane its 2-D mesh takes the norm over. The trial
    counts equal one process's, and a trial is 3 RHS evaluations and one
    row-group reduction: a collective each."""
    from odinn_tpu.parallel.spatial import pad_batch_rows

    j_traj, j_nacc = jax_runs[key]
    batch = problem[2] if key == "adaptive" else pad_batch_rows(problem[5], 2)[0]
    trials = _port_single(batch, problem[3], adaptive=True, reltol=RELTOL)
    for out in _outs(ranks):
        run = out[key]
        ids, own = run["ids"], run["traj"]
        assert_rel(np.moveaxis(own["x"], 0, 1), j_traj[ids][..., own["lo"]:own["hi"], :], 1e-10,
                   f"{key} trajectory")
        np.testing.assert_array_equal(run["naccs"], j_nacc[ids])
        np.testing.assert_array_equal(run["trials"], trials[ids])
        n_trials = (run["rhs_evals"] - 1) // 3
        assert out["costs"][key][0] == run["rhs_evals"] + n_trials, (out["costs"][key], run)


@pytest.mark.parametrize("key", ["calibrate", "calibrate_padded", "calibrate_si"])
def test_calibrations_on_rows_match_jax(ranks, jax_runs, key):
    """calibrate_substeps (its probe on the rows, the most over the job;
    row-padded against JAX on the padded batch) and calibrate_substeps_si
    (each distance a plane max over the row group, then the job) give
    JAX's numbers on every rank."""
    for out in _outs(ranks):
        got = out[key]
        assert (tuple(got) if isinstance(got, (tuple, list)) else got) == \
            (tuple(jax_runs[key]) if isinstance(jax_runs[key], tuple) else jax_runs[key])


def test_replay_record_on_rows_matches_jax(ranks, jax_runs):
    """resolve_replay on the rows: the glacier groups' records gathered into
    JAX's (glaciers, intervals, cap) record (the one its replay training
    recorded), to 1e-11 years."""
    want = jax_runs["train_replay"]["replay_dts"]
    for out in _outs(ranks):
        assert out["replay_dts"].shape == want.shape
        np.testing.assert_allclose(out["replay_dts"], want, rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", [t[0] for t in CONTROLLER_TRAININGS])
def test_train_ude_under_controllers_matches_jax(ranks, jax_runs, name):
    """train_ude on the (2 × 2) mesh under replay, substeps="auto" (RK4 with
    a stage-end re-probe on the rows; SI) and the continuous adjoint equals
    JAX's single-device run: losses 1e-9, θ 1e-9, trajectories 1e-8, the
    same re-sizings, θ bitwise the same on every rank."""
    ref = jax_runs[f"train_{name}"]
    outs = _outs(ranks)
    for out in outs:
        run = out[f"train_{name}"]
        assert run["same_on_every_rank"]
        assert [tuple(b) for b in run["bumps"]] == [tuple(b) for b in ref["bumps"]]
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-9)
        for a, b in zip(run["theta"], ref["theta"]):
            assert_rel(a, b, 1e-9, f"{name} θ")
        assert run["H"].shape == ref["H"].shape
        assert_rel(run["H"], ref["H"], 1e-8, f"{name} H")
    np.testing.assert_array_equal(outs[0][f"train_{name}"]["H"], outs[3][f"train_{name}"]["H"])


def test_continuous_adjoint_on_rows_matches_jax(ranks, jax_runs):
    """The continuous adjoint on the rows, its partials summed over the
    mesh: JAX's loss (1e-12) and θ gradient (1e-9); each glacier's reverse
    steps per interval equal one process's."""
    ref_val, ref_g = jax_runs["continuous_vg"]
    outs = _outs(ranks)
    for out in outs:
        run = out["continuous_vg"]
        np.testing.assert_allclose(run["loss"], ref_val, rtol=1e-12)
        for a, b in zip(run["grads"], ref_g):
            assert_rel(a, b, 1e-9, "continuous gradient")
    for out in outs[:2]:
        assert out["continuous_vg"]["reverse_steps"] == out["continuous_vg"]["single_steps"]
    assert outs[0]["continuous_vg"]["reverse_steps"] == outs[1]["continuous_vg"]["reverse_steps"]


@pytest.mark.parametrize("key", ["laplace_blocks", "laplace_dense", "laplace_uncertainty"])
def test_laplace_posterior_on_rows_matches_jax(ranks, jax_runs, key):
    """laplace_posterior of a per-glacier A (p = 4) on the rows, by the
    per-glacier blocks and dense (J·v and pullbacks on the rows, JᵀJ summed
    over the job once), and laplace_uncertainty under a registered rows
    mesh (the whole batch, as the JAX package's): Σ and σ² at 1e-8 of JAX's
    per-glacier posterior, which the dense one equals here (RK4: J is
    exactly block-diagonal by glacier)."""
    ref_cov, ref_s2 = jax_runs["laplace_blocks"]
    for out in _outs(ranks):
        run = out[key]
        cov = run["cov"] if isinstance(run, dict) else run
        assert_rel(cov, ref_cov, 1e-8, f"{key} Σ")
        if isinstance(run, dict):
            np.testing.assert_allclose(run["sigma2"], ref_s2, rtol=1e-8)


def test_gridded_law_values_on_rows_match_jax(ranks, jax_runs):
    """Laws of the gridded temperature (with a factor of its plane mean),
    degree-days and roughness on a bumpy bed, on the rows: each rank's own
    rows of the forward equal JAX's single-device trajectory (1e-10)."""
    want = jax_runs["gridded"]
    assert np.isfinite(want).all()
    for out in _outs(ranks):
        run = out["gridded"]
        own = run["traj"]
        assert_rel(np.moveaxis(own["x"], 0, 1), want[run["ids"]][..., own["lo"]:own["hi"], :],
                   1e-10, "gridded trajectory")


def test_shard_map_step_on_2d_mesh_matches_jax(ranks, jax_runs):
    """make_shard_map_value_and_grad on the (2 × 2) mesh maps the glacier
    axis alone, as JAX's shard_map does: JAX's loss (1e-12) and gradient
    (1e-10) on every rank."""
    ref_val, ref_g = jax_runs["vg_rk4"]
    for out in _outs(ranks):
        val, grads = out["shard_map"]
        np.testing.assert_allclose(val, ref_val, rtol=1e-12)
        for a, b in zip(grads, ref_g):
            assert_rel(a, b, 1e-10, "shard_map gradient")
