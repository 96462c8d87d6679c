"""One rank of the 2-rank CPU jobs of ``test_torch_mesh.py`` and
``test_torch_ensemble.py`` (started by
``odinn_tpu_torch.parallel.multiprocess.launch_local_workers``):

    python -m tests.torch_mesh_ranks RANK N PORT 1 SCENARIO IN_PICKLE OUT_DIR

It imports the port only (no JAX): the test process hands it the JAX
package's glaciers and θ as numpy (``IN_PICKLE``), and it writes what the
rank computed to ``OUT_DIR/rank<r>.pkl``, numpy only, for the test to hold
against the JAX package and the single process. Each run on the mesh is
paired with the same run in this one process (no mesh), and θ after it is
compared bitwise with rank 0's (a broadcast).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _leaves(tree):
    from odinn_tpu_torch.utils.flatten import tree_leaves

    return [x.detach().cpu().numpy() for x in tree_leaves(tree)]


def _same_on_every_rank(theta, mesh) -> bool:
    from odinn_tpu_torch.parallel.mesh import replicate
    from odinn_tpu_torch.utils.flatten import tree_leaves

    return all(torch.equal(a, b) for a, b in zip(tree_leaves(theta),
                                                 tree_leaves(replicate(theta, mesh))))


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# tests/test_sharding.py's problem: 8 Halfar glaciers of 24², RK4 at 8 substeps
# ---------------------------------------------------------------------------

def sharding_params(tspan=(5.0, 5.5), **hyper):
    import odinn_tpu_torch.core.params as P

    return P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=2e-18),
        simulation=P.SimulationParameters(tspan=tspan, use_MB=False, use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=8),
        hyper=P.Hyperparameters(**(hyper or dict(optimizer="adam", learning_rate=1e-2,
                                                 epochs=1))),
        UDE=P.UDEParameters(grad="jax"))


def nn_model(params):
    from odinn_tpu_torch.laws.laws import LawA
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture

    return Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1, light=True)),
                                           params)))


# the train_ude runs held to the single process, on the first glaciers of
# the batch over the first 3 months (TRAIN_TSPAN): (name, glaciers,
# hyperparameters, gradient, solver settings). The autograd run keeps the
# problem's RK4; the others solve by SI at PCG-10, the production solver,
# whose solves take a fraction of RK4's 8 substeps on the CPU (forward mode
# ~1/14). The LM stage's CG stops short of convergence (~3 iterations
# here): iterations past it divide roundoff by roundoff.
TRAIN_TSPAN = (5.0, 5.25)
SI = dict(solver="SI", substeps=1, cg_iters=10)
TRAININGS = (
    ("jax_padded", 3, dict(optimizer="adam", learning_rate=1e-2, epochs=2), "jax", {}),
    ("discrete", 4, dict(optimizer="adam", learning_rate=1e-2, epochs=2), "discrete", SI),
    ("dummy", 4, dict(optimizer="adam", learning_rate=1e-2, epochs=2), "dummy", SI),
    ("minibatch", 4, dict(optimizer="adam", learning_rate=1e-2, epochs=2, batch_size=2), "jax",
     SI),
    ("adam_lm", 4, dict(optimizer=("adam", "lm"), learning_rate=(1e-2, 1e-2), epochs=(1, 1),
                        gn_cg_iters=2), "jax", SI),
)


def mesh_scenario(data, mesh):
    import dataclasses

    from odinn_tpu_torch.api import enable_multiprocessing
    from odinn_tpu_torch.convert import glacier_from_numpy, theta_from_numpy
    from odinn_tpu_torch.laws.laws import LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.parallel import mesh as tmesh
    from odinn_tpu_torch.simulation import inversion as tinv
    from odinn_tpu_torch.simulation.results import TrainingStats

    batch = glacier_from_numpy(data["batch"], data["rgi_id"], device=CPU)
    theta = theta_from_numpy(data["theta"], device=CPU)
    params = sharding_params()
    model = nn_model(params)
    tstops = tinv.assemble_tstops(params, batch)
    out = {"rank": tmesh.mesh_rank(mesh), "size": tmesh.mesh_size(mesh)}

    # the explicit-collective step, and train_ude's reduced value-and-grad
    val, grads = tmesh.make_shard_map_value_and_grad(model, params, tstops, mesh)(theta, batch)
    out["shard_map"] = (float(val), _leaves(grads))
    inv = tinv.Inversion(model=model, glaciers=batch, parameters=params, theta=theta, device=CPU)
    _, local, _ = tmesh.shard_inversion(theta, batch, mesh)

    def loss_fn_b(th, b):
        return tinv.batch_transient_loss(th, b, model, params, tstops)

    th = tinv._tree_map(lambda x: x.detach().clone().requires_grad_(True), theta)
    val, grads = tinv._make_grad_fn(inv, loss_fn_b, TrainingStats(), mesh)(th, local)
    out["train_ude_vg"] = (float(val), [g.numpy() for g in grads])
    dummy = dataclasses.replace(params, UDE=dataclasses.replace(params.UDE, grad="dummy"))
    inv_d = tinv.Inversion(model=model, glaciers=batch, parameters=dummy, theta=theta,
                           device=CPU)
    for name, m in (("dummy_vg_mesh", mesh), ("dummy_vg_single", None)):
        b = local if m is not None else batch
        val, grads = tinv._make_grad_fn(inv_d, loss_fn_b, TrainingStats(), m)(theta, b)
        out[name] = (float(val), [g.numpy() for g in grads])

    # one A per glacier: this rank's rows of its gradient
    model_a = Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True)))
    theta_a = theta_from_numpy(data["theta_a"], device=CPU)
    val, grads = tmesh.make_shard_map_value_and_grad(model_a, params, tstops, mesh,
                                                     per_glacier_keys=("A",))(theta_a, batch)
    out["per_glacier"] = (float(val), grads["A"].numpy())
    out["shard_theta"] = tmesh.shard_theta(theta_a, mesh, per_glacier_keys=("A",))["A"].numpy()
    from odinn_tpu_torch.parallel.multiprocess import gather_to_host, is_multiprocess

    out["is_multiprocess"] = is_multiprocess()
    out["gathered"] = gather_to_host({"x": torch.full((2, 3), float(out["rank"])),
                                      "y": [torch.arange(3) + 10 * out["rank"]]})

    # train_ude: the single process (run i on rank i % 2 alone), then the mesh
    for i, (name, n_g, hyper, grad, solver) in enumerate(TRAININGS):
        p = sharding_params(TRAIN_TSPAN, **hyper)
        p = dataclasses.replace(p, UDE=dataclasses.replace(p.UDE, grad=grad),
                                solver=dataclasses.replace(p.solver, **solver))
        b = tinv.gather_batch(batch, torch.arange(n_g)).replace(glacier_ids=None)
        runs = {}
        for kind in ("single", "mesh"):
            if kind == "single" and i % out["size"] != out["rank"]:
                continue
            inv = tinv.Inversion(model=model, glaciers=b, parameters=p, theta=theta, device=CPU)
            if kind == "single":
                res = tinv.train_ude(inv, mesh=None)
            elif name == "jax_padded":
                # through the registered mesh, as enable_multiprocessing leaves it
                registered = enable_multiprocessing()
                try:
                    res = tinv.train_ude(inv)
                finally:
                    tmesh.set_active_mesh(None)
                out["registered_size"] = tmesh.mesh_size(registered)
            else:
                res = tinv.train_ude(inv, mesh=mesh)
            runs[kind] = {"losses": list(res.stats.losses), "theta": _leaves(inv.theta),
                          "grad_norms": list(res.stats.grad_norm_hist),
                          "H": res.simulation["H"].numpy()}
            if kind == "mesh":
                runs[kind]["same_on_every_rank"] = _same_on_every_rank(inv.theta, mesh)
        out[name] = runs
    p = sharding_params(TRAIN_TSPAN, optimizer="adam", learning_rate=1e-2, epochs=1,
                        batch_size=8)
    res = tinv.run_inversion(tinv.Inversion(model=model, glaciers=batch, parameters=p,
                                            theta=theta, device=CPU), mesh=mesh)
    with torch.no_grad():
        res1 = tinv.forward_batch(res.stats.theta, batch, model, p,
                                  tinv.assemble_tstops(p, batch), device=CPU)
    out["run_inversion"] = {"losses": list(res.stats.losses), "H": res.simulation["H"].numpy(),
                            "H_single": res1.numpy()}

    # the rows dimension: taken, substeps="auto" too (its stage-end
    # re-probe on the rows), against one process
    from torch.distributed.device_mesh import init_device_mesh

    out["make_mesh_3"] = _raises(lambda: tmesh.make_mesh(3), ValueError)
    mesh2d = init_device_mesh("cpu", (1, 2), mesh_dim_names=("glaciers", "rows"))
    auto = dataclasses.replace(params, solver=dataclasses.replace(params.solver,
                                                                  substeps="auto"))
    rows_runs = {}
    for kind, m in (("mesh", mesh2d), ("single", None)):
        inv = tinv.Inversion(model=model, glaciers=batch, parameters=auto, theta=theta,
                             device=CPU)
        res = tinv.train_ude(inv, mesh=m)
        rows_runs[kind] = {"losses": list(res.stats.losses), "theta": _leaves(inv.theta),
                           "substeps": inv.parameters.solver.substeps}
    out["rows_train_ude"] = rows_runs
    _, rows_local, _ = tmesh.shard_inversion(theta, batch, mesh2d)
    out["rows_shard_inversion"] = (rows_local.row_shard.lo, rows_local.row_shard.hi,
                                   rows_local.H0.shape[-2])
    try:
        out["rows_set_active_mesh"] = tuple(tmesh.set_active_mesh(mesh2d).mesh_dim_names)
    finally:
        tmesh.set_active_mesh(None)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_ensemble.py's problem: 2 Halfar glaciers of 24², SI PCG-15
# ---------------------------------------------------------------------------

def ensemble_scenario(data, mesh):
    import dataclasses

    import odinn_tpu_torch.core.params as P
    from odinn_tpu_torch.convert import glacier_from_numpy
    from odinn_tpu_torch.laws.laws import LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.simulation import inversion as tinv
    from odinn_tpu_torch.simulation.eki import eki_train
    from odinn_tpu_torch.simulation.ensemble import multistart_train

    batch = glacier_from_numpy(data["batch"], data["rgi_id"], device=CPU)
    params = P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=P.SimulationParameters(tspan=(5.0, 5.5), use_MB=False, test_mode=True),
        solver=P.SolverParameters(step=1.0 / 6.0, substeps=1, solver="SI", cg_iters=15,
                                  rkc_stages=12),
        hyper=P.Hyperparameters(optimizer=("adam",), learning_rate=(0.08,), epochs=(3,),
                                batch_size=8),
        UDE=P.UDEParameters(grad="jax", target="A"))
    model = Model(iceflow=SIA2DModel(A=LawA_inversion(params, scalar=True)))
    out = {}
    for n in (4, 3):            # 4 split over the ranks, 3 run whole on every rank
        runs = {}
        for kind, m in (("single", None), ("mesh", mesh)):
            inv = tinv.Inversion(model=model, glaciers=batch, parameters=params, device=CPU)
            ms = multistart_train(inv, n_restarts=n, seed=4, mesh=m)
            runs[kind] = {"losses": ms.losses, "final": ms.final_losses, "best": ms.best_idx,
                          "thetas": _leaves(ms.thetas), "best_theta": _leaves(inv.theta)}
        out[f"multistart_{n}"] = runs
    # LBFGS and LM refinement of the best restart, its glacier axis split
    runs = {}
    for kind, m in (("single", None), ("mesh", mesh)):
        p = dataclasses.replace(params, hyper=dataclasses.replace(
            params.hyper, optimizer=("adam", "lbfgs", "lm"), learning_rate=(0.08, 1.0, 1e-3),
            epochs=(2, 1, 1), gn_cg_iters=1))
        inv = tinv.Inversion(model=model, glaciers=batch, parameters=p, device=CPU)
        ms = multistart_train(inv, n_restarts=2, seed=4, mesh=m, refine_top_k=1)
        runs[kind] = {"refined": ms.refined_losses, "best": ms.best_idx,
                      "best_theta": _leaves(inv.theta)}
    out["multistart_refine"] = runs
    for j in (4, 3):
        runs = {}
        for kind, m in (("single", None), ("mesh", mesh)):
            inv = tinv.Inversion(model=model, glaciers=batch, parameters=params, device=CPU)
            res = eki_train(inv, n_ensemble=j, n_iters=2, seed=2, mesh=m, perturb_obs=True)
            runs[kind] = {"misfits": res.misfits, "thetas": _leaves(res.thetas),
                          "best": res.best_idx, "mean_loss": res.mean_loss,
                          "same_on_every_rank": _same_on_every_rank(res.thetas, mesh)}
        out[f"eki_{j}"] = runs
    return out


SCENARIOS = {"mesh": mesh_scenario, "ensemble": ensemble_scenario}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    pid, nproc, port, devs = int(argv[0]), int(argv[1]), argv[2], int(argv[3])
    scenario, in_path, out_dir = argv[4:7]
    torch.set_num_threads(1)
    from odinn_tpu_torch.parallel.multiprocess import global_mesh, init_distributed

    init_distributed(f"localhost:{port}", nproc, pid, devices_per_process=devs, device=CPU)
    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    out = SCENARIOS[scenario](data, global_mesh())
    with open(os.path.join(out_dir, f"rank{pid}.pkl"), "wb") as fh:
        pickle.dump(_np(out), fh)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
