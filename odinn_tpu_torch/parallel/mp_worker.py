"""One rank of a local multi-process job, self-verifying.

    python -m odinn_tpu_torch.parallel.mp_worker RANK N PORT DEVICES_PER_PROCESS
        [--device cuda|cpu] [--dtype float64|float32] [--optimizer adam|adam,lm]
        [--glaciers G]

(:func:`odinn_tpu_torch.parallel.multiprocess.launch_local_workers` starts
N of them.) Each rank joins the job (:func:`init_distributed`), then

1. trains the dry-run problem on the whole batch in this one process (no
   mesh): G Halfar glaciers of 24² (G = max(N, 4) by default), 3 monthly
   intervals, SI at PCG-15, A = NN(T) against Cuffey–Paterson ground
   truth, Adam (3 epochs, learning rate 1e-2) and optionally one Levenberg–Marquardt
   iteration (CG 3, :data:`LM_CG`);
2. trains the same problem through ``train_ude(inv, mesh=global_mesh())``,
   its glaciers split over the ranks (padded to a multiple of N);
3. asserts that the per-epoch losses, the final θ and the trajectories
   equal the single process's (float64: 1e-10, 1e-9 and 1e-9 relative;
   float32: 1e-5, 1e-4 and 1e-4), and that θ is bitwise the same on every
   rank (against a broadcast of rank 0's).

Rank 0 prints ``MP_OK {json}``: the job's size, the device, the dtype and
both loss curves.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

TSPAN = (5.0, 5.25)
NX = 24
# LM's CG converges in 3 iterations on this problem (A(T) over the glaciers'
# temperatures spans ~3 directions); a 4th divides roundoff by roundoff and
# turns the reduction order's last bits into ~1e-7 of θ, in one process too
LM_CG = 3


def build_problem(n_glaciers: int, device, dtype: str):
    """(params, model, glaciers, θ): the dry-run problem on ``device``."""
    from odinn_tpu_torch.core.params import (
        Hyperparameters, Parameters, PhysicalParameters, SimulationParameters,
        SolverParameters, UDEParameters, torch_dtype)
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.data.synthetic import halfar_glacier
    from odinn_tpu_torch.laws.laws import CuffeyPaterson, LawA
    from odinn_tpu_torch.models.model import Model, SIA2DModel, init_theta
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture
    from odinn_tpu_torch.simulation.prediction import generate_ground_truth
    from odinn_tpu_torch.simulation.solver import build_tstops

    params = Parameters(
        physical=PhysicalParameters(min_A=8e-21, max_A=8e-18),
        simulation=SimulationParameters(tspan=TSPAN, use_MB=False, use_velocities=False,
                                        float_dtype=dtype),
        solver=SolverParameters(step=1.0 / 12.0, substeps=2, solver="SI", cg_iters=15),
        hyper=Hyperparameters(optimizer="adam", learning_rate=1e-2, epochs=1),
        UDE=UDEParameters(grad="jax", target="A"),
    )
    fdt = torch_dtype(dtype)
    glaciers = [halfar_glacier(nx=NX, ny=NX, dx=120.0, dy=120.0, temp=float(t),
                               rgi_id=f"halfar-{i}", device=device, dtype=fdt)
                for i, t in enumerate(np.linspace(-25.0, -14.0, n_glaciers))]
    truth = Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0))
    glaciers = generate_ground_truth(glaciers, params, truth,
                                     build_tstops(TSPAN, params.solver.step), store=("H",),
                                     device=device)
    model = Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1), seed=666),
                                            params), n_value=3.0))
    batch = stack_glaciers(glaciers, device=device)
    return params, model, batch, init_theta(model, batch, fdt)


def _leaves(tree) -> list:
    from odinn_tpu_torch.utils.flatten import tree_leaves

    return tree_leaves(tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    pid, nproc, port, devs = int(argv[0]), int(argv[1]), argv[2], int(argv[3])
    ap = argparse.ArgumentParser(prog="mp_worker")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--glaciers", type=int, default=None)
    opts = ap.parse_args(argv[4:])

    from odinn_tpu_torch.parallel.mesh import mesh_size, replicate
    from odinn_tpu_torch.parallel.multiprocess import global_mesh, init_distributed

    world = init_distributed(f"localhost:{port}", nproc, pid, devices_per_process=devs,
                             device=opts.device)
    assert world == nproc, (world, nproc)
    if opts.device == "cpu":
        torch.set_num_threads(1)
    device = "cpu" if opts.device == "cpu" else None

    from odinn_tpu_torch.core.params import Hyperparameters
    from odinn_tpu_torch.simulation.inversion import Inversion, train_ude

    optimizers = tuple(opts.optimizer.split(","))
    n_g = opts.glaciers or max(world, 4)
    params, model, batch, theta = build_problem(n_g, device, opts.dtype)
    lrs = {"adam": 1e-2, "lm": 1e-2}
    epochs = {"adam": 3, "lm": 1}
    params = params.replace(hyper=Hyperparameters(
        optimizer=optimizers, learning_rate=tuple(lrs[o] for o in optimizers),
        epochs=tuple(epochs[o] for o in optimizers), batch_size=n_g, gn_cg_iters=LM_CG))

    def train(mesh):
        inv = Inversion(model=model, glaciers=batch, parameters=params, theta=theta,
                        device=device)
        return inv, train_ude(inv, mesh=mesh)

    inv_ref, res_ref = train(None)
    mesh = global_mesh()
    assert mesh_size(mesh) == world
    inv_mp, res_mp = train(mesh)

    tol_loss, tol = (1e-10, 1e-9) if opts.dtype == "float64" else (1e-5, 1e-4)
    errs = {"losses": _rel(res_mp.stats.losses, res_ref.stats.losses),
            "theta": max(_rel(a.cpu(), b.cpu()) for a, b in zip(_leaves(inv_mp.theta),
                                                                 _leaves(inv_ref.theta))),
            "trajectories": _rel(res_mp.simulation["H"].cpu(), res_ref.simulation["H"].cpu())}
    assert res_mp.simulation["H"].shape == res_ref.simulation["H"].shape
    assert errs["losses"] <= tol_loss and errs["theta"] <= tol and errs["trajectories"] <= tol, \
        errs
    leaves = _leaves(inv_mp.theta)
    from0 = _leaves(replicate(inv_mp.theta, mesh))
    assert all(torch.equal(a, b) for a, b in zip(leaves, from0)), \
        "θ differs between the ranks"

    if pid == 0:
        print("MP_OK " + json.dumps({
            "processes": nproc,
            "devices_per_process": devs,
            "global_devices": world,
            "device": str(leaves[0].device),
            "dtype": opts.dtype,
            "glaciers": n_g,
            "optimizer": list(optimizers),
            "losses": [float(v) for v in res_mp.stats.losses],
            "single_process_losses": [float(v) for v in res_ref.stats.losses],
            "final_loss": float(res_mp.stats.final_loss),
            "errors": errs,
        }), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
