"""One rank of the 4-rank (2 × 2) CPU job of ``test_torch_spatial.py``
(started by ``odinn_tpu_torch.parallel.multiprocess.launch_local_workers``):

    python -m tests.torch_spatial_ranks RANK 4 PORT 1 IN_PICKLE OUT_DIR

It imports the port only (no JAX): the test process hands it the JAX
package's problem (tests/test_spatial_sharding.py's: 4 Halfar glaciers of
24², RK4 at 8 substeps, A = NN(T)) as numpy (``IN_PICKLE``), and it writes
what the rank computed to ``OUT_DIR/rank<r>.pkl``, numpy only. Every rank
runs every scenario on the ``("glaciers", "rows")`` mesh in the same order;
the single-process runs the mesh runs are held to are split over the
ranks (no collective in them).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

CPU = "cpu"
F64 = torch.float64
# the hooked operators held to their unsharded calls (op, θ of the SI step)
OPERATORS = ("rhs_fused", "rhs_generic", "velocity", "rkc8", "si_theta1", "si_theta_half",
             "si_generic")
# the train_ude runs held to the JAX package: (name, hyperparameters, grad)
TRAININGS = (
    ("adam3", dict(optimizer="adam", learning_rate=1e-2, epochs=3), "jax"),
    ("discrete_lm", dict(optimizer=("adam", "lm"), learning_rate=(1e-2, 1e-2), epochs=(2, 2),
                         batch_size=4, gn_cg_iters=2), "discrete"),
)
SI6 = dict(solver="SI", substeps=1, cg_iters=6)
# the trainings run over the first 3 months (an exchange is ~1.5 ms of
# gloo on the CPU, and RK4 makes one each RHS evaluation and pullback);
# the problem's RK4 for Adam by autograd, SI at PCG-6 for the discrete
# ladder, whose LM stage through RK4's steps takes 20 s in one process
TRAIN_TSPAN = (5.0, 5.25)
TRAIN_SOLVER = {"adam3": {}, "discrete_lm": SI6}


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


def _raises(fn, exc=NotImplementedError) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def spatial_params(tspan=(5.0, 5.5), **kw):
    """tests/test_spatial_sharding.py's parameters over ``tspan``; ``kw``
    replaces solver fields (``solver``), hyperparameters (``hyper``), the
    gradient (``grad``) or the loss (``loss``)."""
    import odinn_tpu_torch.core.params as P

    p = P.Parameters(
        physical=P.PhysicalParameters(min_A=8e-21, max_A=2e-18),
        simulation=P.SimulationParameters(tspan=tspan, use_MB=False, use_velocities=False),
        solver=P.SolverParameters(step=1.0 / 12.0, substeps=8),
        hyper=P.Hyperparameters(optimizer="adam", learning_rate=1e-2, epochs=1),
        UDE=P.UDEParameters(grad="jax"))
    if "solver" in kw:
        p = dataclasses.replace(p, solver=dataclasses.replace(p.solver, **kw["solver"]))
    if "hyper" in kw:
        p = dataclasses.replace(p, hyper=P.Hyperparameters(**kw["hyper"]))
    if "grad" in kw:
        p = dataclasses.replace(p, UDE=dataclasses.replace(p.UDE, grad=kw["grad"]))
    if "loss" in kw:
        p = dataclasses.replace(p, UDE=dataclasses.replace(p.UDE,
                                                           empirical_loss_function=kw["loss"]))
    return p


def nn_model(params):
    from odinn_tpu_torch.laws.laws import LawA
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.models.nn import NeuralNetwork, default_architecture

    return Model(iceflow=SIA2DModel(A=LawA(NeuralNetwork(default_architecture(1, light=True)),
                                           params)))


@dataclasses.dataclass(frozen=True)
class ThetaTikhonov:
    """A Tikhonov term on a grid made from θ alone (the NN's first weight
    matrix tiled): whole on every rank of a row group, so the trainer must
    count it once."""

    kind: str = "initial"
    reads_grid = False

    def _grid(self, ctx):
        from odinn_tpu_torch.utils.flatten import tree_leaves

        w = tree_leaves(ctx.theta)[0].reshape(-1)
        n_g = ctx.glacier.H0.shape[0]
        return (w[None, :, None] * w[None, None, :]).expand(n_g, -1, -1)

    def __call__(self, ctx, H_pred, t):
        from odinn_tpu_torch.losses.regularization import TikhonovRegularization

        g = self._grid(ctx)
        return TikhonovRegularization()(g, 1.0, 1.0, torch.ones_like(g, dtype=torch.bool))

    def residuals(self, ctx, H_pred, t):
        from odinn_tpu_torch.losses.regularization import TikhonovRegularization

        g = self._grid(ctx)
        return (TikhonovRegularization().residual(g, 1.0, 1.0,
                                                  torch.ones_like(g, dtype=torch.bool)),)


# ---------------------------------------------------------------------------
# The primitives and the hooked operators against the unsharded calls
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(_np(a), dtype=np.float64), np.asarray(_np(b), dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _fields(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=F64)


def halo_checks(local, whole, shard):
    """RowHalo's forward, backward and jvp against the whole plane, at
    halos 1, 2, 8 and 13 (beyond a 12-row neighbour)."""
    import torch.autograd.forward_ad as fwAD

    out = {}
    lo, hi = shard.lo, shard.hi
    for h in (1, 2, 8, 13):
        t, b = shard.extent(h)
        x = whole.H0
        ext = shard.halo_rows(local.H0, h)
        out[f"fwd{h}"] = _rel(ext, x[..., lo - t:hi + b, :])
        # backward: ⟨halo(x), G⟩ = ⟨x, haloᵀ(G)⟩ per rank; the sum over the
        # row group of the own-row cotangents is the whole plane's
        G = _fields(x.shape, 7 + h)
        xo = local.H0.clone().requires_grad_(True)
        g_ext = G[..., lo - t:hi + b, :]
        (gx,) = torch.autograd.grad(torch.sum(shard.halo_rows(xo, h) * g_ext), xo)
        # the whole plane's transpose: each row's cotangent from every rank's slab
        want = torch.zeros_like(x)
        for q in range(shard.size):
            qlo, qhi = q * shard.own, (q + 1) * shard.own
            qt, qb = min(h, qlo), min(h, shard.nx - qhi)
            want[..., qlo - qt:qhi + qb, :] += G[..., qlo - qt:qhi + qb, :]
        out[f"bwd{h}"] = _rel(gx, want[..., lo:hi, :])
        with fwAD.dual_level():
            T = _fields(x.shape, 99 + h)
            dual = fwAD.make_dual(local.H0, T[..., lo:hi, :])
            tan = fwAD.unpack_dual(shard.halo_rows(dual, h)).tangent
        out[f"jvp{h}"] = _rel(tan, T[..., lo - t:hi + b, :])
    return out


def _operator(name, glacier, model, params, shard, theta):
    """H → the operator's output on ``glacier`` (a whole plane when
    ``shard`` is None)."""
    from odinn_tpu_torch.models.model import make_values_fn, resolve_outer_values
    from odinn_tpu_torch.ops.cuda import rkc_kernel
    from odinn_tpu_torch.ops.cuda.common import shared_exps
    from odinn_tpu_torch.ops.cuda.sia_kernel import derive_table
    from odinn_tpu_torch.physics.sia2d import (
        ValuesFn, scalar_law_table, sia2d_rhs, sia2d_rhs_generic, v_from_h)
    from odinn_tpu_torch.simulation.implicit import semi_implicit_step

    phys = params.physical
    outer = resolve_outer_values(model, theta, glacier, 5.0)
    vfn = make_values_fn(model, theta, glacier, 5.0, outer)
    dx = glacier.dx.reshape(-1, 1, 1)
    dy = glacier.dy.reshape(-1, 1, 1)
    tgt = model.target
    if name == "rhs_fused":
        return lambda H: sia2d_rhs(H, glacier.B, dx, dy, vfn, tgt, phys, shard=shard)
    if name == "rhs_generic":
        return lambda H: sia2d_rhs_generic(H, glacier.B, dx, dy, vfn, tgt, phys, shard=shard)
    if name == "velocity":
        return lambda H: v_from_h(H, glacier.B, dx, dy, vfn, tgt, phys, shard=shard)[2]
    if name == "rkc8":
        table = derive_table(scalar_law_table(vfn, tgt, dx, dy, glacier.H0), phys.rho, phys.g)
        exps = shared_exps(table)
        if shard is None:
            return lambda H: rkc_kernel.rkc_interval(H, glacier.B, table, 0.25, 8, phys.eta0,
                                                     exps)
        B = shard.bed(8)
        return lambda H: shard.crop(rkc_kernel.rkc_interval(shard.halo_rows(H, 8), B, table,
                                                            0.25, 8, phys.eta0, exps), 8)
    theta_si = {"si_theta1": 1.0, "si_theta_half": 0.5, "si_generic": 1.0}[name]
    if name == "si_generic":     # an inner law that returns the outer values: the tensor code
        vfn = ValuesFn(outer, inner=lambda vals, hbar, grad_s: vals)
    return lambda H: semi_implicit_step(H, glacier.B, dx, dy, vfn, tgt, phys, 0.25, 6,
                                        x0=1.01 * H, theta=theta_si, shard=shard)


def operator_checks(local, whole, shard, model, params, theta):
    """Each hooked operator's own rows, forward, VJP and JVP, against the
    unsharded call on this rank's glaciers' whole planes."""
    import torch.autograd.forward_ad as fwAD

    lo, hi = shard.lo, shard.hi
    out = {}
    for name in OPERATORS:
        f_whole = _operator(name, whole, model, params, None, theta)
        f_shard = _operator(name, local, model, params, shard, theta)
        Hw = whole.H0.clone()
        G = _fields(Hw.shape, 3)
        T = _fields(Hw.shape, 5) * 10.0
        Hw_g = Hw.clone().requires_grad_(True)
        yw = f_whole(Hw_g)
        (vw,) = torch.autograd.grad(torch.sum(yw * G), Hw_g)
        Hs = local.H0.clone().requires_grad_(True)
        ys = f_shard(Hs)
        (vs,) = torch.autograd.grad(torch.sum(ys * G[..., lo:hi, :]), Hs)
        with fwAD.dual_level():
            jw = fwAD.unpack_dual(f_whole(fwAD.make_dual(Hw, T))).tangent
        with fwAD.dual_level():
            js = fwAD.unpack_dual(f_shard(fwAD.make_dual(local.H0.clone(),
                                                         T[..., lo:hi, :]))).tangent
        out[name] = {"fwd": _rel(ys, yw[..., lo:hi, :]), "vjp": _rel(vs, vw[..., lo:hi, :]),
                     "jvp": _rel(js, jw[..., lo:hi, :])}
    return out


# ---------------------------------------------------------------------------
# The scenario
# ---------------------------------------------------------------------------

def spatial_scenario(data, mesh):
    import torch.distributed as dist

    from odinn_tpu_torch.convert import glacier_from_numpy, theta_from_numpy
    from odinn_tpu_torch.parallel import mesh as tmesh
    from odinn_tpu_torch.parallel import spatial
    from odinn_tpu_torch.simulation import inversion as tinv
    from odinn_tpu_torch.simulation.results import TrainingStats

    import odinn_tpu_torch.inverse.gauss_newton as tgn

    rank = dist.get_rank()
    batch = glacier_from_numpy(data["batch"], data["rgi_id"], device=CPU)
    theta = theta_from_numpy(data["theta"], device=CPU)
    # the LM stages' Hutchinson probes: the JAX package's draw
    probes = [theta_from_numpy(v, device=CPU) for v in data["probes"]]
    tgn._draw_probes = lambda gen, th, n: probes[:n]
    params = spatial_params()
    model = nn_model(params)
    out = {"rank": rank, "glacier_rank": tmesh.mesh_rank(mesh),
           "row_rank": int(mesh.get_local_rank("rows"))}

    # placement, and θ's IC rows
    _, local, n_orig = tmesh.shard_inversion(theta, batch, mesh)
    sh = local.row_shard
    out.update(n_orig=n_orig, lo=sh.lo, hi=sh.hi, H0=local.H0, glacier_ids=local.glacier_ids,
               obs=local.thickness_data.H)
    ic = torch.arange(4 * 24 * 24, dtype=F64).reshape(4, 24, 24)
    out["ic_rows"] = spatial.shard_theta_spatial({"IC": ic, "A": theta["A"]}, mesh)["IC"]

    # the primitives and the hooked operators, at halo 13 (the RKC step's 8
    # and RowHalo's check beyond a neighbour's block)
    local13 = spatial.shard_spatial(batch, mesh, halo=13)
    whole = tmesh.shard_glacier_axis(batch, mesh)
    out["halo"] = halo_checks(local13, whole, local13.row_shard)
    out["operators"] = operator_checks(local13, whole, local13.row_shard, model, params, theta)
    out["rows_sum"] = spatial.rows_sum(torch.tensor([float(sh.rank + 1)]), sh).item()

    # batch_transient_loss's value and gradient over 3 months, summed over the mesh
    for key, kw in (("vg_rk4", {}), ("vg_si6", {"solver": SI6})):
        p = spatial_params(TRAIN_TSPAN, **kw)
        tstops = tinv.assemble_tstops(p, batch)
        inv = tinv.Inversion(model=model, glaciers=batch, parameters=p, theta=theta, device=CPU)

        def loss_fn_b(th, b, p=p, tstops=tstops):
            return tinv.batch_transient_loss(th, b, model, p, tstops)

        th = tinv._tree_map(lambda x: x.detach().clone().requires_grad_(True), theta)
        val, grads = tinv._make_grad_fn(inv, loss_fn_b, TrainingStats(), mesh)(th, local)
        out[key] = (float(val), [g.numpy() for g in grads])

    # train_ude on the mesh, held to the JAX package by the test
    for name, hyper, grad in TRAININGS:
        p = spatial_params(TRAIN_TSPAN, hyper=hyper, grad=grad, solver=TRAIN_SOLVER[name])
        inv = tinv.Inversion(model=model, glaciers=batch, parameters=p, theta=theta, device=CPU)
        res = tinv.train_ude(inv, mesh=mesh)
        out[name] = {"losses": list(res.stats.losses), "theta": _leaves(inv.theta),
                     "H": res.simulation["H"].numpy(),
                     "same_on_every_rank": _same_on_every_rank(inv.theta, mesh)}

    # the single-process runs of the next checks, one on each of ranks 0 and 1
    singles = {}
    padded = glacier_from_numpy(data["pad_batch"], data["pad_rgi_id"], device=CPU)
    p_pad = spatial_params(TRAIN_TSPAN, hyper=dict(optimizer="adam", learning_rate=1e-2,
                                                   epochs=2), solver=SI6)
    p_tik = spatial_params(TRAIN_TSPAN, hyper=dict(optimizer="adam", learning_rate=1e-2,
                                                   epochs=2), solver=SI6, loss=_tikhonov_loss())
    runs = (("row_padding", padded, p_pad), ("replicated", batch, p_tik))
    for i, (name, b, p) in enumerate(runs):
        if rank == i:
            inv = tinv.Inversion(model=model, glaciers=b, parameters=p, theta=theta, device=CPU)
            res = tinv.train_ude(inv, mesh=None)
            singles[name] = {"losses": list(res.stats.losses), "theta": _leaves(inv.theta),
                             "H": res.simulation["H"].numpy()}
    out["singles"] = singles
    for name, b, p in runs:
        inv = tinv.Inversion(model=model, glaciers=b, parameters=p, theta=theta, device=CPU)
        res = tinv.train_ude(inv, mesh=mesh)
        out[name] = {"losses": list(res.stats.losses), "theta": _leaves(inv.theta),
                     "H": res.simulation["H"].numpy(),
                     "same_on_every_rank": _same_on_every_rank(inv.theta, mesh)}
    out["replicated_vg"] = _value_and_grad(model, batch, theta, p_tik, mesh, local)

    out["refusals"] = refusals(model, batch, theta, mesh)
    return out


def _tikhonov_loss():
    from odinn_tpu_torch.losses.losses import LossH, MultiLoss

    return MultiLoss(terms=(LossH(), ThetaTikhonov()), weights=(1.0, 1e-2))


def _value_and_grad(model, batch, theta, p, mesh, local):
    """(loss, gradient) on the mesh and in one process."""
    from odinn_tpu_torch.simulation import inversion as tinv
    from odinn_tpu_torch.simulation.results import TrainingStats

    tstops = tinv.assemble_tstops(p, batch)
    inv = tinv.Inversion(model=model, glaciers=batch, parameters=p, theta=theta, device=CPU)
    out = {}
    for kind, m, b in (("mesh", mesh, local), ("single", None, batch)):
        th = tinv._tree_map(lambda x: x.detach().clone().requires_grad_(True), theta)
        val, grads = tinv._make_grad_fn(
            inv, lambda t, bb: tinv.batch_transient_loss(t, bb, model, p, tstops),
            TrainingStats(), m)(th, b)
        out[kind] = (float(val), [g.numpy() for g in grads])
    return out


def _same_on_every_rank(theta, mesh) -> bool:
    from odinn_tpu_torch.parallel.mesh import replicate
    from odinn_tpu_torch.utils.flatten import tree_leaves

    return all(torch.equal(a, b) for a, b in zip(tree_leaves(theta),
                                                 tree_leaves(replicate(theta, mesh))))


def refusals(model, batch, theta, mesh) -> dict:
    """The rows mesh's refusals (ROADMAP.md Queue 1 item 11)."""
    from odinn_tpu_torch.inverse.uncertainty import laplace_uncertainty
    from odinn_tpu_torch.parallel.mesh import set_active_mesh
    from odinn_tpu_torch.simulation import inversion as tinv

    out = {}
    cases = (("adaptive", dict(solver=dict(adaptive=True))),
             ("replay", dict(solver=dict(adaptive="replay"))),
             ("substeps_auto", dict(solver=dict(substeps="auto"))),
             ("continuous", dict(grad="continuous")))
    for name, kw in cases:
        inv = tinv.Inversion(model=model, glaciers=batch, parameters=spatial_params(**kw),
                             theta=theta, device=CPU)
        out[name] = _raises(lambda: tinv.train_ude(inv, mesh=mesh))
    inv = tinv.Inversion(model=model, glaciers=batch, parameters=spatial_params(), theta=theta,
                         device=CPU)
    set_active_mesh(mesh)
    try:
        out["laplace"] = _raises(lambda: laplace_uncertainty(inv))
    finally:
        set_active_mesh(None)
    return out


SCENARIOS = {"spatial": spatial_scenario}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    pid, nproc, port, devs = int(argv[0]), int(argv[1]), argv[2], int(argv[3])
    in_path, out_dir = argv[4:6]
    torch.set_num_threads(1)
    from odinn_tpu_torch.parallel.multiprocess import init_distributed
    from odinn_tpu_torch.parallel.spatial import make_mesh_2d

    init_distributed(f"localhost:{port}", nproc, pid, devices_per_process=devs, device=CPU)
    with open(in_path, "rb") as fh:
        data = pickle.load(fh)
    out = spatial_scenario(data, make_mesh_2d(2, 2))
    with open(os.path.join(out_dir, f"rank{pid}.pkl"), "wb") as fh:
        pickle.dump(_np(out), fh)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main()
