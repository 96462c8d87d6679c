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
# the host-driven controllers on the rows (all over TRAIN_TSPAN): the
# tolerance of the adaptive runs, the SI calibration's (which doubles the
# substeps 1 → 4 there, each probe at PCG-8) and the SI training's
# (4 substeps at PCG-4 from its whole-batch calibration)
RELTOL = 1e-4
SI_RELTOL = 5e-3
SI_TRAIN_RELTOL = 1e-2
SI_PROBE = dict(cg_probe=8, cg_candidates=(4, 6))
# train_ude on the rows under the controllers: (name, hyperparameters,
# grad, solver fields); auto_rk4's two stages re-probe at the stage end
CONTROLLER_TRAININGS = (
    ("replay", dict(optimizer="adam", learning_rate=1e-2, epochs=2), "jax",
     dict(adaptive="replay", reltol=RELTOL)),
    ("auto_rk4", dict(optimizer=("adam", "adam"), learning_rate=(1e-2, 1e-2), epochs=(1, 1)),
     "jax", dict(substeps="auto", reltol=RELTOL)),
    ("auto_si", dict(optimizer="adam", learning_rate=1e-2, epochs=1), "jax",
     dict(substeps="auto", reltol=SI_TRAIN_RELTOL, solver="SI")),
    ("continuous", dict(optimizer="adam", learning_rate=1e-2, epochs=2), "continuous", {}),
)
# the gridded laws' sliding ceiling (SyntheticC's c_max)
C_MAX = 1e-19


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

    out.update(controllers(data, mesh, batch, padded, theta, model))
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


def gridded_model(params):
    """A model whose laws read grids: A from the gridded temperature
    (Cuffey–Paterson on each cell, times a factor of the plane's mean
    temperature, on the staggered grid) and C from the degree-days and the
    bed's roughness (``SyntheticC``)."""
    from odinn_tpu_torch.laws import inputs as I
    from odinn_tpu_torch.laws.laws import Law, SyntheticC, poly_A_paterson_cuffey
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.ops.stencils import avg

    a_of_t = poly_A_paterson_cuffey()

    def apply_a(theta, inp):
        T = inp["T_grid"]
        mean = torch.mean(T, dim=(-2, -1), keepdim=True)
        return avg(a_of_t(T) * (1.0 + 0.1 * torch.tanh(mean / 10.0)))

    law_a = Law(slot="A", apply_fn=apply_a, inputs=(I.AvgGriddedTemp(),), callback_freq=0.0,
                trainable=False, name="gridA")
    return Model(iceflow=SIA2DModel(A=law_a, C=SyntheticC(params, c_max=C_MAX)))


def _own(x, shard):
    """A tensor's numpy, with the shard's position."""
    return {"x": _np(x), "lo": shard.lo, "hi": shard.hi}


def controllers(data, mesh, batch, padded, theta, model) -> dict:
    """The host-driven controllers on the rows: the adaptive forward (also
    row-padded), the substep calibrations, the replay record, train_ude
    under each, the continuous adjoint, the Laplace posterior, gridded law
    values and the explicit-collective step. Each run's collectives and
    seconds are recorded beside it."""
    import time

    from odinn_tpu_torch.convert import glacier_from_numpy
    from odinn_tpu_torch.inverse.gradient import make_adjoint_value_and_grad
    from odinn_tpu_torch.inverse.gauss_newton import make_residual_fn
    from odinn_tpu_torch.inverse.uncertainty import laplace_posterior, laplace_uncertainty
    from odinn_tpu_torch.laws.laws import LawA_inversion
    from odinn_tpu_torch.models.model import Model, SIA2DModel, init_theta
    from odinn_tpu_torch.parallel import mesh as tmesh
    from odinn_tpu_torch.parallel import spatial
    from odinn_tpu_torch.simulation import inversion as tinv
    from odinn_tpu_torch.simulation import prediction as tpred
    from odinn_tpu_torch.simulation.solver import integrate_adaptive

    out, costs = {}, {}

    def timed(name, fn):
        spatial.EXCHANGES.update(calls=0, seconds=0.0)
        t0 = time.perf_counter()
        r = fn()
        costs[name] = (spatial.EXCHANGES["calls"], time.perf_counter() - t0)
        return r

    tstops = tinv.assemble_tstops(spatial_params(TRAIN_TSPAN), batch)
    _, local, _ = tmesh.shard_inversion(theta, batch, mesh)
    _, local_pad, _ = tmesh.shard_inversion(theta, padded, mesh)
    sh = local.row_shard

    # the adaptive forward: own rows, accepted and trial counts, RHS evaluations
    p_ad = spatial_params(TRAIN_TSPAN, solver=dict(adaptive=True, reltol=RELTOL))
    for key, b in (("adaptive", local), ("adaptive_padded", local_pad)):
        rec = {}
        integrate_adaptive.rhs_evals = 0
        with torch.no_grad():
            traj, naccs = timed(key, lambda b=b, rec=rec: tpred.forward_glacier(
                theta, b, model, p_ad, tstops, _return_stats=True, _record=rec))
        out[key] = {"traj": _own(traj, b.row_shard), "naccs": _np(naccs),
                    "trials": _np(rec["trials"]), "ids": _np(b.glacier_ids),
                    "rhs_evals": integrate_adaptive.rhs_evals}

    # the calibrations and the replay record, on the rows
    p_rk = spatial_params(TRAIN_TSPAN, solver=dict(reltol=RELTOL))
    p_si = spatial_params(TRAIN_TSPAN, solver=dict(reltol=SI_RELTOL, solver="SI"))
    p_rp = spatial_params(TRAIN_TSPAN, solver=dict(adaptive="replay", reltol=RELTOL))
    out["calibrate"] = timed("calibrate", lambda: tpred.calibrate_substeps(
        theta, local, model, p_rk, tstops))
    out["calibrate_padded"] = timed("calibrate_padded", lambda: tpred.calibrate_substeps(
        theta, local_pad, model, p_rk, tstops))
    out["calibrate_si"] = timed("calibrate_si", lambda: tpred.calibrate_substeps_si(
        theta, local, model, p_si, tstops, **SI_PROBE))
    out["replay_dts"] = timed("replay_record", lambda: tpred.resolve_replay(
        p_rp, local, model, theta, tstops).solver.replay_dts)

    # train_ude under each controller, on the mesh
    for name, hyper, grad, solver in CONTROLLER_TRAININGS:
        p = spatial_params(TRAIN_TSPAN, hyper=hyper, grad=grad, solver=solver)
        inv = tinv.Inversion(model=model, glaciers=batch, parameters=p, theta=theta, device=CPU)
        res = timed(f"train_{name}", lambda inv=inv: tinv.train_ude(inv, mesh=mesh))
        out[f"train_{name}"] = {
            "losses": list(res.stats.losses), "theta": _leaves(inv.theta),
            "H": res.simulation["H"].numpy(), "bumps": list(res.stats.substeps_bumps),
            "same_on_every_rank": _same_on_every_rank(inv.theta, mesh)}

    # the continuous adjoint's loss and gradient, summed over the mesh, and
    # its reverse steps (the single process's on ranks 0 and 1)
    p_c = spatial_params(TRAIN_TSPAN, grad="continuous")
    inv = tinv.Inversion(model=model, glaciers=batch, parameters=p_c, theta=theta, device=CPU)
    vg = make_adjoint_value_and_grad(inv, "continuous")
    val, grads = timed("continuous_vg", lambda: vg(theta, local))
    leaves = tinv._tree_leaves(grads)
    summed = tmesh.allreduce_sum([val] + leaves, mesh)
    out["continuous_vg"] = {"loss": float(summed[0]), "grads": [g.numpy() for g in summed[1:]],
                            "reverse_steps": vg.record["reverse_steps"], "ids": _np(local.glacier_ids)}
    if dist_rank() < 2:
        single = make_adjoint_value_and_grad(inv, "continuous")
        single(theta, tinv.gather_batch(batch, local.glacier_ids))
        out["continuous_vg"]["single_steps"] = single.record["reverse_steps"]

    # the Laplace posterior of a per-glacier A on the rows (per-glacier
    # blocks and dense, p = 4), and laplace_uncertainty under the rows mesh
    model_a = Model(iceflow=SIA2DModel(A=LawA_inversion(spatial_params())))
    theta_a = init_theta(model_a, batch)
    _, local_a, _ = tmesh.shard_inversion(theta_a, batch, mesh)
    resid = make_residual_fn(model_a, spatial_params(TRAIN_TSPAN), tstops)
    out["laplace_blocks"] = timed("laplace_blocks", lambda: laplace_posterior(
        theta_a, local_a, resid, structure="per_glacier")._cov)
    post = timed("laplace_dense", lambda: laplace_posterior(theta_a, local_a, resid))
    out["laplace_dense"] = {"cov": post._cov, "sigma2": post.sigma2}
    inv_a = tinv.Inversion(model=model_a, glaciers=batch, parameters=spatial_params(TRAIN_TSPAN),
                           theta=theta_a, device=CPU)
    tmesh.set_active_mesh(mesh)
    try:
        out["laplace_uncertainty"] = laplace_uncertainty(inv_a, structure="per_glacier")._cov
    finally:
        tmesh.set_active_mesh(None)

    # gridded law values on the rows: the forward's own rows
    grid = glacier_from_numpy(data["grid_batch"], data["grid_rgi_id"], device=CPU)
    p_g = spatial_params(TRAIN_TSPAN)
    model_g = gridded_model(p_g)
    local_g = spatial.shard_spatial(grid, mesh)
    with torch.no_grad():
        traj = timed("gridded", lambda: tpred.forward_glacier(None, local_g, model_g, p_g,
                                                               tstops))
    out["gridded"] = {"traj": _own(traj, local_g.row_shard), "ids": _np(local_g.glacier_ids)}

    # the explicit-collective step on the 2-D mesh: glacier blocks with
    # whole planes, summed over the glacier axis
    step = tmesh.make_shard_map_value_and_grad(model, spatial_params(TRAIN_TSPAN), tstops, mesh)
    val, g = timed("shard_map", lambda: step(theta, batch))
    out["shard_map"] = (float(val), [x.numpy() for x in tinv._tree_leaves(g)])
    out["costs"] = costs
    return out


def dist_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


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
