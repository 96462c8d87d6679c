"""Inversion: training the trainable laws and initial thickness through the
PDE solve.

``run_inversion`` → ``train_ude``: staged optimizers (Adam/AdamW, LBFGS,
and Levenberg–Marquardt stages ``"lm"``/``"gn"``/``"gauss_newton"``/
``"gauss-newton"``, :mod:`odinn_tpu_torch.inverse.gauss_newton`) over the θ
tree, with best-iterate tracking. The gradient is autograd through the
whole forward solve of the stacked glacier batch
(``UDEParameters(grad="jax")``), a hand-written adjoint
(``grad="discrete"``/``"continuous"`` or a ``DiscreteAdjoint``/
``ContinuousAdjoint``, :mod:`odinn_tpu_torch.inverse.gradient`), whose
pullbacks on the card are the same kernels', forward mode
(``grad="forward"``: one ``torch.autograd.forward_ad`` solve per θ leaf,
for per-glacier scalar θ; on the card through the kernels' tangent rules),
or a random gradient (``grad="dummy"``/``DummyAdjoint``, for testing the
pipeline: normal draws from a ``torch.Generator`` seeded 0 at every call,
not JAX's numbers). The transient loss is
Σ_g Σ_τ Δt_τ · ℓ(H_g(t_τ), refs_g(t_τ)) with the glacier axis as a batch
dimension, plus once per solve the "initial" terms (the regularizations of
``losses/regularization.py``, on H₀ and θ) and the "aggregate" terms (the
time-aggregated losses of ``losses/time_aggregated.py``, on the whole
trajectory). A classical inversion trains per-glacier laws
(``LawA_inversion``, ``LawC_inversion``, ``LawN_inversion``) and, with a
model ``initial_condition``, H₀ = σ(θ_IC). On the CUDA card the solve runs
through the fused kernels; with ``solver="RKC"`` every RKC2 step is one
``rkc_interval`` launch and every backward stage one ``sia2d_rhs_vjp``
launch; with ``solver="SI"``/``"SI2"`` every step is one ``si_step`` launch
forward and, by the implicit-function adjoint, one ``si_step_transpose``
and one ``si_step_vjp`` launch backward.

Adam and AdamW are ``torch.optim.Adam``/``AdamW`` (the update of optax's:
bias-corrected, eps outside the square root; AdamW with optax's default
weight decay 1e-4). LBFGS is ``torch.optim.LBFGS`` with its strong-Wolfe
line search, one iteration per epoch, optax's history of 10 and up to 20
line-search steps.

Every target trains: the A target, the hybrid-D (``LawY``) and pure-D
(``LawU``) targets and the capped target (``SIA2DModel.max_D``), by
autograd and by the manual adjoints; the D and capped targets take the
generic path, with no kernel launch. Periodic laws (``callback_freq`` > 0)
train by autograd only: the manual adjoints refuse them
(:func:`odinn_tpu_torch.inverse.gradient.check_adjoint_supported`).

The tolerance contract: ``adaptive="replay"`` records the accepted steps of
one error-controlled forward before training and trains through their
replay (by autograd only); ``substeps="auto"`` sizes the fixed-step solve
from probe solves before training, and for an explicit solver probes again
at every stage's end, raising the substeps when the θ reached needs more.
A non-finite loss in either mode rewinds to the best finite iterate,
re-sizes there (at least doubling the substeps, or re-recording the
schedule with each step split 2^(attempt−1) ways) and reruns the stage, at
most three times. ``adaptive=True`` is forward-only and refused.

``run_inversion(path=…, file_name=…)`` saves the trained result
(:mod:`odinn_tpu_torch.utils.io`); ``load_inversion_file`` reads it back.

Scale-out: with a mesh (``train_ude(…, mesh=…)``, or one registered by
``set_active_mesh`` / ``api.enable_multiprocessing``) over the ranks of a
``torch.distributed`` job, each rank solves its own block of the glacier
axis (:mod:`odinn_tpu_torch.parallel.mesh`) and the loss and every gradient
leaf are summed over the ranks by one ``all_reduce`` a step (``grad="dummy"``'s
draw excepted: every rank draws the same one). θ stays whole on every
rank, and every host decision (the best iterate, the non-finite check and
the gradient norm, LBFGS's line search, the re-sizings) reads reduced
values, so the ranks take the same steps. The tolerance is resolved on the
whole batch; the final trajectories are gathered, so every rank returns
the same ``Results``. A 2-D mesh ``("glaciers", "rows")`` also splits each
glacier's grid rows (:mod:`odinn_tpu_torch.parallel.spatial`): each rank
solves its glacier block on its rows, the loss and gradient are summed
over the whole mesh, and the trajectories are gathered over both
dimensions and cropped to the original grid and glacier count. The
tolerance contract is resolved on the whole batch there too, before the
placement, as the JAX package resolves it; its stage-end re-probe and
its recovery probe the rank's rows, their controllers' norms summed over
the row group and their step counts maximised over the job. Replay
solves, and the continuous adjoint, run on the rows.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from odinn_tpu_torch.core.device import resolve_device
from odinn_tpu_torch.core.glacier import (
    loss_normalization, map_tensors, per_glacier_column, stack_glaciers)
from odinn_tpu_torch.core.params import torch_dtype
from odinn_tpu_torch.losses.losses import LossContext, LossH, LossV, MultiLoss, term_kind
from odinn_tpu_torch.models.model import (
    Model, glacier_index, init_theta, initial_thickness, make_values_fn, resolve_outer_values)
from odinn_tpu_torch.parallel.mesh import (
    active_mesh, allreduce_sum, gather_rows, glacier_mesh, has_rows, mesh_rank, mesh_size,
    pad_batch_to, shard_inversion)
from odinn_tpu_torch.physics.sia2d import v_from_h
from odinn_tpu_torch.simulation.observations import thickness_at, velocity_at
from odinn_tpu_torch.simulation.prediction import (
    calibrate_substeps, forward_batch, forward_glacier, resolve_replay, resolve_substeps)
from odinn_tpu_torch.simulation.results import Results, TrainingStats, create_results
from odinn_tpu_torch.simulation.solver import build_tstops
from odinn_tpu_torch.utils.io import TrainingResult, save_inversion_file

__all__ = ["Inversion", "assemble_tstops", "glacier_transient_loss", "glacier_residuals",
           "batch_transient_loss", "gather_batch", "resolve_accum_chunks", "train_ude",
           "run_inversion"]


def _default_loss():
    return MultiLoss(terms=(LossH(),), weights=(1.0,))


def _host_times(x) -> list:
    return np.unique(np.asarray(torch.as_tensor(x).detach().cpu(), dtype=float)).tolist()


def assemble_tstops(params, batch):
    """The solver's save grid unioned with every observation time of the
    batch, so transient losses never interpolate."""
    extra = []
    if params.solver.tstops is not None:
        extra.extend(np.asarray(params.solver.tstops, float).ravel().tolist())
    td = batch.thickness_data
    if td is not None and td.t is not None:
        extra.extend(_host_times(td.t))
    vd = batch.velocity_data
    if vd is not None and vd.t is not None:
        extra.extend(_host_times(vd.t))
    dd = batch.dhdt_data
    if dd is not None:
        extra.extend(_host_times(dd.t1))
        extra.extend(_host_times(dd.t2))
    return build_tstops(params.simulation.tspan, params.solver.step,
                        extra=extra if extra else None)


class _LossEnv:
    """The loss terms by kind, the context factory and the time-matched
    observation lookup of one (batched) loss evaluation."""

    def __init__(self, theta, glacier, model, params, tstops):
        loss_cfg = params.UDE.empirical_loss_function or _default_loss()
        if not isinstance(loss_cfg, MultiLoss):
            loss_cfg = MultiLoss(terms=(loss_cfg,), weights=(1.0,))
        self.ts = np.asarray(torch.as_tensor(tstops).detach().cpu(), dtype=np.float64)
        self.dts = np.diff(self.ts)
        self.glacier = glacier
        self.theta = theta
        self.model = model
        self.glacier_idx = glacier_index(glacier)
        self.normalization = loss_normalization(glacier).to(glacier.H0.device)
        t0 = float(self.ts[0])
        outer = resolve_outer_values(model, theta, glacier, t0)
        vfn = make_values_fn(model, theta, glacier, t0, outer)
        dx = per_glacier_column(glacier, glacier.dx)
        dy = per_glacier_column(glacier, glacier.dy)

        shard = glacier.row_shard
        self.row_rank = 0 if shard is None else shard.rank

        def velocity_fn(H, t):
            return v_from_h(H, glacier.B, dx, dy, vfn, model.target, params.physical,
                            shard=shard)

        self.velocity_fn = velocity_fn
        pairs = list(zip(loss_cfg.weights, loss_cfg.terms))
        kinds = {"transient": [], "initial": [], "aggregate": []}
        for w, term in pairs:
            kind = term_kind(term)
            if kind not in kinds:
                raise ValueError(f"loss term {term!r} has an unknown kind {kind!r}")
            kinds[kind].append((w, term))
        self.transient, self.initial, self.aggregate = kinds.values()

    def make_ctx(self, H_ref=None, V_ref=None, Vx_ref=None, Vy_ref=None, H_ref_ext=None):
        g = self.glacier
        return LossContext(H_ref=H_ref, V_ref=V_ref, Vx_ref=Vx_ref, Vy_ref=Vy_ref,
                           velocity_fn=self.velocity_fn, normalization=self.normalization,
                           theta=self.theta, glacier_idx=self.glacier_idx, glacier=g,
                           dx=g.dx, dy=g.dy, H_ref_ext=H_ref_ext)

    def counted(self, term) -> float:
        """1, or 0 for a term that reads θ alone (``reads_grid`` False) on a
        row rank other than 0: such a term is whole on every rank of a row
        group, and the trainer's all-reduce would count it once per rank."""
        return 0.0 if (self.row_rank and not getattr(term, "reads_grid", True)) else 1.0

    def initial_H(self):
        """The H₀ the initial-state terms see: σ(θ_IC) or the data's H₀."""
        return initial_thickness(self.model, self.theta, self.glacier)

    def once_per_solve(self, traj):
        """The initial-state terms at t₀ and the aggregate terms on the
        trajectory (T, …, nx, ny): per glacier, weighted, or None when the
        loss has neither."""
        total = None
        if self.initial:
            ctx, h_init = self.make_ctx(), self.initial_H()
            for w, term in self.initial:
                v = w * self.counted(term) * term(ctx, h_init, float(self.ts[0]))
                total = v if total is None else total + v
        if self.aggregate:
            ctx = self.make_ctx()
            ts = torch.as_tensor(self.ts).to(traj.device)
            for w, term in self.aggregate:
                v = w * self.counted(term) * term(ctx, traj, ts)
                total = v if total is None else total + v
        return total

    def obs_at(self, tau, dtype):
        """References and per-glacier validity gates at save index τ."""
        t = float(self.ts[tau])
        h_ref, h_valid = thickness_at(self.glacier.thickness_data, t, dtype)
        v_ref, vx_ref, vy_ref, v_valid = velocity_at(self.glacier.velocity_data, t, dtype)
        shard = self.glacier.row_shard
        h_ext = None
        if shard is not None and h_ref is not None:
            h_ext = thickness_at(shard.ext.thickness_data, t, dtype)[0]
        ctx = self.make_ctx(H_ref=h_ref, V_ref=v_ref, Vx_ref=vx_ref, Vy_ref=vy_ref,
                            H_ref_ext=h_ext)
        return t, ctx, h_valid, v_valid

    @staticmethod
    def term_valid(term, h_valid, v_valid):
        """Thickness terms need a matching H observation at this tstop,
        velocity terms a matching V observation, others both."""
        if isinstance(term, LossH):
            return h_valid
        if isinstance(term, LossV):
            return v_valid
        return h_valid * v_valid


def glacier_transient_loss(theta, glacier, model, params, tstops):
    """(loss, trajectory) of a glacier, or of a stacked batch with the
    (n_g,) per-glacier losses: Σ_τ Δt_τ · Σ_terms w·valid·ℓ(H(t_τ), refs),
    normalized by each glacier's pixel count, plus the weighted initial-state
    terms at t₀ and aggregate terms on the trajectory."""
    traj = forward_glacier(theta, glacier, model, params, tstops)
    env = _LossEnv(theta, glacier, model, params, tstops)
    total = torch.zeros((), dtype=traj.dtype, device=traj.device)
    if env.transient:
        for tau in range(1, len(env.ts)):
            t, ctx, h_valid, v_valid = env.obs_at(tau, traj.dtype)
            acc = 0.0
            for w, term in env.transient:
                acc = acc + w * env.term_valid(term, h_valid, v_valid) * term(ctx, traj[tau], t)
            total = total + acc * float(env.dts[tau - 1])
    once = env.once_per_solve(traj)
    if once is not None:
        total = total + once
    return total, traj


def _rows(r, batched: bool):
    """A residual block flattened per glacier: (n_g, −1) for a batch."""
    return r.reshape(r.shape[0], -1) if batched else r.reshape(-1)


def _per_glacier(c, like):
    """A per-glacier factor (a number or an (n_g,) tensor) shaped to
    broadcast over a batch's block ``like``."""
    if isinstance(c, torch.Tensor) and c.ndim == 1:
        return c.reshape(c.shape + (1,) * (like.ndim - 1))
    return c


def glacier_residuals(theta, glacier, model, params, tstops):
    """The least-squares residuals r with Σr² == :func:`glacier_transient_loss`:
    (n_g, R) for a stacked batch, one row per glacier, or (R,) for a lone
    glacier. Every configured term must have ``.residuals`` (LossH, LossV,
    LossHV over L2Sum/LogSum, LossDhdt, LossAvgV, the Tikhonov family);
    others raise with a remedy. Transient blocks carry √(w·Δt_τ·valid),
    initial and aggregate blocks √w; a transient block's rows run over the
    tstops, then the grid, as the JAX package ravels them."""
    traj = forward_glacier(theta, glacier, model, params, tstops)
    env = _LossEnv(theta, glacier, model, params, tstops)
    batched = glacier.is_batched

    def check(term):
        if not hasattr(term, "residuals"):
            raise NotImplementedError(
                f"Gauss-Newton training needs a least-squares residual form for "
                f"{term!r} (no .residuals method); use grad='jax' with "
                f"Adam/LBFGS for this loss")

    pieces = []
    if env.transient:
        for _, term in env.transient:
            check(term)
        per_t = []
        for tau in range(1, len(env.ts)):
            t, ctx, h_valid, v_valid = env.obs_at(tau, traj.dtype)
            blocks = []
            for w, term in env.transient:
                valid = env.term_valid(term, h_valid, v_valid)
                c = torch.sqrt(torch.as_tensor(w * float(env.dts[tau - 1]) * valid,
                                               dtype=traj.dtype, device=traj.device))
                blocks.extend(_per_glacier(c, r) * r for r in term.residuals(ctx, traj[tau], t))
            per_t.append(blocks)
        for b in range(len(per_t[0]) if per_t else 0):
            stacked = torch.stack([blocks[b] for blocks in per_t], dim=1 if batched else 0)
            pieces.append(_rows(stacked, batched))
    for kind, terms in (("initial", env.initial), ("aggregate", env.aggregate)):
        if not terms:
            continue
        ctx = env.make_ctx()
        for w, term in terms:
            check(term)
            sw = torch.sqrt(torch.as_tensor(w * env.counted(term), dtype=traj.dtype))
            if kind == "initial":
                rs = term.residuals(ctx, env.initial_H(), float(env.ts[0]))
            else:
                rs = term.residuals(ctx, traj, torch.as_tensor(env.ts).to(traj.device))
            pieces.extend(_rows(sw * r, batched) for r in rs)
    if not pieces:
        shape = (traj.shape[1], 0) if batched else (0,)
        return torch.zeros(shape, dtype=traj.dtype, device=traj.device)
    return torch.cat(pieces, dim=-1)


def batch_transient_loss(theta, batch, model, params, tstops):
    """Sum of the transient losses over the stacked glacier batch."""
    losses, _ = glacier_transient_loss(theta, batch, model, params, tstops)
    return torch.sum(losses)


def gather_batch(batch, idx):
    """Glaciers ``idx`` of a stacked batch: every field with the leading
    glacier axis is indexed along it, ``glacier_ids`` too, so per-glacier θ
    entries still resolve to the original glaciers."""
    n_g = batch.H0.shape[0]
    idx = torch.as_tensor(idx, device=batch.H0.device)
    batch = batch.replace(glacier_ids=glacier_index(batch))
    return map_tensors(batch, lambda x: x[idx] if x.ndim >= 1 and x.shape[0] == n_g else x)


@dataclass
class Inversion:
    """A training run: model, glaciers (a stacked batch, or a list stacked
    on construction) and parameters on ``device`` (None: the CUDA card).
    θ defaults to ``init_theta`` in ``simulation.float_dtype``."""

    model: Model
    glaciers: Any
    parameters: Any
    results: Optional[Results] = None
    theta: Any = None
    device: Optional[Any] = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        if isinstance(self.glaciers, (list, tuple)):
            self.glaciers = stack_glaciers(list(self.glaciers), device=dev)
        else:
            self.glaciers = self.glaciers.to(dev)
        self.device = dev
        if self.theta is None:
            dtype = torch_dtype(self.parameters.simulation.float_dtype)
            self.theta = init_theta(self.model, self.glaciers, dtype)


def _stages(hyper) -> Sequence[Tuple[str, float, int]]:
    """The (optimizer, learning rate, epochs) stages of the hyperparameters."""
    opts = hyper.optimizer if isinstance(hyper.optimizer, (tuple, list)) else (hyper.optimizer,)
    eps = hyper.epochs if isinstance(hyper.epochs, (tuple, list)) else (hyper.epochs,)
    lrs = hyper.learning_rate if isinstance(hyper.learning_rate, (tuple, list)) else (
        hyper.learning_rate,
    ) * len(opts)
    if len(eps) != len(opts):
        raise ValueError("hyper.epochs and hyper.optimizer stage counts differ")
    return list(zip(opts, lrs, eps))


def resolve_accum_chunks(cfg, n: int) -> int:
    """hyper.grad_accum_chunks for a batch of ``n`` glaciers: ``"auto"`` is
    the largest chunk count that keeps chunks at ≥ 64 glaciers."""
    if cfg == "auto":
        best = 1
        for k in range(2, n // 64 + 1):
            if n % k == 0 and n // k >= 64:
                best = k
        return best
    return int(cfg or 1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _forward_mode_grad(theta, b, model, params, tstops, members: Optional[int] = None):
    """(loss, gradients in θ's leaf order) by forward mode: each glacier's
    loss depends on its own θ entries only (per-glacier laws route by
    glacier index), so one dual solve per θ leaf, with tangent 1 on every
    glacier at once, reads the gradient off the per-glacier losses'
    tangents; a batch row adds into its glacier's entry (``glacier_ids``
    under minibatching).

    ``members``: θ is a stack of that many members over a folded batch
    (``simulation.ensemble.fold_members``): each leaf's member shape must be
    per-glacier scalar, member k's rows add into its own θ row (at
    k·n_θ + glacier id of the flattened leaf), and the loss is the (members,)
    vector of per-member sums."""
    leaves = _tree_leaves(theta)
    lead = 0 if members is None else 1
    for x in leaves:
        if x.ndim - lead != 1:
            raise ValueError(
                "grad='forward' requires per-glacier SCALAR θ leaves of shape "
                f"(n_glaciers,), got {tuple(x.shape[lead:])}: it reads the gradient off "
                "per-glacier loss tangents, which only resolves one component per "
                "glacier per leaf. Use classical inversion laws (LawA_inversion/"
                "LawC_inversion/LawN_inversion); gridded or NN θ needs a reverse-mode "
                "path (grad='jax'/'discrete'/'continuous').")
    idxs = glacier_index(b)
    val, grads = None, []
    for l, x in enumerate(leaves):
        with fwAD.dual_level(), torch.no_grad():
            duals = [fwAD.make_dual(p.detach(), torch.ones_like(p) if i == l else
                                    torch.zeros_like(p)) for i, p in enumerate(leaves)]
            it = iter(duals)
            losses, _ = glacier_transient_loss(_tree_map(lambda _: next(it), theta), b, model,
                                               params, tstops)
            primal, tangent = fwAD.unpack_dual(losses)
        if val is None:
            val = (torch.sum(primal) if members is None
                   else primal.reshape(members, -1).sum(dim=1))
        jv = torch.zeros_like(primal) if tangent is None else tangent
        rows = idxs.to(x.device)
        if members is not None:     # member k's rows are the k-th block of the fold
            rows = rows + x.shape[1] * torch.arange(
                members, device=x.device).repeat_interleave(rows.numel() // members)
        grads.append(torch.zeros(x.numel(), dtype=x.dtype, device=x.device).index_add(
            0, rows, jv.to(x.dtype)).reshape(x.shape))
    return val, grads


def _dummy_grad(theta, members: Optional[int] = None):
    """Normal draws in θ's leaf order from a ``torch.Generator`` seeded 0
    (the same at every call), drawn on the host and moved to each leaf.
    ``members``: θ is a stack of that many members, and every member gets
    the same draw of the member's leaf shape, as the JAX package's
    restart ``vmap`` gives its unbatched key's draw to every restart."""
    gen = torch.Generator().manual_seed(0)
    lead = 0 if members is None else 1
    return [torch.randn(tuple(x.shape[lead:]), generator=gen, dtype=torch.float64).to(
        dtype=x.dtype, device=x.device).expand(x.shape).clone() for x in _tree_leaves(theta)]


def _reduced(vg, mesh, grads_too: bool = True):
    """``vg`` with its loss, and its gradients when ``grads_too``, summed
    over the mesh's ranks in one ``all_reduce`` (no mesh: ``vg``)."""
    if mesh is None:
        return vg

    def reduced_vg(theta, b):
        val, grads = vg(theta, b)
        if not grads_too:
            return allreduce_sum([val], mesh)[0], grads
        out = allreduce_sum([val, *grads], mesh)
        return out[0], out[1:]

    return reduced_vg


_GRAD_MODES = ("jax", "sciml", "discrete", "continuous", "forward", "dummy")


def grad_mode(grad_cfg) -> str:
    """The gradient mode's name of ``params.UDE.grad``: the string itself,
    or a DiscreteAdjoint's or ContinuousAdjoint's ``name``."""
    name = grad_cfg if isinstance(grad_cfg, str) else getattr(grad_cfg, "name", "jax")
    if name not in _GRAD_MODES:
        raise ValueError(f"unknown adjoint method {name!r}")
    return name


def _mode_value_and_grad(name, model, params, tstops, loss_fn_b,
                         members: Optional[int] = None):
    """``value_and_grad(theta, b) -> (loss, gradients in θ's leaf order)``
    of one batch for the gradient mode ``name``: autograd of
    ``loss_fn_b(theta, b)``, a hand-written adjoint (one forward solve and
    one backward sweep), forward mode (one dual solve per θ leaf) or the
    dummy gradient (the loss without a graph). After a manual-adjoint call,
    ``value_and_grad.record`` holds that call's record
    (:func:`~odinn_tpu_torch.inverse.gradient.glacier_adjoint_value_and_grad`;
    one dict, refilled at every call).

    ``members``: θ is a stack of that many members over a folded batch
    (``simulation.ensemble.fold_members``, whose model and parameters these
    are), and ``loss_fn_b`` and ``value_and_grad`` give the (members,)
    per-member losses."""
    record = {}
    if name == "forward":
        def value_and_grad(theta, b):
            return _forward_mode_grad(theta, b, model, params, tstops, members)
    elif name == "dummy":
        def value_and_grad(theta, b):
            with torch.no_grad():
                val = loss_fn_b(theta, b)
            return val, _dummy_grad(theta, members)
    elif name in ("discrete", "continuous"):
        from odinn_tpu_torch.inverse.gradient import (
            check_adjoint_supported, glacier_adjoint_value_and_grad, resolve_adjoint)

        check_adjoint_supported(model)
        adjoint, quad_nodes = resolve_adjoint(params, tstops, name)

        def value_and_grad(theta, b):
            record.clear()
            losses, grads = glacier_adjoint_value_and_grad(
                theta, b, model, params, tstops, adjoint, quad_nodes, record)
            val = torch.sum(losses) if members is None else losses.reshape(members, -1).sum(1)
            return val, _tree_leaves(grads)
    else:
        def value_and_grad(theta, b):
            leaves = _tree_leaves(theta)
            loss = loss_fn_b(theta, b)
            grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)]
    value_and_grad.record = record
    return value_and_grad


def _make_grad_fn(inversion: Inversion, loss_fn_b, stats: TrainingStats, mesh=None):
    """``vg(theta, b) -> (loss, grads)`` for params.UDE.grad, with the
    gradients in θ's leaf order (:func:`_mode_value_and_grad`). Chunked
    accumulation (hyper.grad_accum_chunks) sums the exact per-chunk losses
    and gradients of autograd and the adjoints, bounding the live autograd
    graph (or the adjoint's trajectory) to one chunk. With a ``mesh`` the
    loss and gradients are summed over its ranks (the dummy draw is not:
    every rank draws the same). ``vg.record`` is the manual adjoint's record
    of its last chunk."""
    params = inversion.parameters
    name = grad_mode(params.UDE.grad)
    k_cfg = getattr(params.hyper, "grad_accum_chunks", 1) or 1
    one = _mode_value_and_grad(name, inversion.model, params,
                               assemble_tstops(params, inversion.glaciers), loss_fn_b)

    def value_and_grad(theta, b):
        val, grads = one(theta, b)
        if name == "forward":
            stats.solves += len(grads)
        elif name in ("discrete", "continuous"):
            stats.solves += 1
            stats.gradients += 1
        elif name != "dummy":       # autograd: loss_fn_b counted the solve
            stats.gradients += 1
        return val, grads

    def vg(theta, b):
        if name in ("forward", "dummy"):     # one dual solve a leaf, one draw: unchunked
            return value_and_grad(theta, b)
        n = b.H0.shape[0]
        k = resolve_accum_chunks(k_cfg, n)
        if k <= 1:
            return value_and_grad(theta, b)
        if n % k != 0:
            raise ValueError(f"grad_accum_chunks={k} must divide the batch of {n} glaciers")
        val, grads = None, None
        for c in range(k):
            v, g = value_and_grad(theta, gather_batch(b, torch.arange(c * n // k,
                                                                      (c + 1) * n // k)))
            val = v if val is None else val + v
            grads = g if grads is None else [a + x for a, x in zip(grads, g)]
        return val, grads

    out = _reduced(vg, mesh, grads_too=name != "dummy")
    out.record = one.record
    return out


def _record(stats: TrainingStats, val, theta, gnorm, dt):
    stats.losses.append(val)
    stats.niter += 1
    stats.theta = theta
    if getattr(stats, "_record_theta_hist", False):
        stats.theta_hist.append(_tree_map(lambda x: x.detach().cpu().numpy().copy(), theta))
    if not np.isfinite(val):
        stats.retcode = "NumericalFailure"
        raise FloatingPointError(
            f"training loss became non-finite at iteration {stats.niter}. "
            "The forward solve likely violated the explicit stability limit "
            "(large creep/diffusivity). Increase solver.substeps / "
            "solver.rkc_stages (see suggest_substeps / rkc_stages_for), set "
            "SIA2DModel.max_D, or lower the learning rate.")
    stats.grad_norm_hist.append(gnorm)
    stats.time_per_iter.append(dt)
    if gnorm > 1e7:
        print(f"[odinn_tpu_torch] WARNING: gradient norm {gnorm:.3e} > 1e7")


def _resolve_tolerance(params, batch, model, theta, tstops):
    """The training parameters with the replay schedule recorded and
    ``substeps="auto"`` sized at θ; ``adaptive=True``, and replay under a
    manual adjoint, are refused."""
    if params.solver.adaptive == "replay":
        grad_cfg = params.UDE.grad
        grad_kind = grad_cfg if isinstance(grad_cfg, str) else getattr(grad_cfg, "name", "jax")
        if grad_kind not in ("jax", "sciml", "forward", "dummy"):
            raise ValueError(
                f"solver.adaptive='replay' replays the BS3(2) stepper, which "
                f"the manual adjoints do not transpose — use grad='jax' (or "
                f"'forward'), got grad={grad_kind!r}")
        params = resolve_replay(params, batch, model, theta, tstops)
    elif params.solver.adaptive:
        raise ValueError(
            "solver.adaptive error-controlled integration is forward-only "
            "— it serves Prediction/generate_ground_truth. For training, either "
            "set adaptive='replay' (record the accepted dt schedule once, replay "
            "it as a fixed differentiable schedule), set fixed "
            "solver.substeps/rkc_stages/cg_iters, or set substeps='auto' to "
            "calibrate fixed substeps from solver.reltol via probe solves "
            "(with adaptive=False).")
    return resolve_substeps(params, batch, model, theta, tstops)


def train_ude(inversion: Inversion, callback: Optional[Callable] = None,
              record_theta_hist: bool = False, mesh=None) -> Results:
    """Staged training loop (see the module doc). θ warm-starts across
    stages; each stage starts from the best iterate so far; the returned θ
    is the best iterate seen (full-batch losses). ``record_theta_hist`` keeps
    θ per iteration. Results hold the final forward with the trained θ.
    The resolved parameters (recorded schedule, sized substeps) are left in
    ``inversion.parameters``; ``stats.substeps_bumps`` lists each re-sizing
    as (iteration, old, new). ``mesh`` (default: the registered
    ``active_mesh()``) splits the glacier axis over a job's ranks, and a
    ``"rows"`` dimension each glacier's grid rows (module doc)."""
    model = inversion.model
    batch = inversion.glaciers
    params = inversion.parameters
    tstops = assemble_tstops(params, batch)
    stats = TrainingStats()
    stats._record_theta_hist = record_theta_hist
    mesh = glacier_mesh(active_mesh() if mesh is None else mesh, "train_ude")
    rows = has_rows(mesh)
    halo = None
    if rows:
        from odinn_tpu_torch.parallel.spatial import static_halo

        halo = static_halo(params, model)
    # this rank's glaciers (padded to a multiple of the mesh), θ as rank 0 has it
    theta0, local, n_results = shard_inversion(inversion.theta, batch, mesh, halo=halo)
    theta = _tree_map(lambda x: x.detach().clone().requires_grad_(True), theta0)
    leaves = _tree_leaves(theta)
    substeps_auto = params.solver.substeps == "auto"
    # the tolerance contract resolved on the whole batch, before any
    # sharding, as the JAX package resolves it; the stage-end re-probe and
    # the recovery probe the placed batch, on a rows mesh its rows
    params = _resolve_tolerance(params, batch, model, theta, tstops)
    inversion.parameters = params
    probed = local if rows else batch
    # an explicit solver's sizing is a stability bound that the θ reached
    # may outgrow (SI and SI2 are unconditionally stable: theirs buys
    # accuracy only); a replay schedule is held fixed and shares the hazard
    substeps_guard = substeps_auto and params.solver.solver not in ("SI", "SI2")
    replay_mode = params.solver.adaptive == "replay"

    def loss_fn_b(theta, b):
        stats.solves += 1
        return batch_transient_loss(theta, b, model, params, tstops)

    def eval_loss(theta, b) -> float:
        with torch.no_grad():
            val = loss_fn_b(theta, b)
        return float(val if mesh is None else allreduce_sum([val], mesh)[0])

    vg = _make_grad_fn(inversion, loss_fn_b, stats, mesh)
    best = {"val": math.inf, "theta": None}

    def fold_best(val, values):
        if val < best["val"]:
            best["val"] = val
            best["theta"] = [v.detach().clone() for v in values]

    def load(values):
        with torch.no_grad():
            for p, v in zip(leaves, values):
                p.copy_(v)

    def resize(new_params, bump):
        """Train on with ``new_params``: the gradient function rebuilt, the
        re-sizing listed."""
        nonlocal params, vg
        params = new_params
        inversion.parameters = params
        stats.substeps_bumps.append(bump)
        vg = _make_grad_fn(inversion, loss_fn_b, stats, mesh)

    def recheck_substeps():
        """The staleness guard: probe at the stage's best iterate, and raise
        the substeps when it needs more than the current count."""
        needed = calibrate_substeps(theta, probed, model, params, tstops)
        cur = int(params.solver.substeps)
        if needed <= cur:
            return
        print(f"[odinn_tpu_torch] substeps='auto' probe went stale: current θ needs "
              f"{needed} substeps/interval (calibrated {cur} at the initial "
              f"θ) — re-sizing for the remaining stages")
        resize(params.replace(solver=dataclasses.replace(params.solver, substeps=needed)),
               (stats.niter, cur, needed))

    def end_stage():
        """The last iterate's loss joins the best; the next stage starts
        from the best iterate, and an explicit auto-sized solve is probed
        there."""
        if best["theta"] is not None:
            fold_best(eval_loss(theta, local), leaves)
            load(best["theta"])
        if substeps_guard:
            recheck_substeps()

    def recover(attempt):
        """A non-finite loss mid-stage: rewind to the best finite iterate,
        drop the failed record, and re-size there before the stage reruns."""
        load(best["theta"])
        n = len(stats.grad_norm_hist)
        del stats.losses[n:]
        if record_theta_hist:
            del stats.theta_hist[n:]
        stats.niter = n
        stats.retcode = None
        if replay_mode:
            splits = 2 ** (attempt - 1)
            print("[odinn_tpu_torch] adaptive='replay': non-finite loss mid-stage "
                  "— rewinding to the best iterate, re-recording the "
                  f"accepted-dt schedule there (each step split {splits}×), "
                  "and rerunning the stage")
            p = params.replace(solver=dataclasses.replace(params.solver, replay_dts=None))
            p = resolve_replay(p, probed, model, theta, tstops)
            if splits > 1:
                dts = np.repeat(p.solver.replay_dts / splits, splits, axis=-1)
                p = p.replace(solver=dataclasses.replace(p.solver, replay_dts=dts))
            resize(p, (stats.niter, "replay", f"re-recorded x{splits}"))
        else:
            cur = int(params.solver.substeps)
            needed = max(calibrate_substeps(theta, probed, model, params, tstops), 2 * cur)
            print(f"[odinn_tpu_torch] substeps='auto': non-finite loss mid-stage — "
                  f"rewinding to the best iterate, re-sizing {cur} → {needed} "
                  f"substeps/interval, and rerunning the stage")
            resize(params.replace(solver=dataclasses.replace(params.solver, substeps=needed)),
                   (stats.niter, cur, needed))

    def gnorm_of(grads) -> float:
        return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))

    # the whole (padded) batch that minibatches draw from: on a rows mesh,
    # every glacier on this rank's rows
    padded = batch if mesh is None else pad_batch_to(batch, mesh_size(mesh))[0]
    n_glaciers = padded.H0.shape[0]
    if rows:
        from odinn_tpu_torch.parallel.spatial import pad_batch_rows, row_slab

        padded = row_slab(pad_batch_rows(padded, mesh.size(1))[0], mesh, halo)
    bsize = min(params.hyper.batch_size, n_glaciers)
    # a batch size that covers the glaciers stays full-batch under padding
    minibatching = 0 < bsize < n_results
    if minibatching:
        print(f"[odinn_tpu_torch] minibatching {bsize}/{n_glaciers} glaciers per step "
              f"(set hyper.batch_size >= {n_results} for full-batch)")
        if mesh is not None and bsize % mesh_size(mesh) != 0:
            raise ValueError(
                f"hyper.batch_size={bsize} must be a multiple of the mesh's "
                f"glacier-axis size {mesh_size(mesh)} (glacier-axis sharding)")
    else:
        fold_best(eval_loss(theta, local), leaves)
    rng = np.random.default_rng(0)

    def draw_minibatch():
        """The same ids on every rank; each rank takes its block of them."""
        ids = rng.choice(n_glaciers, size=bsize, replace=False)
        if mesh is not None:
            k = bsize // mesh_size(mesh)
            ids = ids[mesh_rank(mesh) * k:(mesh_rank(mesh) + 1) * k]
        return gather_batch(padded, ids)

    def run_lm_stage(lr, epochs):
        """Matrix-free Levenberg–Marquardt on the least-squares loss
        (:mod:`odinn_tpu_torch.inverse.gauss_newton`): ``lr`` is the
        initial damping λ, ``epochs`` the iteration count. Full batch only.
        With ``hyper.gn_glacier_norm`` each glacier's rows are weighted by
        its inverse loss at the stage start, and the recorded losses are
        re-priced as the true loss."""
        from odinn_tpu_torch.inverse.gauss_newton import lm_train, make_residual_fn

        if minibatching:
            raise ValueError("Gauss-Newton stages require full-batch training "
                             f"(hyper.batch_size >= {n_glaciers})")
        base = make_residual_fn(model, params, tstops)

        def resid(th, b):
            stats.solves += 1
            return base(th, b)

        glacier_norm = params.hyper.gn_glacier_norm
        if glacier_norm:
            with torch.no_grad():
                r0 = resid(theta, local)
            L_g = torch.sum(r0 * r0, dim=tuple(range(1, r0.ndim)))
            if rows:
                from odinn_tpu_torch.parallel.spatial import rows_sum

                L_g = rows_sum(L_g, local.row_shard)
            mean_L = torch.mean(L_g) if mesh is None else (
                allreduce_sum([torch.sum(L_g)], mesh)[0] / n_glaciers
                / (mesh.size(1) if rows else 1))
            sqrt_w = torch.sqrt(1.0 / (L_g + 0.01 * mean_L))
            sqrt_w = sqrt_w.reshape((-1,) + (1,) * (r0.ndim - 1))
            unweighted = resid

            def resid(th, b):
                return unweighted(th, b) * sqrt_w

        t_stage, n_before = time.time(), stats.niter

        def rec(v, th, gn):
            if glacier_norm:
                v = eval_loss(th, local)
            _record(stats, v, th, gn, 0.0)
            if callback is not None:
                callback(stats)

        trained, lm_losses = lm_train(theta, local, resid, iters=epochs,
                                      cg_iters=params.hyper.gn_cg_iters, init_damping=lr,
                                      record=rec, precond=params.hyper.gn_precond,
                                      cg_restarts=params.hyper.gn_cg_restarts,
                                      allreduce=None if mesh is None else (
                                          lambda ts: allreduce_sum(ts, mesh)))
        # rec() recorded 0.0 a record; each gets the stage's mean wall time
        n_rec = stats.niter - n_before
        if n_rec > 0:
            stats.time_per_iter[-n_rec:] = [(time.time() - t_stage) / n_rec] * n_rec
        load(_tree_leaves(trained))
        # the accept rule is monotone: the returned θ is the stage's best;
        # normalized losses are not comparable, end_stage prices it then
        if not glacier_norm:
            fold_best(min(lm_losses), leaves)

    def run_stage(opt_name, lr, epochs):
        if opt_name in ("adam", "adamw"):
            opt = (torch.optim.Adam(leaves, lr=lr) if opt_name == "adam"
                   else torch.optim.AdamW(leaves, lr=lr, weight_decay=1e-4))
            for _ in range(epochs):
                t_start = time.time()
                if minibatching:
                    val, grads = vg(theta, draw_minibatch())
                else:
                    val, grads = vg(theta, local)
                    fold_best(float(val), leaves)
                for p, g in zip(leaves, grads):
                    p.grad = g
                opt.step()
                _record(stats, float(val), theta, gnorm_of(grads), time.time() - t_start)
                if callback is not None:
                    callback(stats)
        elif opt_name in ("lbfgs", "bfgs"):
            if params.hyper.lbfgs_linesearch not in ("auto", "zoom"):
                raise ValueError(
                    "hyper.lbfgs_linesearch: the port's LBFGS line search is "
                    "torch.optim.LBFGS's strong-Wolfe search ('auto' or 'zoom'), got "
                    f"{params.hyper.lbfgs_linesearch!r}")
            # one iteration per epoch; max_eval (torch's default is 5/4 of
            # max_iter, which leaves the line search no trial) allows the
            # first evaluation and 20 line-search steps, optax's zoom budget
            opt = torch.optim.LBFGS(leaves, lr=lr, max_iter=1, max_eval=21, history_size=10,
                                    line_search_fn="strong_wolfe")
            evals = []

            def closure():
                val, grads = vg(theta, local)
                for p, g in zip(leaves, grads):
                    p.grad = g
                evals.append((float(val), gnorm_of(grads)))
                return val

            for _ in range(epochs):
                t_start = time.time()
                before = [p.detach().clone() for p in leaves]
                evals.clear()
                opt.step(closure)
                val, gnorm = evals[0]          # at θ before the step
                fold_best(val, before)
                _record(stats, val, theta, gnorm, time.time() - t_start)
                if callback is not None:
                    callback(stats)
        elif opt_name in ("lm", "gn", "gauss_newton", "gauss-newton"):
            run_lm_stage(lr, epochs)
        else:
            raise ValueError(f"unknown optimizer {opt_name!r}")
        end_stage()

    for opt_name, lr, epochs in _stages(params.hyper):
        attempts = 0
        while True:
            try:
                run_stage(opt_name.lower(), lr, epochs)
                break
            except FloatingPointError:
                # recoverable only where the trainer owns the sizing and a
                # finite best iterate exists to rewind to
                if not (substeps_guard or replay_mode) or best["theta"] is None \
                        or attempts >= 3:
                    raise
                attempts += 1
                recover(attempts)

    if best["theta"] is not None and stats.losses:
        final_val = eval_loss(theta, local)
        if best["val"] < final_val:
            load(best["theta"])
        stats.final_loss = min(best["val"], final_val)
    stats.retcode = "Success"
    trained = _tree_map(lambda x: x.detach(), theta)
    stats.theta = trained
    if model.initial_condition is not None and "IC" in trained:
        stats.initial_conditions = trained["IC"]
    inversion.theta = trained

    with torch.no_grad():
        stats.solves += 1
        trajs = forward_batch(trained, local, model, params, tstops, device=inversion.device)
    if mesh is not None:
        trajs = gather_rows(trajs, mesh, nx=batch.H0.shape[-2])[:n_results]
    inversion.results = Results(simulation=create_results(trajs, tstops, glaciers=batch),
                                stats=stats)
    return inversion.results


def run_inversion(inversion: Inversion, callback=None, path: Optional[str] = None,
                  file_name: Optional[str] = None, mesh=None) -> Results:
    """Train (:func:`train_ude`, on ``mesh``: by default the registered
    mesh) and return the results. With ``path`` or
    ``file_name`` set, the trained result is saved as a
    :class:`~odinn_tpu_torch.utils.io.TrainingResult` (θ, the gradient-norm
    and loss histories, and ``niter``/``final_loss``/``retcode`` in the
    ``.meta.json`` sidecar) at ``path/file_name``, by default
    ``./training_result.pt``."""
    results = train_ude(inversion, callback=callback, mesh=mesh)
    if path is not None or file_name is not None:
        stats = results.stats
        save_inversion_file(os.path.join(path or ".", file_name or "training_result.pt"),
                            TrainingResult(theta=stats.theta, grad_norm_hist=stats.grad_norm_hist,
                                           losses=stats.losses,
                                           params_meta={"niter": stats.niter,
                                                        "final_loss": stats.final_loss,
                                                        "retcode": stats.retcode}))
    return results
