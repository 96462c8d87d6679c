"""Multi-start (ensemble) training, and the member fold it runs on.

The JAX package trains N restarts as one more ``vmap`` axis: the device
sees N·G glacier solves a step. The port's kernels are ctypes launches
behind autograd Functions and cannot be vmapped, so the member axis is
folded into the kernels' glacier axis instead (:func:`fold_members`):

- the batch of G glaciers is tiled N times into one batch of N·G glaciers
  (each tensor field copied once), whose ``glacier_ids`` repeat the
  batch's own, so member k's rows read the same per-glacier θ entries as
  the batch does;
- every trainable law is wrapped to evaluate once per member, with that
  member's θ on its G rows of inputs, and the per-glacier values are
  concatenated along the glacier axis (the fused route's scalar table
  then holds N·G rows); the trainable initial condition likewise, and
  every "initial" loss term (the Tikhonov family, which reads θ through
  ``LossContext.theta``) sees its own member's θ and rows;
- θ is a stack: every leaf of the θ tree gains a leading member axis.

The folded batch then solves through the unchanged ``forward_glacier`` /
``glacier_transient_loss`` / ``glacier_residuals`` path: one ``si_step``,
``sia2d_rhs`` or ``rkc_interval`` launch per step for all N·G planes,
forward, backward and tangent. Members are independent, so the gradient
of Σ_k loss_k gives each member its own gradient, and one
``torch.optim.Adam`` over the stack's leaves, which updates element by
element, is N independent optimizers (JAX's ``vmap(opt.update)``).

Usage::

    inv = Inversion(model=model, glaciers=glaciers, parameters=params)
    ms = multistart_train(inv, n_restarts=8)      # explores; sets inv.theta
    run_inversion(inv)                            # refines the best start

``multistart_train`` runs the hyperparameters' leading Adam stages on every
restart. Trailing curvature stages (LBFGS/LM) either belong in a follow-up
``run_inversion`` on the single winner, or, with ``refine_top_k=k``, run on
the best k surviving restarts one after the other (LBFGS through
``train_ude``'s strong-Wolfe ``torch.optim.LBFGS`` stage, LM through
``lm_train``), with the final winner selected after refinement. The folded
Adam stages take every gradient mode of ``params.UDE.grad``, as the JAX
package's restart ``vmap`` of ``_make_grad_fn`` does: autograd; the
discrete or continuous adjoint (``DiscreteAdjoint`` / ``ContinuousAdjoint``
instances too) over the folded batch, its per-glacier losses summed by
member (a trainable H₀'s cotangent lands in each member's own θ_IC row);
forward mode, one dual solve a θ leaf for every member, each member's
loss tangents scattered into its own θ row; and the dummy gradient, one
draw of the member's leaf shape shared by every member (JAX draws from an
unbatched key inside its ``vmap``).

On a mesh of several ranks (:mod:`odinn_tpu_torch.parallel.mesh`; every
rank of a 2-D ``("glaciers", "rows")`` one, whose rows do not split the
restarts' batch, as in the JAX package) whose size divides the restart
count, each rank folds its own block of restarts
into its kernels' glacier axis and trains it (restarts are independent:
nothing is summed across ranks); the loss curves, final losses and θ
stacks are then gathered, so every rank returns the whole
``MultistartResult``. Otherwise every rank runs every restart, as the JAX
package's unsharded fallback does. The refinement splits each survivor's
glacier axis over the mesh (``train_ude(…, mesh=…)``, ``lm_train``'s
``allreduce``), and on a 2-D mesh its grid rows too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from odinn_tpu_torch.core.glacier import map_tensors
from odinn_tpu_torch.inverse.gauss_newton import lm_train, make_residual_fn
from odinn_tpu_torch.losses.losses import MultiLoss, term_kind
from odinn_tpu_torch.models.model import Model, glacier_index
from odinn_tpu_torch.parallel.mesh import (
    active_mesh, allreduce_sum, gather_rows, glacier_mesh, has_rows, mesh_devices,
    mesh_flat_rank, replicate, shard_inversion)
from odinn_tpu_torch.simulation.inversion import (
    Inversion, _mode_value_and_grad, _stages, _tree_leaves, assemble_tstops, gather_batch,
    glacier_residuals, glacier_transient_loss, grad_mode, resolve_accum_chunks, train_ude)
from odinn_tpu_torch.utils.flatten import tree_leaves, tree_map

__all__ = ["MultistartResult", "init_restarts", "multistart_train", "select_best",
           "stack_thetas", "member_theta", "fold_members", "folded_losses",
           "folded_residuals"]


def select_best(final_losses: np.ndarray) -> int:
    """Index of the best restart, nan-safe: a diverged restart (non-finite
    final loss) must never win (plain ``np.argmin`` returns the first NaN
    index). Raises if every restart diverged."""
    final = np.asarray(final_losses, np.float64)
    if not np.isfinite(final).any():
        raise FloatingPointError(
            "every restart diverged to a non-finite loss — lower the Adam "
            "learning rate or init_scale"
        )
    return int(np.argmin(np.where(np.isfinite(final), final, np.inf)))


@dataclass
class MultistartResult:
    """All restarts' trajectories plus the selected winner."""

    thetas: Any                 # θ tree with leading restart axis (final iterates)
    losses: np.ndarray          # (n_restarts, total_epochs) per-step losses
    final_losses: np.ndarray    # (n_restarts,) loss at the final iterate
    best_idx: int
    best_loss: float
    best_theta: Any             # winner's θ (no restart axis)
    refined_idxs: Any = None    # (k,) original restart indices that entered
                                # curvature refinement (refine_top_k)
    refined_losses: Any = None  # (k,) their post-refinement losses
    adjoint_records: list = dataclasses.field(default_factory=list)
                                # each Adam epoch's manual-adjoint record (the
                                # continuous adjoint's reverse steps; {} else)


def stack_thetas(thetas):
    """One θ stack (a leading member axis on every leaf) from a list of θ
    trees."""
    return tree_map(lambda *xs: torch.stack([x.detach() for x in xs]), *thetas)


def member_theta(stacked, k: int):
    """Member ``k`` of a θ stack."""
    return tree_map(lambda x: x[k], stacked)


def init_restarts(theta0, n_restarts: int, init_scale: float = 0.5, seed: int = 0):
    """Stack of ``n_restarts`` initializations with a leading restart axis.

    Restart 0 is ``theta0`` exactly (multistart can never do worse than the
    single start it replaces); restarts k>0 perturb every leaf with Gaussian
    noise of std ``init_scale × leaf_scale``, where leaf_scale is the leaf's
    own (population) std or 1.0 for constant leaves (zero-initialized
    biases and raw classical-inversion parameters). The noise is drawn in
    float64 on the host from a ``torch.Generator`` seeded ``seed``, leaf
    after leaf in θ's dict order, then cast to each leaf's dtype and
    device: the same draw on the CPU and the card, not the JAX package's.
    """
    gen = torch.Generator().manual_seed(int(seed))

    def perturb(leaf):
        leaf = leaf.detach()
        s = float(torch.std(leaf.double(), correction=0)) if leaf.numel() > 1 else 0.0
        s = s if s > 0 else 1.0
        noise = init_scale * s * torch.randn((n_restarts,) + tuple(leaf.shape), generator=gen,
                                             dtype=torch.float64)
        noise[0] = 0.0
        return leaf[None] + noise.to(dtype=leaf.dtype, device=leaf.device)

    return tree_map(perturb, theta0)


# ---------------------------------------------------------------------------
# The member fold
# ---------------------------------------------------------------------------

def _rows(x, k: int, n: int, n_g: int):
    """Member k's rows of a folded per-glacier value (a tensor with the
    leading n·G glacier axis); anything else passes as it is."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == n * n_g:
        return x[k * n_g:(k + 1) * n_g]
    return x


def _cat_members(outs, n_g: int):
    """Per-member law values along the glacier axis: a value shared by a
    member's glaciers (0-dim) is spread over its rows first."""
    outs = [torch.as_tensor(o) for o in outs]
    return torch.cat([o.expand(n_g) if o.ndim == 0 else o for o in outs])


def _member_law(law, n: int, n_g: int):
    """``law`` evaluated once per member on its G rows, with its θ."""
    def apply_fn(stacked, inputs):
        outs = []
        for k in range(n):
            rows = {name: _rows(v, k, n, n_g) for name, v in inputs.items()}
            outs.append(law.apply(member_theta(stacked, k), rows))
        return _cat_members(outs, n_g)

    return dataclasses.replace(law, apply_fn=apply_fn)


class _MemberIC:
    """A trainable initial condition evaluated per member: σ(θ_IC) of each
    member's θ on its rows."""

    def __init__(self, ic, n: int, n_g: int):
        self._ic, self._n, self._n_g = ic, n, n_g

    def __getattr__(self, name):
        return getattr(self._ic, name)

    def _per_member(self, method, stacked, glacier_idx):
        return torch.cat([getattr(self._ic, method)(member_theta(stacked, k),
                                                    _rows(glacier_idx, k, self._n, self._n_g))
                          for k in range(self._n)])

    def evaluate_H0(self, theta, glacier_idx):
        return self._per_member("evaluate_H0", theta, glacier_idx)

    def evaluate_dH0(self, theta, glacier_idx):
        return self._per_member("evaluate_dH0", theta, glacier_idx)

    def add_cotangent(self, d_theta_ic, glacier_idx, d_rows):
        """Member k's rows of ``d_rows`` into ``d_theta_ic[k]``."""
        n, n_g = self._n, self._n_g
        return torch.stack([self._ic.add_cotangent(d_theta_ic[k], _rows(glacier_idx, k, n, n_g),
                                                   _rows(d_rows, k, n, n_g))
                            for k in range(n)])


class _MemberTerm:
    """An "initial" loss term evaluated per member: each member's θ, with
    its rows of the context and of H₀ (the Tikhonov family reads θ through
    ``LossContext.theta``)."""

    def __init__(self, term, n: int, n_g: int):
        self._term, self._n, self._n_g = term, n, n_g

    def __getattr__(self, name):
        if name == "residuals":
            inner = getattr(self._term, "residuals")     # AttributeError if absent
            return lambda ctx, H, t: tuple(
                torch.cat(blocks) for blocks in zip(*self._each(inner, ctx, H, t)))
        return getattr(self._term, name)

    def _each(self, fn, ctx, H, t):
        out = []
        for k in range(self._n):
            rows = lambda x: _rows(x, k, self._n, self._n_g)  # noqa: E731
            sub = dataclasses.replace(
                ctx, theta=member_theta(ctx.theta, k), glacier_idx=rows(ctx.glacier_idx),
                glacier=None if ctx.glacier is None else map_tensors(ctx.glacier, rows),
                dx=rows(ctx.dx), dy=rows(ctx.dy), normalization=rows(ctx.normalization),
                velocity_fn=None)
            out.append(fn(sub, rows(H), t))
        return out

    def __call__(self, ctx, H, t):
        return torch.cat(self._each(self._term, ctx, H, t))


@dataclass(frozen=True)
class MemberFold:
    """A folded problem: the model with per-member laws, the batch tiled
    ``members`` times, the parameters with per-member initial loss terms;
    ``glaciers`` (G) rows a member."""

    model: Model
    batch: Any
    params: Any
    members: int
    glaciers: int


def fold_members(model: Model, batch, params, n: int) -> MemberFold:
    """Fold ``n`` members into the glacier axis of ``batch`` (see the module
    doc). The returned problem takes a θ stack of ``n`` members."""
    n_g = batch.H0.shape[0]
    ids = glacier_index(batch)
    tiled = map_tensors(batch, lambda x: x.repeat((n,) + (1,) * (x.ndim - 1))
                        if x.ndim >= 1 and x.shape[0] == n_g else x)
    tiled = tiled.replace(glacier_ids=ids.repeat(n))
    iceflow = dataclasses.replace(model.iceflow, **{
        slot: _member_law(law, n, n_g) for slot, law in model.iceflow.laws.items()
        if law.trainable})
    ic = model.initial_condition
    fmodel = dataclasses.replace(model, iceflow=iceflow,
                                 initial_condition=None if ic is None else _MemberIC(ic, n, n_g))
    cfg = params.UDE.empirical_loss_function
    if cfg is not None:
        if not isinstance(cfg, MultiLoss):
            cfg = MultiLoss(terms=(cfg,), weights=(1.0,))
        cfg = MultiLoss(terms=tuple(_MemberTerm(t, n, n_g) if term_kind(t) == "initial" else t
                                    for t in cfg.terms), weights=cfg.weights)
        params = params.replace(UDE=dataclasses.replace(params.UDE,
                                                        empirical_loss_function=cfg))
    return MemberFold(fmodel, tiled, params, n, n_g)


def folded_losses(stacked, fold: MemberFold, tstops) -> torch.Tensor:
    """(N,) per-member losses of the θ stack: the folded batch's per-glacier
    losses summed over each member's G glaciers."""
    losses, _ = glacier_transient_loss(stacked, fold.batch, fold.model, fold.params, tstops)
    return losses.reshape(fold.members, fold.glaciers).sum(dim=1)


def _fold_value_and_grad(folds, tstops):
    """``vg(stacked) -> ((N,) per-member losses, the stack's gradient in θ's
    leaf order)`` over ``folds``, the folds of one batch (its chunks under
    ``hyper.grad_accum_chunks``, whose losses and gradients add up), for
    the folds' ``params.UDE.grad``: the trainer's value and gradient of one
    batch (``inversion._mode_value_and_grad``) over each folded batch, as
    the JAX package's ``_make_grad_fn`` under its restart ``vmap``. The
    dummy draw is taken once, however many chunks. ``vg.record`` is the
    manual adjoint's record of the last fold."""
    name = grad_mode(folds[0].params.UDE.grad)
    ones = [_mode_value_and_grad(name, f.model, f.params, tstops,
                                 lambda th, _b, f=f: folded_losses(th, f, tstops), f.members)
            for f in folds]

    def vg(stacked):
        per, grads = None, None
        for fold, one in zip(folds, ones):
            p, g = one(stacked, fold.batch)
            per = p if per is None else per + p
            if grads is None:
                grads = g
            elif name != "dummy":
                grads = [a + b for a, b in zip(grads, g)]
        return per, grads

    vg.record = ones[-1].record
    return vg


def folded_residuals(stacked, fold: MemberFold, tstops) -> torch.Tensor:
    """(N, G·R) per-member residual rows, each a member's (G, R) residuals
    raveled glacier by glacier (the JAX package's ``r.ravel()``)."""
    r = glacier_residuals(stacked, fold.batch, fold.model, fold.params, tstops)
    return r.reshape(fold.members, -1)


# ---------------------------------------------------------------------------
# Multi-start training
# ---------------------------------------------------------------------------

_CURVATURE = ("lbfgs", "bfgs", "lm", "gn", "gauss_newton", "gauss-newton")


def multistart_train(
    inversion,
    n_restarts: int = 8,
    init_scale: float = 0.5,
    thetas=None,
    seed: int = 0,
    mesh=None,
    refine_top_k: Optional[int] = None,
) -> MultistartResult:
    """Train every restart through the hyperparameters' leading Adam stages
    on one folded batch; leave ``inversion.theta`` at the best final
    iterate.

    ``thetas``: optional explicit θ stack (leading restart axis) or list of
    θ trees; by default :func:`init_restarts` jitters the inversion's own θ.
    ``mesh``: the registered mesh by default; over several ranks each
    trains its block of restarts when their count divides by the mesh size
    (module doc).
    ``refine_top_k``: with trailing curvature stages (LBFGS/LM) configured,
    carry the best k post-Adam restarts through them, one after the other,
    and select the winner AFTER refinement.
    """
    params = inversion.parameters
    model = inversion.model
    batch = inversion.glaciers
    tstops = assemble_tstops(params, batch)

    all_stages = _stages(params.hyper)
    n_adam = 0
    while n_adam < len(all_stages) and all_stages[n_adam][0] == "adam":
        n_adam += 1
    stages = all_stages[:n_adam]
    refine_stages = all_stages[n_adam:]
    for opt_name, _, _ in refine_stages:
        if opt_name in ("adam", "adamw"):
            raise ValueError(
                "multistart_train needs the Adam (exploration) stages FIRST; "
                f"found {opt_name!r} after a curvature stage"
            )
        if opt_name not in _CURVATURE:
            raise ValueError(f"unknown refinement stage {opt_name!r}")
    if refine_stages and not refine_top_k:
        # refine_top_k=0 would otherwise silently drop the configured
        # curvature stages at the truthiness check below
        raise ValueError(
            "multistart_train explores with Adam stages only (got "
            f"{refine_stages[0][0]!r}); either pass refine_top_k >= 1 to run "
            "the curvature stages on the best k restarts, or run them on the "
            "winner via run_inversion(inversion) afterwards — it warm-starts "
            "at the best θ this function selects"
        )
    grad_mode(params.UDE.grad)       # an unknown mode raises before any solve
    mesh = glacier_mesh(active_mesh() if mesh is None else mesh, "multistart_train")

    if thetas is None:
        thetas = init_restarts(inversion.theta, n_restarts, init_scale, seed)
    elif isinstance(thetas, (list, tuple)):
        thetas = stack_thetas(thetas)
    n_restarts = int(tree_leaves(thetas)[0].shape[0])
    # this rank's block of restarts, or all of them when they do not split
    split = mesh is not None and n_restarts % mesh_devices(mesh) == 0
    n_local = n_restarts // mesh_devices(mesh) if split else n_restarts
    if mesh is not None:
        thetas = replicate(thetas, mesh)
    if split:
        lo = mesh_flat_rank(mesh) * n_local
        thetas = tree_map(lambda x: x[lo:lo + n_local], thetas)

    def gathered(x):
        return gather_rows(x) if split else x

    thetas = tree_map(lambda x: x.detach().clone().requires_grad_(True), thetas)
    leaves = _tree_leaves(thetas)       # the order of the gradients' leaves

    # the folded batch, or its chunks under hyper.grad_accum_chunks, built once
    n_g = batch.H0.shape[0]
    k_chunks = resolve_accum_chunks(getattr(params.hyper, "grad_accum_chunks", 1) or 1, n_g)
    if n_g % k_chunks != 0:
        raise ValueError(f"grad_accum_chunks={k_chunks} must divide the batch of {n_g} glaciers")
    subs = [batch] if k_chunks <= 1 else [
        gather_batch(batch, torch.arange(c * n_g // k_chunks, (c + 1) * n_g // k_chunks))
        for c in range(k_chunks)]
    folds = [fold_members(model, b, params, n_local) for b in subs]
    vg = _fold_value_and_grad(folds, tstops)

    def final_of(stacked, n):
        fold = fold_members(model, batch, params, n)
        with torch.no_grad():
            return np.asarray(folded_losses(stacked, fold, tstops).double().cpu(), np.float64)

    curves, records = [], []
    for _, lr, epochs in stages:
        opt = torch.optim.Adam(leaves, lr=lr)
        for _ in range(int(epochs)):
            vals, grads = vg(thetas)
            records.append(dict(vg.record))
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
            curves.append(vals)
    del folds, vg
    final = gathered(torch.as_tensor(final_of(thetas, n_local)))
    final = np.asarray(final, np.float64)
    thetas = tree_map(lambda x: gathered(x.detach()), thetas)
    # one host read of the loss curves at the end
    losses = (gathered(torch.stack(curves, dim=1)).double().cpu().numpy() if curves
              else np.zeros((n_restarts, 0)))
    best = select_best(final)

    refined_idxs = refined_final = None
    if refine_stages and refine_top_k:
        k = min(int(refine_top_k), n_restarts)
        order = np.argsort(np.where(np.isfinite(final), final, np.inf), kind="stable")
        refined_idxs = order[:k]
        top = tree_map(lambda x: x[torch.as_tensor(refined_idxs, device=x.device)], thetas)
        top = _refine(top, refine_stages, inversion, tstops, mesh)
        refined_final = final_of(top, k)
        j = select_best(refined_final)
        # refinement is warm-started from the Adam iterate but its last step
        # is not guaranteed downhill — fall back to the unrefined winner if
        # every refined survivor ended worse
        if refined_final[j] <= final[best]:
            best_theta = member_theta(top, j)
            best = int(refined_idxs[j])
            best_loss = float(refined_final[j])
        else:
            best_theta = member_theta(thetas, best)
            best_loss = float(final[best])
    else:
        best_theta = member_theta(thetas, best)
        best_loss = float(final[best])

    best_theta = tree_map(lambda x: x.clone(), best_theta)
    inversion.theta = best_theta
    return MultistartResult(
        thetas=thetas,
        losses=losses,
        final_losses=final,
        best_idx=best,
        best_loss=best_loss,
        best_theta=best_theta,
        refined_idxs=refined_idxs,
        refined_losses=refined_final,
        adjoint_records=records,
    )


def _refine(top, refine_stages, inversion, tstops, mesh=None):
    """Run the trailing curvature stages on the top-k restart stack, one
    survivor after the other: LBFGS as ``train_ude``'s LBFGS stage on the
    full batch (it returns the stage's best iterate), LM as ``lm_train``
    (its damping accept/reject loop reads the host each iteration); on a
    ``mesh`` each survivor's glacier axis is split over the ranks."""
    params = inversion.parameters
    batch = inversion.glaciers
    hyper = params.hyper
    n_g = batch.H0.shape[0]
    k = int(tree_leaves(top)[0].shape[0])
    for opt_name, lr, epochs in refine_stages:
        outs = []
        for j in range(k):
            th_j = tree_map(lambda x: x.clone(), member_theta(top, j))
            if opt_name in ("lbfgs", "bfgs"):
                p_j = params.replace(hyper=dataclasses.replace(
                    hyper, optimizer=(opt_name,), learning_rate=(lr,), epochs=(int(epochs),),
                    batch_size=max(int(hyper.batch_size), n_g)))
                inv_j = Inversion(model=inversion.model, glaciers=batch, parameters=p_j,
                                  theta=th_j, device=inversion.device)
                train_ude(inv_j, mesh=mesh)
                th_j = inv_j.theta
            else:  # lm / gn
                resid = make_residual_fn(inversion.model, params, tstops)
                halo = None
                if has_rows(mesh):
                    from odinn_tpu_torch.parallel.spatial import static_halo

                    halo = static_halo(params)
                th_j, local, _ = shard_inversion(th_j, batch, mesh, halo=halo)
                th_j, _ = lm_train(th_j, local, resid, iters=int(epochs),
                                   cg_iters=hyper.gn_cg_iters, init_damping=lr,
                                   precond=hyper.gn_precond, cg_restarts=hyper.gn_cg_restarts,
                                   allreduce=None if mesh is None else (
                                       lambda ts: allreduce_sum(ts, mesh)))
            outs.append(th_j)
        top = stack_thetas(outs)
    return top
