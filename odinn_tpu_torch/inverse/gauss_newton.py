"""Matrix-free Gauss–Newton / Levenberg–Marquardt training.

The transient thickness loss is an exact least-squares objective,

    loss(θ) = Σ_g Σ_τ dt_τ/npix · Σ_mask (H_{g,τ}(θ) − H_ref)²  =  ‖r(θ)‖²,

so a Gauss–Newton step solves (JᵀJ + λ·diag)δ = −Jᵀr with J = ∂r/∂θ. The
port of ``odinn_tpu.inverse.gauss_newton``: nothing is formed but the
linearisation of one residual evaluation. Each iteration builds the
residual's autograd graph once and takes every pullback Jᵀu from it
(``torch.autograd.grad(..., retain_graph=True)``); J·v is forward mode
(``torch.autograd.forward_ad``), one dual solve, which on the card runs the
kernels' tangent rules (``si_step_tangent``, ``sia2d_rhs_jvp``); JᵀJ·v is
that pullback of J·v. The normal equations are solved by fixed-iteration CG
in θ space (:func:`_cg_tree`), and the damping follows the classic λ ÷3 /
×10 accept rule. Every value stays on the device; one host read an
iteration gives the loss trace.

Scope: every least-squares-shaped objective (``.residuals`` on the loss
terms; :func:`make_residual_fn`). On a mesh each rank passes its own
glaciers and an ``allreduce`` (:func:`lm_train`): every θ-space pullback
and every Σr² is summed over the ranks, so all of them take the same
steps; J·v stays on each rank's glaciers.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.autograd.forward_ad as fwAD

from odinn_tpu_torch.utils.flatten import tree_leaves as _leaves
from odinn_tpu_torch.utils.flatten import tree_map as _tmap
from odinn_tpu_torch.utils.flatten import tree_unflatten as _unflatten

__all__ = ["make_residual_fn", "lm_train", "diag_estimate", "linearize", "jvp"]

# rounds to 0 in float32: the CG guards then compare against 0
_TINY = 1e-300


def _tree_dot(a, b):
    return sum(torch.sum(x * y) for x, y in zip(_leaves(a), _leaves(b)))


def _tree_axpy(alpha, x, y):
    """alpha·x + y"""
    return _tmap(lambda xi, yi: alpha * xi + yi, x, y)


def make_residual_fn(model, params, tstops):
    """The residual map ``resid(theta, batch)`` → (n_g, R) with ‖r‖² ==
    the full :func:`~odinn_tpu_torch.simulation.inversion.batch_transient_loss`
    objective, one row per glacier (the rows of a gathered batch follow its
    ``glacier_ids``). It is :func:`~odinn_tpu_torch.simulation.inversion.
    glacier_residuals`: the same ``_LossEnv`` assembles the loss and the
    residuals. Terms without a residual form raise with a remedy."""
    from odinn_tpu_torch.simulation.inversion import glacier_residuals

    def resid(theta, batch):
        return glacier_residuals(theta, batch, model, params, tstops)

    return resid


def _cg_tree(matvec, b, iters: int, minv=None, restarts: int = 1):
    """Fixed-iteration (preconditioned) CG in θ-tree space.

    ``minv``: an elementwise Jacobi preconditioner tree (1/diag of the SPD
    operator). ``restarts``: the ``iters`` budget split into this many CG
    rounds, each restarted from the exact residual b − A·x of the
    accumulated iterate (one more matvec a round); 1 is single-shot CG.
    """
    apply_minv = (lambda r: _tmap(torch.mul, minv, r)) if minv is not None else (lambda r: r)
    restarts = max(int(restarts), 1)
    per_round = max(iters // restarts, 1)
    x = _tmap(torch.zeros_like, b)
    for k in range(restarts):
        r = b if k == 0 else _tmap(torch.sub, b, matvec(x))
        z = apply_minv(r)
        p, rz = z, _tree_dot(r, z)
        for _ in range(per_round):
            Ap = matvec(p)
            denom = _tree_dot(p, Ap)
            alpha = torch.where(denom > 0.0, rz / torch.clamp(denom, min=_TINY),
                                torch.zeros_like(denom))
            x = _tree_axpy(alpha, p, x)
            r = _tree_axpy(-alpha, Ap, r)
            z = apply_minv(r)
            rz_new = _tree_dot(r, z)
            beta = torch.where(rz > 0.0, rz_new / torch.clamp(rz, min=_TINY),
                               torch.zeros_like(rz))
            p = _tree_axpy(beta, p, z)
            rz = rz_new
    return x


def linearize(resid, theta, batch):
    """(r, pullback): the residual at θ with its autograd graph built once,
    and ``pullback(u)`` = Jᵀu as a θ tree, each a ``torch.autograd.grad``
    through the retained graph."""
    leaves = [x.detach().requires_grad_(True) for x in _leaves(theta)]
    with torch.enable_grad():
        r = resid(_unflatten(theta, leaves), batch)

    def pullback(u):
        gs = torch.autograd.grad(r, leaves, u, retain_graph=True, allow_unused=True)
        return _unflatten(theta, [torch.zeros_like(x) if g is None else g
                                  for x, g in zip(leaves, gs)])

    return r.detach(), pullback


def jvp(resid, theta, batch, v):
    """J·v: the residual's forward-mode derivative at θ along the tree
    ``v``, one dual solve without an autograd graph."""
    with fwAD.dual_level(), torch.no_grad():
        dual = _tmap(lambda p, t: fwAD.make_dual(p.detach(), t.to(p.dtype)), theta, v)
        primal, tangent = fwAD.unpack_dual(resid(dual, batch))
    return torch.zeros_like(primal) if tangent is None else tangent


def _draw_probes(gen, theta, n: int) -> list:
    """``n`` Rademacher θ trees (entries ±1 in each leaf's dtype) from the
    generator ``gen``, drawn on the host and moved to each leaf's device,
    leaf by leaf in θ's own entry order (``tree_map``'s)."""
    def one(leaf):
        bits = torch.randint(0, 2, tuple(leaf.shape), generator=gen)
        return (2 * bits - 1).to(dtype=leaf.dtype, device=leaf.device)

    return [_tmap(one, theta) for _ in range(n)]


def diag_estimate(theta, batch, resid, pullback, probes):
    """(per-leaf mean diag(JᵀJ) broadcast to θ's shapes, their mean): the
    Hutchinson leaf-block traces E[⟨v_l, (JᵀJv)_l⟩] over the Rademacher
    ``probes``, taken one after the other (one J·v and one pullback each),
    floored at 1e-7 of the tree-wide mean."""
    acc = None
    for v in probes:
        jtv = pullback(jvp(resid, theta, batch, v))
        contrib = [torch.mean(a * b) for a, b in zip(_leaves(v), _leaves(jtv))]
        acc = contrib if acc is None else [a + c for a, c in zip(acc, contrib)]
    n = max(len(probes), 1)
    acc = [a / n for a in acc]
    mean = sum(acc) / len(acc)
    floor = torch.clamp(mean, min=1e-30) * 1e-7
    leaves = _leaves(theta)
    return (_unflatten(theta, [torch.full_like(x, 0.0) + torch.maximum(d, floor)
                               for x, d in zip(leaves, acc)]), mean)


def lm_train(theta, batch, resid, iters: int = 15, cg_iters: int = 8,
             init_damping: float = 1e-3, record=None, precond: bool = True,
             diag_probes: int = 8, precond_refresh: int = 5, cg_restarts: int = 1,
             seed: int = 0, allreduce=None) -> Tuple:
    """The Levenberg–Marquardt loop; returns (θ, losses).

    Each iteration linearises r at θ once (:func:`linearize`), forms
    g = Jᵀr, solves (JᵀJ + λ·diag)δ = −g by :func:`_cg_tree` with
    JᵀJ·v = pullback(J·v), evaluates the candidate, and accepts it when its
    loss is lower (λ ÷ 3, else λ × 10): one host read an iteration, for the
    loss trace and ``record(loss, θ, |g|)``; a trailing evaluation covers
    the returned θ.

    ``precond``: Jacobi-precondition the CG with a per-leaf scalar
    curvature (:func:`diag_estimate`, ``diag_probes`` Rademacher probes
    drawn from a ``torch.Generator`` seeded ``seed``), refreshed every
    ``precond_refresh`` iterations, which also scales the damping (λ·diag
    instead of λ·I). Without it the damping is λ·(mean diag)·I from one
    estimate. ``cg_restarts``: see :func:`_cg_tree`.

    ``allreduce``: for a ``batch`` that is one rank's block of the glacier
    axis, a function that sums a list of tensors over the ranks
    (``parallel.mesh.allreduce_sum``); every pullback Jᵀu and every Σr²
    goes through it.
    """
    gen = torch.Generator().manual_seed(int(seed))
    theta = _tmap(lambda x: x.detach(), theta)
    total = (lambda ts: ts) if allreduce is None else allreduce

    def sq(r):
        return total([torch.sum(r * r)])[0]

    def linearized(th):
        r, pb = linearize(resid, th, batch)
        if allreduce is None:
            return r, pb
        return r, lambda u: _unflatten(th, total(_leaves(pb(u))))

    def step(theta, lam, diag, r, pb):
        loss = sq(r)
        g = pb(r)

        def gnvp(v):
            jtv = pb(jvp(resid, theta, batch, v))
            return _tmap(lambda a, d, vi: a + lam * d * vi, jtv, diag, v)

        minv = _tmap(lambda d: 1.0 / (d * (1.0 + lam)), diag)
        delta = _cg_tree(gnvp, _tmap(torch.neg, g), cg_iters, minv=minv, restarts=cg_restarts)
        cand = _tmap(torch.add, theta, delta)
        with torch.no_grad():
            r_new = resid(cand, batch)
        accept = sq(r_new) < loss
        theta_out = _tmap(lambda c, t: torch.where(accept, c, t), cand, theta)
        lam_out = torch.where(accept, lam / 3.0, lam * 10.0)
        return theta_out, lam_out, loss, torch.sqrt(_tree_dot(g, g))

    r, pb = linearized(theta)
    diag, md = diag_estimate(theta, batch, resid, pb,
                             _draw_probes(gen, theta, max(diag_probes, 1)))
    if not precond:
        diag = _tmap(lambda x: torch.full_like(x, 0.0) + md, theta)
    dtype = _leaves(theta)[0].dtype
    lam = torch.tensor(init_damping, dtype=dtype, device=r.device)
    losses = []
    for it in range(iters):
        if it > 0:
            r, pb = linearized(theta)
            if precond and it % max(precond_refresh, 1) == 0:
                diag, _ = diag_estimate(theta, batch, resid, pb,
                                        _draw_probes(gen, theta, max(diag_probes, 1)))
        theta, lam, loss, gnorm = step(theta, lam, diag, r, pb)
        del r, pb
        loss_f, gnorm_f = torch.stack([loss.detach(), gnorm.detach().to(loss.dtype)]).tolist()
        losses.append(loss_f)
        if record is not None:
            record(loss_f, theta, gnorm_f)
    with torch.no_grad():
        r_fin = float(sq(resid(theta, batch)))
    losses.append(r_fin)
    if record is not None:
        record(r_fin, theta, 0.0)
    return theta, losses
