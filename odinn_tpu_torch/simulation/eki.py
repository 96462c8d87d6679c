"""Ensemble Kalman Inversion (EKI): derivative-free UDE training.

A third trainer family next to first-order (Adam/LBFGS, ``train_ude``) and
second-order least-squares (LM, ``inverse.gauss_newton``): the iterative
ensemble Kalman method of Iglesias, Law & Stuart (2013) applied to the same
least-squares objective the LM trainer minimizes, ‖r(θ)‖² with r from
:func:`~odinn_tpu_torch.simulation.inversion.glacier_residuals`.

One iteration is the J members' forward solves, folded into the kernels'
glacier axis (:func:`~odinn_tpu_torch.simulation.ensemble.fold_members`):
one solve of J·G glaciers without autograd, so one kernel launch a step for
all members, and no adjoint memory. Only forward solves are evaluated, so
EKI trains through ``params.solver.adaptive = True``, the error-controlled
BS3(2) forward that ``train_ude`` refuses: the fold gives it one step-size
controller per member and glacier, as the JAX package's ``vmap`` does.

Algebra (subspace form). With member rows Θ ∈ R^{J×d} (θ raveled by
:mod:`odinn_tpu_torch.utils.flatten`, the JAX package's leaf order),
residual rows R ∈ R^{J×m} (observations y = 0), anomalies Θa = Θ − mean,
Ra = R − mean, the update is computed all in J×J through the push-through
identity:

    C = Ra Raᵀ / J,  γ = damping · tr(C)/J
    S = (C + γI)⁻¹ (Ra Dᵀ / J),  D = y − R (+ perturbations)
    Θ ← Θ + Sᵀ Θa

in PyTorch on the residuals' device and dtype. The iteration preserves the
affine span of the initial ensemble (the subspace property), so J should
exceed the effective parameter dimension.

On a mesh of several ranks (:mod:`odinn_tpu_torch.parallel.mesh`; every
rank of a 2-D one, whose rows do not split the members' batch, as in the
JAX package) whose size divides J, each rank folds and solves its own block
of members; the
residual rows are gathered, so the Kalman step (and ``perturb_obs``'s
draw, made for the whole ensemble from one seeded generator) runs the
same on every rank. Otherwise every rank evaluates every member.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from odinn_tpu_torch.parallel.mesh import (
    active_mesh, gather_rows, glacier_mesh, mesh_devices, mesh_flat_rank, replicate)
from odinn_tpu_torch.simulation.ensemble import (
    fold_members, folded_residuals, init_restarts, stack_thetas)
from odinn_tpu_torch.simulation.inversion import assemble_tstops
from odinn_tpu_torch.utils.flatten import (
    rows_to_stack, stack_to_rows, theta_to_vector, tree_leaves, tree_map)

__all__ = ["EKIResult", "eki_train"]


@dataclass
class EKIResult:
    """Final ensemble plus per-iteration misfit history."""

    thetas: Any                # θ tree with leading member axis (final ensemble)
    misfits: np.ndarray        # (n_done+1, J) per-member ‖r‖² incl. the initial ensemble
    best_idx: int              # member with the lowest final misfit
    best_loss: float
    best_theta: Any            # that member's θ (no member axis)
    mean_theta: Any            # ensemble-mean θ (the classical EKI estimator)
    mean_loss: float           # misfit at mean_theta
    n_iters: int               # iterations actually run (≤ requested; tol may stop early)


def _sanitize_rows(R, fill_row):
    """Replace any member row containing a non-finite residual with
    ``fill_row`` (the finite-member mean): the bad member's anomaly becomes
    zero, so it stops steering the gain and its own update pulls it back
    toward the ensemble consensus (a diverged forward solve degrades one
    member, not the round). Returns (rows, finite mask)."""
    ok = torch.all(torch.isfinite(R), dim=1, keepdim=True)
    return torch.where(ok, R, fill_row[None, :]), ok[:, 0]


def eki_train(
    inversion,
    n_ensemble: int = 32,
    n_iters: int = 20,
    init_scale: float = 0.5,
    damping: float = 1.0,
    thetas=None,
    seed: int = 0,
    mesh=None,
    perturb_obs: bool = False,
    select: str = "best",
    tol: Optional[float] = None,
) -> EKIResult:
    """Run EKI on the inversion's least-squares objective; leave
    ``inversion.theta`` at the selected estimate.

    ``thetas``: optional explicit initial ensemble (leading member axis, or a
    list of θ trees); by default the inversion's θ is jittered with
    :func:`~odinn_tpu_torch.simulation.ensemble.init_restarts` (member 0 =
    θ exactly).
    ``damping``: scales the self-adaptive Kalman regularization
    γ = damping·tr(C)/J; smaller = more aggressive Gauss–Newton-like steps.
    ``perturb_obs``: add N(0, γI) observation perturbations, drawn in
    float64 on the host from a ``torch.Generator`` seeded ``seed + 1`` (the
    stochastic EnKF flavor; off by default because training wants the
    deterministic collapse).
    ``select``: ``"best"`` (lowest-misfit member) or ``"mean"`` (the
    classical EKI estimator) for the write-back.
    ``tol``: optional early stop when the relative drop of the best misfit
    over one iteration falls below it.
    ``mesh``: the registered mesh by default; over several ranks each
    evaluates its block of members when J divides by the mesh size
    (module doc).

    Every configured loss term must expose ``.residuals`` (the same contract
    as LM training); terms without one raise with a remedy. One host read
    of the misfits an iteration.
    """
    if select not in ("best", "mean"):
        raise ValueError(f"select must be 'best' or 'mean', got {select!r}")

    params = inversion.parameters
    model = inversion.model
    batch = inversion.glaciers
    tstops = assemble_tstops(params, batch)

    if thetas is None:
        thetas = init_restarts(inversion.theta, n_ensemble, init_scale, seed)
    elif isinstance(thetas, (list, tuple)):
        thetas = stack_thetas(thetas)
    n_ensemble = int(tree_leaves(thetas)[0].shape[0])
    if n_ensemble < 2:
        raise ValueError("EKI needs n_ensemble >= 2 (covariances of one "
                         "member are identically zero)")

    like = inversion.theta
    Th = stack_to_rows(tree_map(lambda x: x.detach(), thetas))            # (J, d)
    d = int(theta_to_vector(like)[0].numel())
    if n_ensemble <= d:
        # not an error — the subspace property just means the search happens
        # in a J−1-dimensional affine slice; say so once, loudly, at setup
        import warnings

        warnings.warn(
            f"EKI ensemble (J={n_ensemble}) does not exceed the parameter "
            f"dimension (d={d}): updates stay in the initial ensemble's "
            f"affine span. Raise n_ensemble or init_scale coverage if the "
            f"fit stalls.", stacklevel=2)
    mesh = glacier_mesh(active_mesh() if mesh is None else mesh, "eki_train")

    J = n_ensemble
    # this rank's block of members, or all of them when they do not split
    split = mesh is not None and J % mesh_devices(mesh) == 0
    n_local = J // mesh_devices(mesh) if split else J
    lo = mesh_flat_rank(mesh) * n_local if split else 0
    if mesh is not None:
        Th = replicate(Th, mesh)
    fold = fold_members(model, batch, params, n_local)

    def residuals_of(Th, fold, members=None):
        rows = Th if members is None else Th[members]
        with torch.no_grad():
            R = folded_residuals(rows_to_stack(rows, like), fold, tstops)  # (rows, m)
        if members is not None:
            R = gather_rows(R)
        return R, torch.sum(R * R, dim=1)

    members = slice(lo, lo + n_local) if split else None

    gen = torch.Generator().manual_seed(int(seed) + 1)

    def kalman_step(Th, R):
        # sanitize diverged members before any covariance touches them
        finite = torch.all(torch.isfinite(R), dim=1)
        n_ok = torch.clamp(torch.sum(finite), min=1)
        fill = torch.sum(torch.where(finite[:, None], R, torch.zeros_like(R)), dim=0) / n_ok
        R, _ = _sanitize_rows(R, fill)

        Ta = Th - torch.mean(Th, dim=0, keepdim=True)                      # (J, d)
        Ra = R - torch.mean(R, dim=0, keepdim=True)                        # (J, m)
        C = (Ra @ Ra.T) / J                                                # (J, J)
        gamma = damping * torch.trace(C) / J + 1e-30
        D = -R                                                             # y = 0
        if perturb_obs:
            z = torch.randn(tuple(R.shape), generator=gen, dtype=torch.float64)
            D = D + torch.sqrt(gamma) * z.to(device=R.device, dtype=R.dtype)
        M = (Ra @ D.T) / J                                                 # (J, J)
        S = torch.linalg.solve(C + gamma * torch.eye(J, dtype=R.dtype, device=R.device), M)
        return Th + (S.T @ Ta.to(S.dtype)).to(Th.dtype)

    R, misfit = residuals_of(Th, fold, members)
    history = [misfit.double().cpu().numpy()]
    n_done = 0
    for k in range(n_iters):
        Th = kalman_step(Th, R)
        R, misfit = residuals_of(Th, fold, members)
        history.append(misfit.double().cpu().numpy())
        n_done = k + 1
        if tol is not None and len(history) >= 2:
            prev = float(np.nanmin(history[-2]))
            cur = float(np.nanmin(history[-1]))
            if prev > 0 and (prev - cur) / prev < tol:
                break
    del fold, R

    misfits = np.stack(history)                                            # (n_done+1, J)
    final = misfits[-1]
    if not np.isfinite(final).any():
        raise FloatingPointError(
            "every EKI member's final misfit is non-finite — the forward "
            "solve is unstable at this ensemble's θ range; lower init_scale "
            "or raise solver substeps")
    best_idx = int(np.argmin(np.where(np.isfinite(final), final, np.inf)))

    thetas_out = rows_to_stack(Th, like)
    best_theta = rows_to_stack(Th[best_idx:best_idx + 1], like)
    mean_row = torch.mean(Th, dim=0, keepdim=True)
    mean_theta = rows_to_stack(mean_row, like)
    _, mean_misfit = residuals_of(mean_row, fold_members(model, batch, params, 1))
    mean_loss = float(mean_misfit[0])
    result = EKIResult(
        thetas=thetas_out,
        misfits=misfits,
        best_idx=best_idx,
        best_loss=float(final[best_idx]),
        best_theta=_first(best_theta),
        mean_theta=_first(mean_theta),
        mean_loss=mean_loss,
        n_iters=n_done,
    )
    inversion.theta = result.best_theta if select == "best" else result.mean_theta
    return result


def _first(stack):
    """Member 0 of a stack, without its member axis."""
    return tree_map(lambda x: x[0], stack)
