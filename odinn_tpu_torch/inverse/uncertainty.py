"""Laplace-approximation uncertainty quantification for inversions.

Every least-squares inversion the port trains (the Gauss–Newton trainer's
scope, :mod:`odinn_tpu_torch.inverse.gauss_newton`) gets error bars from
its curvature.

Model: loss(θ) = ‖r(θ)‖² with r ~ N(0, σ²I) in weighted-residual space.
With an optional Gaussian prior θ ~ N(θ̂, τ²I), the Laplace posterior at
the optimum θ* is

    θ | data  ≈  N(θ*, Σ),    Σ = (JᵀJ/σ² + I/τ²)⁻¹,   J = ∂r/∂θ|θ*

(the Gauss–Newton Hessian), and for a scalar quantity q(θ) the delta
method gives var[q] ≈ gᵀ Σ g with g = ∇q(θ*).

No Jacobian of the solve is ever formed. J·v is one forward-mode solve
(``gauss_newton.jvp``: on the card the kernels' tangent rules,
``si_step_tangent`` and ``sia2d_rhs_jvp``), Jᵀu a pullback through the
residual's autograd graph built once (``gauss_newton.linearize``). Three
curvature paths:

- **per-glacier block** (``structure="per_glacier"``, classical
  inversions): per-glacier laws route θ by glacier index, so J is
  block-diagonal by glacier, and one J·v per θ leaf (tangent 1 on every
  glacier at once) gives the exact JᵀJ;
- **dense** (p ≤ ``dense_threshold``): p J·v products and p pullbacks,
  ``JtJ[:, i] = Jᵀ(J e_i)``;
- **matrix-free** (large θ): one conjugate-gradient solve per query
  (``gauss_newton._cg_tree``), each query linearising afresh.

θ is raveled by :mod:`odinn_tpu_torch.utils.flatten` in the JAX package's
leaf order. All covariance algebra and delta-method contractions run in
numpy float64 whatever the solve's dtype: A lives at 1e-18 (Pa⁻³ s⁻¹),
whose squares underflow float32. A quantity's gradient or Jacobian
(:meth:`LaplacePosterior.std`, ``band``, ``cov_band``) is taken by
``torch.autograd`` of the quantity, which evaluates laws, not solves.

σ² defaults to ‖r‖²/(N_eff − p) with N_eff = #{r ≠ 0} (masked entries are
exactly 0), clamped at ‖r‖²/N_eff when p ≥ N_eff (overparameterized NNs:
set ``prior_std``).

On a row-sharded batch (``batch.row_shard``, a rank's block of a
``("glaciers", "rows")`` mesh) every J·v and pullback runs on the rank's
own rows, and each rank's part of JᵀJ (and of ‖r‖² and N_eff) is summed
over every rank of the job in one reduction, so the p × p algebra is the
same numpy float64 on every rank; the matrix-free path sums each product
of its CG. Every rank must then build and query the posterior together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from odinn_tpu_torch.inverse import gauss_newton as gn
from odinn_tpu_torch.models.model import glacier_index
from odinn_tpu_torch.simulation.inversion import assemble_tstops
from odinn_tpu_torch.utils.flatten import (
    rows_to_stack, theta_to_vector, tree_leaves, tree_map, tree_unflatten)

__all__ = ["estimate_sigma2", "laplace_posterior", "laplace_uncertainty",
           "LaplacePosterior", "whitened_calibration"]


def estimate_sigma2(r, n_params: int):
    """σ̂² = ‖r‖² / (N_eff − p), N_eff = #active residuals; falls back to
    ‖r‖²/N_eff when p ≥ N_eff (overparameterized — no dof correction left).

    Masked/padded residual entries are structurally exact zeros (weight 0.0),
    while active residuals of a float fit are never exactly zero — counting
    ``r != 0`` recovers the active-observation count."""
    if isinstance(r, torch.Tensor):
        r = r.detach().cpu().double().numpy()
    r = np.ravel(np.asarray(r, np.float64))
    n_eff = int(np.sum(r != 0.0))
    dof = n_eff - n_params if n_eff > n_params else max(n_eff, 1)
    return float(np.sum(r * r) / dof)


def _chi2_sf(x: float, k: int) -> float:
    """Survival function of χ²_k at x (Wilson–Hilferty normal approximation,
    accurate to ~1e-3 for k ≥ 3)."""
    if k <= 0:
        return float("nan")
    z = ((x / k) ** (1.0 / 3.0) - (1.0 - 2.0 / (9.0 * k))) / math.sqrt(2.0 / (9.0 * k))
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def whitened_calibration(d, C, rel_tol: float = 1e-10):
    """Joint (whitened) calibration of an error vector against its claimed
    covariance: is ``d`` plausibly a draw from N(0, C)?

    Eigendecompose C = V diag(λ) Vᵀ, keep the resolved modes
    λ > rel_tol·λ_max, and score z_k = (vₖ·d)/√λ_k. Under a calibrated
    posterior T = Σ z_k² ~ χ²_r: T/r ≫ 1 is overconfident, T/r ≪ 1
    (p_value → 1) an inflated band.

    Returns a dict: effective rank ``r``, ``T``, ``T_over_r``, two-sided
    ``p_value`` (min(sf, 1−sf)·2 of χ²_r), ``max_abs_z`` and ``median_abs_z``
    over the whitened modes. numpy float64.
    """
    d = np.ravel(np.asarray(d, np.float64))
    C = np.asarray(C, np.float64)
    lam, V = np.linalg.eigh(0.5 * (C + C.T))
    keep = lam > rel_tol * max(float(lam.max()), 0.0)
    r = int(np.sum(keep))
    if r == 0:
        return {"rank": 0, "T": float("nan"), "T_over_r": float("nan"),
                "p_value": float("nan"), "max_abs_z": float("nan"),
                "median_abs_z": float("nan")}
    z = (V[:, keep].T @ d) / np.sqrt(lam[keep])
    T = float(z @ z)
    sf = _chi2_sf(T, r)
    return {
        "rank": r,
        "T": T,
        "T_over_r": T / r,
        "p_value": float(min(sf, 1.0 - sf) * 2.0),
        "max_abs_z": float(np.abs(z).max()),
        "median_abs_z": float(np.median(np.abs(z))),
    }


def _flat64(tree) -> np.ndarray:
    """A θ tree (or a gradient tree) as one float64 numpy vector."""
    return theta_to_vector(tree)[0].detach().cpu().double().numpy()


@dataclasses.dataclass
class LaplacePosterior:
    """Gaussian posterior N(θ*, Σ) over inversion parameters.

    Obtain via :func:`laplace_posterior`. Query with:

    - ``std(quantity_fn)`` → (value, std) of a scalar quantity q(θ);
    - ``band(vector_fn)`` → (values, stds) of a vector quantity (e.g. a law
      swept over an input grid — a pointwise confidence band);
    - ``cov_band(vector_fn)`` → (values, full output covariance);
    - ``theta_std()`` → elementwise posterior std of θ itself (tree of
      numpy float64 arrays).

    All returned stds are float64.
    """

    theta: object
    sigma2: float
    _p: int
    _cov: Optional[np.ndarray]            # dense/per-glacier: Σ, np.float64
    _solve_fn: Optional[Callable]         # matrix-free: g_flat ↦ Σg (f64)

    def _solve(self, g_flat: np.ndarray) -> np.ndarray:
        if self._cov is not None:
            return self._cov @ g_flat
        return self._solve_fn(g_flat)

    def _with_grad(self):
        """(θ tree of fresh leaves that require grad, those leaves)."""
        leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(self.theta)]
        return tree_unflatten(self.theta, leaves), leaves

    def _grad_flat(self, quantity_fn) -> tuple:
        th, leaves = self._with_grad()
        with torch.enable_grad():
            q = torch.as_tensor(quantity_fn(th)).sum()
            gs = torch.autograd.grad(q, leaves, allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi for x, gi in zip(leaves, gs)]
        return q.detach(), np.concatenate([gi.detach().cpu().double().numpy().ravel()
                                           for gi in g])

    def std(self, quantity_fn: Callable):
        """(value, posterior std) of scalar ``quantity_fn(theta)``."""
        q, g = self._grad_flat(quantity_fn)
        var = float(g @ self._solve(g))
        return q, float(np.sqrt(max(var, 0.0)))

    def _jac_flat(self, vector_fn: Callable):
        """(values, (m, p) float64 Jacobian of the raveled output wrt θ), one
        autograd pullback per output; columns in the flat view's order, the
        order Σ was built in (one place, shared by :meth:`band` and
        :meth:`cov_band`)."""
        th, leaves = self._with_grad()
        with torch.enable_grad():
            q = torch.as_tensor(vector_fn(th))
            flat = q.reshape(-1)
            rows = []
            for i in range(flat.numel()):
                gs = torch.autograd.grad(flat[i], leaves, retain_graph=True, allow_unused=True)
                rows.append(np.concatenate([
                    (np.zeros(x.numel()) if gi is None
                     else gi.detach().cpu().double().numpy().ravel())
                    for x, gi in zip(leaves, gs)]))
        G = np.stack(rows) if rows else np.zeros((0, self._p))
        return q.detach(), G

    def band(self, vector_fn: Callable):
        """(values, pointwise stds) of vector ``vector_fn(theta)`` — the
        confidence band of a law swept over an input grid."""
        q, G_flat = self._jac_flat(vector_fn)
        if self._cov is not None:
            variances = np.einsum("mp,pq,mq->m", G_flat, self._cov, G_flat)
        else:
            variances = np.array([g @ self._solve(g) for g in G_flat])
        stds = np.sqrt(np.maximum(variances, 0.0)).reshape(tuple(q.shape))
        return q, stds

    def cov_band(self, vector_fn: Callable):
        """(values, FULL output covariance) of vector ``vector_fn(theta)``:
        C = G Σ Gᵀ with G = ∂(vector_fn)/∂θ|θ*, the joint posterior law of
        the output vector (:meth:`band` returns ``sqrt(diag(C))``); judge it
        with :func:`whitened_calibration`. numpy float64."""
        q, G_flat = self._jac_flat(vector_fn)
        if self._cov is not None:
            C = G_flat @ self._cov @ G_flat.T
        else:
            C = G_flat @ np.stack([self._solve(g) for g in G_flat], axis=1)
        return q, 0.5 * (C + C.T)

    def theta_std(self):
        """Elementwise posterior std of θ (tree like θ, numpy float64)."""
        if self._cov is not None:
            diag = np.diag(self._cov)
        else:
            diag = np.array([
                self._solve(np.eye(self._p, dtype=np.float64)[i])[i]
                for i in range(self._p)
            ])
        return theta_to_vector(self.theta)[1](np.sqrt(np.maximum(diag, 0.0)))

    def sample(self, n: int, seed: int = 0):
        """``n`` posterior θ draws as one stacked tree (leading sample axis,
        θ's device and dtype), from ``np.random.default_rng(seed)`` as the
        JAX package draws them. Requires the dense/per-glacier covariance
        (rebuild with ``dense_threshold ≥ p`` otherwise)."""
        if self._cov is None:
            raise NotImplementedError(
                "posterior sampling needs the dense covariance — rebuild the "
                "posterior with dense_threshold >= p (or "
                "structure='per_glacier' for classical inversions)"
            )
        L = np.linalg.cholesky(self._cov)
        z = np.random.default_rng(seed).standard_normal((n, self._p))
        flat0 = _flat64(self.theta)
        draws = flat0[None, :] + z @ L.T                     # (n, p), f64
        dev = tree_leaves(self.theta)[0].device
        return rows_to_stack(torch.as_tensor(draws, device=dev), self.theta)

    def predictive(self, fn: Callable, n: int = 64, seed: int = 0,
                   return_samples: bool = False):
        """Monte-Carlo predictive (mean, std) of ``fn(theta)`` under the
        posterior, ``fn`` evaluated on each of ``n`` θ draws in turn (a
        forward solve of all draws at once is
        :func:`~odinn_tpu_torch.simulation.ensemble.fold_members` of the
        :meth:`sample` stack). Statistics in numpy float64."""
        thetas = self.sample(n, seed)
        with torch.no_grad():
            vals = [np.asarray(torch.as_tensor(fn(tree_map(lambda x: x[i], thetas)))
                               .detach().cpu().double().numpy()) for i in range(n)]
        v64 = np.stack(vals)
        mean, std = v64.mean(axis=0), v64.std(axis=0, ddof=1)
        if return_samples:
            return mean, std, v64
        return mean, std


def _finish_dense(theta, p, sigma2, prior_precision, JtJ64):
    """Assemble H = JᵀJ/σ² + prior, invert in f64, return the posterior.

    The GGN is PSD mathematically, but float32 J·v and pullback products
    give it tiny NEGATIVE eigenvalues, which a tight fit (small σ²)
    amplifies past any prior, and Cholesky fails. Then: project to the PSD
    cone (eigh, negative eigenvalues clamped to 0) and re-add the prior; a
    positive prior makes the result PD. The singular no-prior case raises.
    """
    H = JtJ64 / sigma2
    if prior_precision == 0.0:
        H = H + (1e-8 * float(np.mean(np.diag(H))) + 1e-300) * np.eye(p)
    else:
        H = H + prior_precision * np.eye(p)
    try:
        np.linalg.cholesky(H)
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(0.5 * (JtJ64 + JtJ64.T) / sigma2)
        neg = float(w.min())
        w = np.maximum(w, 0.0)
        prior = prior_precision if prior_precision > 0.0 else (
            1e-8 * float(np.mean(w)) + 1e-300)
        H = (V * (w + prior)) @ V.T
        try:
            np.linalg.cholesky(H)
        except np.linalg.LinAlgError as e:
            raise FloatingPointError(
                "GGN Cholesky failed even after PSD projection (min eig "
                f"{neg:.3e}) — the curvature is singular at this θ. Pass "
                "prior_std= to regularize, or check that the inversion "
                "converged."
            ) from e
    cov = np.linalg.inv(H)
    return LaplacePosterior(theta, sigma2, p, cov, None)


def laplace_posterior(
    theta,
    batch,
    resid,
    sigma2: Optional[float] = None,
    prior_std: Optional[float] = None,
    dense_threshold: int = 1024,
    cg_iters: int = 100,
    glacier_ids=None,
    structure: Optional[str] = None,
) -> LaplacePosterior:
    """Build the Laplace posterior N(θ*, (JᵀJ/σ² + I/τ²)⁻¹) at θ* = ``theta``.

    ``resid`` is a residual map ``r(θ, batch)`` with ‖r‖² == the training
    loss, as :func:`~odinn_tpu_torch.inverse.gauss_newton.make_residual_fn`
    returns it. ``glacier_ids``: the rows of per-glacier θ each batch row
    reads (duplicates allowed), set as the batch's ``glacier_ids``.

    ``sigma2``: observation noise in weighted-residual space; defaults to
    :func:`estimate_sigma2`. ``prior_std`` τ: Gaussian prior width on θ;
    ``None`` adds only a jitter floor (1e-8 of the mean GGN diagonal),
    appropriate when p ≪ N; a warning is emitted when p ≥ N_eff and no
    prior is given. ``structure="per_glacier"``: every θ leaf a
    per-glacier vector (G,), one J·v per leaf (see the module doc).
    On a row-sharded batch the module doc's reductions over the job.
    """
    sharded = getattr(batch, "row_shard", None) is not None

    def job_sum(a: np.ndarray) -> np.ndarray:
        if not sharded:
            return a
        from odinn_tpu_torch.parallel.spatial import job_sum as _sum

        return _sum(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))).numpy()

    flat, unravel = theta_to_vector(theta)
    p = int(flat.numel())
    dt_ = flat.dtype
    b = batch
    if glacier_ids is not None:
        b = batch.replace(glacier_ids=torch.as_tensor(glacier_ids, device=batch.H0.device)
                          .reshape(-1).long())

    with torch.no_grad():
        r = resid(theta, b)
    r64 = np.ravel(r.detach().cpu().double().numpy())
    rr, n_eff = job_sum(np.array([np.sum(r64 * r64), np.sum(r64 != 0.0)], np.float64))
    n_eff = int(n_eff)
    if sigma2 is None:
        if p >= n_eff and prior_std is None:
            import warnings

            warnings.warn(
                f"Laplace posterior with p={p} parameters >= N_eff={n_eff} "
                "active residuals and no prior_std: σ² falls back to "
                "‖r‖²/N_eff and the GGN is rank-deficient — pass prior_std "
                "to get a well-posed posterior."
            )
        # estimate_sigma2's ‖r‖² / dof, from the sums over the job
        dof = n_eff - p if n_eff > p else max(n_eff, 1)
        sigma2 = float(rr / dof)
    prior_precision = 0.0 if prior_std is None else 1.0 / float(prior_std) ** 2

    if structure == "per_glacier":
        # glacier g's residual block depends ONLY on θ[·][g], so J is
        # block-diagonal by glacier and one J·v per θ leaf, tangent 1 on
        # that leaf for every glacier at once, gives J's (g, l) blocks
        leaves = tree_leaves(theta)
        if not leaves or leaves[0].ndim != 1:
            raise ValueError("structure='per_glacier' requires 1-D θ leaves")
        G = leaves[0].shape[0]
        for x in leaves:
            if x.ndim != 1 or x.shape[0] != G:
                raise ValueError(
                    "structure='per_glacier' requires every θ leaf to be a "
                    f"per-glacier vector of shape ({G},); got {tuple(x.shape)}"
                )
        L = len(leaves)
        # batch row-block g reads θ[·][ids[g]], so its curvature belongs at
        # θ column ids[g], and duplicate ids must ACCUMULATE
        if glacier_ids is not None:
            ids = np.asarray(glacier_ids, dtype=int).ravel()
        elif sharded:          # a rank's block: the batch's own ids
            ids = glacier_index(b).reshape(-1).cpu().numpy().astype(int)
        else:
            ids = np.arange(G)
        n_blocks = ids.shape[0]
        jvs = []
        for l in range(L):
            v = tree_unflatten(theta, [torch.ones_like(x) if i == l else torch.zeros_like(x)
                                       for i, x in enumerate(leaves)])
            jv = gn.jvp(resid, theta, b, v)
            jvs.append(jv.reshape(n_blocks, -1).detach().cpu().double().numpy())
        JtJ = np.zeros((p, p), dtype=np.float64)
        for l in range(L):                            # flat layout is
            for m in range(l, L):                     # leaf-major: off_l = l·G
                s = np.sum(jvs[l] * jvs[m], axis=1)
                np.add.at(JtJ, (l * G + ids, m * G + ids), s)
                if m > l:
                    np.add.at(JtJ, (m * G + ids, l * G + ids), s)
        return _finish_dense(theta, p, sigma2, prior_precision, job_sum(JtJ))

    if p <= dense_threshold:
        # p J·v products and p pullbacks through one linearisation build the
        # exact raw JᵀJ; numpy f64 assembles and inverts
        _, pb = gn.linearize(resid, theta, b)
        eye = torch.eye(p, dtype=dt_, device=flat.device)
        cols = []
        for i in range(p):
            jtv = pb(gn.jvp(resid, theta, b, unravel(eye[i])))
            cols.append(_flat64(jtv))
        del pb
        JtJ = job_sum(np.stack(cols))
        JtJ = 0.5 * (JtJ + JtJ.T)
        return _finish_dense(theta, p, sigma2, prior_precision, JtJ)

    # matrix-free: one flat-space CG solve of (JᵀJ/σ² + P)x = g per query
    if prior_precision == 0.0:
        _, pb = gn.linearize(resid, theta, b)
        gen = torch.Generator().manual_seed(0)
        v = (2 * torch.randint(0, 2, (p,), generator=gen) - 1).to(dtype=dt_, device=flat.device)
        jtv = theta_to_vector(pb(gn.jvp(resid, theta, b, unravel(v))))[0]
        del pb
        vjtv = float(job_sum(np.array([float(torch.dot(v, jtv))]))[0])
        scale = abs(vjtv) / (p * sigma2)
        prior_precision = 1e-8 * scale + 1e-300

    s2 = torch.as_tensor(sigma2, dtype=dt_, device=flat.device)
    pp = torch.as_tensor(prior_precision, dtype=dt_, device=flat.device)

    def solve_fn(g64: np.ndarray) -> np.ndarray:
        g = torch.as_tensor(g64, dtype=dt_, device=flat.device)
        _, pb = gn.linearize(resid, theta, b)

        def mv(v):
            jtv = theta_to_vector(pb(gn.jvp(resid, theta, b, unravel(v))))[0]
            if sharded:
                jtv = torch.as_tensor(job_sum(jtv.detach().cpu().double().numpy()),
                                      dtype=jtv.dtype, device=jtv.device)
            return jtv / s2 + pp * v

        x = gn._cg_tree(mv, g, cg_iters)
        return x.detach().cpu().double().numpy()

    return LaplacePosterior(theta, sigma2, p, None, solve_fn)


def laplace_uncertainty(inversion, **kwargs) -> LaplacePosterior:
    """Posterior over a trained :class:`~odinn_tpu_torch.simulation.
    inversion.Inversion`'s θ in one call: the residual map of the
    inversion's own model and parameters, priced at its θ. Keyword
    arguments go to :func:`laplace_posterior` (``sigma2``, ``prior_std``,
    ``structure``, …)."""
    params = inversion.parameters
    batch = inversion.glaciers
    tstops = assemble_tstops(params, batch)
    resid = gn.make_residual_fn(inversion.model, params, tstops)
    return laplace_posterior(inversion.theta, batch, resid, **kwargs)
