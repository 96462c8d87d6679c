"""Semi-implicit SIA2D stepping: unconditional stability via linear solves.

    (I − θ·dt·∇·(Dᵏ∇·)) H^{k+1} = Hᵏ + dt·∇·(Dᵏ∇(B + …))

with the diffusivity frozen at step k. The operator (interior-masked on
both sides, the border ring held fixed through the right-hand side) is
symmetric positive definite, so H^{k+1} comes from a fixed number of
Jacobi-preconditioned CG iterations, warm-started, then projected to H ≥ 0.

"SI" is θ = 1 (backward Euler); "SI2" is Crank–Nicolson (θ = ½) with the
diffusivity at the time midpoint through one Picard iteration: a predictor
solve with D(Hᵏ), then a corrector with D((Hᵏ + H_pred)/2) warm-started at
H_pred.

For the A target with per-glacier scalar laws on a (n_g, nx, ny) batch the
whole step is the fused kernel
:func:`odinn_tpu_torch.ops.cuda.si_kernel.si_step` (its plain version on a
CPU tensor); every other law configuration takes the unfused path below.

Both paths differentiate the solve as the JAX package's
``lax.custom_linear_solve`` does, by the implicit-function adjoint: one
transpose PCG solve on the same symmetric operator, warm-started at the
cotangent, then one pullback of the residual through b and the frozen D
(:func:`odinn_tpu_torch.ops.si_math.theta_solve`; on the fused path the
kernel's own backward). CG is never unrolled, and the warm start x0 gets no
gradient.

On a row-sharded batch (``shard``, a ``parallel.spatial.RowShard``) a step
takes the own rows of H: H, the frozen state and the guess get two ghost
rows in one exchange, and the step runs on that slab with the PCG split at
its reductions (``si_rows_step`` on the fused path,
``si_math.rows_theta_solve`` on the unfused one).
"""

from __future__ import annotations

import torch

from odinn_tpu_torch.ops import si_math
from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda import si_kernel
from odinn_tpu_torch.ops.cuda.common import derived_scalars, shared_exps
from odinn_tpu_torch.physics.sia2d import scalar_law_table
from odinn_tpu_torch.simulation.solver import host_tstops, substep_dt

__all__ = ["semi_implicit_step", "si2_step", "integrate_semi_implicit"]


def _frozen_diffusivity(H, B, dx, dy, values_fn, target, phys):
    Hc = st.relu_strict(H)
    S = B.to(H.dtype) + Hc
    gsx, gsy = st.grad_slope(S, dx, dy)
    grad_s = st.safe_norm(gsx, gsy)
    hbar = st.avg(Hc)
    vals = values_fn(hbar, grad_s)
    # solve dtype = state dtype: float64 law values must not promote
    return target.diffusivity(vals, hbar, grad_s, phys).to(H.dtype)


def _kernel_args(values_fn, target, dx, dy, H, phys):
    """(derived table, shared exponents) for the fused step, or None when
    the configuration is not the kernel's. Cached on ``values_fn``."""
    raw = scalar_law_table(values_fn, target, dx, dy, H, slide_grad=True)
    if raw is None:
        return None
    hit = values_fn.cache.get("si")
    if hit is not None and hit[0] is raw:
        return hit[1]
    derived = derived_scalars(*(raw[:, k] for k in range(7)), phys.rho, phys.g)
    exps = shared_exps(derived)
    args = None if exps is None else (derived, exps)
    values_fn.cache["si"] = (raw, args)
    return args


def _rows_step(H, H_D, guess, dx, dy, values_fn, target, phys, dt, cg_iters, theta, shard,
               precondition=True):
    """One step on a row shard (module doc)."""
    H_s, HD_s, x0_s = shard.halo_rows(torch.stack([H, H_D, guess]), si_math.ROWS_HALO).unbind(0)
    B_s = shard.bed(si_math.ROWS_HALO, H.dtype)
    args = _kernel_args(values_fn, target, dx, dy, H, phys)
    if args is not None:
        derived, exps = args
        return si_kernel.si_rows_step(shard, H_s, HD_s, B_s, x0_s, derived, dt, theta, cg_iters,
                                      exps, precondition)
    D = _frozen_diffusivity(HD_s, B_s, dx, dy, values_fn, target, phys)
    return si_math.rows_theta_solve(shard, H_s, D, B_s, x0_s, dt, theta, cg_iters, dx, dy,
                                    precondition)


def semi_implicit_step(H, B, dx, dy, values_fn, target, phys, dt, cg_iters: int = 30,
                       x0=None, theta: float = 1.0, H_star=None, shard=None):
    """One θ-scheme semi-implicit step of length ``dt`` (a Python number).

    A = I − θ·dt·M·L·M with M the interior mask;
    b = H + dt·M·∇·(D∇(B + ring·H + (1−θ)·M·H)). CG warm-starts at ``x0``
    (default H). ``H_star`` is the state the diffusivity is frozen at
    (default H). ``shard``: the module doc's row shard.
    """
    guess = H if x0 is None else x0
    H_D = H if H_star is None else H_star
    if shard is not None:
        return _rows_step(H, H_D, guess, dx, dy, values_fn, target, phys, dt, cg_iters, theta,
                          shard)
    args = _kernel_args(values_fn, target, dx, dy, H, phys)
    if args is not None:
        derived, exps = args
        return si_kernel.si_step(H, H_D, B.to(H.dtype), guess, derived, dt, theta,
                                 cg_iters, exps)

    D = _frozen_diffusivity(H_D, B, dx, dy, values_fn, target, phys)
    return si_math.theta_solve(H, D, B.to(H.dtype), guess, dt, theta, cg_iters, dx, dy)


def si2_step(H, B, dx, dy, values_fn, target, phys, dt, cg_iters: int = 30,
             cg_iters_predictor: int = 6, x0=None, shard=None):
    """One second-order step: Crank–Nicolson predictor with D(Hᵏ), then the
    corrector with D((Hᵏ + H_pred)/2), warm-started at H_pred."""
    H_pred = semi_implicit_step(H, B, dx, dy, values_fn, target, phys, dt,
                                cg_iters_predictor, x0=x0, theta=0.5, shard=shard)
    H_mid = 0.5 * (H + H_pred)
    return semi_implicit_step(H, B, dx, dy, values_fn, target, phys, dt,
                              cg_iters, x0=H_pred, theta=0.5, H_star=H_mid, shard=shard)


def integrate_semi_implicit(
    H0, B, dx, dy, values_fn, target, phys, tstops, substeps: int = 1,
    cg_iters: int = 30, callback=None, theta: float = 1.0,
    corrector: bool = False, cg_iters_predictor: int = 6, shard=None,
):
    """Semi-implicit integration saving at every tstop.

    ``corrector=True`` runs :func:`si2_step` per substep. The CG warm start
    extrapolates the previous step's increment: x0 = H + dH·(dt/dt_prev),
    with dt_prev = 0 (ratio 0, so x0 = H) before the first step; callback
    jumps are not part of dH. Times are differenced in the state's dtype.
    Returns the trajectory, shape ``(len(tstops), *H0.shape)``.
    """
    ts = host_tstops(tstops, H0.dtype)
    npt = ts.dtype.type
    H, dH, dt_prev = H0, torch.zeros_like(H0), npt(0.0)
    traj = [H0]
    for i in range(len(ts) - 1):
        t0, t1 = ts[i], ts[i + 1]
        dt = substep_dt(t0, t1, substeps)
        for _ in range(substeps):
            ratio = dt / dt_prev if dt_prev > 0 else npt(0.0)
            guess = H + float(ratio) * dH
            if corrector:
                Hn = si2_step(H, B, dx, dy, values_fn, target, phys, float(dt),
                              cg_iters, cg_iters_predictor, x0=guess, shard=shard)
            else:
                Hn = semi_implicit_step(H, B, dx, dy, values_fn, target, phys,
                                        float(dt), cg_iters, x0=guess, theta=theta,
                                        shard=shard)
            H, dH, dt_prev = Hn, Hn - H, dt
        if callback is not None:
            H = callback(H, t0, t1, i)
        traj.append(H)
    return torch.stack(traj)
