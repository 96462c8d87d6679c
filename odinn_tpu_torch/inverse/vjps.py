"""Hand-written VJPs of the SIA2D right-hand side, the surface velocity and
the mass balance.

- :func:`vjp_sia_dH`: λᵀ ∂(SIA2D)/∂H, by flavor. ``DiscreteVJP`` is the
  transpose of the discretised forward chain, built from the stencil
  transposes of :mod:`odinn_tpu_torch.ops.stencils` and the target's
  analytic ∂D partials; ``ContinuousVJP`` the differentiate-then-discretize
  operator dλ = ∇·(D∇λ) − ∂D/∂H̄⟨∇S,∇λ⟩ + ∇·(…) on the same staggered
  stencils; ``AutoVJP`` autograd of the RHS; ``NoVJP`` zero.
- :func:`vjp_sia_dtheta`: λᵀ ∂(SIA2D)/∂θ. The discrete and continuous
  flavors take the hand chain down to the D cotangent, then one exact
  pullback through θ ↦ D by autograd.
- :func:`vjp_surface_v_dH`, :func:`vjp_surface_v_dtheta`: the velocity
  pullbacks (autograd).
- :func:`vjp_mb_dH`: the pullback of the mass-balance step minus the
  identity (autograd, or the analytic TImodel1 mask algebra for
  ``DiscreteVJP``).

Which path: for the A target with per-glacier scalar laws whose values do
not depend on time and only A trainable (the fused kernels' configuration,
:func:`fused_table`; C too on the SI transposes),
the discrete pullback of the RHS is the fused RHS's pullback,
:func:`odinn_tpu_torch.ops.cuda.sia_kernel.sia2d_rhs_vjp`: dH and the
cotangent of each glacier's creep coefficient in one launch on the card
(its plain version on the CPU), the creep cotangent taken to θ through the
law by autograd (:func:`table_to_theta`). Every other configuration takes
the tensor code below on either device.
"""

from __future__ import annotations

import torch

from odinn_tpu_torch.core.glacier import per_glacier_column
from odinn_tpu_torch.inverse.adjoint_types import AutoVJP, ContinuousVJP, DiscreteVJP, NoVJP
from odinn_tpu_torch.models.model import make_values_fn, resolve_outer_values
from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda import sia_kernel
from odinn_tpu_torch.physics.mass_balance import _DAYS_PER_MONTH, compute_mb, mb_timestep
from odinn_tpu_torch.physics.sia2d import scalar_law_table, sia2d_rhs, surface_velocity
from odinn_tpu_torch.simulation.inversion import _tree_leaves as tree_leaves
from odinn_tpu_torch.simulation.inversion import _tree_map as tree_map

__all__ = [
    "vjp_sia_dH",
    "vjp_sia_dtheta",
    "vjp_surface_v_dH",
    "vjp_surface_v_dtheta",
    "vjp_mb_dH",
    "rhs_with_theta",
    "fused_table",
    "fused_pullback",
    "table_to_theta",
]

# law inputs whose values do not depend on the time they are read at
_TIME_FREE_INPUTS = ("T", "T_grid", "topo_rough")


def _unflatten(tree, leaves):
    """A θ tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _values_fn(theta, glacier, model, t):
    outer = resolve_outer_values(model, theta, glacier, t)
    return make_values_fn(model, theta, glacier, t, outer)


def _spacings(glacier):
    return per_glacier_column(glacier, glacier.dx), per_glacier_column(glacier, glacier.dy)


def _grad_theta(out, theta, cot, retain=False):
    """The θ-tree cotangent of ``out`` at ``cot``: zeros where θ has no
    route to ``out``. ``theta``'s leaves require grad."""
    leaves = tree_leaves(theta)
    if not out.requires_grad:       # no leaf has a route (a trainable H₀ beside fixed laws)
        return _unflatten(theta, [torch.zeros_like(p) for p in leaves])
    grads = torch.autograd.grad(out, leaves, cot, allow_unused=True, retain_graph=retain)
    return _unflatten(theta, [torch.zeros_like(p) if g is None else g
                              for p, g in zip(leaves, grads)])


def _requiring_grad(theta):
    return tree_map(lambda x: x.detach().requires_grad_(True), theta)


def rhs_with_theta(H, theta, glacier, model, params, t):
    """The SIA2D RHS as an explicit function of (H, θ)."""
    dx, dy = _spacings(glacier)
    return sia2d_rhs(H, glacier.B, dx, dy, _values_fn(theta, glacier, model, t), model.target,
                     params.physical)


def fused_table(theta, glacier, model, params, t, H, slide: bool = False):
    """The raw (n_g, 7) table (dx, dy, A, C, n, p, q) of the fused kernels
    when the configuration is theirs (the A target, constant per-glacier
    scalar law values, one (n_g, nx, ny) state) and no law reads a
    time-dependent input; else None. Only the creep column may depend on
    θ, and the slide column too when ``slide`` (a route whose pullback has
    the slide cotangent: the SI transposes): a trainable C elsewhere, or a
    trainable n anywhere, takes the tensor code, as the kernels' pullbacks
    would drop its gradient."""
    if not set(model.trainable_laws) <= ({"A", "C"} if slide else {"A"}):
        return None
    for law in model.iceflow.laws.values():
        if any(name not in _TIME_FREE_INPUTS for name in law.input_names):
            return None
    dx, dy = _spacings(glacier)
    return scalar_law_table(_values_fn(theta, glacier, model, t), model.target, dx, dy, H,
                            slide_grad=slide)


def table_to_theta(theta, glacier, model, params, t, H, d_creep, d_slide=None):
    """The θ tree of the cotangents ``d_creep`` (and ``d_slide``), (n_g,)
    each, of the derived table's creep (and slide) columns: one evaluation
    of the laws at t into the raw table, then autograd through it and
    :func:`~odinn_tpu_torch.ops.cuda.sia_kernel.derive_table`."""
    phys = params.physical
    with torch.enable_grad():
        th = _requiring_grad(theta)
        raw = fused_table(th, glacier, model, params, t, H, slide=d_slide is not None)
        derived = sia_kernel.derive_table(raw, phys.rho, phys.g)
        pairing = torch.sum(derived[:, 2] * d_creep.to(derived.dtype))
        if d_slide is not None:
            pairing = pairing + torch.sum(derived[:, 3] * d_slide.to(derived.dtype))
        return _grad_theta(pairing, th, None)


def derived_table(raw, phys, dtype):
    """The fused kernels' derived (n_g, 8) table of a raw table, in ``dtype``."""
    return sia_kernel.derive_table(raw, phys.rho, phys.g).to(dtype).contiguous()


def fused_pullback(lam, H, B, derived, eta0):
    """(dH, d_creep) of the fused RHS of the ``derived`` table at H: one
    :func:`~odinn_tpu_torch.ops.cuda.sia_kernel.sia2d_rhs_vjp` launch on
    the card, its plain version on the CPU."""
    return sia_kernel.sia2d_rhs_vjp(lam.contiguous(), H.contiguous(), B.to(H.dtype).contiguous(),
                                    derived, eta0)


def _forward_staggered(H, vfn, glacier, model, params):
    """The forward staggered-grid quantities the adjoint needs."""
    H = st.relu_strict(H)
    S = glacier.B.to(H.dtype) + H
    dx, dy = _spacings(glacier)
    gsx, gsy = st.grad_slope(S, dx, dy)
    grad_s = st.safe_norm(gsx, gsy)
    hbar = st.avg(H)
    vals = vfn(hbar, grad_s)
    D = model.target.diffusivity(vals, hbar, grad_s, params.physical).to(H.dtype)
    dsdx_e_raw = st.diff_x(S[..., :, 1:-1]) / dx
    dsdy_e_raw = st.diff_y(S[..., 1:-1, :]) / dy
    eta0 = params.physical.eta0
    dsdx_e = st.clamp_borders_dx(dsdx_e_raw, H, eta0, dx)
    dsdy_e = st.clamp_borders_dy(dsdy_e_raw, H, eta0, dy)
    return H, S, gsx, gsy, grad_s, hbar, vals, D, dsdx_e_raw, dsdy_e_raw, dsdx_e, dsdy_e


def _flux_adjoint_chain(lam, D, dsdx_e, dsdy_e, dx, dy):
    """The discrete adjoint's head: the cotangents of D and of the clamped
    edge gradients."""
    lam_inn = st.inn(lam)
    fx_adj = st.diff_x_adjoint(-lam_inn, dx)        # (nx-1, ny-2)
    fy_adj = st.diff_y_adjoint(-lam_inn, dy)        # (nx-2, ny-1)
    dx_adj = st.avg_y_adjoint(-fx_adj * dsdx_e)     # (nx-1, ny-1) cotangent via Dx
    dy_adj = st.avg_x_adjoint(-fy_adj * dsdy_e)
    d_adj = dx_adj + dy_adj                          # cotangent on D
    dcx = -fx_adj * st.avg_y(D)                      # cotangent on clamped dS/dx|e
    dcy = -fy_adj * st.avg_x(D)
    return d_adj, dcx, dcy


def _target_partials(tgt, vals, hbar, grad_s, phys, dtype):
    """(∂D/∂H̄, β) with ∂D/∂∇Sᵢ = β·∇Sᵢ: the target's closed forms, or
    autograd through its diffusivity at fixed law values."""
    if hasattr(tgt, "d_diffusivity_dH"):
        return (tgt.d_diffusivity_dH(vals, hbar, grad_s, phys).to(dtype),
                tgt.d_diffusivity_dgradS(vals, hbar, grad_s, phys).to(dtype))
    with torch.enable_grad():
        hb, gs = hbar.detach().requires_grad_(True), grad_s.detach().requires_grad_(True)
        alpha, g = torch.autograd.grad(torch.sum(tgt.diffusivity(vals, hb, gs, phys)), (hb, gs),
                                       allow_unused=True, materialize_grads=True)
    safe = torch.where(grad_s > 0.0, grad_s, torch.ones_like(grad_s))
    return alpha, g / safe


def _vjp_dH_discrete(lam, H, vfn, glacier, model, params):
    """Discrete λᵀ∂f/∂H."""
    dx, dy = _spacings(glacier)
    eta0 = params.physical.eta0
    (Hc, S, gsx, gsy, grad_s, hbar, vals, D,
     dsdx_e_raw, dsdy_e_raw, dsdx_e, dsdy_e) = _forward_staggered(H, vfn, glacier, model, params)
    d_adj, dcx, dcy = _flux_adjoint_chain(lam, D, dsdx_e, dsdy_e, dx, dy)

    # the D = D(H̄, ∇S(H)) route
    alpha, beta = _target_partials(model.target, vals, hbar, grad_s, params.physical, H.dtype)
    dD_dH_adj = (
        st.avg_adjoint(alpha * d_adj)
        + st.diff_x_adjoint(st.avg_y_adjoint(beta * gsx * d_adj), dx)
        + st.diff_y_adjoint(st.avg_x_adjoint(beta * gsy * d_adj), dy)
    )
    # the clamped edge-gradient route
    ddsx, dhx = st.clamp_borders_dx_adjoint(dcx, eta0, dx, Hc, dsdx_e_raw)
    ddsy, dhy = st.clamp_borders_dy_adjoint(dcy, eta0, dy, Hc, dsdy_e_raw)
    pad = torch.nn.functional.pad
    grad_x_back = pad(st.diff_x_adjoint(ddsx, dx), (1, 1, 0, 0))
    grad_y_back = pad(st.diff_y_adjoint(ddsy, dy), (0, 0, 1, 1))
    dlam = dD_dH_adj + grad_x_back + dhx + grad_y_back + dhy
    return dlam * (Hc > 0.0)


def _vjp_dH_continuous(lam, H, vfn, glacier, model, params):
    """Continuous (differentiate-then-discretize) λᵀ∂f/∂H:

        (∂f/∂H)ᵀλ = ∇·(D∇λ) − ∂D/∂H̄ ⟨∇S, ∇λ⟩ + ∇·(β ⟨∇S,∇λ⟩ ∇S)

    on the same staggered grid, without the border clamps (the continuous
    operator ignores the discrete boundary condition)."""
    dx, dy = _spacings(glacier)
    Hc, S, gsx, gsy, grad_s, hbar, vals, D, *_ = _forward_staggered(
        H, vfn, glacier, model, params)
    alpha, beta = _target_partials(model.target, vals, hbar, grad_s, params.physical, H.dtype)
    glx, gly = st.grad_slope(lam, dx, dy)
    sdotl = gsx * glx + gsy * gly

    def div_centers(vx_st, vy_st):
        """Divergence of a staggered-node vector field onto the interior
        cell centers (zero ring)."""
        ddx = st.avg_y(st.diff_x(vx_st)) / dx
        ddy = st.avg_x(st.diff_y(vy_st)) / dy
        return st.pad_inner(ddx + ddy)

    fx = st.avg_y(D) * (st.diff_x(lam[..., :, 1:-1]) / dx)
    fy = st.avg_x(D) * (st.diff_y(lam[..., 1:-1, :]) / dy)
    term1 = st.pad_inner(st.diff_x(fx) / dx + st.diff_y(fy) / dy)
    term2 = -st.avg_adjoint(alpha * sdotl)
    term3 = div_centers(beta * sdotl * gsx, beta * sdotl * gsy)
    return (term1 + term2 + term3) * (Hc > 0.0)


def vjp_sia_dH(flavor, lam, H, theta, glacier, model, params, t):
    """λᵀ ∂(SIA2D)/∂H by flavor (module doc); laws evaluated at t."""
    if isinstance(flavor, NoVJP):
        return torch.zeros_like(lam)
    if isinstance(flavor, AutoVJP):
        with torch.enable_grad():
            h = H.detach().requires_grad_(True)
            (dH,) = torch.autograd.grad(rhs_with_theta(h, theta, glacier, model, params, t), h,
                                        lam)
        return dH
    vfn = _values_fn(theta, glacier, model, t)
    if isinstance(flavor, ContinuousVJP):
        return _vjp_dH_continuous(lam, H, vfn, glacier, model, params)
    if isinstance(flavor, DiscreteVJP):
        raw = fused_table(theta, glacier, model, params, t, H)
        if raw is not None:
            return fused_pullback(lam, H, glacier.B, derived_table(raw, params.physical, H.dtype),
                                  params.physical.eta0)[0]
        return _vjp_dH_discrete(lam, H, vfn, glacier, model, params)
    raise TypeError(f"unknown VJP flavor {flavor!r}")


def _d_cotangent(lam, H, vfn, glacier, model, params):
    """The hand chain's D cotangent and the (H̄, |∇S|) it was taken at."""
    dx, dy = _spacings(glacier)
    _, _, _, _, grad_s, hbar, _, D, _, _, dsdx_e, dsdy_e = _forward_staggered(
        H, vfn, glacier, model, params)
    d_adj, _, _ = _flux_adjoint_chain(lam, D, dsdx_e, dsdy_e, dx, dy)
    return d_adj, hbar, grad_s


def vjp_sia_dtheta(flavor, lam, H, theta, glacier, model, params, t):
    """λᵀ ∂(SIA2D)/∂θ by flavor, a θ tree (module doc); laws evaluated at t.
    The discrete and continuous flavors take the hand chain to the D
    cotangent, then one exact pullback through θ ↦ D."""
    if isinstance(flavor, NoVJP):
        return tree_map(torch.zeros_like, theta)
    with torch.enable_grad():
        th = _requiring_grad(theta)
        if isinstance(flavor, AutoVJP):
            return _grad_theta(rhs_with_theta(H.detach(), th, glacier, model, params, t), th, lam)
        if not isinstance(flavor, (DiscreteVJP, ContinuousVJP)):
            raise TypeError(f"unknown VJP flavor {flavor!r}")
        raw = fused_table(theta, glacier, model, params, t, H)
        if raw is not None:
            _, d_creep = fused_pullback(lam, H, glacier.B,
                                        derived_table(raw, params.physical, H.dtype),
                                        params.physical.eta0)
            return table_to_theta(theta, glacier, model, params, t, H, d_creep)
        d_adj, hbar, grad_s = _d_cotangent(lam, H.detach(), _values_fn(theta, glacier, model, t),
                                           glacier, model, params)
        vals = _values_fn(th, glacier, model, t)(hbar, grad_s)
        D = model.target.diffusivity(vals, hbar, grad_s, params.physical).to(H.dtype)
        return _grad_theta(D, th, d_adj)


def vjp_surface_v_dH(flavor, lam_x, lam_y, H, theta, glacier, model, params, t):
    """(λx, λy)ᵀ ∂(Vx, Vy)/∂H, the staggered surface velocity's exact
    pullback."""
    dx, dy = _spacings(glacier)
    vfn = _values_fn(theta, glacier, model, t)
    with torch.enable_grad():
        h = H.detach().requires_grad_(True)
        vx, vy, _ = surface_velocity(h, glacier.B, dx, dy, vfn, model.target, params.physical)
        (dH,) = torch.autograd.grad((vx, vy), h, (lam_x, lam_y))
    return dH


def vjp_surface_v_dtheta(flavor, lam_x, lam_y, H, theta, glacier, model, params, t):
    """(λx, λy)ᵀ ∂(Vx, Vy)/∂θ, a θ tree."""
    dx, dy = _spacings(glacier)
    with torch.enable_grad():
        th = _requiring_grad(theta)
        vx, vy, _ = surface_velocity(H.detach(), glacier.B, dx, dy,
                                     _values_fn(th, glacier, model, t), model.target,
                                     params.physical)
        leaves = tree_leaves(th)
        grads = torch.autograd.grad((vx, vy), leaves, (lam_x, lam_y), allow_unused=True)
    return _unflatten(th, [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)])


def vjp_mb_dH(flavor, lam, H, glacier, mb_model, t, step):
    """λᵀ ∂(H + MB(H))/∂H − λ: the pullback of the mass-balance increment."""
    if isinstance(flavor, NoVJP):
        return torch.zeros_like(lam)
    if isinstance(flavor, DiscreteVJP):
        return _vjp_mb_dH_discrete(lam, H, glacier, mb_model, t, step)
    with torch.enable_grad():
        h = H.detach().requires_grad_(True)
        (dH,) = torch.autograd.grad(mb_timestep(h, glacier, mb_model, t, step), h, lam)
    return dH - lam


def _trail(a, k: int):
    return a.reshape(a.shape + (1,) * k)


def _vjp_mb_dH_discrete(lam, H, glacier, mb_model, t, step):
    """Analytic TImodel1 pullback, the PDD-mask algebra of the window sum:

        ∂melt/∂H = DDF · Σ_m w_m · days · ∇T_m · 1[T₂D_m > 0]
        ∂MB_eff/∂H = −1 on ice-disappearance cells (MB clipped to −H),
                     ∂MB/∂H on masked cells, 0 elsewhere.
    """
    if hasattr(mb_model, "compute_mb_field"):
        raise TypeError("the discrete MB VJP supports TImodel1 only; MLP MB models use "
                        "the AutoVJP path")
    H_pos = torch.where(H > 0.0, H, torch.zeros_like(H))
    S = glacier.B.to(H.dtype) + H_pos
    clim = glacier.climate
    MB = compute_mb(mb_model, clim, S, t, step).to(H.dtype)
    n_m = clim.temp.shape[-1]
    months = torch.arange(n_m, device=clim.temp.device)
    t_m = _trail(clim.t_start, 1) + (months + 0.5) / 12.0
    w = ((t_m > t - step) & (t_m <= t)).to(S.dtype)
    t2d = _trail(clim.temp, 2) + _trail(clim.gradient, 2) * (
        S.unsqueeze(-3) - _trail(clim.ref_hgt, 3))
    dmelt_dH = mb_model.DDF * torch.sum(
        _trail(w, 2) * _trail(clim.gradient, 2) * (t2d > 0.0) * _DAYS_PER_MONTH, dim=-3
    ).to(H.dtype)
    mask = ((H_pos > 0.0) & (MB < 0.0)) | ((H_pos > 10.0) & (MB >= 0.0))
    pos = (H > 0.0).to(lam.dtype)
    dmb_raw = torch.where(mask, -dmelt_dH, torch.zeros_like(dmelt_dH)) * pos
    t1 = torch.where(mask, MB, torch.zeros_like(MB))
    t2 = -H_pos
    # d(max(t1, t2))/dH with autograd's even split at ties (the structural
    # H = 0 cells)
    dmax = torch.where(t1 > t2, dmb_raw, torch.where(t1 < t2, -pos, 0.5 * (dmb_raw - pos)))
    return lam * (pos + dmax - 1.0)
