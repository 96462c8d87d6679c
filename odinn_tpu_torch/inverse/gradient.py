"""The discrete and continuous manual adjoints: loss and θ-gradient by a reverse sweep.

**DiscreteAdjoint**: the exact transpose of the forward integrator. Each
substep H_{k+1} = ψ(H_k) is pulled back stage by stage
(λ_k = (∂ψ/∂H)ᵀλ_{k+1}), its stage states rematerialised by re-running the
forward inside each save interval with the plain steppers (not the
compensated forward), so the transpose reproduces reverse-mode autograd of
that forward to roundoff while holding only one interval's states. The
semi-implicit steps (SI, SI2) are transposed by the implicit-function
theorem: the pre-relu state is rematerialised from H₀ by plain CG, the
adjoint system A·μ = λ·[w > 0] is solved by plain CG from its right-hand
side, and μ is pulled back through b − A(D)·w at fixed w and through the
frozen diffusivity; SI2 routes half of the corrector's D cotangent back
through the predictor solve.

**ContinuousAdjoint**: the reverse adjoint ODE dλ/dτ = (∂f/∂H)ᵀλ solved
with the embedded BS3(2) pair and one step-size controller per glacier,
the loss cotangents injected at the interval boundaries and H(t)
interpolated between the saves (cubic Hermite with Ḣ = f(H, t), or
linear); dL/dθ is contracted by Gauss–Legendre quadrature over the span.

Both adjoints run the whole stacked batch at once: every pullback covers
all glaciers, and θ's cotangent is summed over them. The loss terms'
cotangents come from one autograd pass over the saves: the transient
terms' at each save, the aggregate terms' (a function of the whole
trajectory) at every save, save 0 included, and the initial-state terms'
(at t₀, on H₀ and θ) straight into θ. Both sweeps return λ(t₀); with a
trainable initial condition H₀ = σ(θ_IC), λ(t₀) plus the aggregate
cotangent at save 0, times σ′(θ_IC), is θ_IC's cotangent. The laws are
evaluated once, at the first tstop, as the forward solve evaluates them;
so periodic laws, which the forward refreshes from the evolving state, are
refused (train them with ``grad="jax"``). The D and capped targets take
the tensor code: their inner laws' values are held fixed in the local
pullback of D to (H̄, |∇S|), as in the JAX package, while θ's pullback
goes through them.
Where the configuration is the fused kernels' (A target, constant
per-glacier scalar laws of time-free inputs, only A trainable, or A and C
on the SI transposes; see
:func:`odinn_tpu_torch.inverse.vjps.fused_table`) the pullbacks are the
kernels' on the card (their plain versions on the CPU): each explicit
stage's (dH, dθ) pair is one ``sia2d_rhs_vjp`` launch (an RKC step its
``rkc_interval`` rematerialisation and fused stages), each SI/SI2 solve's
transpose is ``si_step`` and ``si_step_transpose`` without the
preconditioner and one ``si_step_vjp``, and the creep and slide
cotangents are summed per glacier and taken to θ through the law once a
gradient.

On a row-sharded batch (``glacier.row_shard``) the discrete adjoint runs on
the rank's own rows: each RHS evaluation and each stage pullback takes the
slab of one ghost row (λ zero on the ghost rows, the ghost rows'
cotangents sent back to their owners), a fused RKC step and its pullback
the slab of ``s``, and the SI/SI2 transposes the slab of two with their
plain-CG solves split at the reductions (``si_math.rows_cg``); θ's
cotangent is this rank's partial, which the trainer sums over the mesh.
The continuous adjoint runs there too: the saved trajectory (and its
slopes) is extended by one ghost row once, so each reverse RHS pullback
and each quadrature node reads its slab with no exchange of H; a pullback
by an exact transpose sends the ghost rows' cotangents back to their
owners, and the continuous VJP flavor, an operator applied to λ, takes
λ's ghost rows instead; the reverse controller's error norm is summed
over the row group (``solver.error_norm``), so every rank of a group
takes the same reverse steps.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from odinn_tpu_torch.inverse import vjps
from odinn_tpu_torch.inverse.adjoint_types import (
    ContinuousAdjoint, ContinuousVJP, DiscreteAdjoint, DiscreteVJP)
from odinn_tpu_torch.models.model import glacier_index
from odinn_tpu_torch.ops import si_math
from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda import rkc_kernel, si_kernel
from odinn_tpu_torch.ops.cuda.common import shared_exps
from odinn_tpu_torch.physics.sia2d import sia2d_rhs
from odinn_tpu_torch.simulation import solver as solver_mod
from odinn_tpu_torch.simulation.implicit import (
    _frozen_diffusivity, semi_implicit_step, si2_step)
from odinn_tpu_torch.simulation.inversion import _LossEnv, assemble_tstops
from odinn_tpu_torch.simulation.prediction import _METHODS, _mb_every, forward_glacier

__all__ = ["glacier_adjoint_value_and_grad", "make_adjoint_value_and_grad",
           "resolve_adjoint", "gauss_legendre_nodes", "check_adjoint_supported"]

_MAX_INNER = 10_000      # reverse steps of one interval at most


def gauss_legendre_nodes(t0, t1, n):
    """Gauss–Legendre nodes and weights on [t0, t1] (numpy float64)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0) * (t1 - t0) + t0, 0.5 * (t1 - t0) * w


def _per_tstop_loss_fn(env):
    """ℓ(H, τ): the per-glacier transient loss at save index τ, Δt-weighted
    as in the total loss; θ enters through the velocity terms."""

    def loss_at(H, tau):
        t, ctx, h_valid, v_valid = env.obs_at(tau, H.dtype)
        acc = 0.0
        for w, term in env.transient:
            acc = acc + w * env.term_valid(term, h_valid, v_valid) * term(ctx, H, t)
        return acc * float(env.dts[tau - 1])

    return loss_at


def _tree_add(like, a, b):
    return vjps._unflatten(like, [x + y for x, y in zip(vjps.tree_leaves(a),
                                                        vjps.tree_leaves(b))])


class _Pullbacks:
    """The RHS and its pullbacks over the batch at θ, with the laws at the
    first tstop, and the accumulated θ cotangent: a θ tree and, on the
    fused route, the per-glacier cotangents of the derived table's creep
    and slide columns, taken to θ once (:meth:`theta_cotangent`).
    ``slide``: the sweep's pullbacks give the slide cotangent (the SI
    transposes), so a trainable C may take the fused route."""

    def __init__(self, flavor, theta, glacier, model, params, t_first, H0, slide=False):
        self.flavor, self.glacier, self.model, self.params = flavor, glacier, model, params
        self.t_first, self.H0, self.slide = t_first, H0, slide
        self.shard = glacier.row_shard
        self.theta = vjps.tree_map(lambda x: x.detach(), theta)
        self.phys = params.physical
        self.B = glacier.B.to(H0.dtype).contiguous()
        self.dx, self.dy = vjps._spacings(glacier)
        self.vfn = vjps._values_fn(self.theta, glacier, model, t_first)
        self._glacier = glacier      # the batch itself, also inside on_slab
        self.raw = vjps.fused_table(self.theta, glacier, model, params, t_first, H0, slide)
        self.derived = self.exps = None
        if self.raw is not None:
            self.derived = vjps.derived_table(self.raw, self.phys, H0.dtype)
            self.exps = shared_exps(self.derived)
        self.tree = vjps.tree_map(torch.zeros_like, self.theta)
        n_g = H0.shape[0]
        self.d_creep = torch.zeros(n_g, dtype=torch.float64, device=H0.device)
        self.d_slide = torch.zeros(n_g, dtype=torch.float64, device=H0.device)
        self._th = self._vfn_th = None

    # -- the θ route of the tensor code: the laws once, with their graph --
    def _theta_values(self):
        if self._th is None:
            with torch.enable_grad():
                self._th = vjps._requiring_grad(self.theta)
                self._vfn_th = vjps._values_fn(self._th, self._glacier, self.model,
                                               self.t_first)
        return self._th, self._vfn_th

    def add_tree(self, tree):
        self.tree = _tree_add(self.theta, self.tree, tree)

    def add_table(self, d_creep, d_slide=None):
        self.d_creep.add_(d_creep)
        if d_slide is not None:
            self.d_slide.add_(d_slide)

    def theta_cotangent(self):
        """The accumulated θ cotangent as a θ tree."""
        if self.raw is None:
            return self.tree
        table = vjps.table_to_theta(self.theta, self.glacier, self.model, self.params,
                                    self.t_first, self.H0, self.d_creep,
                                    self.d_slide if self.slide else None)
        return _tree_add(self.theta, self.tree, table)

    # -- the RHS and its pullbacks --
    @property
    def fused(self) -> bool:
        return self.raw is not None

    def rhs(self, H, t=None):
        return sia2d_rhs(H, self.glacier.B, self.dx, self.dy, self.vfn, self.model.target,
                         self.phys, shard=self.shard)

    @contextlib.contextmanager
    def on_slab(self, h):
        """The pullbacks' bed (and the glacier they read it from) on the row
        shard's slab of halo ``h`` for the duration."""
        glacier, B = self.glacier, self.B
        self.B = self.shard.bed(h, B.dtype)
        self.glacier = glacier.replace(B=self.shard.bed(h), row_shard=None)
        try:
            yield
        finally:
            self.glacier, self.B = glacier, B

    def _fused_vjp(self, lam, H):
        return vjps.fused_pullback(lam, H, self.B, self.derived, self.phys.eta0)

    def vjp_H(self, lam, H, t=None):
        """λᵀ∂f/∂H at H, by the flavor."""
        f = self.flavor
        if isinstance(f, DiscreteVJP):
            if self.fused:
                return self._fused_vjp(lam, H)[0]
            return vjps._vjp_dH_discrete(lam, H, self.vfn, self.glacier, self.model, self.params)
        if isinstance(f, ContinuousVJP):
            return vjps._vjp_dH_continuous(lam, H, self.vfn, self.glacier, self.model,
                                           self.params)
        return vjps.vjp_sia_dH(f, lam, H, self.theta, self.glacier, self.model, self.params,
                               self.t_first)

    def vjp_theta(self, lam, H, t=None):
        """Accumulates λᵀ∂f/∂θ at H."""
        f = self.flavor
        if isinstance(f, (DiscreteVJP, ContinuousVJP)):
            if self.fused:
                self.add_table(self._fused_vjp(lam, H)[1])
                return
            d_adj, hbar, grad_s = vjps._d_cotangent(lam, H, self.vfn, self.glacier, self.model,
                                                    self.params)
            th, vfn_th = self._theta_values()
            with torch.enable_grad():
                D = self.model.target.diffusivity(vfn_th(hbar, grad_s), hbar, grad_s,
                                                  self.phys).to(H.dtype)
                self.add_tree(vjps._grad_theta(D, th, d_adj, retain=True))
            return
        self.add_tree(vjps.vjp_sia_dtheta(f, lam, H, self.theta, self.glacier, self.model,
                                          self.params, self.t_first))

    def pull(self, lam, H, t=None):
        """λᵀ∂f/∂H at H; accumulates λᵀ∂f/∂θ. On the fused route of the
        discrete flavor both are one pullback launch. On a row shard: on
        the slab of halo 1 (module doc, :meth:`rows_vjp_H`)."""
        sh = self.shard
        if sh is None:
            return self._pull(lam, H, t)
        H_s = sh.exchange(H, 1)
        if isinstance(self.flavor, DiscreteVJP) and self.fused:
            with self.on_slab(1):
                dH = self._pull(sh.pad(lam, 1), H_s, t)
            return sh.halo_transpose(dH, 1)
        self.rows_vjp_theta(lam, H_s, t)
        return self.rows_vjp_H(lam, H_s, t)

    def rows_vjp_H(self, lam, H_s, t=None):
        """:meth:`vjp_H` on a row shard: ``lam`` on the own rows, ``H_s`` on
        the slab of halo 1; returns the own rows. An exact transpose takes
        λ zero on the ghost rows and sends the ghost rows' cotangents back
        to their owners; the continuous flavor, an operator applied to λ,
        reads λ's ghost rows (one exchange) and keeps its own rows."""
        sh = self.shard
        with self.on_slab(1):
            if isinstance(self.flavor, ContinuousVJP):
                return sh.crop(self.vjp_H(sh.exchange(lam, 1), H_s, t), 1)
            dH = self.vjp_H(sh.pad(lam, 1), H_s, t)
        return sh.halo_transpose(dH, 1)

    def rows_vjp_theta(self, lam, H_s, t=None):
        """:meth:`vjp_theta` on a row shard: λ zero on the ghost rows, so the
        cotangent is this rank's equations' part."""
        with self.on_slab(1):
            self.vjp_theta(self.shard.pad(lam, 1), H_s, t)

    def _pull(self, lam, H, t=None):
        if isinstance(self.flavor, DiscreteVJP) and self.fused:
            dH, d_creep = self._fused_vjp(lam, H)
            self.add_table(d_creep)
            return dH
        self.vjp_theta(lam, H, t)
        return self.vjp_H(lam, H, t)


# ---------------------------------------------------------------------------
# Stage-level transposes of the explicit steppers
# ---------------------------------------------------------------------------

def _euler_transpose(lam, H0, dt, t, rhs, pull):
    """Transpose of H1 = H0 + dt·f(H0)."""
    return lam + pull(dt * lam, H0, t)


def _rk4_transpose(lam, H0, dt, t, rhs, pull):
    """Exact transpose of the classic RK4 step (stages rematerialised)."""
    half = 0.5 * dt
    k1 = rhs(H0, t)
    u2 = H0 + half * k1
    k2 = rhs(u2, t + half)
    u3 = H0 + half * k2
    k3 = rhs(u3, t + half)
    u4 = H0 + dt * k3
    w = dt / 6.0
    g4 = pull(w * lam, u4, t + dt)
    g3 = pull(2.0 * w * lam + dt * g4, u3, t + half)
    g2 = pull(2.0 * w * lam + half * g3, u2, t + half)
    g1 = pull(w * lam + half * g2, H0, t)
    return lam + g1 + g2 + g3 + g4


def _ssprk3_transpose(lam, H0, dt, t, rhs, pull):
    """Exact transpose of the Shu–Osher SSPRK3 step:
    y1 = y + dt f(y);  y2 = ¾y + ¼(y1 + dt f(y1));  y' = ⅓y + ⅔(y2 + dt f(y2))."""
    y1 = H0 + dt * rhs(H0, t)
    y2 = 0.75 * H0 + 0.25 * (y1 + dt * rhs(y1, t + dt))
    c_y2 = (2.0 / 3.0) * lam + pull((2.0 / 3.0) * dt * lam, y2, t + 0.5 * dt)
    c_y1 = 0.25 * c_y2 + pull(0.25 * dt * c_y2, y1, t + dt)
    g1 = pull(dt * c_y1, H0, t)
    return lam / 3.0 + 0.75 * c_y2 + c_y1 + g1


def _make_rkc_transpose(s: int):
    """Exact transpose of the s-stage RKC2 step (stages rematerialised),
    through the RHS and its pullbacks:
        y₁ = y + μ̃₁·dt·f₀,   f₀ = f(y, t)
        yⱼ = (1−μⱼ−νⱼ)·y + μⱼ·yⱼ₋₁ + νⱼ·yⱼ₋₂ + μ̃ⱼ·dt·f(yⱼ₋₁) + γ̃ⱼ·dt·f₀
    The cotangent of yⱼ₋₁ collects the μⱼ route, the f route (ξⱼ = μ̃ⱼ·dt·cⱼ)
    and the ν route pending from two stages up; f₀'s cotangent collects
    every γ̃ⱼ route and μ̃₁ and is pulled back once at the end."""
    _, _, mu1_t, mu, nu, mu_t, gam_t, c = solver_mod._rkc2_coeffs(s)

    def transpose(lam, H0, dt, t, rhs, pull):
        f0 = rhs(H0, t)
        y_jm1, y_jm2 = H0 + mu1_t * dt * f0, H0
        y_inputs = []                   # y_inputs[j-2] = y_{j-1}, the state f sees at stage j
        for j in range(2, s + 1):
            y_inputs.append(y_jm1)
            f_j = rhs(y_jm1, t + c[j - 1] * dt)
            y_j = ((1.0 - mu[j] - nu[j]) * H0 + mu[j] * y_jm1 + nu[j] * y_jm2
                   + mu_t[j] * dt * f_j + gam_t[j] * dt * f0)
            y_jm1, y_jm2 = y_j, y_jm1
        zero = torch.zeros_like(lam)
        c_j, pend, cot_y, cot_f0 = lam, zero, zero, zero
        for j in range(s, 1, -1):
            cot_y = cot_y + (1.0 - mu[j] - nu[j]) * c_j
            cot_f0 = cot_f0 + gam_t[j] * dt * c_j
            g = pull(mu_t[j] * dt * c_j, y_inputs[j - 2], t + c[j - 1] * dt)
            c_j, pend = pend + mu[j] * c_j + g, nu[j] * c_j
        cot_y = cot_y + c_j + pend
        cot_f0 = cot_f0 + mu1_t * dt * c_j
        return cot_y + pull(cot_f0, H0, t)

    return transpose


def _fused_rkc_transpose(pb, s):
    """The RKC2 transpose on the fused kernels: one ``rkc_interval`` launch
    rematerialises the stages, then the stage-mode pullbacks
    (``rkc_kernel.interval_pullback``)."""

    def transpose(lam, H0, dt, t, rhs, pull):
        sh, B = pb.shard, pb.B
        if sh is not None:        # on the slab of halo s (module doc)
            lam, H0, B = sh.pad(lam, s), sh.exchange(H0, s), sh.bed(s, H0.dtype)
        dH, d_creep = rkc_kernel.interval_pullback(lam.contiguous(), H0.contiguous(), B,
                                                   pb.derived, dt, s, pb.phys.eta0, pb.exps)
        pb.add_table(d_creep)
        return dH if sh is None else sh.halo_transpose(dH, s)

    return transpose


# ---------------------------------------------------------------------------
# Semi-implicit transposes
# ---------------------------------------------------------------------------

def _make_si_transpose(pb, cg_iters):
    """Exact transpose of one semi-implicit step (θ = 1) by the
    implicit-function theorem: rematerialise w = CG(A, b, H₀), solve
    A·μ = λ·[w > 0] by CG from its right-hand side (A is symmetric), and
    pull μ back through b − A(D)·w at fixed w and through D = D(H₀, θ).
    Both solves are plain CG, as the JAX package's transpose solves them
    (the forward steps by Jacobi-PCG from an extrapolated guess)."""

    def fused(lam, H0, dt, t, rhs, pull):
        d, e = pb.derived, pb.exps
        sh = pb.shard
        if sh is not None:
            H_s = sh.exchange(H0, 2).contiguous()
            B_s = sh.bed(2, H0.dtype)
            w = si_kernel.rows_step_x(sh, H_s, H_s, B_s, H_s, d, dt, 1.0, cg_iters, e,
                                      precondition=False)
            mu = si_kernel.rows_step_transpose(sh, lam, w, H_s, B_s, d, dt, 1.0, cg_iters, e,
                                               precondition=False)
            dH, dH_D, _, d_creep, d_slide = si_kernel.si_step_vjp(
                sh.pad(mu, 2).contiguous(), H_s, H_s, B_s, sh.exchange(w, 2).contiguous(), d, dt,
                1.0, e)
            pb.add_table(d_creep, d_slide)
            return sh.halo_transpose(dH + dH_D, 2)
        _, w = si_kernel.si_step(H0, H0, pb.B, H0, d, dt, 1.0, cg_iters, e,
                                 precondition=False, keep_x=True)
        mu = si_kernel.si_step_transpose(lam.contiguous(), w, H0, pb.B, d, dt, 1.0, cg_iters, e,
                                         precondition=False)
        dH, dH_D, _, d_creep, d_slide = si_kernel.si_step_vjp(mu, H0, H0, pb.B, w, d, dt, 1.0, e)
        pb.add_table(d_creep, d_slide)
        return dH + dH_D

    def generic(lam, H0, dt, t, rhs, pull):
        dH, dH_D = _generic_theta_pull(pb, lam, H0, H0, dt, 1.0, cg_iters, x0=H0)
        return dH + dH_D

    return fused if pb.fused and pb.exps is not None else generic


def _generic_theta_pull(pb, lam, H, H_D, dt, theta, iters, x0):
    """One θ-step's transpose on the tensor code: the cotangents of H and of
    H_D for the cotangent λ on relu(w), w = CG(A(D(H_D)), b(H), x0); θ's
    part is accumulated."""
    th, vfn_th = pb._theta_values()
    sh = pb.shard
    B = pb.B
    if sh is not None:
        H, H_D, x0 = sh.exchange(torch.stack([H, H_D, x0]), 2).unbind(0)
        B = sh.bed(2, H.dtype)
    with torch.enable_grad():
        hd = H_D.detach().requires_grad_(True)
        D = _frozen_diffusivity(hd, B, pb.dx, pb.dy, vfn_th, pb.model.target, pb.phys)
    Dc = D.detach()
    if sh is None:
        w = si_math.theta_solve_x(H, Dc, B, x0, dt, theta, iters, pb.dx, pb.dy,
                                  precondition=False)
        mu = si_math.transpose_solve(lam, w, Dc, dt, theta, iters, pb.dx, pb.dy,
                                     precondition=False)
    else:
        w = si_math.rows_theta_x(sh, H, Dc, B, x0, dt, theta, iters, pb.dx, pb.dy,
                                 precondition=False)
        mu = sh.pad(si_math.rows_transpose_solve(sh, lam, w, Dc, B, dt, theta, iters, pb.dx,
                                                 pb.dy, precondition=False), 2)
        w = sh.exchange(w, 2)
    dH, cot_D, _ = si_math.residual_pullback(mu, H, Dc, B, w, dt, theta, pb.dx, pb.dy)
    leaves = vjps.tree_leaves(th)
    with torch.enable_grad():
        grads = torch.autograd.grad(D, [hd] + leaves, cot_D, allow_unused=True,
                                    retain_graph=True)
    pb.add_tree(vjps._unflatten(th, [torch.zeros_like(p) if g is None else g
                                     for p, g in zip(leaves, grads[1:])]))
    dH_D = torch.zeros_like(H) if grads[0] is None else grads[0]
    if sh is not None:
        return sh.halo_transpose(dH, 2), sh.halo_transpose(dH_D, 2)
    return dH, dH_D


def _make_si2_transpose(pb, cg, cg_p):
    """Exact transpose of one SI2 predictor–corrector step: two chained
    Crank–Nicolson solves, the predictor with D(H₀), the corrector with
    D((H₀ + H_pred)/2) from H_pred, each transposed as in
    :func:`_make_si_transpose` at θ = ½; half of the corrector's
    D cotangent goes back through the predictor solve (the midpoint's
    chain rule), half straight into H₀."""
    ts = 0.5

    def fused_rows(lam, H0, dt):
        d, e, sh = pb.derived, pb.exps, pb.shard
        B = sh.bed(2, H0.dtype)
        H0_s = sh.exchange(H0, 2).contiguous()
        w1 = si_kernel.rows_step_x(sh, H0_s, H0_s, B, H0_s, d, dt, ts, cg_p, e,
                                   precondition=False)
        H_pred = st.relu_strict(w1)
        H_mid = 0.5 * (H0 + H_pred)
        mid_s, pred_s = sh.exchange(torch.stack([H_mid, H_pred]), 2).unbind(0)
        mid_s, pred_s = mid_s.contiguous(), pred_s.contiguous()
        w2 = si_kernel.rows_step_x(sh, H0_s, mid_s, B, pred_s, d, dt, ts, cg, e,
                                   precondition=False)
        mu2 = si_kernel.rows_step_transpose(sh, lam, w2, mid_s, B, d, dt, ts, cg, e,
                                            precondition=False)
        dH_a, dH_mid, _, dc2, ds2 = si_kernel.si_step_vjp(
            sh.pad(mu2, 2).contiguous(), H0_s, mid_s, B, sh.exchange(w2, 2).contiguous(), d, dt,
            ts, e)
        dH_a, dH_mid = sh.halo_transpose(dH_a, 2), sh.halo_transpose(dH_mid, 2)
        mu1 = si_kernel.rows_step_transpose(sh, 0.5 * dH_mid, w1, H0_s, B, d, dt, ts, cg_p, e,
                                            precondition=False)
        dH_b, dH_c, _, dc1, ds1 = si_kernel.si_step_vjp(
            sh.pad(mu1, 2).contiguous(), H0_s, H0_s, B, sh.exchange(w1, 2).contiguous(), d, dt,
            ts, e)
        pb.add_table(dc2 + dc1, ds2 + ds1)
        return dH_a + 0.5 * dH_mid + sh.halo_transpose(dH_b + dH_c, 2)

    def fused(lam, H0, dt, t, rhs, pull):
        if pb.shard is not None:
            return fused_rows(lam, H0, dt)
        d, e, B = pb.derived, pb.exps, pb.B
        H_pred, w1 = si_kernel.si_step(H0, H0, B, H0, d, dt, ts, cg_p, e, precondition=False,
                                       keep_x=True)
        H_mid = 0.5 * (H0 + H_pred)
        _, w2 = si_kernel.si_step(H0, H_mid, B, H_pred, d, dt, ts, cg, e, precondition=False,
                                  keep_x=True)
        mu2 = si_kernel.si_step_transpose(lam.contiguous(), w2, H_mid, B, d, dt, ts, cg, e,
                                          precondition=False)
        dH_a, dH_mid, _, dc2, ds2 = si_kernel.si_step_vjp(mu2, H0, H_mid, B, w2, d, dt, ts, e)
        mu1 = si_kernel.si_step_transpose((0.5 * dH_mid).contiguous(), w1, H0, B, d, dt, ts,
                                          cg_p, e, precondition=False)
        dH_b, dH_c, _, dc1, ds1 = si_kernel.si_step_vjp(mu1, H0, H0, B, w1, d, dt, ts, e)
        pb.add_table(dc2 + dc1, ds2 + ds1)
        return dH_a + 0.5 * dH_mid + dH_b + dH_c

    def generic(lam, H0, dt, t, rhs, pull):
        sh = pb.shard
        with torch.no_grad():
            if sh is None:
                D1 = _frozen_diffusivity(H0, pb.B, pb.dx, pb.dy, pb.vfn, pb.model.target,
                                         pb.phys)
                w1 = si_math.theta_solve_x(H0, D1, pb.B, H0, dt, ts, cg_p, pb.dx, pb.dy,
                                           precondition=False)
            else:
                B, H0_s = sh.bed(2, H0.dtype), sh.exchange(H0, 2)
                D1 = _frozen_diffusivity(H0_s, B, pb.dx, pb.dy, pb.vfn, pb.model.target,
                                         pb.phys)
                w1 = si_math.rows_theta_x(sh, H0_s, D1, B, H0_s, dt, ts, cg_p, pb.dx, pb.dy,
                                          precondition=False)
        H_pred = st.relu_strict(w1)
        H_mid = 0.5 * (H0 + H_pred)
        dH_a, dH_mid = _generic_theta_pull(pb, lam, H0, H_mid, dt, ts, cg, x0=H_pred)
        dH_b, dH_c = _generic_theta_pull(pb, 0.5 * dH_mid, H0, H0, dt, ts, cg_p, x0=H0)
        return dH_a + 0.5 * dH_mid + dH_b + dH_c

    return fused if pb.fused and pb.exps is not None else generic


# ---------------------------------------------------------------------------
# The reverse sweeps
# ---------------------------------------------------------------------------

def _gather_time(stack, idx):
    """stack[idx[g], g] for each glacier g: (K, n_g, …) → (n_g, …)."""
    return stack[idx, torch.arange(stack.shape[1], device=stack.device)]


def _col(v, dtype):
    return v.to(dtype).reshape(-1, 1, 1)


def _interp(t, tdev, lo, hi, d_lo=None, d_hi=None):
    """Interpolation at per-glacier times t (n_g,) float64: cubic Hermite
    when the slopes d_lo, d_hi are given, else linear. ``lo``/``hi`` (and
    the slopes) are (K, n_g, …) stacks indexed by interval; the interval of
    t is searchsorted(tstops, t, right) − 1, clipped."""
    idx = torch.clamp(torch.searchsorted(tdev, t, right=True) - 1, 0, tdev.shape[0] - 2)
    ta, tb = tdev[idx], tdev[idx + 1]
    pa, pb_ = _gather_time(lo, idx), _gather_time(hi, idx)
    dtype = pa.dtype
    h = tb - ta
    if d_lo is None:
        w = torch.where(tb > ta, (t - ta) / torch.where(tb > ta, h, torch.ones_like(h)),
                        torch.zeros_like(h))
        return _col(1.0 - w, dtype) * pa + _col(w, dtype) * pb_
    s = torch.where(h > 0, (t - ta) / torch.where(h > 0, h, torch.ones_like(h)),
                    torch.zeros_like(h))
    h00 = (1.0 + 2.0 * s) * (1.0 - s) ** 2
    h10 = s * (1.0 - s) ** 2
    h01 = s ** 2 * (3.0 - 2.0 * s)
    h11 = s ** 2 * (s - 1.0)
    return (_col(h00, dtype) * pa + _col(h10 * h, dtype) * _gather_time(d_lo, idx)
            + _col(h01, dtype) * pb_ + _col(h11 * h, dtype) * _gather_time(d_hi, idx))


def check_adjoint_supported(model) -> None:
    """Raise for what the manual adjoints cannot differentiate: periodic
    laws, whose refresh from the evolving state the sweeps do not follow.
    Only the manual adjoints ask: autograd, forward mode (``grad="forward"``)
    and the dummy gradient (``grad="dummy"``, :class:`DummyAdjoint`) take
    every model the JAX package's take, periodic laws included."""
    if model.iceflow.periodic_laws:
        raise NotImplementedError(
            "the manual adjoints (grad='discrete'/'continuous', DiscreteAdjoint, "
            "ContinuousAdjoint) do not support periodic laws (callback_freq > 0): "
            "they evaluate the laws once, at the first tstop, so their gradient is "
            "not that of a forward solve that refreshes the laws from the evolving "
            "state; train periodic-law models with grad='jax'")


def glacier_adjoint_value_and_grad(theta, glacier, model, params, tstops, adjoint,
                                   quad_nodes=None, record: Optional[dict] = None):
    """(per-glacier losses (n_g,), θ cotangent of their sum) of a stacked
    batch by the manual adjoint ``adjoint``. For the continuous adjoint,
    ``record`` (a dict) receives ``reverse_steps`` (per interval, from the
    last, the reverse steps each glacier took) and ``host_syncs`` (the
    step loop's reads of the continue condition)."""
    check_adjoint_supported(model)
    flavor = adjoint.VJP_method
    mb_flavor = adjoint.MB_VJP
    use_mb = params.simulation.use_MB and model.mass_balance is not None
    k_mb = _mb_every(params) if use_mb else 0
    theta = vjps.tree_map(lambda x: x.detach(), theta)
    with torch.enable_grad():
        th_loss = vjps._requiring_grad(theta)
        env = _LossEnv(th_loss, glacier, model, params, tstops)
    loss_at = _per_tstop_loss_fn(env)
    loss_leaves = vjps.tree_leaves(th_loss)

    with torch.no_grad():
        traj = forward_glacier(theta, glacier, model, params, tstops)
    dtype = traj.dtype
    ts = solver_mod.host_tstops(tstops, dtype)
    npt = ts.dtype.type
    t_first = float(ts[0])
    n_save = len(ts)

    # the loss and its cotangents at every save and in θ, by one autograd pass
    method = params.solver.solver if params.solver.solver in _METHODS else "RK4"
    slide = isinstance(adjoint, DiscreteAdjoint) and method in ("SI", "SI2")
    pb = _Pullbacks(flavor, theta, glacier, model, params, t_first, traj[0], slide)
    with torch.enable_grad():
        saves = [traj[tau].detach().requires_grad_(True) for tau in range(n_save)]
        losses = torch.zeros(traj.shape[1], dtype=dtype, device=traj.device)
        if env.transient:
            for tau in range(1, n_save):
                losses = losses + loss_at(saves[tau], tau)
        # the initial-state and aggregate terms: one function of the whole
        # trajectory, its cotangent at every save, save 0 included
        if env.initial or env.aggregate:
            losses = losses + env.once_per_solve(torch.stack(saves))
        grads = ([None] * (n_save + len(loss_leaves)) if not losses.requires_grad else
                 torch.autograd.grad(torch.sum(losses), saves + loss_leaves, allow_unused=True))
    losses = losses.detach()
    dl_H = list(grads[:n_save])
    theta_grads = grads[n_save:]
    if any(g is not None for g in theta_grads):
        pb.add_tree(vjps._unflatten(theta, [torch.zeros_like(p) if g is None else g
                                            for p, g in zip(loss_leaves, theta_grads)]))

    def inject(lam, j):
        """λ at save j after the loss cotangent and the MB pullback."""
        if dl_H[j] is not None:     # None: no loss term reads this save
            lam = lam + dl_H[j]
        if use_mb and j % k_mb == 0:
            lam = lam + vjps.vjp_mb_dH(mb_flavor, lam, traj[j], glacier, model.mass_balance,
                                       float(ts[j]), params.simulation.step_MB)
        return lam

    with torch.no_grad():
        if isinstance(adjoint, DiscreteAdjoint):
            lam0 = _discrete(pb, adjoint, traj, ts, npt, params, inject)
        elif isinstance(adjoint, ContinuousAdjoint):
            lam0 = _continuous(pb, adjoint, traj, solver_mod.host_tstops(tstops, torch.float64),
                               inject, quad_nodes, record)
        else:
            raise TypeError(f"unknown adjoint {adjoint!r}")
        grads = pb.theta_cotangent()
        if model.initial_condition is not None and "IC" in theta:
            # H₀ = σ(θ_IC): λ(t₀), after save 0's own loss cotangent, times σ′
            if dl_H[0] is not None:
                lam0 = lam0 + dl_H[0]
            ids = glacier_index(glacier)
            d_ic = model.initial_condition.evaluate_dH0(theta, ids)
            if glacier.row_shard is not None:      # θ_IC is whole: this rank's rows of it
                full = torch.zeros_like(d_ic)
                full[..., glacier.row_shard.lo:glacier.row_shard.hi, :] = (
                    lam0 * glacier.row_shard.rows_of(d_ic))
                d_ic = full
            else:
                d_ic = lam0 * d_ic
            grads = dict(grads, IC=model.initial_condition.add_cotangent(
                grads["IC"], ids, d_ic.to(grads["IC"].dtype)))
        return losses, grads


def _discrete(pb, adjoint, traj, ts, npt, params, inject):
    """The reverse sweep through the forward's substeps; accumulates θ's
    cotangent on ``pb`` and returns λ(t₀)."""
    substeps = adjoint.substeps or params.solver.substeps
    method = params.solver.solver if params.solver.solver in _METHODS else "RK4"
    sp = params.solver
    rhs = pb.rhs
    slab_rows = traj.shape[-2] + (0 if pb.shard is None else sum(pb.shard.extent(sp.rkc_stages)))
    fused_rkc = (method == "RKC" and isinstance(pb.flavor, DiscreteVJP) and pb.fused
                 and pb.exps is not None
                 and rkc_kernel.rkc_fits(slab_rows, traj.shape[-1], traj.dtype))
    s_rkc = sp.rkc_stages
    if method == "RKC" and fused_rkc:
        transpose = _fused_rkc_transpose(pb, s_rkc)
        if pb.shard is None:
            rkc_step = lambda f, H, t, dt: rkc_kernel.rkc_interval(
                H, pb.B, pb.derived, dt, s_rkc, pb.phys.eta0, pb.exps)
        else:
            sh, B_s = pb.shard, pb.shard.bed(s_rkc, traj.dtype)
            rkc_step = lambda f, H, t, dt: sh.crop(rkc_kernel.rkc_interval(
                sh.exchange(H, s_rkc), B_s, pb.derived, dt, s_rkc, pb.phys.eta0, pb.exps), s_rkc)
    elif method == "RKC":
        transpose = _make_rkc_transpose(sp.rkc_stages)
        rkc_step = solver_mod.make_rkc2_step(sp.rkc_stages)
    elif method == "SI":
        transpose = _make_si_transpose(pb, sp.cg_iters)
    elif method == "SI2":
        transpose = _make_si2_transpose(pb, sp.cg_iters, sp.cg_iters_predictor)
    else:
        transpose = {"RK4": _rk4_transpose, "SSPRK3": _ssprk3_transpose,
                     "Euler": _euler_transpose}[method]

    def forward_step(H, t, dt):
        """The plain forward substep the transpose differentiates."""
        if method == "RK4":
            return solver_mod.rk4_step(rhs, H, t, dt)
        if method == "SSPRK3":
            return solver_mod.ssprk3_step(rhs, H, t, dt)
        if method == "RKC":
            return rkc_step(rhs, H, t, dt)
        if method in ("SI", "SI2"):
            step = semi_implicit_step if method == "SI" else si2_step
            kw = {} if method == "SI" else {"cg_iters_predictor": sp.cg_iters_predictor}
            return step(H, pb.glacier.B, pb.dx, pb.dy, pb.vfn, pb.model.target, pb.phys, dt,
                        sp.cg_iters, shard=pb.shard, **kw)
        return H + dt * rhs(H, t)

    lam = torch.zeros_like(traj[0])
    for j in range(len(ts) - 1, 0, -1):
        lam = inject(lam, j)
        t0j = ts[j - 1]
        dt = solver_mod.substep_dt(t0j, ts[j], substeps)
        # the states at the start of each substep, rematerialised
        H_sub = [traj[j - 1]]
        for s in range(substeps - 1):
            H_sub.append(forward_step(H_sub[-1], float(t0j + npt(s) * dt), float(dt)))
        for s in range(substeps - 1, -1, -1):
            lam = transpose(lam, H_sub[s], float(dt), float(t0j + npt(s) * dt), rhs, pb.pull)
    return lam


def _continuous(pb, adjoint, traj, ts64, inject, quad_nodes, record):
    """The reverse λ solve, one BS3(2) controller per glacier, then the
    Gauss–Legendre θ contraction; times in float64 (``ts64``). Returns
    λ(t₀). On a row shard the module doc's slabs and norm."""
    dev = traj.device
    sh = pb.shard
    n_save, n_g = traj.shape[0], traj.shape[1]
    tdev = torch.as_tensor(ts64, device=dev)
    hermite = adjoint.interpolation == "hermite"
    traj_dots = torch.stack([pb.rhs(traj[k]) for k in range(n_save)]) if hermite else None
    # the states the pullbacks read: on a row shard, each save (and slope)
    # with its ghost row, one exchange for all of them
    traj_s = traj if sh is None else sh.exchange(traj, 1)
    dots_s = traj_dots if sh is None or not hermite else sh.exchange(traj_dots, 1)

    def interp_traj(t):
        if hermite:
            return _interp(t, tdev, traj_s[:-1], traj_s[1:], dots_s[:-1], dots_s[1:])
        return _interp(t, tdev, traj_s[:-1], traj_s[1:])

    vjp_H = pb.vjp_H if sh is None else pb.rows_vjp_H
    vjp_theta = pb.vjp_theta if sh is None else pb.rows_vjp_theta

    def lam_rhs_rev(lam, tau):
        return vjp_H(lam, interp_traj(-tau))

    rtol, atol = adjoint.rtol, adjoint.atol
    dtmax = float("inf") if adjoint.dtmax is None else float(adjoint.dtmax)
    f64 = torch.float64
    lam = torch.zeros_like(traj[0])
    dt_guess = torch.full((n_g,), (ts64[1] - ts64[0]) / max(adjoint.substeps, 1), dtype=f64,
                          device=dev)
    lam_rights, lam_lefts = [None] * (n_save - 1), [None] * (n_save - 1)
    steps, syncs = [], 0
    for j in range(n_save - 1, 0, -1):
        lam = inject(lam, j)
        lam_rights[j - 1] = lam      # λ⁺(t_j): the post-injection limit inside the interval
        tau0, tau1 = -ts64[j], -ts64[j - 1]
        tau = torch.full((n_g,), tau0, dtype=f64, device=dev)
        dt = dt_guess
        k1 = lam_rhs_rev(lam, tau)
        it = torch.zeros(n_g, dtype=torch.long, device=dev)
        while True:
            active = (tau < tau1 - 1e-12) & (it < _MAX_INNER)
            syncs += 1
            if not bool(active.any()):
                break
            dt_eff = torch.minimum(torch.clamp(dt, max=dtmax), tau1 - tau)
            lam3, err, k4 = solver_mod._bs32_step(lam_rhs_rev, lam, tau, dt_eff, k1)
            scale = atol + rtol * torch.maximum(lam.abs(), lam3.abs())
            en = solver_mod.error_norm(err, scale, sh, dtype=f64)
            accept = active & (en <= 1.0)
            fac = torch.clamp(0.9 * (en + 1e-16) ** (-1.0 / 3.0), 0.2, 5.0)
            acc3 = accept.reshape(-1, 1, 1)
            lam = torch.where(acc3, lam3, lam)
            k1 = torch.where(acc3, k4, k1)
            tau = torch.where(accept, tau + dt_eff, tau)
            dt = torch.where(active, dt_eff * fac, dt)
            it = it + active.to(torch.long)
        dt_guess = dt
        steps.append(it)
        lam_lefts[j - 1] = lam       # λ at t_{j−1}, the limit inside the interval
    if record is not None:
        record["reverse_steps"] = torch.stack(steps).tolist()
        record["host_syncs"] = syncs

    if quad_nodes is None:
        quad_nodes = gauss_legendre_nodes(float(ts64[0]), float(ts64[-1]), adjoint.n_quadrature)
    tq, wq = quad_nodes
    lefts, rights = torch.stack(lam_lefts), torch.stack(lam_rights)
    if hermite:
        # λ̇ = −(∂f/∂H)ᵀλ at each interval's own one-sided limits
        d_left = torch.stack([-vjp_H(lefts[b], traj_s[b]) for b in range(n_save - 1)])
        d_right = torch.stack([-vjp_H(rights[b], traj_s[b + 1]) for b in range(n_save - 1)])
    for t_q, w_q in zip(np.asarray(tq, np.float64), np.asarray(wq, np.float64)):
        t_vec = torch.full((n_g,), float(t_q), dtype=f64, device=dev)
        lam_q = (_interp(t_vec, tdev, lefts, rights, d_left, d_right) if hermite
                 else _interp(t_vec, tdev, lefts, rights))
        vjp_theta(float(w_q) * lam_q, interp_traj(t_vec))
    return lam


def resolve_adjoint(params, tstops, flavor: str = "continuous"):
    """(adjoint, quad_nodes): ``params.UDE.grad`` when it is a
    DiscreteAdjoint or ContinuousAdjoint, else the default of ``flavor``;
    a continuous adjoint's Gauss–Legendre nodes over ``tstops`` (None for
    the discrete one)."""
    grad_cfg = params.UDE.grad
    if isinstance(grad_cfg, (DiscreteAdjoint, ContinuousAdjoint)):
        adjoint = grad_cfg
    elif flavor == "discrete":
        adjoint = DiscreteAdjoint()
    else:
        adjoint = ContinuousAdjoint()
    quad_nodes = None
    if isinstance(adjoint, ContinuousAdjoint):
        ts = np.asarray(tstops, dtype=np.float64)
        quad_nodes = gauss_legendre_nodes(float(ts[0]), float(ts[-1]), adjoint.n_quadrature)
    return adjoint, quad_nodes


def make_adjoint_value_and_grad(inversion, flavor: str = "continuous") -> Callable:
    """``vg(theta, b=None) -> (loss, θ gradient)`` over the inversion's
    stacked batch (or the batch ``b``) by a manual adjoint:
    ``params.UDE.grad`` when it is a DiscreteAdjoint or ContinuousAdjoint,
    else the default of ``flavor``. After a continuous call, ``vg.record``
    holds the reverse step counts (:func:`glacier_adjoint_value_and_grad`)."""
    params = inversion.parameters
    model = inversion.model
    check_adjoint_supported(model)
    batch = inversion.glaciers
    tstops = assemble_tstops(params, batch)
    adjoint, quad_nodes = resolve_adjoint(params, tstops, flavor)

    def vg(theta, b=None):
        record = {}
        losses, grads = glacier_adjoint_value_and_grad(
            theta, batch if b is None else b, model, params, tstops, adjoint, quad_nodes, record)
        vg.record = record
        return torch.sum(losses), grads

    vg.adjoint = adjoint
    vg.record = {}
    return vg
