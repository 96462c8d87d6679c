"""The semi-implicit θ-step's linear algebra on ``[..., x, y]`` planes, and
its implicit-function adjoint.

Shared by the unfused solve (:mod:`odinn_tpu_torch.simulation.implicit`)
and the fused kernel's plain versions
(:mod:`odinn_tpu_torch.ops.cuda.si_kernel`), which differ only in how they
form the frozen staggered diffusivity D.

The step solves A·x = b with A = I − θ·dt·M·L_D·M and
b = H + dt·M·L_D(B + ring·H + (1−θ)·M·H), L_D(u) = ∇·(D∇u) on the interior
and M the interior mask, then returns relu(x). Its gradient is the one
``lax.custom_linear_solve`` gives the JAX package's ``semi_implicit_step``:
with g = ḡ·[x > 0], λ = PCG(A, g) warm-started at g (the transpose solve; A
and the Jacobi preconditioner are symmetric), and the cotangents of H, D and
B are the vector-Jacobian product at λ of the residual b − A(D)·x with x
held fixed. The guess x0 and the preconditioner get no gradient, and CG is
never unrolled.

Its tangent (forward mode, ``torch.autograd.forward_ad``) is the one
``lax.custom_linear_solve``'s jvp gives: ẋ = PCG(A, ṙ) with the forward's
``solve`` closure, ``cg_iters`` Jacobi-PCG iterations started from the
primal guess x0 (not from zero or from ṙ), where ṙ is the tangent of the
residual b(H, D, B) − A(D)·x with x fixed (:func:`residual_tangent`);
then ẋ·[x > 0]. The guess gets no tangent. At a low ``cg_iters`` this is
not the derivative of the unrolled PCG, and a solve started from H can give
a tangent far from the converged one: JAX's is the reference.

``precondition=False`` runs both solves as plain CG (no Jacobi
preconditioner): the solves of the JAX package's hand-written SI/SI2
transposes (``odinn_tpu.inverse.gradient``), which rematerialise the step
and solve the adjoint system with ``_cg`` and no preconditioner.

The row-sharded step (a ``parallel.spatial.RowShard``: a rank holds its
own grid rows) runs on a slab of the own rows plus two ghost rows on each
side: the assembly (D, b and the Jacobi diagonal, :func:`rows_assemble`)
and the residual's pullback are the unsharded ones on that slab, exact on
the own rows. The PCG is split at its two reductions (:func:`rows_cg`):
each dot product is an own-row partial summed over the row group in rank
order, so α and β are bitwise the same on every rank, and ``p`` reads one
fresh ghost row, which each rank updates as its owner does from ``z``'s
ghost row, gathered with the r·z partials. Its iterations run on
``si_rows_apply`` and ``si_rows_update``
(:mod:`odinn_tpu_torch.ops.cuda.si_kernel`: the ``csrc/si_rows.cu`` kernels
on the card, their plain versions on the CPU) over a scratch of
:data:`ROWS_PLANES` planes. :func:`rows_theta_solve` is the tensor code's
step, differentiable as :func:`theta_solve`: the transpose and tangent
solves are the same distributed PCG, the pullback runs on the slab with λ
zero on the ghost rows and x's ghost rows exchanged.
"""

from __future__ import annotations

import torch

from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda.common import needs_function

__all__ = ["div_flux", "dot", "cg", "jacobi_diag", "theta_solve_x", "relu_cotangent",
           "transpose_solve", "residual_pullback", "residual_tangent", "tangent_solve",
           "theta_solve", "ROWS_PLANES", "rows_assemble", "rows_cg", "rows_solve",
           "spacing_table", "rows_theta_x", "rows_transpose_solve", "rows_theta_solve"]

# rounds to 0 in float32: the CG guards then compare against 0
_TINY = 1e-300


def div_flux(u, D, dx, dy):
    """∇·(D∇u) on the interior (zero ring), D frozen on the staggered grid."""
    dudx_e = st.diff_x(u[..., :, 1:-1]) / dx
    dudy_e = st.diff_y(u[..., 1:-1, :]) / dy
    fx = st.avg_y(D) * dudx_e
    fy = st.avg_x(D) * dudy_e
    div = st.diff_x(fx) / dx + st.diff_y(fy) / dy
    return st.pad_inner(div)


def dot(a, b):
    """Per-glacier inner product over the grid axes."""
    return torch.sum(a * b, dim=(-2, -1), keepdim=True)


def cg(matvec, b, x0, iters: int, precond=None):
    """Fixed-iteration (Jacobi-)preconditioned conjugate gradients, one
    independent recursion per glacier of the batch."""
    if precond is None:
        precond = lambda r: r
    x = x0
    r = b - matvec(x0)
    p = precond(r)
    rz = dot(r, p)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = torch.where(denom > 0.0, rz / torch.clamp(denom, min=_TINY), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0.0, rz_new / torch.clamp(rz, min=_TINY), zero)
        p = z + beta * p
        rz = rz_new
    return x


def jacobi_diag(D, dt, dx, dy, interior):
    """diag(I − dt·M·∇·(D∇(M·))) on the interior, 1 on the ring."""
    Dx = st.avg_y(D)
    Dy = st.avg_x(D)
    sx = (Dx[..., :-1, :] + Dx[..., 1:, :]) / (dx * dx)
    sy = (Dy[..., :, :-1] + Dy[..., :, 1:]) / (dy * dy)
    return 1.0 + dt * interior * st.pad_inner(sx + sy)


def _masks(like):
    interior = torch.zeros_like(like)
    interior[..., 1:-1, 1:-1] = 1.0
    return interior, 1.0 - interior


def _operator(D, dt, theta, dx, dy, interior, precondition=True):
    """(matvec of A, the Jacobi preconditioner or None)."""

    def matvec(u):
        return u - theta * dt * interior * div_flux(interior * u, D, dx, dy)

    if not precondition:
        return matvec, None
    inv_diag = 1.0 / jacobi_diag(D, theta * dt, dx, dy, interior)
    return matvec, lambda r: r * inv_diag


def theta_solve_x(H, D, B, x0, dt, theta, cg_iters: int, dx, dy, precondition=True):
    """The pre-relu solution x: ``cg_iters`` Jacobi-PCG iterations (plain CG
    without ``precondition``) from ``x0`` on A·x = b (module doc). B is in
    H's dtype; dt and theta are Python numbers."""
    interior, ring = _masks(H)
    matvec, precond = _operator(D, dt, theta, dx, dy, interior, precondition)
    b = H + dt * interior * div_flux(B + ring * H + (1.0 - theta) * interior * H, D, dx, dy)
    return cg(matvec, b, x0, cg_iters, precond)


def relu_cotangent(gbar, x):
    """ḡ·[x > 0]: relu_strict's pullback, with the tie at x = 0 sent to 0."""
    return torch.where(x > 0.0, gbar, torch.zeros_like(gbar))


def transpose_solve(gbar, x, D, dt, theta, cg_iters: int, dx, dy, precondition=True):
    """λ = PCG(A, g) from the guess g = ḡ·[x > 0], ``cg_iters`` iterations
    with the forward's Jacobi preconditioner (plain CG without
    ``precondition``): the transpose solve of the step's adjoint (A is
    symmetric)."""
    interior, _ = _masks(x)
    matvec, precond = _operator(D, dt, theta, dx, dy, interior, precondition)
    g = relu_cotangent(gbar, x)
    return cg(matvec, g, g, cg_iters, precond)


def residual_pullback(lam, H, D, B, x, dt, theta, dx, dy):
    """(dH, dD, dB): the vector-Jacobian product at λ of the residual
    b(H, D, B) − A(D)·x with x fixed. L_D is linear in its argument, so
    this is λ (b's H term) plus one pullback of ⟨dt·M·λ, L_D(u)⟩ with
    u = B + ring·H + (1−θ)·M·H + θ·M·x."""
    dx, dy = (v.detach() if isinstance(v, torch.Tensor) else v for v in (dx, dy))
    with torch.enable_grad():
        h, d, b = (t.detach().requires_grad_(True) for t in (H, D, B))
        interior, ring = _masks(H)
        u = b + ring * h + (1.0 - theta) * interior * h + theta * interior * x.detach()
        w = dt * interior * lam.detach()
        pairing = torch.sum(w * div_flux(u, d, dx, dy))
        dh, dd, db = torch.autograd.grad(pairing, (h, d, b))
    return lam + dh, dd, db


def residual_tangent(dH, dD, dB, H, D, B, x, dt, theta, dx, dy):
    """ṙ, the tangent of the residual b(H, D, B) − A(D)·x with x fixed:
    Ḣ + dt·M·∇·(Ḋ∇(B + ring·H + (1−θ)·M·H + θ·M·x))
    + dt·M·∇·(D∇(Ḃ + ring·Ḣ + (1−θ)·M·Ḣ)). A None tangent is zero."""
    interior, ring = _masks(x)
    r = torch.zeros_like(x) if dH is None else dH
    if dD is not None:
        u = B + ring * H + (1.0 - theta) * interior * H + theta * interior * x
        r = r + dt * interior * div_flux(u, dD, dx, dy)
    if dH is not None or dB is not None:
        du = torch.zeros_like(x) if dB is None else dB
        if dH is not None:
            du = du + ring * dH + (1.0 - theta) * interior * dH
        r = r + dt * interior * div_flux(du, D, dx, dy)
    return r


def tangent_solve(rdot, x, x0, D, dt, theta, cg_iters: int, dx, dy, precondition=True):
    """ẋ·[x > 0] with ẋ = ``cg_iters`` Jacobi-PCG iterations (plain CG
    without ``precondition``) on the step's A from the primal guess x0 on
    the right-hand side ṙ: the tangent solve of ``lax.custom_linear_solve``
    (module doc), x the forward's pre-relu solution."""
    interior, _ = _masks(x)
    matvec, precond = _operator(D, dt, theta, dx, dy, interior, precondition)
    return relu_cotangent(cg(matvec, rdot, x0, cg_iters, precond), x)


class _ThetaSolve(torch.autograd.Function):
    """relu of :func:`theta_solve_x` with the implicit-function adjoint
    and tangent (module doc): the forward keeps x; the backward is one
    transpose solve and one residual pullback, the jvp one residual tangent
    and one tangent solve."""

    @staticmethod
    def forward(ctx, H, D, B, x0, dt, theta, cg_iters, dx, dy, precondition):
        ctx.set_materialize_grads(False)
        x = theta_solve_x(H, D, B, x0, dt, theta, cg_iters, dx, dy, precondition)
        ctx.save_for_backward(H, D, B, x)
        # the jvp cannot read saved_tensors
        ctx.primals = (H, D, B, x0, x)
        ctx.consts = (dt, theta, cg_iters, dx, dy, precondition)
        return st.relu_strict(x)

    @staticmethod
    def jvp(ctx, dH, dD, dB, *_):
        H, D, B, x0, x = ctx.primals
        dt, theta, cg_iters, dx, dy, precondition = ctx.consts
        rdot = residual_tangent(dH, dD, dB, H, D, B, x, dt, theta, dx, dy)
        return tangent_solve(rdot, x, x0, D, dt, theta, cg_iters, dx, dy, precondition)

    @staticmethod
    def backward(ctx, gbar):
        if gbar is None:       # grads are not materialised (for the jvp's Nones)
            return (None,) * 10
        H, D, B, x = ctx.saved_tensors
        dt, theta, cg_iters, dx, dy, precondition = ctx.consts
        dx, dy = (v.detach() if isinstance(v, torch.Tensor) else v for v in (dx, dy))
        lam = transpose_solve(gbar, x, D, dt, theta, cg_iters, dx, dy, precondition)
        dH, dD, dB = residual_pullback(lam, H, D, B, x, dt, theta, dx, dy)
        need = ctx.needs_input_grad
        return ((dH if need[0] else None), (dD if need[1] else None), (dB if need[2] else None),
                None, None, None, None, None, None, None)


def theta_solve(H, D, B, x0, dt, theta, cg_iters: int, dx, dy, precondition=True):
    """One θ-step with D frozen: relu of :func:`theta_solve_x`,
    differentiable in H, D and B by the implicit-function adjoint when one
    of them requires grad, and by its tangent when one carries a
    forward-mode tangent (module doc); x0 gets neither."""
    if needs_function(H, D, B):
        return _ThetaSolve.apply(H, D, B, x0, float(dt), float(theta), int(cg_iters), dx, dy,
                                 bool(precondition))
    return st.relu_strict(theta_solve_x(H, D, B, x0, dt, theta, cg_iters, dx, dy,
                                        precondition))


# ---------------------------------------------------------------------------
# The row-sharded step (module doc)
# ---------------------------------------------------------------------------

# planes of the scratch: the large-plane path's first seven (csrc/si_plane.cu,
# Plane: D, b, inverse diagonal, x, r, p, Ap), then z and a second p
(ROWS_D, ROWS_RHS, ROWS_INV, ROWS_X, ROWS_R, ROWS_P, ROWS_AP, ROWS_Z,
 ROWS_P2) = range(9)
ROWS_PLANES = 9
# the assembly's modes (csrc/si_plane.cu): b of the step, ḡ·[x > 0], b as given
FORWARD, TRANSPOSE, TANGENT = 0, 1, 2
# the slab's ghost rows: the ring two rows from any own equation
ROWS_HALO = 2


def spacing_table(dx, dy, like):
    """The (n_g, 4) table (dx, dy, 0, 0) the row kernels read, in ``like``'s
    dtype, from spacings that are numbers or per-glacier columns."""
    n_g = like.shape[0]

    def col(v):
        v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
        return v.reshape(-1).expand(n_g) if v.numel() in (1, n_g) else v.reshape(n_g)

    zero = torch.zeros(n_g, dtype=like.dtype, device=like.device)
    return torch.stack([col(dx), col(dy), zero, zero], dim=1).contiguous()


def rows_assemble(work, H, D, B, dt, theta, mode, precondition, dx, dy, X=None):
    """The step's assembly on a slab into ``work``: D's corners (D[i, j]
    at the plane's cell (i, j)), b (``mode`` FORWARD: the step's; TRANSPOSE:
    ḡ·[X > 0] with ḡ in H's place; TANGENT: H as given) and the inverse
    Jacobi diagonal (1 without ``precondition``)."""
    interior, ring = _masks(H)
    work[ROWS_D].zero_()
    work[ROWS_D][..., :-1, :-1] = D
    if mode == FORWARD:
        b = H + dt * interior * div_flux(B + ring * H + (1.0 - theta) * interior * H, D, dx, dy)
    elif mode == TRANSPOSE:
        b = relu_cotangent(H, X)
    else:
        b = H
    work[ROWS_RHS] = b
    if precondition:
        work[ROWS_INV] = 1.0 / jacobi_diag(D, theta * dt, dx, dy, interior)
    else:
        work[ROWS_INV].fill_(1.0)


def rows_cg(shard, work, x0, table, coef, iters: int, precondition=True):
    """``iters`` PCG iterations on the assembled slab system from the slab
    ``x0`` (module doc); returns x on the own rows. Every rank of the row
    group runs the same rounds: one gather of r·z partials and ``z``'s
    boundary rows after the start, then a gather of the p·Ap partials and
    one of the r·z partials with ``z``'s rows an iteration, less the last
    iteration's r·z, which no one reads. α and β are formed on the host in
    the state's dtype with :func:`cg`'s guards."""
    from odinn_tpu_torch.ops.cuda.si_kernel import si_rows_apply, si_rows_update

    t, _ = shard.extent(ROWS_HALO)
    r0, r1 = t, t + shard.own
    t1, b1 = shard.extent(1)
    dev, dtype = work.device, work.dtype

    def z_round(partial):
        top, bot, total = shard.ghosts(work[ROWS_Z][..., r0:r1, :], 1, partial)
        if t1:
            work[ROWS_Z][..., r0 - 1:r0, :] = top
        if b1:
            work[ROWS_Z][..., r1:r1 + 1, :] = bot
        return total

    rz = z_round(si_rows_apply(work, x0, None, ROWS_P2, ROWS_P, r0, r1, table, coef, True,
                               precondition))
    zero = torch.zeros_like(rz)
    beta = torch.zeros(rz.shape, dtype=dtype, device=dev)
    src, dst = ROWS_P2, ROWS_P
    for it in range(iters):
        denom = shard.rows_total(si_rows_apply(work, None, beta, src, dst, r0, r1, table, coef,
                                               False, precondition))
        alpha = torch.where(denom > 0.0, rz / torch.clamp(denom, min=_TINY), zero)
        partial = si_rows_update(work, alpha.to(dev), dst, r0, r1, precondition)
        if it == iters - 1:
            break
        rz_new = z_round(partial)
        beta = torch.where(rz > 0.0, rz_new / torch.clamp(rz, min=_TINY), zero).to(dev)
        rz = rz_new
        src, dst = dst, src
    return work[ROWS_X][..., r0:r1, :].clone()


def rows_solve(shard, assemble, x0, table, coef, iters: int, precondition=True):
    """A fresh scratch, ``assemble(work)`` into it, then :func:`rows_cg`."""
    work = x0.new_empty((ROWS_PLANES,) + tuple(x0.shape))
    work[ROWS_P2].zero_()
    assemble(work)
    return rows_cg(shard, work, x0.contiguous(), table, coef, iters, precondition)


def rows_theta_x(shard, H, D, B, x0, dt, theta, cg_iters: int, dx, dy, precondition=True):
    """The own rows of :func:`theta_solve_x` on the slabs H, D, B, x0."""
    return rows_solve(shard, lambda w: rows_assemble(w, H, D, B, dt, theta, FORWARD,
                                                     precondition, dx, dy),
                      x0, spacing_table(dx, dy, H), theta * dt, cg_iters, precondition)


def rows_transpose_solve(shard, gbar, x, D, B, dt, theta, cg_iters: int, dx, dy,
                         precondition=True):
    """The own rows of :func:`transpose_solve` for the own-row cotangent
    ``gbar`` and pre-relu x: g = ḡ·[x > 0] with its ghost rows is both b
    and the guess."""
    g = shard.exchange(relu_cotangent(gbar, x), ROWS_HALO)
    return rows_solve(shard, lambda w: rows_assemble(w, g, D, B, dt, theta, TANGENT,
                                                     precondition, dx, dy),
                      g, spacing_table(dx, dy, g), theta * dt, cg_iters, precondition)


class _RowsThetaSolve(torch.autograd.Function):
    """:class:`_ThetaSolve` on a row shard: slab inputs (halo 2), own-row
    output; slab cotangents and own-row tangents (module doc)."""

    @staticmethod
    def forward(ctx, H, D, B, x0, dt, theta, cg_iters, dx, dy, precondition, shard):
        ctx.set_materialize_grads(False)
        x = rows_theta_x(shard, H, D, B, x0, dt, theta, cg_iters, dx, dy, precondition)
        ctx.save_for_backward(H, D, B, x)
        ctx.primals = (H, D, B, x0, x)
        ctx.consts = (dt, theta, cg_iters, dx, dy, precondition, shard)
        return st.relu_strict(x)

    @staticmethod
    def jvp(ctx, dH, dD, dB, *_):
        H, D, B, x0, x = ctx.primals
        dt, theta, cg_iters, dx, dy, precondition, shard = ctx.consts
        rdot = residual_tangent(dH, dD, dB, H, D, B, shard.exchange(x, ROWS_HALO), dt, theta,
                                dx, dy)
        xd = rows_solve(shard, lambda w: rows_assemble(w, rdot, D, B, dt, theta, TANGENT,
                                                       precondition, dx, dy),
                        x0, spacing_table(dx, dy, x), theta * dt, cg_iters, precondition)
        return relu_cotangent(xd, x)

    @staticmethod
    def backward(ctx, gbar):
        H, D, B, x = ctx.saved_tensors
        dt, theta, cg_iters, dx, dy, precondition, shard = ctx.consts
        dx, dy = (v.detach() if isinstance(v, torch.Tensor) else v for v in (dx, dy))
        if gbar is None:       # every rank joins the exchanges
            gbar = torch.zeros_like(x)
        lam = rows_transpose_solve(shard, gbar, x, D, B, dt, theta, cg_iters, dx, dy,
                                   precondition)
        dH, dD, dB = residual_pullback(shard.pad(lam, ROWS_HALO), H, D, B,
                                       shard.exchange(x, ROWS_HALO), dt, theta, dx, dy)
        need = ctx.needs_input_grad
        return ((dH if need[0] else None), (dD if need[1] else None), (dB if need[2] else None),
                None, None, None, None, None, None, None, None)


def rows_theta_solve(shard, H, D, B, x0, dt, theta, cg_iters: int, dx, dy, precondition=True):
    """:func:`theta_solve` on a row shard: H, D (staggered), B and x0 on the
    slab of halo 2, the own rows of relu(x) out."""
    if needs_function(H, D, B):
        return _RowsThetaSolve.apply(H, D, B, x0, float(dt), float(theta), int(cg_iters), dx, dy,
                                     bool(precondition), shard)
    return st.relu_strict(rows_theta_x(shard, H, D, B, x0, dt, theta, cg_iters, dx, dy,
                                       precondition))
