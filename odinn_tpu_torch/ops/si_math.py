"""The semi-implicit θ-step's linear algebra on ``[..., x, y]`` planes.

Shared by the unfused solve (:mod:`odinn_tpu_torch.simulation.implicit`)
and the fused kernel's plain version
(:func:`odinn_tpu_torch.ops.cuda.si_kernel.si_step_reference`), which differ
only in how they form the frozen staggered diffusivity D.
"""

from __future__ import annotations

import torch

from odinn_tpu_torch.ops import stencils as st

__all__ = ["div_flux", "dot", "cg", "jacobi_diag", "theta_step"]

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


def theta_step(H, D, B, x0, dt, theta, cg_iters: int, dx, dy):
    """relu of ``cg_iters`` Jacobi-PCG iterations from ``x0`` on
    A = I − θ·dt·M·∇·(D∇(M·)), b = H + dt·M·∇·(D∇(B + ring·H + (1−θ)·M·H)),
    with M the interior mask and D the frozen staggered diffusivity. B is in
    H's dtype; dt and theta are Python numbers."""
    interior = torch.zeros_like(H)
    interior[..., 1:-1, 1:-1] = 1.0
    ring = 1.0 - interior

    def matvec(u):
        return u - theta * dt * interior * div_flux(interior * u, D, dx, dy)

    b = H + dt * interior * div_flux(B + ring * H + (1.0 - theta) * interior * H, D, dx, dy)
    inv_diag = 1.0 / jacobi_diag(D, theta * dt, dx, dy, interior)
    x = cg(matvec, b, x0, cg_iters, lambda r: r * inv_diag)
    return st.relu_strict(x)
