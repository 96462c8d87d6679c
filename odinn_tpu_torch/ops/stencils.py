"""Staggered-grid finite-difference and averaging stencils.

Arrays are laid out ``[..., x, y]`` (x second-to-last, y last), so every op
broadcasts over leading axes: the glacier batch axis is a plain leading
dimension. The ``*_adjoint`` functions are the transposes the hand-written
adjoints (:mod:`odinn_tpu_torch.inverse.vjps`) are built from.
"""

from __future__ import annotations

import torch

__all__ = [
    "diff_x", "diff_y", "avg", "avg_x", "avg_y", "inn", "inn1", "safe_norm",
    "grad_slope", "pad_inner", "relu_strict", "clamp_borders_dx",
    "clamp_borders_dy", "diff_x_adjoint", "diff_y_adjoint", "avg_adjoint",
    "avg_x_adjoint", "avg_y_adjoint", "clamp_borders_dx_adjoint",
    "clamp_borders_dy_adjoint",
]


def diff_x(a):
    """Forward difference along x: out[i,j] = a[i+1,j] - a[i,j]; (nx,ny)→(nx-1,ny)."""
    return a[..., 1:, :] - a[..., :-1, :]


def diff_y(a):
    """Forward difference along y: out[i,j] = a[i,j+1] - a[i,j]; (nx,ny)→(nx,ny-1)."""
    return a[..., :, 1:] - a[..., :, :-1]


def avg(a):
    """4-point cell average; (nx,ny)→(nx-1,ny-1)."""
    return 0.25 * (a[..., :-1, :-1] + a[..., 1:, :-1] + a[..., :-1, 1:] + a[..., 1:, 1:])


def avg_x(a):
    """2-point average along x; (nx,ny)→(nx-1,ny)."""
    return 0.5 * (a[..., :-1, :] + a[..., 1:, :])


def avg_y(a):
    """2-point average along y; (nx,ny)→(nx,ny-1)."""
    return 0.5 * (a[..., :, :-1] + a[..., :, 1:])


def inn(a):
    """Interior of the grid: drop one ring."""
    return a[..., 1:-1, 1:-1]


def inn1(a):
    """Drop the last row and column."""
    return a[..., :-1, :-1]


def safe_norm(x, y):
    """√(x²+y²), with the value 0 (and a zero gradient) at the origin."""
    sq = x * x + y * y
    pos = sq > 0.0
    return torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * pos


def grad_slope(s, dx, dy):
    """Staggered surface-slope components (∇Sx, ∇Sy), each (nx-1, ny-1)."""
    dsdx = diff_x(s) / dx
    dsdy = diff_y(s) / dy
    return avg_y(dsdx), avg_x(dsdy)


def pad_inner(a):
    """Zero-pad a (nx-2, ny-2) interior field back to (nx, ny)."""
    return torch.nn.functional.pad(a, (1, 1, 1, 1))


def relu_strict(h):
    """max(h, 0) with the tie subgradient at h = 0 fixed to 0."""
    return torch.where(h > 0.0, h, torch.zeros_like(h))


def _clamp(ds, upper, lower):
    return torch.where(ds > upper, upper, torch.where(ds < lower, lower, ds))


def clamp_borders_dx(ds, h, eta0, dx):
    """Clamp x-edge surface gradients (nx-1, ny-2) by η₀·upstream thickness."""
    upper = eta0 * h[..., 1:, 1:-1] / dx
    lower = -eta0 * h[..., :-1, 1:-1] / dx
    return _clamp(ds, upper, lower)


def clamp_borders_dy(ds, h, eta0, dy):
    """Clamp y-edge surface gradients (nx-2, ny-1) by η₀·upstream thickness."""
    upper = eta0 * h[..., 1:-1, 1:] / dy
    lower = -eta0 * h[..., 1:-1, :-1] / dy
    return _clamp(ds, upper, lower)


# ---------------------------------------------------------------------------
# Transposes
# ---------------------------------------------------------------------------

def _pad(a, x=(0, 0), y=(0, 0)):
    """Zero-pad the x axis by ``x`` = (before, after) and the y axis by ``y``."""
    return torch.nn.functional.pad(a, (y[0], y[1], x[0], x[1]))


def diff_x_adjoint(i, dx):
    """Transpose of diff_x(·)/Δx: (nx-1,ny)→(nx,ny)."""
    return (_pad(i, x=(1, 0)) - _pad(i, x=(0, 1))) / dx


def diff_y_adjoint(i, dy):
    """Transpose of diff_y(·)/Δy: (nx,ny-1)→(nx,ny)."""
    return (_pad(i, y=(1, 0)) - _pad(i, y=(0, 1))) / dy


def avg_adjoint(i):
    """Transpose of avg: (nx-1,ny-1)→(nx,ny)."""
    return 0.25 * (_pad(i, (0, 1), (0, 1)) + _pad(i, (1, 0), (0, 1))
                   + _pad(i, (0, 1), (1, 0)) + _pad(i, (1, 0), (1, 0)))


def avg_x_adjoint(i):
    """Transpose of avg_x: (nx-1,ny)→(nx,ny)."""
    return 0.5 * (_pad(i, x=(0, 1)) + _pad(i, x=(1, 0)))


def avg_y_adjoint(i):
    """Transpose of avg_y: (nx,ny-1)→(nx,ny)."""
    return 0.5 * (_pad(i, y=(0, 1)) + _pad(i, y=(1, 0)))


def clamp_borders_dx_adjoint(dC, eta0, dx, h, ds):
    """Transpose of :func:`clamp_borders_dx` in (ds, h): returns (∂ds, ∂h).
    At an exact tie the cotangent goes to ds, as the where-based forward
    routes it."""
    up = eta0 * h[..., 1:, 1:-1] / dx
    lo = -eta0 * h[..., :-1, 1:-1] / dx
    d_ds = dC * ((ds <= up) & (ds >= lo))
    contrib_lo = -(eta0 / dx) * dC * (ds < lo)       # → h[:-1, 1:-1]
    contrib_up = (eta0 / dx) * dC * (ds > up)        # → h[1:, 1:-1]
    return d_ds, _pad(contrib_lo, (0, 1), (1, 1)) + _pad(contrib_up, (1, 0), (1, 1))


def clamp_borders_dy_adjoint(dC, eta0, dy, h, ds):
    """Transpose of :func:`clamp_borders_dy` in (ds, h): returns (∂ds, ∂h)."""
    up = eta0 * h[..., 1:-1, 1:] / dy
    lo = -eta0 * h[..., 1:-1, :-1] / dy
    d_ds = dC * ((ds <= up) & (ds >= lo))
    contrib_lo = -(eta0 / dy) * dC * (ds < lo)       # → h[1:-1, :-1]
    contrib_up = (eta0 / dy) * dC * (ds > up)        # → h[1:-1, 1:]
    return d_ds, _pad(contrib_lo, (1, 1), (0, 1)) + _pad(contrib_up, (1, 1), (1, 0))
