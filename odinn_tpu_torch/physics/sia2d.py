"""SIA2D: the 2-D Shallow Ice Approximation right-hand side and diagnostics.

    ∂H/∂t = −∇·F,     F = −D(H̄, |∇S|) ∇S|_edges (clamped at borders)

A pure function of the state. Law values arrive through a :class:`ValuesFn`;
when they are per-glacier scalars for the A target (no inner laws, and no
gradient wanted through C or the exponents), the RHS of a (n_g, nx, ny)
batch is the fused kernel
:func:`odinn_tpu_torch.ops.cuda.sia_kernel.sia2d_rhs` (its plain PyTorch
version on a CPU tensor); every other law configuration takes the stencil
chain below on either device.

On a row-sharded batch (``shard``, a ``parallel.spatial.RowShard``) each
function takes the own rows of H: it extends them by one ghost row on each
side (``RowHalo``), runs the unchanged computation on that slab with the
bed's slab, and returns the own rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from odinn_tpu_torch.core.glacier import per_glacier_column
from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda import sia_kernel
from odinn_tpu_torch.ops.cuda.common import has_tangent
from odinn_tpu_torch.physics.targets import ATarget

__all__ = [
    "SIAValues", "ValuesFn", "default_values", "scalar_law_table", "sia2d_rhs",
    "sia2d_rhs_generic", "surface_velocity", "v_from_h",
]


@dataclass(frozen=True)
class SIAValues:
    """Evaluated law values for every SIA2D slot: Python numbers, per-glacier
    columns broadcastable against the staggered grid, or staggered
    (…, nx−1, ny−1) tensors. ``None`` slots are unused by the target."""

    A: Any = None          # creep coefficient
    C: Any = None          # sliding coefficient
    n: Any = None          # Glen exponent
    p: Any = None          # sliding thickness exponent (defaults to n)
    q: Any = None          # sliding slope exponent offset (defaults to 0)
    Y: Any = None          # hybrid diffusivity (D_hybrid target)
    U: Any = None          # diffusive velocity (D target)
    n_H: Any = None        # decoupled H exponent (hybrid)
    n_gradS: Any = None    # decoupled |∇S| exponent (hybrid)

    def replace(self, **kw) -> "SIAValues":
        return dataclasses.replace(self, **kw)


class ValuesFn:
    """The per-RHS-call law resolver ``values_fn(hbar, grad_s) -> SIAValues``.

    ``outer`` holds the values fixed for the solve; ``inner`` (optional)
    re-evaluates the state-dependent laws from (H̄, |∇S|). Without inner laws
    the values are ``constant``, which is what lets the solvers hand them to
    the fused kernels. ``cache`` keeps the kernels' per-glacier tables for
    the life of one solve. On a row shard (``shard``) a gridded value is the
    whole plane's, and a call returns the rows of the caller's slab, read
    from the row count of its H̄.
    """

    def __init__(self, outer: SIAValues,
                 inner: Optional[Callable[[SIAValues, Any, Any], SIAValues]] = None,
                 shard=None):
        self.outer = outer
        self.inner = inner
        self.shard = shard
        self.cache = {}

    @property
    def constant(self) -> Optional[SIAValues]:
        return self.outer if self.inner is None else None

    def __call__(self, hbar, grad_s) -> SIAValues:
        vals = self.outer
        if self.shard is not None:
            from odinn_tpu_torch.parallel.spatial import slab_rows

            rows = hbar.shape[-2] + 1
            vals = SIAValues(**{f.name: slab_rows(getattr(vals, f.name), self.shard, rows)
                                for f in dataclasses.fields(vals)})
        if self.inner is None:
            return vals
        return self.inner(vals, hbar, grad_s)


def default_values(glacier) -> SIAValues:
    """Slot defaults from the glacier constants (A, C, n with p = n, q = 0)."""
    n = per_glacier_column(glacier, glacier.n)
    return SIAValues(A=per_glacier_column(glacier, glacier.A),
                     C=per_glacier_column(glacier, glacier.C),
                     n=n, p=n, q=torch.zeros_like(n))


def _as_column(v, n_g: int, device) -> Optional[torch.Tensor]:
    """``v`` as a float64 (n_g,) column if it is one value per glacier."""
    if isinstance(v, (int, float)):
        return torch.full((n_g,), float(v), dtype=torch.float64, device=device)
    if not isinstance(v, torch.Tensor):
        return None
    v = v.to(device=device, dtype=torch.float64)
    if v.numel() == 1:
        return v.reshape(1).expand(n_g)
    if v.ndim >= 1 and v.shape[0] == n_g and v.numel() == n_g:
        return v.reshape(n_g)
    return None


def _carries_grad(v) -> bool:
    """Whether ``v`` is differentiated: it requires grad or carries a
    forward-mode tangent."""
    return isinstance(v, torch.Tensor) and (v.requires_grad or has_tangent(v))


def scalar_law_table(values_fn, target, dx, dy, H, slide_grad: bool = False
                     ) -> Optional[torch.Tensor]:
    """The raw (n_g, 7) float64 table (dx, dy, A, C, n, p, q) of the fused
    kernels, or None when the configuration is not theirs: the A target,
    constant values, every slot one value per glacier, an (n_g, nx, ny)
    state, and no value the kernels' backwards cannot differentiate. The
    kernels take the exponents as numbers, so an n, p or q that carries a
    gradient or a forward-mode tangent is refused; the explicit RHS and the RKC step pull back to the
    creep column only, so a C that carries one is refused unless
    ``slide_grad`` (the semi-implicit step, whose backward has the slide
    cotangent). Cached on ``values_fn`` for as long as ``dx``/``dy`` are
    the same tensors."""
    vals = getattr(values_fn, "constant", None)
    if vals is None or type(target) is not ATarget or H.ndim != 3:
        return None
    if any(_carries_grad(v) for v in (vals.n, vals.p, vals.q)) or (
            _carries_grad(vals.C) and not slide_grad):
        return None
    hit = values_fn.cache.get("table")
    if hit is not None and hit[0] is dx and hit[1] is dy and hit[2] == H.device:
        return hit[3]
    n_g = H.shape[0]
    cols = [_as_column(v, n_g, H.device)
            for v in (dx, dy, vals.A, vals.C, vals.n, vals.p, vals.q)]
    if any(c is None for c in cols):
        return None
    table = torch.stack(cols, dim=1)
    values_fn.cache["table"] = (dx, dy, H.device, table)
    return table


def _slab(fn, H, dx, dy, values_fn, target, phys, shard):
    """``fn`` on the own rows of H through the slab of halo 1 (module doc)."""
    out = fn(shard.halo_rows(H, 1), shard.bed(1), dx, dy, values_fn, target, phys)
    if isinstance(out, tuple):
        return tuple(shard.crop(o, 1) for o in out)
    return shard.crop(out, 1)


def sia2d_rhs_generic(H, B, dx, dy, values_fn, target, phys, shard=None):
    """The unfused stencil chain of :func:`sia2d_rhs` (any law configuration)."""
    if shard is not None:
        return _slab(sia2d_rhs_generic, H, dx, dy, values_fn, target, phys, shard)
    H = st.relu_strict(H)
    # solve dtype = state dtype: neither the bed nor float64 law values
    # (CuffeyPaterson's table fit) may promote a float32 solve
    S = B.to(H.dtype) + H

    gsx, gsy = st.grad_slope(S, dx, dy)           # (nx-1, ny-1) staggered
    grad_s = st.safe_norm(gsx, gsy)
    hbar = st.avg(H)

    vals = values_fn(hbar, grad_s)
    D = target.diffusivity(vals, hbar, grad_s, phys).to(H.dtype)

    dsdx_e = st.diff_x(S[..., :, 1:-1]) / dx       # (nx-1, ny-2)
    dsdy_e = st.diff_y(S[..., 1:-1, :]) / dy       # (nx-2, ny-1)
    eta0 = phys.eta0
    dsdx_e = st.clamp_borders_dx(dsdx_e, H, eta0, dx)
    dsdy_e = st.clamp_borders_dy(dsdy_e, H, eta0, dy)

    Fx = -st.avg_y(D) * dsdx_e
    Fy = -st.avg_x(D) * dsdy_e

    div = st.diff_x(Fx) / dx + st.diff_y(Fy) / dy  # (nx-2, ny-2)
    return st.pad_inner(-div)


def sia2d_rhs(H, B, dx, dy, values_fn, target, phys, shard=None):
    """dH/dt of the SIA2D equation for a glacier or a (n_g, nx, ny) batch.

    Steps: clamp H ≥ 0 and S = B + H; staggered gradients, |∇S| and H̄; law
    values; D from the target; η₀-clamped edge gradients; fluxes and the
    negated interior divergence, with a zero ring. ``shard``: the module
    doc's row shard.
    """
    if shard is not None:
        return _slab(sia2d_rhs, H, dx, dy, values_fn, target, phys, shard)
    table = scalar_law_table(values_fn, target, dx, dy, H)
    if table is not None:
        return sia_kernel.sia2d_rhs(H, B.to(H.dtype), table, phys.rho, phys.g,
                                    phys.eta0)
    return sia2d_rhs_generic(H, B, dx, dy, values_fn, target, phys)


def surface_velocity(H, B, dx, dy, values_fn, target, phys, shard=None):
    """Staggered surface velocity (Vx, Vy, |V|) on the (nx−1, ny−1) grid:
    V = −Velocityꜛ(H̄, |∇S|)·∇S. On a row shard: the staggered rows between
    an own row and the next, one fewer on the last row block."""
    if shard is not None:
        out = surface_velocity(shard.halo_rows(H, 1), shard.bed(1), dx, dy, values_fn, target,
                               phys)
        t, _ = shard.extent(1)
        n = min(shard.hi, shard.nx - 1) - shard.lo
        return tuple(o[..., t:t + n, :] for o in out)
    H = st.relu_strict(H)
    S = B.to(H.dtype) + H
    gsx, gsy = st.grad_slope(S, dx, dy)
    grad_s = st.safe_norm(gsx, gsy)
    hbar = st.avg(H)
    vals = values_fn(hbar, grad_s)
    v_up = target.velocity_up(vals, hbar, grad_s, phys).to(H.dtype)
    vx = -v_up * gsx
    vy = -v_up * gsy
    return vx, vy, st.safe_norm(vx, vy)


def _to_centers(a):
    """Average an edge-replicated staggered field back to cell centers."""
    a = torch.cat([a[..., :1, :], a, a[..., -1:, :]], dim=-2)
    a = torch.cat([a[..., :, :1], a, a[..., :, -1:]], dim=-1)
    return st.avg(a)


def v_from_h(H, B, dx, dy, values_fn, target, phys, shard=None):
    """Cell-centered (nx, ny) surface velocity (Vx, Vy, |V|)."""
    if shard is not None:
        return _slab(v_from_h, H, dx, dy, values_fn, target, phys, shard)
    vx_s, vy_s, _ = surface_velocity(H, B, dx, dy, values_fn, target, phys)
    vx, vy = _to_centers(vx_s), _to_centers(vy_s)
    return vx, vy, st.safe_norm(vx, vy)
