"""Fused SIA2D right-hand side (A target, per-glacier scalar laws) and its
pullback.

``sia2d_rhs`` launches the hand-written CUDA kernel ``csrc/sia2d_rhs.cu`` on
a CUDA tensor and runs its plain PyTorch version,
:func:`sia2d_rhs_reference`, on a CPU tensor. The kernel replaces the TPU
kernel ``odinn_tpu.ops.pallas.sia_kernel.sia2d_rhs_pallas``: a block loads
its tile of (relu(H), B + relu(H)) with a one-cell ring into shared memory,
forms each staggered diffusivity of the tile once, then each cell its
η₀-clamped edge fluxes and the negated divergence; dH/dt has a zero ring.
Each glacier takes the fixed-exponent path when its set is (5, 2, 4, 2).

``sia2d_rhs`` is differentiable with the contract of the TPU kernel's
``_bwd``: cotangents for H and for the A column of the raw table; B and the
other columns get none (zero). Its backward is :func:`sia2d_rhs_vjp`, which
launches ``csrc/sia2d_rhs_vjp.cu`` on a CUDA tensor (plain version
:func:`sia2d_rhs_vjp_reference`) and returns the cotangents of H and of the
derived table's creep column, d(creep) included, in one launch; the creep
cotangent is taken back to A through :func:`derive_table` by autograd on the
host-side table math. The same kernel, in its stage mode, is one stage of the
RKC2 step's backward (``rkc_kernel.stage_pullback``).

Its tangent (forward mode through ``torch.autograd.forward_ad``, the
contract of the same two inputs) is :func:`sia2d_rhs_jvp`: ḟ = ∂f/∂H·Ḣ +
∂f/∂creep·ċreep with ċreep from the A column's tangent, one launch of the
hand-written kernel ``csrc/sia2d_rhs_jvp.cu`` on a CUDA tensor (plain version
:func:`sia2d_rhs_jvp_reference`). The TPU kernel has no tangent: JAX takes
this one by ``jax.jvp`` of ``odinn_tpu.physics.sia2d.sia2d_rhs``. A tangent
on B or on another column of the table raises. In its stage mode the same
kernel is one stage of the RKC2 step's tangent
(``rkc_kernel.interval_tangent``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda.build import load_library
from odinn_tpu_torch.ops.cuda.common import (
    check_inputs, derived_scalars, diffusivity_tangent, has_tangent, needs_function, pow_pos,
    refuse_tangent, storage_key, ticket_buffers)

__all__ = ["sia2d_rhs", "sia2d_rhs_reference", "sia2d_rhs_vjp", "sia2d_rhs_vjp_reference",
           "sia2d_rhs_jvp", "sia2d_rhs_jvp_reference", "derive_table", "creep_tangent",
           "JvpLayout", "jvp_layout"]

# the raw table's columns the RHS does not differentiate: all but A
_FIXED_RAW_COLS = (0, 1, 3, 4, 5, 6)


def derive_table(scalars, rho, g):
    """The raw (n_g, 7) table (dx, dy, A, C, n, p, q) → the kernel's derived
    (n_g, 8) table, in the raw table's dtype."""
    return derived_scalars(*(scalars[:, i] for i in range(7)), rho, g)


def creep_tangent(scalars, d_A, rho, g):
    """The derived creep column's tangent (n_g,) from the A column's: creep
    = A·2(ρg)ⁿ/(n+2) is linear in A, formed in the order of
    :func:`~odinn_tpu_torch.ops.cuda.common.derived_scalars`."""
    n = scalars[:, 4].detach()
    return d_A * 2.0 * (rho * g) ** n / (n + 2.0)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library, its entry points' signatures declared once."""
    lib = load_library("sia2d_rhs")
    for fn in (lib.sia2d_rhs_f32, lib.sia2d_rhs_f64):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_double,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _vjp_library() -> ctypes.CDLL:
    lib = load_library("sia2d_rhs_vjp")
    for fn in (lib.sia2d_rhs_vjp_f32, lib.sia2d_rhs_vjp_f64):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_double,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.sia2d_rhs_vjp_stage_f32, lib.sia2d_rhs_vjp_stage_f64):
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_double] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.sia2d_rhs_vjp_partials.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sia2d_rhs_vjp_partials.restype = ctypes.c_int
    return lib


# sia2d_rhs_jvp_f32/_f64 of csrc/sia2d_rhs_jvp.cu: the ten planes and
# tables (dH, H, B, table, dcreep, dH0, dY2, df0, f, y), n_g, nx, ny, the
# plan's rows a thread and vector flag, eta0, the five stage weights, the
# stage flag and the stream
JVP_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_double] * 6
                + [ctypes.c_int, ctypes.c_void_p])

# the tangent kernel's block (kLanes, kGroups in csrc/sia2d_rhs_jvp.cu): a
# warp of 32 cells along y, 4 warps each R rows down the tile
JVP_LANES = 32
JVP_GROUPS = 4
JVP_THREADS = JVP_LANES * JVP_GROUPS
JVP_ROWS = (4, 2, 1)           # the instantiated rows a thread, largest first
# the blocks below which the plan takes fewer rows a thread: two on each of
# the H100's 132 SMs
JVP_MIN_BLOCKS = 2 * 132
_GRID_LIMIT = 65535            # gridDim.y and gridDim.z


class JvpLayout(NamedTuple):
    """How the tangent kernel tiles a launch (:func:`jvp_layout`)."""

    rows: int                      # cells a thread owns down its column (R)
    tile_rows: int                 # rows of a tile: JVP_GROUPS × rows
    width: int                     # values a load of dH, H and B along y: 16 bytes, or 1
    grid: Tuple[int, int, int]     # (tiles along y, tiles along x, glaciers)


def jvp_layout(n_g, nx, ny, dtype, vec=True, rows=None) -> JvpLayout:
    """The tangent kernel's plan for n_g glaciers of nx × ny: tiles of 32
    cells along y by 4·R rows, one block of JVP_THREADS threads a tile, R
    (``rows``, else picked here) the largest of 4, 2, 1 whose launch still
    has JVP_MIN_BLOCKS blocks, else 1: more rows a thread share more edges
    and corners, fewer blocks launch sooner, and a small plane spreads over
    the most SMs. Loads of 16 bytes where ``vec`` (the caller's dH, H and
    B 16-byte aligned) and ny a multiple of the vector allow it, else of
    one value. What the kernel does not take raises ValueError."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sia2d_rhs_jvp: float32 or float64, got {dtype}")
    if n_g < 1 or nx < 3 or ny < 3:
        raise ValueError(f"sia2d_rhs_jvp: at least 1 glacier of 3 x 3 cells, got "
                         f"{n_g} x {nx} x {ny}")
    if rows is not None and rows not in JVP_ROWS:
        raise ValueError(f"sia2d_rhs_jvp: rows a thread {rows} not among {JVP_ROWS}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    v = 16 // itemsize
    tiles_y = -(-ny // JVP_LANES)

    def blocks(r):
        return n_g * -(-nx // (JVP_GROUPS * r)) * tiles_y

    if rows is None:
        rows = next((r for r in JVP_ROWS if blocks(r) >= JVP_MIN_BLOCKS), 1)
    tile_rows = JVP_GROUPS * rows
    grid = (tiles_y, -(-nx // tile_rows), n_g)
    if grid[1] > _GRID_LIMIT or n_g > _GRID_LIMIT:
        raise ValueError(f"sia2d_rhs_jvp: {n_g} glaciers of {nx} rows exceed the launch's "
                         f"grid ({grid}, at most {_GRID_LIMIT} along x and glaciers)")
    return JvpLayout(rows, tile_rows, v if vec and ny % v == 0 else 1, grid)


@functools.cache
def _jvp_library() -> ctypes.CDLL:
    lib = load_library("sia2d_rhs_jvp")
    for fn in (lib.sia2d_rhs_jvp_f32, lib.sia2d_rhs_jvp_f64):
        fn.argtypes = JVP_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


# the pullback's partials of d(creep) and its ticket counters
_vjp_buffers = {}


def _vjp_scratch(device, dtype, n_g, nx, ny):
    """(partials, counters) for a launch over n_g glaciers of (nx, ny)."""
    need = n_g * _vjp_library().sia2d_rhs_vjp_partials(nx, ny)
    return ticket_buffers(_vjp_buffers, device, dtype, need, n_g)


# The last raw table the wrapper derived, with its derived table: a solve
# hands the same raw table to every RHS call (forward, backward and
# tangent; inside an autograd Function as another view of it). It is reused
# while that memory holds the same values (common.storage_key, through a
# detached alias held here, which keeps no autograd graph) and rho, g and
# the dtype are the same.
_last_derived = [None]


def _kernel_table(scalars, rho, g, dtype):
    """The derived (n_g, 8) table of the raw table ``scalars`` in ``dtype``,
    contiguous, without autograd."""
    raw = scalars.detach()
    key = (storage_key(raw), float(rho), float(g), dtype)
    hit = _last_derived[0]
    if hit is not None and hit[1] == key:
        return hit[2]
    derived = derive_table(raw, rho, g).to(dtype).contiguous()
    _last_derived[0] = (raw, key, derived)
    return derived


def _rhs_math(H, B, row, exps, eta0):
    """The fused stencil chain on (…, nx, ny) planes; ``row`` holds the
    derived per-glacier columns, ``exps`` the four exponents as numbers."""
    dx, dy, creep, slide = row
    e_hc, e_sc, e_hs, e_ss = exps
    H = st.relu_strict(H)
    S = B + H
    gsx, gsy = st.grad_slope(S, dx, dy)
    grad_s = st.safe_norm(gsx, gsy)
    hbar = st.avg(H)
    D = slide * pow_pos(hbar, e_hs) * pow_pos(grad_s, e_ss) + creep * pow_pos(
        hbar, e_hc) * pow_pos(grad_s, e_sc)
    dsdx_e = st.clamp_borders_dx(st.diff_x(S[..., :, 1:-1]) / dx, H, eta0, dx)
    dsdy_e = st.clamp_borders_dy(st.diff_y(S[..., 1:-1, :]) / dy, H, eta0, dy)
    Fx = -st.avg_y(D) * dsdx_e
    Fy = -st.avg_x(D) * dsdy_e
    div = st.diff_x(Fx) / dx + st.diff_y(Fy) / dy
    return st.pad_inner(-div)


def _rhs_derived(H, B, derived, eta0):
    """:func:`_rhs_math` over a batch with the derived (n_g, 8) table in H's
    dtype. Glaciers that share an exponent set run together; exponents are
    read on the host."""
    groups = {}
    for k, exps in enumerate(derived[:, 4:8].tolist()):
        groups.setdefault(tuple(exps), []).append(k)
    if len(groups) == 1:
        cols = tuple(derived[:, k].reshape(-1, 1, 1) for k in range(4))
        return _rhs_math(H, B, cols, next(iter(groups)), eta0)
    out = torch.empty_like(H)
    for exps, idx in groups.items():
        sel = torch.tensor(idx, device=H.device)
        cols = tuple(derived[sel, k].reshape(-1, 1, 1) for k in range(4))
        out[sel] = _rhs_math(H[sel], B[sel], cols, exps, eta0)
    return out


def _rhs_tangent_math(H, dH, B, row, d_creep, exps, eta0):
    """The tangent of :func:`_rhs_math` in H (``dH``) and the creep column
    (``d_creep``, (…, 1, 1) or None), by the chain rule written out: the
    clamp passes the slope's tangent inside [lo, up] and the bounding
    thickness's outside it, as the where-based forward routes it."""
    dx, dy, creep, slide = row
    pos = H > 0.0
    h = torch.where(pos, H, torch.zeros_like(H))
    dh = torch.where(pos, dH, torch.zeros_like(dH))
    S = B + h
    D, dD = diffusivity_tangent(h, dh, S, dh, dx, dy, creep, d_creep, slide, None, exps)

    def clamped(raw, draw, up, dup, lo, dlo):
        return (st._clamp(raw, up, lo),
                torch.where(raw > up, dup, torch.where(raw < lo, dlo, draw)))

    ex, dex = clamped(st.diff_x(S[..., :, 1:-1]) / dx, st.diff_x(dh[..., :, 1:-1]) / dx,
                      eta0 * h[..., 1:, 1:-1] / dx, eta0 * dh[..., 1:, 1:-1] / dx,
                      -eta0 * h[..., :-1, 1:-1] / dx, -eta0 * dh[..., :-1, 1:-1] / dx)
    ey, dey = clamped(st.diff_y(S[..., 1:-1, :]) / dy, st.diff_y(dh[..., 1:-1, :]) / dy,
                      eta0 * h[..., 1:-1, 1:] / dy, eta0 * dh[..., 1:-1, 1:] / dy,
                      -eta0 * h[..., 1:-1, :-1] / dy, -eta0 * dh[..., 1:-1, :-1] / dy)
    dFx = -st.avg_y(dD) * ex - st.avg_y(D) * dex
    dFy = -st.avg_x(dD) * ey - st.avg_x(D) * dey
    return st.pad_inner(-(st.diff_x(dFx) / dx + st.diff_y(dFy) / dy))


def _rhs_tangent_derived(H, dH, B, derived, d_creep, eta0):
    """:func:`_rhs_tangent_math` over a batch with the derived (n_g, 8)
    table in H's dtype, glaciers grouped by exponent set as in
    :func:`_rhs_derived`; ``d_creep`` (n_g,) or None."""
    dc = None if d_creep is None else d_creep.to(H.dtype).reshape(-1, 1, 1)
    groups = {}
    for k, exps in enumerate(derived[:, 4:8].tolist()):
        groups.setdefault(tuple(exps), []).append(k)
    if len(groups) == 1:
        cols = tuple(derived[:, k].reshape(-1, 1, 1) for k in range(4))
        return _rhs_tangent_math(H, dH, B, cols, dc, next(iter(groups)), eta0)
    out = torch.empty_like(H)
    for exps, idx in groups.items():
        sel = torch.tensor(idx, device=H.device)
        cols = tuple(derived[sel, k].reshape(-1, 1, 1) for k in range(4))
        out[sel] = _rhs_tangent_math(H[sel], dH[sel], B[sel], cols,
                                     None if dc is None else dc[sel], exps, eta0)
    return out


def sia2d_rhs_reference(H, B, scalars, rho, g, eta0):
    """Plain PyTorch version of the kernel: H, B of shape (n_g, nx, ny),
    ``scalars`` the raw (n_g, 7) table (dx, dy, A, C, n, p, q)."""
    return _rhs_derived(H, B, derive_table(scalars, rho, g).to(H.dtype), eta0)


def _launch_rhs(H, B, scalars, rho, g, eta0):
    """The RHS on H's device without autograd: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if H.device.type == "cpu":
        return sia2d_rhs_reference(H, B, scalars, rho, g, eta0)
    if H.device.type != "cuda":
        raise ValueError(f"sia2d_rhs: no kernel for device {H.device}")
    if has_tangent(H, B, scalars):
        raise NotImplementedError("sia2d_rhs: a forward-mode tangent reached the kernel "
                                  "launch; call sia2d_rhs")
    derived = _kernel_table(scalars, rho, g, H.dtype)
    out = torch.empty_like(H)
    n_g, nx, ny = H.shape
    lib = _library()
    fn = lib.sia2d_rhs_f32 if H.dtype == torch.float32 else lib.sia2d_rhs_f64
    err = fn(H.data_ptr(), B.data_ptr(), derived.data_ptr(), out.data_ptr(),
             n_g, nx, ny, float(eta0), torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sia2d_rhs: kernel launch failed with CUDA error {err}")
    sia2d_rhs.launches += 1
    return out


def sia2d_rhs_vjp_reference(lam, H, B, derived, eta0):
    """Plain PyTorch version of the pullback kernel: autograd through the
    forward's plain version. ``derived`` is the (n_g, 8) table; returns
    (dH, d_creep) in H's dtype, d_creep of shape (n_g,)."""
    with torch.enable_grad():
        h = H.detach().requires_grad_(True)
        table = derived.detach().to(H.dtype)
        creep = table[:, 2].clone().requires_grad_(True)
        table = torch.cat([table[:, :2], creep[:, None], table[:, 3:]], dim=1)
        out = _rhs_derived(h, B.detach(), table, eta0)
        dH, dcreep = torch.autograd.grad(out, (h, creep), lam)
    return dH, dcreep


def sia2d_rhs_vjp(lam, H, B, derived, eta0):
    """(dH, d_creep) = the pullback of dH/dt = f(H) at H of the cotangent
    ``lam``: lam, H, B of shape (n_g, nx, ny), ``derived`` the (n_g, 8)
    table (cast to H's dtype). The ring of ``lam`` is ignored (dH/dt is 0
    there). A CUDA tensor launches the kernel, in which each glacier takes
    the fixed-exponent path when its set is (5, 2, 4, 2); a CPU tensor
    takes :func:`sia2d_rhs_vjp_reference`."""
    check_inputs("sia2d_rhs_vjp", (lam, H, B), derived, 8)
    if H.device.type == "cpu":
        return sia2d_rhs_vjp_reference(lam, H, B, derived, eta0)
    if H.device.type != "cuda":
        raise ValueError(f"sia2d_rhs_vjp: no kernel for device {H.device}")
    if has_tangent(lam, H, B, derived):
        raise NotImplementedError("sia2d_rhs_vjp: the pullback takes no forward-mode tangent")
    table = derived.detach().to(H.dtype).contiguous()
    n_g, nx, ny = H.shape
    lib = _vjp_library()
    dH = torch.empty_like(H)
    partial, counter = _vjp_scratch(H.device, H.dtype, n_g, nx, ny)
    dcreep = torch.empty((n_g,), dtype=H.dtype, device=H.device)
    fn = lib.sia2d_rhs_vjp_f32 if H.dtype == torch.float32 else lib.sia2d_rhs_vjp_f64
    err = fn(lam.data_ptr(), H.data_ptr(), B.data_ptr(), table.data_ptr(), dH.data_ptr(),
             partial.data_ptr(), counter.data_ptr(), dcreep.data_ptr(), n_g, nx, ny,
             float(eta0), torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sia2d_rhs_vjp: kernel launch failed with CUDA error {err}")
    sia2d_rhs_vjp.launches += 1
    return dH, dcreep


def sia2d_rhs_jvp_reference(dH, H, B, derived, d_creep, eta0, stage=None, keep_f=True):
    """Plain version of the tangent kernel: ḟ = ∂f/∂H·``dH`` +
    ∂f/∂creep·``d_creep`` at H (``d_creep`` (n_g,) or None; ``derived`` the
    (n_g, 8) table, cast to H's dtype). With ``stage`` = (dH0, dY2, df0,
    weights), weights = (1 − μⱼ − νⱼ, μⱼ, νⱼ, μ̃ⱼ·dt, γ̃ⱼ·dt), it is stage j
    of the RKC2 step's tangent at Y = H with ẏ_{j−1} = dH: returns
    (ẏ_j, ḟ or None without ``keep_f``) with ẏ_j = a·dH0 + μ·dH + ν·dY2 +
    μ̃dt·ḟ + γ̃dt·df0, the combination of the forward's stage
    (``rkc_kernel._interval_math``)."""
    table = derived.detach().to(H.dtype)
    f = _rhs_tangent_derived(H, dH, B, table, d_creep, eta0)
    if stage is None:
        return f
    dH0, dY2, df0, (a, mu, nu, mutdt, gamdt) = stage
    return a * dH0 + mu * dH + nu * dY2 + mutdt * f + gamdt * df0, (f if keep_f else None)


def sia2d_rhs_jvp(dH, H, B, derived, d_creep, eta0, stage=None, keep_f=True):
    """ḟ, the tangent of dH/dt = f(H) in H and the creep column
    (:func:`sia2d_rhs_jvp_reference`'s contract, both modes; in the stage
    mode (ẏ_j, ḟ or None)). dH, H, B of shape (n_g, nx, ny), ``derived`` the
    (n_g, 8) table, ``d_creep`` (n_g,) or None. A CUDA tensor launches the
    kernel ``csrc/sia2d_rhs_jvp.cu`` on :func:`jvp_layout`'s plan for the
    shape and the planes' alignment, one launch counted on
    ``sia2d_rhs_jvp.launches``, in which each glacier takes the
    fixed-exponent path when its set is (5, 2, 4, 2); a CPU tensor takes the
    plain version."""
    planes = (dH, H, B) if stage is None else (dH, H, B) + tuple(stage[:3])
    check_inputs("sia2d_rhs_jvp", planes, derived, 8)
    if H.device.type == "cpu":
        return sia2d_rhs_jvp_reference(dH, H, B, derived, d_creep, eta0, stage, keep_f)
    if H.device.type != "cuda":
        raise ValueError(f"sia2d_rhs_jvp: no kernel for device {H.device}")
    if has_tangent(*planes, derived, d_creep):
        raise NotImplementedError("sia2d_rhs_jvp: the tangent kernel takes no forward-mode "
                                  "tangent of its own")
    layout = jvp_layout(*H.shape, H.dtype, vec=all(t.data_ptr() % 16 == 0 for t in (dH, H, B)))
    return _jvp_launch(dH, H, B, derived, d_creep, eta0, stage, keep_f, layout=layout)


def _jvp_launch(dH, H, B, derived, d_creep, eta0, stage=None, keep_f=True, *, layout):
    """The tangent kernel's launch on CUDA inputs that :func:`sia2d_rhs_jvp`
    takes, on the plan ``layout`` (any of :func:`jvp_layout`'s: the card's
    checks hold each to the plain version); one launch counted on
    ``sia2d_rhs_jvp.launches``."""
    table = derived.detach().to(H.dtype).contiguous()
    n_g, nx, ny = H.shape
    dc = None if d_creep is None else d_creep.detach().to(H.dtype).contiguous()
    f = torch.empty_like(H) if stage is None or keep_f else None
    lib = _jvp_library()
    fn = lib.sia2d_rhs_jvp_f32 if H.dtype == torch.float32 else lib.sia2d_rhs_jvp_f64
    if stage is None:
        y, ptrs, weights = None, (None, None, None), (0.0,) * 5
    else:
        dH0, dY2, df0, weights = stage
        y = torch.empty_like(H)
        ptrs = (dH0.data_ptr(), dY2.data_ptr(), df0.data_ptr())
    err = fn(dH.data_ptr(), H.data_ptr(), B.data_ptr(), table.data_ptr(),
             None if dc is None else dc.data_ptr(), *ptrs, None if f is None else f.data_ptr(),
             None if y is None else y.data_ptr(), n_g, nx, ny, layout.rows,
             int(layout.width > 1), float(eta0), *(float(w) for w in weights),
             int(stage is not None), torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sia2d_rhs_jvp: kernel launch failed with CUDA error {err}")
    sia2d_rhs_jvp.launches += 1
    return f if stage is None else (y, f)


def a_cotangent(scalars, dcreep, rho, g):
    """The cotangent of the raw (n_g, 7) table whose only nonzero column is
    A, from the cotangent of the derived table's creep column, by autograd
    through :func:`derive_table`."""
    with torch.enable_grad():
        raw = scalars.detach().requires_grad_(True)
        creep = derive_table(raw, rho, g)[:, 2]
        (d_raw,) = torch.autograd.grad(creep, raw, dcreep.to(creep.dtype))
    d_scal = torch.zeros_like(scalars)
    d_scal[:, 2] = d_raw[:, 2]
    return d_scal


class _RHS(torch.autograd.Function):
    """The RHS with the TPU kernel's differentiation contract, backward and
    tangent (module doc)."""

    @staticmethod
    def forward(ctx, H, B, scalars, rho, g, eta0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(H, B, scalars)
        # the jvp cannot read saved_tensors
        ctx.primals = (H, B, scalars)
        ctx.consts = (rho, g, eta0)
        return _launch_rhs(H, B, scalars, rho, g, eta0)

    @staticmethod
    def jvp(ctx, dH, dB, dscalars, *_):
        H, B, scalars = ctx.primals
        rho, g, eta0 = ctx.consts
        refuse_tangent("sia2d_rhs", "the bed B", dB)
        d_creep = None
        if dscalars is not None:
            refuse_tangent("sia2d_rhs", "a column of the table other than A", dscalars,
                           _FIXED_RAW_COLS)
            d_creep = creep_tangent(scalars, dscalars[:, 2], rho, g)
        dH = torch.zeros_like(H) if dH is None else dH.contiguous()
        return sia2d_rhs_jvp(dH, H, B, _kernel_table(scalars, rho, g, H.dtype), d_creep, eta0)

    @staticmethod
    def backward(ctx, lam):
        if lam is None:        # grads are not materialised (for the jvp's Nones)
            return (None,) * 6
        H, B, scalars = ctx.saved_tensors
        rho, g, eta0 = ctx.consts
        derived = _kernel_table(scalars, rho, g, H.dtype)
        dH, dcreep = sia2d_rhs_vjp(lam.contiguous(), H, B, derived, eta0)
        d_scal = a_cotangent(scalars, dcreep, rho, g) if ctx.needs_input_grad[2] else None
        return (dH if ctx.needs_input_grad[0] else None), None, d_scal, None, None, None


def sia2d_rhs(H, B, scalars, rho, g, eta0):
    """dH/dt for a batch: H, B of shape (n_g, nx, ny); ``scalars`` the raw
    (n_g, 7) table (dx, dy, A, C, n, p, q), derived here (in its own dtype,
    then cast to H's) into the kernel's 8-column table. A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`sia2d_rhs_reference`.
    Differentiable in H and in the A column, in reverse and in forward mode
    (module doc)."""
    check_inputs("sia2d_rhs", (H, B), scalars, 7)
    if needs_function(H, scalars) or has_tangent(B):
        return _RHS.apply(H, B, scalars, rho, g, eta0)
    return _launch_rhs(H, B, scalars, rho, g, eta0)


sia2d_rhs.launches = 0
sia2d_rhs_vjp.launches = 0
sia2d_rhs_jvp.launches = 0
