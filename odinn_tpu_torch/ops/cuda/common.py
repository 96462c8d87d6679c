"""What the fused kernels share: the per-glacier derived table, powers with
the kernels' semantics and their derivatives, the wrappers' input checks
and forward-mode tangent checks, and the cluster kernels' block shape and
cluster choice.

Forward mode runs through ``torch.autograd.forward_ad``: a wrapper hands any
input that carries a tangent (at the current dual level) to its
``autograd.Function``, whose ``jvp`` is the kernel's tangent rule. A tangent
on an input that the kernel's contract does not differentiate raises
(:func:`refuse_tangent`); none is ever dropped."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from odinn_tpu_torch.ops import stencils as st

__all__ = ["derived_scalars", "pow_pos", "dpow_pos", "shared_exps", "check_inputs", "GLEN_EXPS",
           "uses_glen", "block_shape", "pick_cluster", "ticket_buffers", "SMEM_PER_BLOCK",
           "tangent_of", "has_tangent", "refuse_tangent", "needs_function",
           "diffusivity_tangent", "storage_key"]


def tangent_of(t) -> Optional[torch.Tensor]:
    """The forward-mode tangent of ``t`` at the current dual level, or None."""
    if not isinstance(t, torch.Tensor):
        return None
    return fwAD.unpack_dual(t).tangent


def has_tangent(*tensors) -> bool:
    return any(tangent_of(t) is not None for t in tensors)


def needs_function(*tensors) -> bool:
    """Whether a call must go through its autograd Function: an input that
    requires grad (with grad enabled) or carries a tangent."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        return True
    return has_tangent(*tensors)


def storage_key(t: torch.Tensor):
    """What identifies a tensor's values while a reference to it is held:
    its memory (address, shape, strides, dtype, device) and its version
    counter, which views share and every in-place write bumps."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device, t._version)


# the last tangent found zero where a contract does not differentiate: the
# RHS of a solve sees its table's tangent once a call, and the check reads
# the device, so a tangent already checked (the same memory and version,
# through any view) is not read again; holding it keeps its memory from
# being reused
_checked = [None]


def refuse_tangent(name: str, what: str, tangent, cols=None) -> None:
    """Raise when ``tangent`` (columns ``cols`` of a table, or the whole
    tensor) is nonzero: an input the kernel's contract does not
    differentiate. A None tangent passes. Reads the device."""
    if tangent is None:
        return
    key = (storage_key(tangent), None if cols is None else tuple(cols))
    hit = _checked[0]
    if hit is not None and hit[1] == key:
        return
    part = tangent if cols is None else tangent[:, list(cols)]
    if bool(torch.any(part != 0)):
        raise NotImplementedError(
            f"{name}: a forward-mode tangent on {what}, which the kernel does not "
            f"differentiate; route this configuration to the generic tensor path")
    _checked[0] = (tangent, key)


# The exponent set (n+2, n−1, p−q+1, p−1) of n = 3, p = 3, q = 0: the
# kernels' compile-time specialisation (GlenExps in csrc/sia_common.cuh).
GLEN_EXPS = (5.0, 2.0, 4.0, 2.0)


# per-block opt-in shared memory of an H100 (sm_90)
SMEM_PER_BLOCK = 232448


def block_shape(rows: int, ny: int) -> Tuple[int, int, int]:
    """(bx, by, cells) of a cluster kernel's block over ``rows`` rows of ``ny``
    cells (csrc/rkc_interval.cu, csrc/si_step.cu): warps along rows
    (by = min(rows, 16)) and lanes along ny (bx = 32·min(⌈ny/32⌉, ⌊16/by⌋),
    so bx·by ≤ 512); each thread owns ⌈ny/bx⌉·⌈rows/by⌉ cells."""
    by = min(rows, 16)
    bx = 32 * max(1, min(-(-ny // 32), 16 // by))
    return bx, by, -(-ny // bx) * -(-rows // by)


def pick_cluster(name, layouts, occupancy, n_g, device_index):
    """(layout, {cluster size: resident clusters}) for a cluster kernel's
    launch over n_g glaciers. ``layouts`` maps the cluster sizes 8 and 16 to
    layouts (``fits``, ``cluster``, ``bx``, ``by``, ``smem``);
    ``occupancy(size, layout, byref(int))`` is the kernel's
    cudaOccupancyMaxActiveClusters query, asked for each layout that fits.
    16 blocks when all n_g clusters of 16 are resident at once, or when the
    plane fits only at 16; else 8. A size that cannot be scheduled raises."""
    active = {}
    with torch.cuda.device(device_index):
        for c, lay in layouts.items():
            n = ctypes.c_int(0)
            if lay.fits:
                err = occupancy(c, lay, ctypes.byref(n))
                if err != 0:
                    raise RuntimeError(f"{name}: the occupancy query at {c} blocks failed "
                                       f"with CUDA error {err}")
            active[c] = n.value
    big = layouts[16]
    chosen = big if big.fits and (active[16] >= n_g or not layouts[8].fits) else layouts[8]
    if active[chosen.cluster] == 0:
        raise RuntimeError(f"{name}: a cluster of {chosen.cluster} blocks ({chosen.bx}x"
                           f"{chosen.by} threads, {chosen.smem} bytes of shared memory) "
                           f"cannot be scheduled on this device")
    return chosen, active


def ticket_buffers(cache, device, dtype, n_partials, n_g):
    """(partials, counters) of a pullback kernel's per-glacier sums:
    ``n_partials`` values for the blocks' partials and ``n_g`` ticket
    counters, kept in ``cache`` per (device, dtype) and grown when too
    small. The counters are zeroed once and every launch leaves them zero;
    launches on one stream use them in turn."""
    buf = cache.get((device, dtype))
    if buf is None or buf[0].numel() < n_partials or buf[1].numel() < n_g:
        buf = (torch.empty(n_partials, dtype=dtype, device=device),
               torch.zeros(n_g, dtype=torch.int32, device=device))
        cache[(device, dtype)] = buf
    return buf


def derived_scalars(dx, dy, A, C, n, p, q, rho, g):
    """Per-glacier derived table (n_g, 8) of the kernels:
    [dx, dy, creep=A·Γ_noA, slide=C(ρg)^{p−q}, n+2, n−1, p−q+1, p−1]."""
    return torch.stack(
        [
            dx,
            dy,
            A * 2.0 * (rho * g) ** n / (n + 2.0),
            C * (rho * g) ** (p - q),
            n + 2.0,
            n - 1.0,
            p - q + 1.0,
            p - 1.0,
        ],
        dim=1,
    )


def _int_pow(x, k: int):
    """xᵏ by binary exponentiation, the multiply sequence of XLA's
    integer_pow and of the kernels."""
    if k == 0:
        return torch.ones_like(x)
    recip, k = k < 0, abs(k)
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return 1.0 / acc if recip else acc


def pow_pos(x, e: float):
    """xᵉ for x ≥ 0 and a Python-number exponent: an integer-valued e is an
    integer power (multiplies); any other is exp(e·log x) with 0ᵉ := 0."""
    e = float(e)
    if e.is_integer():
        return _int_pow(x, int(e))
    pos = x > 0.0
    return torch.exp(e * torch.log(torch.where(pos, x, torch.ones_like(x)))) * pos


def dpow_pos(x, e: float):
    """d/dx :func:`pow_pos` with the conventions forward-mode AD gives it:
    e·x^(e−1) for an integer-valued e (0 for e = 0), e·xᵉ/x for x > 0 and 0
    at x = 0 for any other e (``dpow_pos`` in csrc/sia_common.cuh)."""
    e = float(e)
    if e.is_integer():
        return torch.zeros_like(x) if e == 0.0 else e * pow_pos(x, e - 1.0)
    pos = x > 0.0
    safe = torch.where(pos, x, torch.ones_like(x))
    return e * torch.exp(e * torch.log(safe)) / safe * pos


def diffusivity_tangent(h, dh, S, dS, dx, dy, creep, d_creep, slide, d_slide, exps):
    """(D, Ḋ) on the corner grid: D = creep·h̄^e_hc·|∇S|^e_sc +
    slide·h̄^e_hs·|∇S|^e_ss from the relu'd thickness h and the surface S,
    and its tangent from theirs (dh, dS) and the rates' (d_creep,
    d_slide); a None tangent is zero. ``exps`` = (e_hc, e_sc, e_hs, e_ss) as
    numbers, the rates (n_g, 1, 1) columns."""
    e_hc, e_sc, e_hs, e_ss = exps
    gsx, gsy = st.grad_slope(S, dx, dy)
    gn = st.safe_norm(gsx, gsy)
    hbar = st.avg(h)
    ph_c, pg_c = pow_pos(hbar, e_hc), pow_pos(gn, e_sc)
    ph_s, pg_s = pow_pos(hbar, e_hs), pow_pos(gn, e_ss)
    D = creep * ph_c * pg_c + slide * ph_s * pg_s
    dD = torch.zeros_like(D)
    if dh is not None or dS is not None:
        dS = torch.zeros_like(S) if dS is None else dS
        dgx, dgy = st.grad_slope(dS, dx, dy)
        pos = gn > 0.0
        dgn = torch.where(pos, (gsx * dgx + gsy * dgy) / torch.where(pos, gn, torch.ones_like(gn)),
                          torch.zeros_like(gn))
        dhb = st.avg(dh) if dh is not None else torch.zeros_like(hbar)
        dD = (creep * (dpow_pos(hbar, e_hc) * dhb * pg_c + ph_c * dpow_pos(gn, e_sc) * dgn)
              + slide * (dpow_pos(hbar, e_hs) * dhb * pg_s + ph_s * dpow_pos(gn, e_ss) * dgn))
    if d_creep is not None:
        dD = dD + d_creep * ph_c * pg_c
    if d_slide is not None:
        dD = dD + d_slide * ph_s * pg_s
    return D, dD


def shared_exps(derived: torch.Tensor) -> Optional[Tuple[float, float, float, float]]:
    """The exponent columns (n+2, n−1, p−q+1, p−1) of a derived table as
    Python floats if every glacier has the same set, else None. Reads the
    table on the host."""
    rows = derived[:, 4:8].tolist()
    if any(r != rows[0] for r in rows):
        return None
    return tuple(float(e) for e in rows[0])


def uses_glen(exps) -> bool:
    """Whether a launch with the batch's shared exponent set ``exps`` takes
    the kernels' fixed-multiply specialisation; None (glaciers with
    different sets) and every other set take the runtime-exponent path."""
    return exps is not None and tuple(float(e) for e in exps) == GLEN_EXPS


def check_inputs(name: str, planes: Sequence[torch.Tensor], table: torch.Tensor,
                 table_cols: int) -> None:
    """Raise on what the kernels do not take: mixed devices or dtypes, a
    dtype other than float32/float64, a non-contiguous or non-3-D plane,
    planes of different shapes, nx or ny below 3, a table of the wrong
    shape. Each wrapper states its own gradient contract."""
    H = planes[0]
    for a in list(planes) + [table]:
        if a.device != H.device:
            raise ValueError(f"{name}: all inputs must be on {H.device}, got {a.device}")
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 planes only, got {H.dtype}")
    if H.ndim != 3:
        raise ValueError(f"{name}: planes must be (n_g, nx, ny), got {tuple(H.shape)}")
    for a in planes:
        if a.dtype != H.dtype or a.shape != H.shape:
            raise ValueError(f"{name}: planes must share dtype and shape "
                             f"({H.dtype}, {tuple(H.shape)})")
        if not a.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous")
    n_g, nx, ny = H.shape
    if nx < 3 or ny < 3:
        raise ValueError(f"{name}: nx and ny must be at least 3, got ({nx}, {ny})")
    if table.shape != (n_g, table_cols) or not table.is_floating_point():
        raise ValueError(f"{name}: the table must be a float ({n_g}, {table_cols}) "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
