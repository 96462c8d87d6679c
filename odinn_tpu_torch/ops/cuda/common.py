"""What the fused kernels share: the per-glacier derived table, powers with
the kernels' semantics, the wrappers' input checks, and the cluster kernels'
block shape and cluster choice."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["derived_scalars", "pow_pos", "shared_exps", "check_inputs", "GLEN_EXPS",
           "uses_glen", "block_shape", "pick_cluster", "ticket_buffers", "SMEM_PER_BLOCK"]

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
