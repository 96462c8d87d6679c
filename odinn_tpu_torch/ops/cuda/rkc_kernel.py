"""One fused RKC2 step (A target, per-glacier scalar laws) and its pullback.

``rkc_interval`` launches the hand-written CUDA kernel
``csrc/rkc_interval.cu`` on a CUDA tensor and runs its plain PyTorch
version, :func:`rkc_interval_reference`, on a CPU tensor. It replaces the
TPU kernel ``odinn_tpu.ops.pallas.rkc_kernel.rkc_interval_pallas``: all s
stages of one RKC2 step of length dt in one launch, one thread-block
cluster of 8 or 16 blocks per glacier (:func:`rkc_layout`, chosen by
occupancy in :func:`rkc_plan`) with the stage carries in registers and
shared memory, so the step reads H and B once and writes H' once.

Differentiable with the contract of the TPU kernel's ``_bwd``: cotangents
for H and for the creep column (2) of the derived table; B and the other
columns get none (zero). The backward rematerialises the stage inputs
y₁ … y_{s−1} with one more launch of the kernel, which then also writes them
to a buffer, and walks the stages backwards (the recipe of
``odinn_tpu.inverse.gradient._make_rkc_transpose``): one launch of the
pullback kernel ``csrc/sia2d_rhs_vjp.cu`` in its stage mode per stage
(:func:`stage_pullback`, which also does the stage's μ, ν, μ̃, γ̃
combinations; plain version :func:`stage_pullback_reference`), and one
plain :func:`~odinn_tpu_torch.ops.cuda.sia_kernel.sia2d_rhs_vjp` for f₀: s
launches in all.

Its tangent (forward mode through ``torch.autograd.forward_ad``, the same
contract: H and the creep column) is built the way the backward is
(:func:`interval_tangent`): one launch of the kernel that keeps the stage
inputs, then the stages in order, each one launch of the tangent kernel
``csrc/sia2d_rhs_jvp.cu`` in its stage mode, which applies the stage's
combination (:func:`_stage_weights`) to J(y_{j−1})·ẏ_{j−1} and the creep
term: s + 1 launches in all. Plain version :func:`interval_tangent_reference`.
A tangent on B or on another column of the table raises. The TPU kernel
has no tangent; JAX takes it by ``jax.jvp`` of ``solver.make_rkc2_step``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from odinn_tpu_torch.ops.cuda.build import load_library
from odinn_tpu_torch.ops.cuda.common import (
    GLEN_EXPS, SMEM_PER_BLOCK, block_shape, check_inputs, has_tangent, needs_function,
    pick_cluster, refuse_tangent, shared_exps, uses_glen)
from odinn_tpu_torch.ops.cuda.sia_kernel import (
    _rhs_math, _vjp_library, _vjp_scratch, sia2d_rhs_jvp, sia2d_rhs_jvp_reference, sia2d_rhs_vjp,
    sia2d_rhs_vjp_reference)
from odinn_tpu_torch.simulation.solver import _rkc2_coeffs

__all__ = ["rkc_interval", "rkc_interval_reference", "rkc_fits", "check_rkc_shape",
           "rkc_layout", "rkc_plan", "stage_pullback", "stage_pullback_reference",
           "interval_pullback", "interval_tangent", "interval_tangent_reference"]

# the derived table's columns the step does not differentiate: all but creep
_FIXED_COLS = (0, 1, 3, 4, 5, 6, 7)

# csrc/rkc_interval.cu: the cells a thread owns at most, the shared-memory
# slabs, the cluster sizes
_MAX_CELLS = 8
_SLABS = 4
_CLUSTERS = (8, 16)


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _make_coeff_arrays(s, dtype):
    """(μ, ν, μ̃, γ̃) of shape (s+1,) and μ̃₁, rounded to ``dtype``."""
    _, _, mu1_t, mu, nu, mu_t, gam_t, _ = _rkc2_coeffs(s)
    npt = _np_dtype(dtype)
    return (mu.astype(npt), nu.astype(npt), mu_t.astype(npt), gam_t.astype(npt),
            npt(mu1_t))


@functools.lru_cache(maxsize=None)
def _coef_table(s, dtype, device):
    """The kernel's (5, s+1) coefficient table: rows μ, ν, μ̃, γ̃, μ̃₁ (as
    ``rkc_kernel._forward`` stacks them), built once per (s, dtype,
    device)."""
    mu, nu, mu_t, gam_t, mu1_t = _make_coeff_arrays(s, dtype)
    table = np.stack([mu, nu, mu_t, gam_t, np.full_like(mu, mu1_t)])
    return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=256)
def _stage_weights(s, dtype, dt):
    """The per-stage products as Python floats holding ``dtype`` values,
    formed in ``dtype`` as the TPU kernel forms them: μ̃₁·dt, and for
    j = 2..s the tuples (1 − μⱼ − νⱼ, μⱼ, νⱼ, μ̃ⱼ·dt, γ̃ⱼ·dt)."""
    mu, nu, mu_t, gam_t, mu1_t = _make_coeff_arrays(s, dtype)
    npt = _np_dtype(dtype)
    dtn = npt(dt)
    stages = {j: (float(npt(1.0) - mu[j] - nu[j]), float(mu[j]), float(nu[j]),
                  float(mu_t[j] * dtn), float(gam_t[j] * dtn)) for j in range(2, s + 1)}
    return float(mu1_t * dtn), stages


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("rkc_interval")
    for fn in (lib.rkc_interval_f32, lib.rkc_interval_f64):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_double] * 2
                       + [ctypes.c_int] + [ctypes.c_double] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.rkc_interval_occupancy.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.rkc_interval_occupancy.restype = ctypes.c_int
    return lib


class RKCLayout(NamedTuple):
    """How the kernel lays one glacier's (nx, ny) plane on a cluster."""

    cluster: int      # blocks per glacier
    rows: int         # rows a block owns: ⌈nx / cluster⌉
    bx: int           # threads along ny (a multiple of 32)
    by: int           # threads along rows
    cells: int        # cells a thread owns
    smem: int         # shared memory per block, bytes
    idle_blocks: int  # blocks of the cluster that own no row

    @property
    def fits(self) -> bool:
        return self.smem <= SMEM_PER_BLOCK and self.cells <= _MAX_CELLS


@functools.lru_cache(maxsize=None)
def rkc_layout(nx, ny, dtype, cluster) -> RKCLayout:
    """The layout at a cluster size: rows = ⌈nx/cluster⌉ a block; warps along
    rows (by = min(rows, 16)) and lanes along ny (bx = 32·min(⌈ny/32⌉,
    ⌊16/by⌋), so bx·by ≤ 512); each thread owns ⌈ny/bx⌉·⌈rows/by⌉ cells; 4
    slabs of rows + 2 rows of ny values (B and two stage buffers with their
    halo rows, and the corner diffusivities)."""
    rows = -(-nx // cluster)
    bx, by, cells = block_shape(rows, ny)
    smem = _SLABS * (rows + 2) * ny * torch.empty((), dtype=dtype).element_size()
    return RKCLayout(cluster, rows, bx, by, cells, smem, cluster - -(-nx // rows))


def rkc_fits(nx, ny, dtype) -> bool:
    """Whether one glacier's (nx, ny) plane of ``dtype`` fits the kernel at
    some cluster size."""
    return any(rkc_layout(nx, ny, dtype, c).fits for c in _CLUSTERS)


def check_rkc_shape(nx, ny, dtype):
    """Raise when one glacier's plane does not fit the kernel (the port's
    counterpart of the TPU kernel's ``unsupported_reason``)."""
    if not rkc_fits(nx, ny, dtype):
        need = "; ".join(f"{lay.smem} bytes of shared memory and {lay.cells} cells a thread "
                         f"at {lay.cluster} blocks" for lay in
                         (rkc_layout(nx, ny, dtype, c) for c in _CLUSTERS))
        raise ValueError(
            f"rkc_interval: a {nx}x{ny} {dtype} plane needs {need}, above the limits of "
            f"{SMEM_PER_BLOCK} bytes and {_MAX_CELLS} cells; use the generic RKC stages "
            f"for this grid")


class RKCPlan(NamedTuple):
    layout: RKCLayout          # the chosen cluster size's layout
    max_active: dict           # cluster size -> cudaOccupancyMaxActiveClusters (0: no fit)


@functools.lru_cache(maxsize=None)
def _plan(dtype, nx, ny, n_g, glen, device_index) -> RKCPlan:
    lib = _library()

    def occupancy(c, lay, active):
        return lib.rkc_interval_occupancy(int(dtype == torch.float64), int(glen), c, lay.bx,
                                          lay.by, lay.smem, lay.cells, active)

    layouts = {c: rkc_layout(nx, ny, dtype, c) for c in _CLUSTERS}
    return RKCPlan(*pick_cluster("rkc_interval", layouts, occupancy, n_g, device_index))


def rkc_plan(n_g, nx, ny, dtype, exps=GLEN_EXPS, device=None) -> RKCPlan:
    """The cluster size a launch over n_g glaciers takes on a CUDA device:
    16 when the occupancy API says all n_g clusters of 16 are resident at
    once, or when the plane fits only at 16; else 8. A size that cannot be
    scheduled raises. Cached per (dtype, nx, ny, n_g, exponent path)."""
    check_rkc_shape(nx, ny, dtype)
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _plan(dtype, nx, ny, n_g, uses_glen(exps), index)


def _interval_math(H, B, row, exps, dt, s, eta0, keep=None):
    """One RKC2 step of length dt (the TPU kernel's ``_interval_math``);
    appends y₁ … y_{s−1} to ``keep`` when it is a list."""
    mu1dt, weights = _stage_weights(s, H.dtype, dt)
    f0 = _rhs_math(H, B, row, exps, eta0)
    y_jm1, y_jm2 = H + mu1dt * f0, H
    for j in range(2, s + 1):
        if keep is not None:
            keep.append(y_jm1)
        a, mu, nu, mutdt, gamdt = weights[j]
        f_j = _rhs_math(y_jm1, B, row, exps, eta0)
        y_j = a * H + mu * y_jm1 + nu * y_jm2 + mutdt * f_j + gamdt * f0
        y_jm1, y_jm2 = y_j, y_jm1
    return y_jm1


def _row(scalars, dtype):
    """The derived table's (dx, dy, creep, slide) as (n_g, 1, 1) columns."""
    sc = scalars[:, :4].to(dtype)
    return tuple(sc[:, k].reshape(-1, 1, 1) for k in range(4))


def rkc_interval_reference(H, B, scalars, dt, s, eta0, exps=(5.0, 2.0, 4.0, 2.0)):
    """Plain PyTorch version of the kernel: H, B of shape (n_g, nx, ny);
    ``scalars`` the derived (n_g, 8) table, whose first 4 columns are read
    (cast to H's dtype); ``exps`` = (n+2, n−1, p−q+1, p−1) as numbers."""
    return _interval_math(H, B, _row(scalars, H.dtype), tuple(float(e) for e in exps), dt, s,
                          eta0)


def _resolve_exps(scalars, exps):
    if exps is not None:
        return tuple(float(e) for e in exps)
    found = shared_exps(scalars)
    if found is None:
        raise ValueError(
            "rkc_interval: the glaciers of the batch have different exponent sets "
            "(n+2, n−1, p−q+1, p−1); the kernel takes one set per launch")
    return found


def _forward(H, B, scalars, dt, s, eta0, exps, keep_stages=False):
    """y_s, and with ``keep_stages`` the stage inputs y₁ … y_{s−1} (a
    sequence of planes), on H's device without autograd."""
    if H.device.type == "cpu":
        keep = [] if keep_stages else None
        out = _interval_math(H, B, _row(scalars, H.dtype), exps, dt, s, eta0, keep)
        return (out, keep) if keep_stages else out
    if H.device.type != "cuda":
        raise ValueError(f"rkc_interval: no kernel for device {H.device}")
    if has_tangent(H, B, scalars):
        raise NotImplementedError("rkc_interval: a forward-mode tangent reached the kernel "
                                  "launch; call rkc_interval")
    n_g, nx, ny = H.shape
    lay = rkc_plan(n_g, nx, ny, H.dtype, exps, H.device).layout
    table = scalars.to(H.dtype).contiguous()
    coef = _coef_table(s, H.dtype, H.device)
    out = torch.empty_like(H)
    stages = (torch.empty((s - 1,) + tuple(H.shape), dtype=H.dtype, device=H.device)
              if keep_stages else None)
    lib = _library()
    fn = lib.rkc_interval_f32 if H.dtype == torch.float32 else lib.rkc_interval_f64
    err = fn(H.data_ptr(), B.data_ptr(), table.data_ptr(), coef.data_ptr(), out.data_ptr(),
             stages.data_ptr() if stages is not None else None, n_g, nx, ny, s,
             float(dt), float(eta0), int(uses_glen(exps)), *exps, lay.cluster, lay.bx,
             lay.by, lay.smem, lay.cells, torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rkc_interval: kernel launch failed with CUDA error {err}")
    rkc_interval.launches += 1
    return (out, stages) if keep_stages else out


def stage_pullback_reference(c, carry, Y, B, table, eta0, weights):
    """Plain version of stage j of the RKC2 backward: ``c`` the cotangent
    of y_j, ``Y`` = y_{j−1}, ``weights`` = (1 − μⱼ − νⱼ, μⱼ, νⱼ, μ̃ⱼ·dt,
    γ̃ⱼ·dt), ``table`` the derived (n_g, 8) table in Y's dtype, ``carry`` =
    (pend, cot_y, cot_f0, d_creep), or None for zeros at the first stage
    (j = s). Returns (c′, carry′): the pullback of c·μ̃ⱼdt at Y through
    :func:`sia2d_rhs_vjp_reference` and the stage's combinations."""
    a, mu, nu, mutdt, gamdt = weights
    if carry is None:
        zero = torch.zeros_like(c)
        carry = (zero, zero, zero, torch.zeros(c.shape[0], dtype=c.dtype, device=c.device))
    pend, cot_y, cot_f0, dcreep = carry
    cot_y = torch.add(cot_y, c, alpha=a)
    cot_f0 = torch.add(cot_f0, c, alpha=gamdt)
    g, dc = sia2d_rhs_vjp_reference(c * mutdt, Y, B, table, eta0)
    # the ν route into y_{j−2} is finalised two stages down
    return torch.add(pend, c, alpha=mu).add_(g), (c * nu, cot_y, cot_f0, dcreep + dc)


def stage_pullback(c, carry, Y, B, table, eta0, weights):
    """Stage j of the RKC2 backward (:func:`stage_pullback_reference`'s
    contract). A CUDA tensor launches the pullback kernel in its stage mode,
    one launch counted on ``sia2d_rhs_vjp.launches``, which updates the
    carries in place and writes c′ to a new buffer (neighbouring cells read
    c); a CPU tensor takes the plain version."""
    if Y.device.type == "cpu":
        return stage_pullback_reference(c, carry, Y, B, table, eta0, weights)
    if Y.device.type != "cuda":
        raise ValueError(f"rkc_interval: no kernel for device {Y.device}")
    if has_tangent(c, Y, B, table, *(carry or ())):
        raise NotImplementedError("rkc_interval: the pullback takes no forward-mode tangent")
    n_g, nx, ny = Y.shape
    first = carry is None
    if first:
        carry = (torch.empty_like(Y), torch.empty_like(Y), torch.empty_like(Y),
                 torch.empty(n_g, dtype=Y.dtype, device=Y.device))
    pend, cot_y, cot_f0, dcreep = carry
    c_out = torch.empty_like(Y)
    table = table.to(Y.dtype).contiguous()
    partial, counter = _vjp_scratch(Y.device, Y.dtype, n_g, nx, ny)
    lib = _vjp_library()
    fn = lib.sia2d_rhs_vjp_stage_f32 if Y.dtype == torch.float32 else lib.sia2d_rhs_vjp_stage_f64
    err = fn(c.data_ptr(), Y.data_ptr(), B.data_ptr(), table.data_ptr(), c_out.data_ptr(),
             pend.data_ptr(), cot_y.data_ptr(), cot_f0.data_ptr(), partial.data_ptr(),
             counter.data_ptr(), dcreep.data_ptr(), n_g, nx, ny, float(eta0), *weights,
             int(first), torch.cuda.current_stream(Y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sia2d_rhs_vjp: stage kernel launch failed with CUDA error {err}")
    sia2d_rhs_vjp.launches += 1
    return c_out, carry


def _transpose(lam, H, B, table, stages, dt, s, eta0):
    """The pullback of one RKC2 step to (H, creep): ``stages`` holds
    y₁ … y_{s−1}; ``table`` the derived (n_g, 8) table in H's dtype with the
    step's exponents."""
    mu1dt, weights = _stage_weights(s, H.dtype, dt)
    c, carry = lam, None
    for j in range(s, 1, -1):
        c, carry = stage_pullback(c, carry, stages[j - 2], B, table, eta0, weights[j])
    pend, cot_y, cot_f0, dcreep = carry
    cot_y += c + pend
    cot_f0.add_(c, alpha=mu1dt)
    g, dc = sia2d_rhs_vjp(cot_f0, H, B, table, eta0)
    return cot_y + g, dcreep + dc


@functools.lru_cache(maxsize=None)
def _exps_row(exps, dtype, device):
    return torch.tensor(exps, dtype=dtype, device=device)


def _kernel_rows(scalars, exps, dtype):
    """The derived table in ``dtype`` with the step's exponent set in its
    exponent columns, as the pullback and tangent kernels read it."""
    n_g = scalars.shape[0]
    return torch.cat([scalars[:, :4].detach().to(dtype),
                      _exps_row(exps, dtype, scalars.device).expand(n_g, 4)], dim=1)


def _stage_tangents(dH, d_creep, H, B, table, stages, dt, s, eta0, jvp):
    """ẏ_s of one RKC2 step from y₀ = H and the stage inputs ``stages`` =
    y₁ … y_{s−1}: stage 1 (ẏ₁ = Ḣ + μ̃₁dt·ḟ₀, keeping ḟ₀) and stages 2 … s,
    each one call of ``jvp`` (:func:`~odinn_tpu_torch.ops.cuda.sia_kernel.
    sia2d_rhs_jvp` or its plain version) in its stage mode."""
    mu1dt, weights = _stage_weights(s, H.dtype, dt)
    y_jm1, f0 = jvp(dH, H, B, table, d_creep, eta0,
                    stage=(dH, dH, dH, (1.0, 0.0, 0.0, mu1dt, 0.0)))
    y_jm2 = dH
    for j in range(2, s + 1):
        y_j, _ = jvp(y_jm1, stages[j - 2], B, table, d_creep, eta0,
                     stage=(dH, y_jm2, f0, weights[j]), keep_f=False)
        y_jm1, y_jm2 = y_j, y_jm1
    return y_jm1


def interval_tangent_reference(dH, d_creep, H, B, scalars, dt, s, eta0, exps=None):
    """Plain version of :func:`interval_tangent`: the forward's stage inputs
    by :func:`_interval_math`, the stages by
    :func:`~odinn_tpu_torch.ops.cuda.sia_kernel.sia2d_rhs_jvp_reference`."""
    exps = _resolve_exps(scalars, exps)
    dt, s, eta0 = float(dt), int(s), float(eta0)
    keep = []
    _interval_math(H, B, _row(scalars, H.dtype), exps, dt, s, eta0, keep)
    table = _kernel_rows(scalars, exps, H.dtype)
    return _stage_tangents(dH, d_creep, H, B, table, keep, dt, s, eta0, sia2d_rhs_jvp_reference)


def interval_tangent(dH, d_creep, H, B, scalars, dt, s, eta0, exps=None):
    """ẏ_s, the tangent of one RKC2 step at H in H (``dH``) and the derived
    table's creep column (``d_creep``, (n_g,) or None). On the card one
    launch of the kernel keeps the stage inputs and s launches of the
    tangent kernel's stage mode walk the stages (module doc); on the CPU
    the plain versions."""
    check_inputs("rkc_interval", (dH, H, B), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    dt, s, eta0 = float(dt), int(s), float(eta0)
    _, stages = _forward(H, B, scalars, dt, s, eta0, exps, keep_stages=True)
    table = _kernel_rows(scalars, exps, H.dtype)
    return _stage_tangents(dH, d_creep, H, B, table, stages, dt, s, eta0, sia2d_rhs_jvp)


def interval_pullback(lam, H, B, scalars, dt, s, eta0, exps=None):
    """(dH, d_creep): the pullback of one RKC2 step at H of the cotangent
    ``lam`` to H and to the derived table's creep column ((n_g,)). On the
    card one more launch of the kernel rematerialises the stage inputs and
    s launches of the pullback kernel walk the stages back (module doc); on
    the CPU the plain versions."""
    check_inputs("rkc_interval", (lam, H, B), scalars, 8)
    exps = _resolve_exps(scalars, exps)
    dt, s, eta0 = float(dt), int(s), float(eta0)
    _, stages = _forward(H, B, scalars, dt, s, eta0, exps, keep_stages=True)
    return _transpose(lam, H, B, _kernel_rows(scalars, exps, H.dtype), stages, dt, s, eta0)


class _RKCInterval(torch.autograd.Function):
    """The step with the TPU kernel's differentiation contract, backward and
    tangent (module doc)."""

    @staticmethod
    def forward(ctx, H, B, scalars, dt, s, eta0, exps):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(H, B, scalars)
        # the jvp cannot read saved_tensors
        ctx.primals = (H, B, scalars)
        ctx.consts = (dt, s, eta0, exps)
        return _forward(H, B, scalars, dt, s, eta0, exps)

    @staticmethod
    def jvp(ctx, dH, dB, dscalars, *_):
        H, B, scalars = ctx.primals
        dt, s, eta0, exps = ctx.consts
        refuse_tangent("rkc_interval", "the bed B", dB)
        refuse_tangent("rkc_interval", "a column of the table other than creep", dscalars,
                       _FIXED_COLS)
        d_creep = None if dscalars is None else dscalars[:, 2]
        dH = torch.zeros_like(H) if dH is None else dH.contiguous()
        return interval_tangent(dH, d_creep, H, B, scalars, dt, s, eta0, exps)

    @staticmethod
    def backward(ctx, lam):
        if lam is None:        # grads are not materialised (for the jvp's Nones)
            return (None,) * 7
        H, B, scalars = ctx.saved_tensors
        dt, s, eta0, exps = ctx.consts
        dH, dcreep = interval_pullback(lam.contiguous(), H, B, scalars, dt, s, eta0, exps)
        d_scal = None
        if ctx.needs_input_grad[2]:
            d_scal = torch.zeros_like(scalars)
            d_scal[:, 2] = dcreep.to(scalars.dtype)
        return (dH if ctx.needs_input_grad[0] else None), None, d_scal, None, None, None, None


def rkc_interval(H, B, scalars, dt, s, eta0, exps=None):
    """One s-stage RKC2 step of length ``dt`` for a batch (see the module
    doc). H, B: (n_g, nx, ny) float32/float64 planes; ``scalars`` the
    derived (n_g, 8) table; ``exps`` the batch's shared exponent set
    (n+2, n−1, p−q+1, p−1), or None to read it from the table, which refuses
    a batch whose glaciers differ. A CUDA tensor launches the kernel (and
    raises for a plane larger than it holds, :func:`check_rkc_shape`); a
    CPU tensor takes :func:`rkc_interval_reference`. Differentiable in H and
    the creep column, in reverse and in forward mode (module doc)."""
    check_inputs("rkc_interval", (H, B), scalars, 8)
    s = int(s)
    if s < 2:
        raise ValueError(f"rkc_interval: RKC2 needs s >= 2 stages, got {s}")
    exps = _resolve_exps(scalars, exps)
    dt, eta0 = float(dt), float(eta0)
    if needs_function(H, scalars) or has_tangent(B):
        return _RKCInterval.apply(H, B, scalars, dt, s, eta0, exps)
    return _forward(H, B, scalars, dt, s, eta0, exps)


rkc_interval.launches = 0
