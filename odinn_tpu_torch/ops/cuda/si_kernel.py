"""Fused semi-implicit θ-step (A target, per-glacier scalar laws).

``si_step`` launches the hand-written CUDA kernels of ``csrc/si_step.cu`` on
a CUDA tensor and runs its plain PyTorch version, :func:`si_step_reference`,
on a CPU tensor. It replaces the TPU kernel
``odinn_tpu.ops.pallas.si_kernel.si_step_pallas``: the frozen staggered
diffusivity at ``H_D``, the right-hand side
b = H + dt·M·∇·(D∇(B + ring·H + (1−θ)·M·H)), the Jacobi inverse diagonal,
``cg_iters`` preconditioned-CG iterations from ``x0`` on
A = I − θ·dt·M·∇·(D∇(M·)), and a final relu. M is the interior mask.

On the card the step is two launches: an assembly kernel over the whole
batch (D, b, inverse diagonal), then one thread block per glacier running
the PCG recursion with its vectors in a global scratch buffer and
deterministic block reductions for the dot products.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from odinn_tpu_torch.ops import si_math
from odinn_tpu_torch.ops import stencils as st
from odinn_tpu_torch.ops.cuda.build import load_library
from odinn_tpu_torch.ops.cuda.common import check_inputs, pow_pos, shared_exps

__all__ = ["si_step", "si_step_reference"]

# planes of the kernel's scratch buffer: D, b, inv_diag, x, r, p, Ap
_N_SCRATCH = 7


def _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps):
    """D = creep·H̄^{n+2}·|∇S|^{n−1} + slide·H̄^{p−q+1}·|∇S|^{p−1} at H_D."""
    e_hc, e_sc, e_hs, e_ss = exps
    Hc = st.relu_strict(H_D)
    S = B + Hc
    gsx, gsy = st.grad_slope(S, dx, dy)
    grad_s = st.safe_norm(gsx, gsy)
    hbar = st.avg(Hc)
    return creep * pow_pos(hbar, e_hc) * pow_pos(grad_s, e_sc) + slide * pow_pos(
        hbar, e_hs) * pow_pos(grad_s, e_ss)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library, its entry points' signatures declared once."""
    lib = load_library("si_step")
    for fn in (lib.si_step_f32, lib.si_step_f64):
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_double] * 2 + [ctypes.c_int] + [ctypes.c_double] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def si_step_reference(H, H_D, B, x0, scalars, dt, theta=1.0, cg_iters=6, exps=None):
    """Plain PyTorch version of the kernel on (n_g, nx, ny) planes.

    ``scalars``: the derived (n_g, 8) table (first 4 columns used, cast to
    H's dtype); ``exps`` = (n+2, n−1, p−q+1, p−1) as Python numbers, read
    from the table's shared exponent set when None. dt, theta, cg_iters are
    Python numbers.
    """
    exps = _resolve_exps(scalars, exps)
    sc = scalars[:, :4].to(H.dtype)
    dx, dy, creep, slide = (sc[:, k].reshape(-1, 1, 1) for k in range(4))
    D = _frozen_D_scalar(H_D, B, dx, dy, creep, slide, exps)
    return si_math.theta_step(H, D, B, x0, dt, theta, cg_iters, dx, dy)


def _resolve_exps(scalars, exps):
    if exps is not None:
        return tuple(float(e) for e in exps)
    found = shared_exps(scalars)
    if found is None:
        raise ValueError(
            "si_step: the glaciers of the batch have different exponent sets "
            "(n+2, n−1, p−q+1, p−1); the kernel takes one set per launch")
    return found


def si_step(H, H_D, B, x0, scalars, dt, theta=1.0, cg_iters=6, exps=None):
    """One fused semi-implicit θ-step for a batch (see the module doc).

    H, H_D, B, x0: (n_g, nx, ny) float32/float64 planes; ``scalars`` the
    derived (n_g, 8) table; ``exps`` the batch's shared exponent set
    (n+2, n−1, p−q+1, p−1) as Python numbers, or None to read it from the
    table, which refuses a batch whose glaciers differ. A CUDA tensor
    launches the kernels; a CPU tensor takes :func:`si_step_reference`.
    Refuses inputs that require grad: the step has no backward yet.
    """
    check_inputs("si_step", (H, H_D, B, x0), scalars, 8)
    if any(a.requires_grad for a in (H, H_D, B, x0, scalars)):
        raise RuntimeError(
            "si_step: gradients through the SI step are not supported yet; they "
            "come with the implicit-function adjoint of the SI/SI2 solve (the "
            "SI-adjoint slice). Train through solver='RKC' or an explicit "
            "stepper, or pass tensors that do not require grad")
    exps = _resolve_exps(scalars, exps)
    dt, theta, cg_iters = float(dt), float(theta), int(cg_iters)
    if H.device.type == "cpu":
        return si_step_reference(H, H_D, B, x0, scalars, dt, theta, cg_iters, exps)
    if H.device.type != "cuda":
        raise ValueError(f"si_step: no kernel for device {H.device}")
    table = scalars[:, :4].to(H.dtype).contiguous()
    work = torch.empty((_N_SCRATCH,) + tuple(H.shape), dtype=H.dtype, device=H.device)
    out = torch.empty_like(H)
    n_g, nx, ny = H.shape
    lib = _library()
    fn = lib.si_step_f32 if H.dtype == torch.float32 else lib.si_step_f64
    err = fn(H.data_ptr(), H_D.data_ptr(), B.data_ptr(), x0.data_ptr(),
             table.data_ptr(), work.data_ptr(), out.data_ptr(), n_g, nx, ny,
             dt, theta, cg_iters, *exps,
             torch.cuda.current_stream(H.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"si_step: kernel launch failed with CUDA error {err}")
    si_step.launches += 1
    return out


si_step.launches = 0
