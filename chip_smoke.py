"""Smoke run of odinn_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
2. build: the CUDA kernels under ``odinn_tpu_torch/csrc``, one ``nvcc`` per
   source, all started together;
3. kernel checks: each kernel against its plain PyTorch version on the card,
   at the main path's 4 x 128^2 and at a ragged 3 x 97 x 131, in float64 and
   float32 (``si_step`` in float32 also on its increment out − H);
4. main path: the forward prediction of 4 Halfar glaciers, 128^2, float32,
   5 years with monthly saves and monthly mass balance, Cuffey–Paterson A(T),
   n = 3, for the rows SI (PCG-6), SI2 (PCG-6) and compensated SSPRK3 at 3
   substeps. Each row runs through ``run_prediction`` with the launch
   counters set to 0 just before and read just after; its final thickness is
   held against the port's float64 run of the row on the unfused path; it is
   timed with CUDA events;
5. the ``kernels`` line: per kernel, what it replaces, its launches on the
   main path, its time, its plain version's time and its bound.

Any failed check raises, so the exit code is not 0. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits with
code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_FP64_OPS_PER_S = 34e12        # H100 SXM float64 outside the tensor cores

NX = NY = 128
N_G = 4
TSPAN = (5.0, 10.0)
DX = 100.0
DT = float(np.float32(1.0 / 12.0))

# float64: the kernel and its plain version do the same arithmetic in
# another order (fused multiply-adds, block-tree dot products) — roundoff.
TOL_F64 = 1e-10
# float32, relative to max|reference|: si_step's CG dot products are summed
# in another order (per-thread partials then a block tree, against torch's
# pairwise sum), which moves alpha and beta at the 1e-7 level in each of the
# 6 iterations; sia2d_rhs has no reduction but its flux difference cancels
# digits. Measured on an H100: 1.9e-7 (si_step) and 9.8e-7 (sia2d_rhs).
TOL_F32 = 1e-5
# float32 si_step on its increment, max|out − ref| / max|ref − H|: the step
# changes H by a small fraction of max|H|, so the same roundoff is a larger
# share of the increment. Measured on an H100: 3.7e-6 to 1.1e-5.
TOL_F32_INCREMENT = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean time per call of ``reps`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, names=None) -> float:
    """Device time per call of ``fn`` from the profiler: the summed time of
    the CUDA kernels it launched (those whose name contains one of ``names``
    when given), over ``reps`` calls. 0.0 when the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if names is None or any(n in e.key for n in names):
            total_us += us
    return total_us / reps / 1e3


def row_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` timed runs after one warm-up, by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Kernel inputs and bounds
# ---------------------------------------------------------------------------

def kernel_inputs(n_g, nx, ny, dtype, seed):
    """Domes of varied height and radius on a smooth bed with 1 m of noise,
    and the raw per-glacier table (dx, dy, A, C, n, p, q), from a seed."""
    from odinn_tpu_torch.laws.laws import poly_A_paterson_cuffey

    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    x = (torch.arange(nx, dtype=f64) - nx / 2) * DX
    y = (torch.arange(ny, dtype=f64) - ny / 2) * DX
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    radius = 0.35 * min(nx, ny) * DX * (0.8 + 0.4 * torch.rand(n_g, generator=gen, dtype=f64))
    height = 400.0 * (0.6 + 0.6 * torch.rand(n_g, generator=gen, dtype=f64))
    H = height[:, None, None] * torch.clamp(
        1.0 - r2 / radius[:, None, None] ** 2, min=0.0) ** (3.0 / 7.0)
    B = (50.0 * torch.sin(x / 700.0)[:, None] * torch.cos(y / 900.0)[None, :]
         + torch.rand((n_g, nx, ny), generator=gen, dtype=f64))
    A = poly_A_paterson_cuffey()(torch.linspace(-25.0, -13.0, n_g, dtype=f64))
    C = torch.where(torch.arange(n_g) % 2 == 1, A, torch.zeros_like(A))
    raw = torch.stack([torch.full((n_g,), DX, dtype=f64), torch.full((n_g,), 1.2 * DX, dtype=f64),
                       A, C, torch.full((n_g,), 3.0, dtype=f64),
                       torch.full((n_g,), 3.0, dtype=f64), torch.zeros(n_g, dtype=f64)], dim=1)
    dev = torch.device("cuda")
    return H.to(dev, dtype), B.to(dev, dtype), raw.to(dev)


# Operation counts per cell, from the plain versions' arithmetic: a corner
# diffusivity (slopes, |∇S|, H̄, the n = 3 integer powers, two terms) is 32;
# the fused RHS per interior cell (clamped edge gradients, fluxes,
# divergence) is 54; relu and S per cell 2. The SI step adds the right-hand
# side and Jacobi diagonal (47 per interior cell), the initial residual (31
# per cell) and 39 per cell per CG iteration (matvec, two dots, updates).
def sia_bound(n_g, nx, ny, itemsize):
    cells, corners, inner = n_g * nx * ny, n_g * (nx - 1) * (ny - 1), n_g * (nx - 2) * (ny - 2)
    nbytes = 3 * cells * itemsize + n_g * 7 * 8
    ops = 2 * cells + 32 * corners + 54 * inner
    return nbytes, ops


def si_bound(n_g, nx, ny, itemsize, cg_iters):
    cells, corners, inner = n_g * nx * ny, n_g * (nx - 1) * (ny - 1), n_g * (nx - 2) * (ny - 2)
    nbytes = 5 * cells * itemsize + n_g * 8 * 8
    ops = 2 * cells + 32 * corners + 47 * inner + 31 * cells + 39 * cells * cg_iters + cells
    return nbytes, ops


def bound_ms(nbytes, ops, dtype):
    peak = PEAK_FP32_OPS_PER_S if dtype == torch.float32 else PEAK_FP64_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def check_kernels():
    """Phase 3: each kernel against its plain version on the card."""
    from odinn_tpu_torch.ops.cuda import si_kernel, sia_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars
    from odinn_tpu_torch.core.params import PhysicalParameters

    PHYS = PhysicalParameters()

    for shape in ((N_G, NX, NY), (3, 97, 131)):
        for dtype in (torch.float64, torch.float32):
            tol = TOL_F64 if dtype == torch.float64 else TOL_F32
            H, B, raw = kernel_inputs(*shape, dtype, seed=sum(shape))
            derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
            cases = {
                "si_step theta=1 H_D=H": lambda f: f(H, H, B, H, derived, DT, 1.0, 6, (5.0, 2.0, 4.0, 2.0)),
                "si_step theta=0.5 H_D!=H": lambda f: f(H, 0.97 * H, B, 0.99 * H, derived, DT, 0.5, 6,
                                                        (5.0, 2.0, 4.0, 2.0)),
            }
            for name, call in cases.items():
                out = call(si_kernel.si_step)
                ref = call(si_kernel.si_step_reference)
                torch.cuda.synchronize()
                err = rel_err(out, ref)
                row = {"phase": "check", "kernel": name, "shape": list(shape),
                       "dtype": str(dtype), "rel_err": err, "tol": tol}
                ok = err <= tol
                if dtype == torch.float32:
                    h = H.double()
                    row["increment_rel_err"] = rel_err(out.double() - h, ref.double() - h)
                    row["increment_tol"] = TOL_F32_INCREMENT
                    ok = ok and row["increment_rel_err"] <= TOL_F32_INCREMENT
                emit(row)
                if not (torch.isfinite(out).all() and ok):
                    raise AssertionError(f"{name} disagrees with its plain version: {row}")
            out = sia_kernel.sia2d_rhs(H, B, raw, PHYS.rho, PHYS.g, PHYS.eta0)
            ref = sia_kernel.sia2d_rhs_reference(H, B, raw, PHYS.rho, PHYS.g, PHYS.eta0)
            torch.cuda.synchronize()
            err = rel_err(out, ref)
            row = {"phase": "check", "kernel": "sia2d_rhs", "shape": list(shape),
                   "dtype": str(dtype), "rel_err": err, "tol": tol}
            emit(row)
            if not (torch.isfinite(out).all() and err <= tol):
                raise AssertionError(f"sia2d_rhs disagrees with its plain version: {row}")


def time_kernels():
    """Kernel and plain-version times at the main path's shape (float32)."""
    from odinn_tpu_torch.ops.cuda import si_kernel, sia_kernel
    from odinn_tpu_torch.ops.cuda.common import derived_scalars
    from odinn_tpu_torch.core.params import PhysicalParameters

    PHYS = PhysicalParameters()

    H, B, raw = kernel_inputs(N_G, NX, NY, torch.float32, seed=7)
    derived = derived_scalars(*(raw[:, k] for k in range(7)), PHYS.rho, PHYS.g)
    exps = (5.0, 2.0, 4.0, 2.0)
    timing = {}

    def si_call(f):
        return lambda: f(H, H, B, H, derived, DT, 1.0, 6, exps)

    def sia_call(f):
        return lambda: f(H, B, raw, PHYS.rho, PHYS.g, PHYS.eta0)

    for name, call, kern, plain, bound, kernel_names in (
        ("si_step", si_call, si_kernel.si_step, si_kernel.si_step_reference,
         si_bound(N_G, NX, NY, 4, 6), ("si_assemble", "si_pcg")),
        ("sia2d_rhs", sia_call, sia_kernel.sia2d_rhs, sia_kernel.sia2d_rhs_reference,
         sia_bound(N_G, NX, NY, 4), ("sia2d_rhs_kernel",)),
    ):
        out, ref = call(kern)(), call(plain)()
        torch.cuda.synchronize()
        b_ms, b_by = bound_ms(*bound, torch.float32)
        timing[name] = {
            # the kernel's own device time, and the wrapper's and the plain
            # version's elapsed time per call on the stream
            "ms": device_ms(call(kern), 50, kernel_names),
            "ms_source": "profiler device time",
            "call_ms": cuda_ms(call(kern), 200),
            "plain_ms": cuda_ms(call(plain), 50),
            "plain_device_ms": device_ms(call(plain), 20),
        }
        if timing[name]["ms"] == 0.0:   # no device time from the profiler
            timing[name].update(ms=timing[name]["call_ms"], ms_source="cuda events per call")
        timing[name].update({
            "max_abs_err": float((out.double() - ref.double()).abs().max()),
            "bound_ms": b_ms,
            "bound_by": b_by,
        })
    return timing


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def main_path_rows():
    """Phase 4: the forward prediction rows, through the kernels. Returns
    each kernel's launches summed over the rows."""
    from odinn_tpu_torch.core.glacier import stack_glaciers
    from odinn_tpu_torch.core.params import (
        Parameters, PhysicalParameters, SimulationParameters, SolverParameters)
    from odinn_tpu_torch.data.synthetic import halfar_glacier, monthly_dummy_climate
    from odinn_tpu_torch.laws.laws import CuffeyPaterson
    from odinn_tpu_torch.models.model import Model, SIA2DModel
    from odinn_tpu_torch.ops.cuda import si_kernel, sia_kernel
    from odinn_tpu_torch.physics.mass_balance import TImodel1
    from odinn_tpu_torch.simulation.prediction import Prediction, forward_batch, run_prediction
    from odinn_tpu_torch.simulation.solver import build_tstops

    def make_params(**solver_kw):
        return Parameters(
            physical=PhysicalParameters(min_A=8e-21, max_A=8e-18),
            simulation=SimulationParameters(tspan=TSPAN, use_MB=True, step_MB=1.0 / 12.0,
                                            use_velocities=False, float_dtype="float32"),
            solver=SolverParameters(step=1.0 / 12.0, **solver_kw),
        )

    tstops = build_tstops(TSPAN, 1.0 / 12.0)
    n_int = len(tstops) - 1          # 60 monthly intervals
    # launches per row: one si_step per SI step, two per SI2 step, one
    # sia2d_rhs per SSPRK3 stage (3 stages x 3 substeps): 60, 120 and 540
    rows = {
        "SI": (make_params(substeps=1, solver="SI", cg_iters=6),
               {"si_step": n_int, "sia2d_rhs": 0}),
        "SI2": (make_params(substeps=1, solver="SI2", cg_iters=6, cg_iters_predictor=6),
                {"si_step": 2 * n_int, "sia2d_rhs": 0}),
        "SSPRK3@3 compensated": (make_params(substeps=3, solver="SSPRK3", compensated=True),
                                 {"si_step": 0, "sia2d_rhs": 9 * n_int}),
    }
    n_months = int(round((TSPAN[1] - TSPAN[0]) * 12)) + 2
    temps = np.linspace(-25.0, -13.0, N_G)

    def glaciers(dtype):
        return [
            halfar_glacier(nx=NX, ny=NY, dx=DX, dy=DX, temp=float(t), rgi_id=f"bench-{i}",
                           climate=monthly_dummy_climate(TSPAN[0], n_months, temp_mean=-4.0,
                                                         longterm_temp=float(t), nx=NX, ny=NY,
                                                         device="cuda", dtype=dtype),
                           device="cuda", dtype=dtype)
            for i, t in enumerate(temps)
        ]

    model = Model(iceflow=SIA2DModel(A=CuffeyPaterson(), n_value=3.0), mass_balance=TImodel1())
    # the same A(T) law evaluated at every RHS call: its values are no longer
    # constant for the solve, so the solve takes the unfused PyTorch path
    plain_model = Model(iceflow=SIA2DModel(A=dataclasses.replace(CuffeyPaterson(), callback_freq=None),
                                           n_value=3.0), mass_balance=TImodel1())
    batch32 = stack_glaciers(glaciers(torch.float32), device="cuda")
    batch64 = stack_glaciers(glaciers(torch.float64), device="cuda")
    counters = {"si_step": si_kernel.si_step, "sia2d_rhs": sia_kernel.sia2d_rhs}
    launches = {name: 0 for name in counters}
    for name, (params, expected) in rows.items():
        for fn in counters.values():
            fn.launches = 0
        pred = Prediction(model=model, glaciers=glaciers(torch.float32), parameters=params,
                          device="cuda")
        H = run_prediction(pred)["H"]
        torch.cuda.synchronize()
        counted = {k: fn.launches for k, fn in counters.items()}
        if counted != expected:
            raise AssertionError(f"{name}: launches {counted}, expected {expected}")
        for k, v in counted.items():
            launches[k] += v
        if tuple(H.shape) != (N_G, len(tstops), NX, NY) or not torch.isfinite(H).all():
            raise AssertionError(f"{name}: trajectory {tuple(H.shape)} not finite or misshapen")

        plain32 = forward_batch(None, batch32, plain_model, params, tstops, device="cuda")
        plain64 = forward_batch(None, batch64, plain_model, params, tstops, device="cuda")
        torch.cuda.synchronize()
        for fn in counters.values():
            if fn.launches != counted[fn.__name__]:
                raise AssertionError(f"{name}: the plain runs launched a kernel")
        err_kernel = rel_err(H[:, -1], plain64[:, -1])
        err_plain = rel_err(plain32[:, -1], plain64[:, -1])
        row = {
            "phase": "main_path", "row": name, "launches": counted,
            "final_H_rel_err_vs_f64_plain": err_kernel,
            "f32_plain_final_H_rel_err_vs_f64_plain": err_plain,
            "kernel_vs_f32_plain_rel_err": rel_err(H[:, -1], plain32[:, -1]),
            "ms": row_ms(lambda: forward_batch(None, batch32, model, params, tstops, device="cuda")),
            "plain_ms": row_ms(lambda: forward_batch(None, batch32, plain_model, params, tstops,
                                                     device="cuda")),
            "device_busy_ms": device_ms(
                lambda: forward_batch(None, batch32, model, params, tstops, device="cuda"), 1),
            "kernel_device_ms": device_ms(
                lambda: forward_batch(None, batch32, model, params, tstops, device="cuda"), 1,
                ("si_assemble", "si_pcg", "sia2d_rhs_kernel")),
        }
        row["device_idle_share"] = 1.0 - row["device_busy_ms"] / row["ms"]
        emit(row)
        if not err_kernel <= 2.0 * err_plain:
            raise AssertionError(f"{name}: kernel path error {err_kernel} exceeds 2x the "
                                 f"float32 plain path's {err_plain}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from odinn_tpu_torch.ops.cuda.build import build_all

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v[0] for k, v in built.items()},
          "ptxas": {k: [ln for ln in v[1].splitlines() if "registers" in ln or "spill" in ln]
                    for k, v in built.items()}})

    check_kernels()
    timing = time_kernels()
    launches = main_path_rows()
    meta = {
        "si_step": ("odinn_tpu_torch/csrc/si_step.cu", "odinn_tpu/ops/pallas/si_kernel.py:174"),
        "sia2d_rhs": ("odinn_tpu_torch/csrc/sia2d_rhs.cu", "odinn_tpu/ops/pallas/sia_kernel.py:137"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": None, "ms_source": t["ms_source"], "call_ms": t["call_ms"],
         "plain_device_ms": t["plain_device_ms"]}
        for name, t in timing.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
