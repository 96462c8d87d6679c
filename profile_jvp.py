"""Time the RHS tangent kernel (``csrc/sia2d_rhs_jvp.cu``) on each of its
plans, on one CUDA card.

    python3 profile_jvp.py [--variants]

At the shapes ``chip_smoke.py`` times it (float32: 16 x 128^2 in the plain
mode and in the RKC tangent's stage mode at s = 8, 4 x 128^2; float64: the
LM gates' 2 x 36^2), the profiler's device time per launch of the kernel
on every plan of ``sia_kernel.jvp_layout`` (R = 1, 2, 4 rows a thread,
16-byte loads, and the plan's R with loads of one value), the plan the
wrapper picks marked, each checked against the plain version first. The
plans are timed twice, in turns (the plans, then the same in reverse
order). With ``--variants``, the source is also built with a phase left out
and timed on every plan at 16 x 128^2 (plain mode): ``-corners`` (each
corner's D and tangent replaced by its H-bar and tangent), ``-cells`` (no
edge's flux: each replaced by a value of the ring), ``-corners-cells``
both, ``launch`` (a block returns at once: the launch of that grid); these
compute wrong results and are only timed; and a ``trace`` variant, whose
blocks record the global timer at each phase's end, gives each plan's
timeline of one launch. Prints one JSON line: the card's name and power
limit, the kernel's ptxas lines, the plans, microseconds per launch and
the single-launch floor (a one-element fill). Without a CUDA card it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (tag, shape, float64, stage mode)
SHAPES = (("16x128x128", (16, 128, 128), False, False),
          ("16x128x128 stage s=8", (16, 128, 128), False, True),
          ("4x128x128", (4, 128, 128), False, False),
          ("2x36x36 float64", (2, 36, 36), True, False))
STAGES = 8
# a variant's text substitutions in the source
_SKIP = {
    "corners": (("corner_tangent(g, hb, thb, k, dcreep, e, D, dD);",
                 "D = hb;\n        dD = thb;"),),
    "cells": (("fx[q] = x_flux(t, grp * R + q + 1, x, lane, k, eta_dx);",
               "fx[q] = t.s[grp * R + q + 1][x];"),
              ("fw[q] = y_flux(t, grp * R + q + 1, x, lane, k, eta_dy);",
               "fw[q] = t.h[grp * R + q + 1][x];"),
              ("last = y_flux(t, grp * R + lane + 1, P::kPad + 1 + kLanes, kLanes, k, eta_dy);",
               "last = T(1);")),
    "launch": (("  __shared__ Tile<T, R> tile;\n",
                "  if (p.nx > 0) return;\n  __shared__ Tile<T, R> tile;\n"),),
}
VARIANTS = {"-corners": ("corners",), "-cells": ("cells",),
            "-corners-cells": ("corners", "cells"), "launch": ("launch",)}
# the trace variant: thread 0 of each block records the global timer at the
# block's start (0), when its loads have arrived (1), after the first
# barrier (2), after its corners (3), after the second barrier (4) and
# after its stores are issued (5), and its SM (6)
_TRACE = (
    ('#include "sia_common.cuh"\n',
     '#include "sia_common.cuh"\n__device__ unsigned long long g_trace[1 << 16][8];\n'
     '#define TR(k) do { if (threadIdx.x == 0) { unsigned long long t_; '
     'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
     'g_trace[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][k] = t_; } '
     '} while (0)\n'),
    ("  __shared__ Own<T, R, kStage> own;\n",
     "  __shared__ Own<T, R, kStage> own;\n  TR(0);\n  if (threadIdx.x == 0) { unsigned s_; "
     'asm volatile("mov.u32 %0, %%smid;" : "=r"(s_)); '
     "g_trace[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][6] = s_; }\n"),
    ("  in.stage_ring(tile, own, threadIdx.x);\n  __syncthreads();\n",
     "  in.stage_ring(tile, own, threadIdx.x);\n  TR(1);\n  __syncthreads();\n  TR(2);\n"),
    ("  __syncthreads();\n\n  // A warp's cells", "  TR(3);\n  __syncthreads();\n  TR(4);\n\n"
     "  // A warp's cells"),
    ("    }\n  }\n}\n\n// The block's loads are issued first",
     "    }\n  }\n  TR(5);\n}\n\n// The block's loads are issued first"),
)
_TRACE_READ = """
extern "C" int read_trace(unsigned long long* out, int blocks) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_trace, blocks * 8 * sizeof(long long)));
}
"""


def _variant_libraries(build_dir):
    """The current source built with phases left out (VARIANTS), all nvcc
    processes at once; {variant: library}."""
    from odinn_tpu_torch.ops.cuda import sia_kernel
    from odinn_tpu_torch.ops.cuda.build import SRC_DIR, nvcc_command

    text = (SRC_DIR / "sia2d_rhs_jvp.cu").read_text()
    procs = {}
    for name, skips in dict(VARIANTS, trace=()).items():
        src = text
        for old, new in [sub for key in skips for sub in _SKIP[key]] + (
                list(_TRACE) if name == "trace" else []):
            assert old in src, (name, old)
            src = src.replace(old, new)
        if name == "trace":
            src += _TRACE_READ
        path = build_dir / f"jvp{name}.cu"
        path.write_text(src)
        lib = build_dir / f"libjvp{name}.so"
        cmd = nvcc_command("sia2d_rhs_jvp", lib)
        cmd[-1] = str(path)
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        L = ctypes.CDLL(str(lib))
        L.sia2d_rhs_jvp_f32.argtypes = sia_kernel.JVP_ARGTYPES
        L.sia2d_rhs_jvp_f32.restype = ctypes.c_int
        if name == "trace":
            L.read_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
            L.read_trace.restype = ctypes.c_int
        libs[name] = L
    return libs


def _trace(torch, L, lay, run):
    """One traced launch after a warm-up: the launch's span, each phase's
    mean and largest length over the blocks, the blocks' start and end
    offsets from the first start (percentiles), and blocks per SM; ns."""
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    blocks = lay.grid[0] * lay.grid[1] * lay.grid[2]
    buf = torch.zeros((blocks, 8), dtype=torch.int64)
    err = L.read_trace(buf.data_ptr(), blocks)
    if err:
        raise RuntimeError(f"read_trace failed with CUDA error {err}")
    t = buf[:, :6].double()
    t0 = t[:, 0].min()
    q = torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=torch.float64)
    phases = ("loads", "barrier_1", "corners", "barrier_2", "cells_and_stores")
    d = t[:, 1:] - t[:, :-1]
    per_sm = torch.bincount(buf[:, 6], minlength=132).double()
    return {"span_ns": float(t[:, 5].max() - t0),
            "start_ns_q": torch.quantile(t[:, 0] - t0, q).tolist(),
            "end_ns_q": torch.quantile(t[:, 5] - t0, q).tolist(),
            "phase_mean_ns": dict(zip(phases, d.mean(0).tolist())),
            "phase_max_ns": dict(zip(phases, d.max(0).values.tolist())),
            "blocks_per_sm": [float(per_sm.min()), float(per_sm.max())]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_jvp: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda import rkc_kernel, sia_kernel
    from odinn_tpu_torch.ops.cuda.build import BUILD_DIR, build_all

    built = build_all(["sia2d_rhs_jvp"])
    build_dir = BUILD_DIR / "profile_jvp"
    build_dir.mkdir(parents=True, exist_ok=True)
    variants = _variant_libraries(build_dir) if "--variants" in sys.argv else {}
    phys = PhysicalParameters()
    result = {"nvidia_smi": cs.nvidia_smi(),
              "ptxas": {k: cs.ptxas_summary(v[1]) for k, v in built.items()},
              "plans": {}, "us": {}, "rel_err": {}}
    names = ("sia2d_rhs_jvp_kernel",)
    for tag, shape, f64, stage in SHAPES:
        dtype = torch.float64 if f64 else torch.float32
        H, B, raw = cs.kernel_inputs(*shape, dtype, seed=sum(shape) + 3)
        table = sia_kernel.derive_table(raw, phys.rho, phys.g).to(dtype).contiguous()
        d_creep = (0.1 * table[:, 2]).contiguous()
        gen = torch.Generator().manual_seed(sum(shape) + 4)
        dY, dH0, dY2, df0 = (torch.randn(shape, generator=gen, dtype=torch.float64)
                             .to("cuda", dtype) for _ in range(4))
        weights = None
        if stage:
            dt = cs.DT * (STAGES / cs.RKC_STAGES) ** 2
            weights = rkc_kernel._stage_weights(STAGES, dtype, dt)[1][5]
        plan = sia_kernel.jvp_layout(*shape, dtype)
        layouts = {f"R={r}": sia_kernel.jvp_layout(*shape, dtype, rows=r)
                   for r in sia_kernel.JVP_ROWS}
        layouts[f"R={plan.rows} scalar"] = sia_kernel.jvp_layout(*shape, dtype, vec=False,
                                                                 rows=plan.rows)
        result["plans"][tag] = {"picked": f"R={plan.rows}",
                                **{k: v._asdict() for k, v in layouts.items()}}

        def call(fn):
            if stage:
                return fn(dY, H, B, table, d_creep, phys.eta0,
                          stage=(dH0, dY2, df0, weights), keep_f=False)[0]
            return fn(dY, H, B, table, d_creep, phys.eta0)

        want = call(sia_kernel.sia2d_rhs_jvp_reference)
        runs = {k: (lambda lay=lay: call(functools.partial(sia_kernel._jvp_launch, layout=lay)))
                for k, lay in layouts.items()}
        if variants and tag == SHAPES[0][0]:
            out = torch.empty_like(H)
            for name, L in variants.items():
                for r in sia_kernel.JVP_ROWS:
                    lay = layouts[f"R={r}"]

                    def run_variant(L=L, lay=lay):
                        err = L.sia2d_rhs_jvp_f32(
                            dY.data_ptr(), H.data_ptr(), B.data_ptr(), table.data_ptr(),
                            d_creep.data_ptr(), None, None, None, out.data_ptr(), None, *shape,
                            lay.rows, int(lay.width > 1), float(phys.eta0), *(0.0,) * 5, 0,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"variant failed with CUDA error {err}")
                        return out

                    if name == "trace":
                        result.setdefault("trace", {})[f"R={r}"] = _trace(torch, L, lay,
                                                                           run_variant)
                    else:
                        runs[f"{name} R={r}"] = run_variant
        for k, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            if k[0] not in "-l":           # the variants compute no tangent
                result["rel_err"][f"{tag} {k}"] = cs.rel_err(got, want)
        order = list(runs) + list(runs)[::-1]
        for k in order:
            us = cs.device_ms(runs[k], 200, names) * 1e3
            result["us"].setdefault(f"{tag} {k}", []).append(us)
    one = torch.empty(1, device="cuda")
    result["floor_us"] = cs.device_ms(lambda: one.fill_(1.0), 200) * 1e3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
