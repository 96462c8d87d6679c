"""Time the large-plane SI path (``si_assemble``, then ``si_pcg``) beside
the floors of its launch shapes, on one CUDA card.

    python3 profile_plane.py [--reps N]

Float32 throughout, the profiler's device time per call of:

- ``si_assemble`` alone, through its wrapper, at a rows-axis rank's
  16 x 66 x 128 slab and at 1 x 1024^2 (the forward mode, Jacobi), on the
  plan the wrapper picks (``si_kernel.assemble_plan``) and on every other
  instantiated plan (``R=``, rows a thread);
- the whole large-plane ``si_step`` (assembly and PCG) at 2 x 300^2
  PCG-6, 1 x 1024^2 PCG-6 and PCG-12 (and the transpose solve at
  PCG-12) and 1 x 2048^2 PCG-12, each with ``bound_ms`` as
  ``chip_smoke.py`` counts it;
- the floors of each launch shape, from a small kernel built here:
  ``empty`` (the PCG's blocks and threads, no work), ``grid_sync`` (the
  same blocks launched cooperatively, 2 x cg_iters grid barriers and
  nothing else), and ``assemble_empty`` (the assembly's grid of tiles, no
  work).

It also prints the plans and the ptxas registers and spills of every
``si_assemble`` and ``si_pcg`` instance. One JSON line; without a CUDA
card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// barriers < 0: nothing; else that many grid barriers
__global__ void plane_floor(int barriers) {
  if (barriers < 0) return;
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < barriers; ++k) grid.sync();
}

extern "C" int floor_launch(int barriers, int blocks, int threads, int cooperative,
                            void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, plane_floor, barriers);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""

# (n_g, nx, ny, PCG iterations, mode): the large-plane steps timed
STEPS = ((2, 300, 300, 6, "forward"), (1, 1024, 1024, 6, "forward"),
         (1, 1024, 1024, 12, "forward"), (1, 1024, 1024, 12, "transpose"),
         (1, 2048, 2048, 12, "forward"))
ASSEMBLIES = ((16, 66, 128), (1, 1024, 1024))


def _build(nvcc, src, lib_path):
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_plane: no CUDA device available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 50
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops import si_math
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.build import BUILD_DIR, _nvcc, build_all
    from odinn_tpu_torch.ops.cuda.common import derived_scalars

    built = build_all(["si_plane"])
    ptxas = {k: v for k, v in cs.ptxas_summary(built.get("si_plane", (0, ""))[1]).items()
             if k.startswith(("si_assemble", "si_pcg"))}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "profile_plane.cu"
    src.write_text(SOURCE)
    floor_lib = _build(_nvcc(), src, BUILD_DIR / "libprofile_plane.so")
    floor_lib.floor_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    floor_lib.floor_launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phys = PhysicalParameters()
    f32 = torch.float32
    exps = (5.0, 2.0, 4.0, 2.0)
    result = {"nvidia_smi": smi, "source": "odinn_tpu_torch/csrc/si_plane.cu",
              "reps": reps, "ptxas": ptxas, "plans": {}, "ms": {}, "call_ms": {}, "bound_ms": {},
              "floor_ms": {}}

    def floor(name, barriers, blocks, threads, cooperative):
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = floor_lib.floor_launch(barriers, blocks, threads, cooperative, stream)
            if err:
                raise RuntimeError(f"plane_floor failed with CUDA error {err}")
        result["floor_ms"][name] = cs.device_ms(launch, reps, ("plane_floor",))

    def inputs(shape, seed):
        H, B, raw = cs.kernel_inputs(*shape, f32, seed=seed)
        return H, B, derived_scalars(*(raw[:, k] for k in range(7)), phys.rho, phys.g)

    for shape in ASSEMBLIES:
        tag = "x".join(map(str, shape))
        H, B, derived = inputs(shape, 64)
        work = torch.zeros((si_math.ROWS_PLANES,) + shape, dtype=f32, device="cuda")
        call = lambda: si_kernel.si_assemble(work, H, H, B, H, derived, cs.DT, 1.0, 0, True, exps)
        name = f"si_assemble {tag}"
        result["ms"][name] = cs.device_ms(call, reps, ("si_assemble",))
        result["call_ms"][name] = cs.cuda_ms(call, reps)
        result["bound_ms"][name] = cs.bound_ms(*cs.assemble_bound(*shape, 4), f32)
        lay = si_kernel.assemble_plan(*shape, f32)
        result["plans"][name] = lay._asdict()
        floor(f"{name} assemble_empty", -1, lay.grid[0] * lay.grid[1] * lay.grid[2],
              lay.threads, 0)
        # every other instantiated plan of the assembly, on the same call
        chosen = si_kernel.assemble_plan
        for r in si_kernel.ASM_ROWS:
            if r == lay.rows:
                continue
            other = lay._replace(rows=r, tile_rows=si_kernel.ASM_GROUPS * r,
                                 grid=(lay.grid[0], -(-shape[1] // (si_kernel.ASM_GROUPS * r)),
                                       lay.grid[2]))
            si_kernel.assemble_plan = lambda *a, other=other, **k: other
            try:
                result["ms"][f"{name} R={r}"] = cs.device_ms(call, reps, ("si_assemble",))
            finally:
                si_kernel.assemble_plan = chosen
    for n_g, nx, ny, it, mode in STEPS:
        shape = (n_g, nx, ny)
        tag = "x".join(map(str, shape))
        if si_kernel.si_plan(*shape, f32).layout is not None:
            raise AssertionError(f"{tag} should take the large-plane path")
        H, B, derived = inputs(shape, 13)
        name = f"si_step {mode} {tag} cg_iters={it}"
        if mode == "forward":
            call = lambda: si_kernel.si_step(H, H, B, H, derived, cs.DT, 1.0, it, exps)
            bound = cs.si_bound(*shape, 4, it)
        else:
            g = torch.randn(shape, generator=torch.Generator().manual_seed(16)).to("cuda")
            x = (H - 20.0).contiguous()
            call = lambda: si_kernel.si_step_transpose(g, x, H, B, derived, cs.DT, 1.0, it, exps)
            bound = cs.si_transpose_bound(*shape, 4, it)
        result["ms"][name] = cs.device_ms(call, reps, ("si_assemble", "si_pcg"))
        result["call_ms"][name] = cs.cuda_ms(call, reps)
        result["bound_ms"][name] = cs.bound_ms(*bound, f32)
        lay = si_kernel.plane_plan(*shape, f32)
        result["plans"][name] = lay._asdict()
        floor(f"{name} empty", -1, lay.blocks, lay.threads, 0)
        floor(f"{name} grid_sync", 2 * it, lay.blocks, lay.threads, 1)
        del H, B, derived
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
