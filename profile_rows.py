"""Time the row PCG's kernels (``csrc/si_rows.cu``) beside the floors of
their launch shape, on one CUDA card.

    python3 profile_rows.py [--reps N]

At a rank's 16 x 66 x 128 float32 slab (own rows [0, 64), the shape of
``chip_smoke.py``'s rows entries) and at half a 1024^2 plane (4 x 516 x
1024, own rows [2, 514)), the profiler's device time per launch of:

- ``si_rows_apply`` in its start and iteration modes and ``si_rows_update``
  (Jacobi), through the wrappers, on the plan of ``rows_layout``;
- floors, from a small kernel built here with the same grid, threads and
  shared memory as the kernels' plan: ``empty`` (no cluster, no work),
  ``cluster`` (the same blocks in clusters, no work) and ``cluster_sum``
  (the clusters and the kernels' own fixed-order sum,
  ``csrc/cluster_exchange.cuh``'s ``cluster_sum``, of one value a thread).

Prints one JSON line: the card and its power limit, the plans, and
microseconds per launch. Without a CUDA card it exits with code 2 and
prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cooperative_groups.h>

#include "cluster_exchange.cuh"

namespace cg = cooperative_groups;

// variant 0: nothing; 1: nothing, in clusters; 2: the clusters' fixed-order
// sum, with si_rows.cu's shared memory head (the mbarrier, 8 slots, the
// warps' partials)
__global__ void __launch_bounds__(512) rows_floor(int variant, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (variant < 2) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = cluster.num_blocks(), rank = cluster.block_rank();
  const unsigned bar = odinn::smem_u32(smem);
  float* slots = reinterpret_cast<float*>(smem + 16);
  odinn::cluster_sum_begin(bar, rank, csize, sizeof(float));
  odinn::cluster_sum(threadIdx.x * 1e-3f + rank, slots, slots + 8, bar, rank, csize,
                     out + blockIdx.x / csize);
}

extern "C" int floor_launch(int variant, int n_g, int cluster, int threads, int smem, float* out,
                            void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_g * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = variant == 0 ? 1 : cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rows_floor, variant, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
"""

SLABS = (((16, 66, 128), (0, 64)), ((4, 516, 1024), (2, 514)))
FLOORS = ("empty", "cluster", "cluster_sum")


def _build(nvcc, src, lib_path, include):
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(include), "-o", str(lib_path),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib_path))


def _kernel_times(torch, cs, si_kernel, si_math, shape, own, reps):
    """Device µs per launch of the row kernels at a float32 slab, from the
    plain assembly and start."""
    from odinn_tpu_torch.core.params import PhysicalParameters
    from odinn_tpu_torch.ops.cuda.common import derived_scalars, shared_exps

    phys = PhysicalParameters()
    f32 = torch.float32
    r0, r1 = own
    H, B, raw = cs.kernel_inputs(*shape, f32, seed=64)
    derived = derived_scalars(*(raw[:, k] for k in range(7)), phys.rho, phys.g)
    table = derived[:, :4].to(f32).contiguous()
    work = torch.zeros((si_math.ROWS_PLANES,) + shape, dtype=f32, device="cuda")
    si_kernel.si_assemble_reference(work, H, H, B, H, derived, cs.DT, 1.0, 0, True,
                                    shared_exps(derived))
    x0 = (1.01 * H).contiguous()
    si_kernel.si_rows_apply_reference(work, x0, None, si_math.ROWS_P2, si_math.ROWS_P, r0, r1,
                                      table, cs.DT, True)
    gen = torch.Generator().manual_seed(65)
    beta = (0.3 * torch.rand(shape[0], generator=gen, dtype=torch.float64)).to("cuda", f32)
    alpha = (0.2 * torch.rand(shape[0], generator=gen, dtype=torch.float64)).to("cuda", f32)
    P, P2 = si_math.ROWS_P, si_math.ROWS_P2
    calls = {
        "si_rows_apply start": (lambda: si_kernel.si_rows_apply(
            work, x0, None, P2, P, r0, r1, table, cs.DT, True), "si_rows_apply"),
        "si_rows_apply": (lambda: si_kernel.si_rows_apply(
            work, None, beta, P2, P, r0, r1, table, cs.DT, False), "si_rows_apply"),
        "si_rows_update": (lambda: si_kernel.si_rows_update(work, alpha, P, r0, r1),
                           "si_rows_update"),
    }
    return {name: cs.device_ms(fn, reps, (kernel,)) * 1e3 for name, (fn, kernel) in calls.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_rows: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from odinn_tpu_torch.ops import si_math
    from odinn_tpu_torch.ops.cuda import si_kernel
    from odinn_tpu_torch.ops.cuda.build import BUILD_DIR, SRC_DIR, _nvcc, build_all

    args = sys.argv[1:]
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 200
    build_all(["si_rows"])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "profile_rows.cu"
    src.write_text(SOURCE)
    floor_lib = _build(_nvcc(), src, BUILD_DIR / "libprofile_rows.so", SRC_DIR)
    floor_lib.floor_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    floor_lib.floor_launch.restype = ctypes.c_int
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = torch.empty(4096, device="cuda")
    result = {"nvidia_smi": smi, "reps": reps, "plans": {}, "us": {}}
    for shape, own in SLABS:
        tag = "x".join(map(str, shape))
        lay = si_kernel.rows_layout(*shape, *own, torch.float32)
        result["plans"][tag] = lay._asdict()
        stream = torch.cuda.current_stream().cuda_stream
        for v, name in enumerate(FLOORS):
            def launch(v=v):
                err = floor_lib.floor_launch(v, shape[0], lay.cluster, lay.threads, lay.smem,
                                             out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"rows_floor {v} failed with CUDA error {err}")
            result["us"][f"{tag} floor {name}"] = cs.device_ms(launch, reps, ("rows_floor",)) * 1e3
        for k, us in _kernel_times(torch, cs, si_kernel, si_math, shape, own, reps).items():
            result["us"][f"{tag} {k}"] = us
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
