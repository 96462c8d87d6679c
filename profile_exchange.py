"""Time one cluster-wide exchange round, the step a distributed dot product
of ``csrc/si_step.cu`` repeats twice a PCG iteration, on one CUDA card.

    python3 profile_exchange.py

Builds a small kernel with ``nvcc`` into ``build/``, from the exchange's
own code in ``csrc/cluster_exchange.cuh``, and runs 4 clusters of 8 and of
16 blocks of 512 threads, R rounds each, timed by CUDA events (a round =
(time at 1010 rounds − time at 10) / 1000). A round exchanges the blocks'
partials alone: the z halo rows that ``si_step_cluster`` adds to its r·z
rounds are left out. Variants of a round:

- ``syncthreads``: ``__syncthreads()`` alone;
- ``cluster_barrier``: ``cluster.sync()`` alone;
- ``store_and_barrier``: the block's partial reduced by warp shuffles and
  ``__syncthreads()``, stored into a slot of every block's shared memory by
  plain remote stores, closed by ``cluster.sync()``, then summed in a fixed
  order;
- ``st_async_mbarrier``: ``share_partial`` and ``mbar_wait``, as
  ``si_step_cluster`` calls them: the same partials sent by ``st.async``,
  counted on the receiving block's mbarrier, each block waiting on its own.

Prints one JSON line: the card and its power limit, and microseconds per
round for each variant and cluster size. Without a CUDA card it exits with
code 2 and prints no result.
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
using odinn::fixed_sum;

__global__ void __launch_bounds__(512, 1) kern(int variant, int rounds, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = cluster.num_blocks(), rank = cluster.block_rank();
  const int tid = threadIdx.x, nwarps = blockDim.x / 32;
  __shared__ float warp_part[2][16];
  __shared__ float slots[2][16];
  __shared__ __align__(8) unsigned long long bars[2];
  if (tid == 0) {
    odinn::mbar_init(odinn::smem_u32(&bars[0]));
    odinn::mbar_init(odinn::smem_u32(&bars[1]));
    odinn::mbar_init_fence();
  }
  cluster.sync();
  float acc = tid * 1e-3f + rank;
  for (int it = 0; it < rounds; ++it) {
    const int b = it & 1;
    if (variant == 0) {
      __syncthreads();
      continue;
    }
    if (variant == 1) {
      cluster.sync();
      continue;
    }
    if (variant == 2) {
      float v = acc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if ((tid & 31) == 0) warp_part[b][tid >> 5] = v;
      __syncthreads();
      if (tid < csize) cluster.map_shared_rank(&slots[b][0], tid)[rank] = fixed_sum(warp_part[b], nwarps);
      cluster.sync();
    } else {
      // si_step_cluster's round: rounds alternate between two mbarriers
      const unsigned bar = odinn::smem_u32(&bars[b]);
      odinn::share_partial(acc, warp_part[b], slots[b], bar, 0, tid, nwarps, csize, rank);
      odinn::mbar_wait(bar, (it >> 1) & 1);
    }
    acc = acc * 0.5f + fixed_sum(slots[b], csize) * 1e-6f;
  }
  if (tid == 0) out[blockIdx.x] = acc;
  cluster.sync();
}

// microseconds per launch of 4 clusters, mean of 10 launches; < 0: a CUDA error
extern "C" double run(int variant, int cluster, int rounds) {
  static float* out = nullptr;
  if (!out && cudaMalloc(&out, 4096 * sizeof(float)) != cudaSuccess) return -1.0;
  cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4 * cluster);
  cfg.blockDim = dim3(512);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, kern, variant, rounds, out);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int k = 0; k < 10; ++k) cudaLaunchKernelEx(&cfg, kern, variant, rounds, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? -static_cast<double>(err) : ms * 1e3 / 10.0;
}
"""

VARIANTS = ("syncthreads", "cluster_barrier", "store_and_barrier", "st_async_mbarrier")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_exchange: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from odinn_tpu_torch.ops.cuda.build import BUILD_DIR, SRC_DIR, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = BUILD_DIR / "profile_exchange.cu", BUILD_DIR / "libprofile_exchange.so"
    src.write_text(SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(SRC_DIR), "-o", str(lib_path),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.restype = ctypes.c_double
    lib.run.argtypes = [ctypes.c_int] * 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    us = {}
    for v, name in enumerate(VARIANTS):
        for cluster in (8, 16):
            short, long_ = lib.run(v, cluster, 10), lib.run(v, cluster, 1010)
            if short < 0 or long_ < 0:
                raise RuntimeError(f"{name} at {cluster} blocks failed with CUDA error "
                                   f"{-min(short, long_):.0f}")
            us[f"{name} {cluster} blocks"] = (long_ - short) / 1000.0
    print(json.dumps({"nvidia_smi": smi, "us_per_round": us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
