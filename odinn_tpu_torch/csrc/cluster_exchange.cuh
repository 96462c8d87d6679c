// The cluster-wide exchange of si_step.cu's PCG dot products, in PTX
// (PTX ISA 8.0, sm_90): the split cluster barrier, distributed shared
// memory addresses, st.async stores counted on the receiving block's
// mbarrier, and the fixed-order sums that make every block's total
// bit-identical. profile_exchange.py times one round of it; si_rows.cu's
// kernels sum through cluster_sum, which profile_rows.py times alone.
#pragma once

#include <cuda_runtime.h>

namespace odinn {

// The split cluster barrier: arrive without ordering memory (the mbarrier
// initialisation is released by its own fence), then wait; every thread of
// the cluster arrives once.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A shared-memory address as a 32-bit shared-window address, and the same
// address in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned mapa(unsigned local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

// An mbarrier with one arrival a phase: the block's own arrive.expect_tx,
// which adds the phase's bytes; st.async stores count their bytes off.
// After initialising a block's mbarriers, one thread releases them to the
// cluster with mbar_init_fence().
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Store v at the remote shared address raddr and count its bytes on the
// remote mbarrier rbar.
__device__ __forceinline__ void st_async(unsigned raddr, float v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(raddr), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned raddr, double v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(raddr), "l"(__double_as_longlong(v)), "r"(rbar) : "memory");
}
// Wait until the phase of parity `parity` of the block's mbarrier `bar` has
// completed; acquire at cluster scope, so the st.async data it counted is
// visible.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// The sum of v over the warp's lanes by a fixed shuffle tree, in lane 0.
template <typename T>
__device__ __forceinline__ T warp_tree(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v[0 .. 15] as a fixed tree.
template <typename T>
__device__ __forceinline__ T tree16(T (&v)[16]) {
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) {
#pragma unroll
    for (int b = 0; b < w; ++b) v[b] += v[b + w];
  }
  return v[0];
}

// The sum of a[0 .. n-1] (n <= 16) in a fixed order.
template <typename T>
__device__ __forceinline__ T fixed_sum(const T* a, int n) {
  T v[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) v[b] = b < n ? a[b] : T(0);
  return tree16(v);
}

// The block's share of one exchange round: the thread's partial v is
// summed by warp shuffles, the warps' partials (at most 16) land in
// warp_part, and after one __syncthreads() threads 0 .. csize-1 each sum
// them (the same value in each) and send it to slot `rank` of block tid's
// `slots`, counted on block tid's mbarrier `bar`. Thread 0 arms the block's
// own `bar` for the round: csize partials and `extra` more values. The
// round ends when the block's mbar_wait on `bar` returns; then
// fixed_sum(slots, csize) is the same in every block.
template <typename T>
__device__ __forceinline__ void share_partial(T v, T* warp_part, T* slots, unsigned bar,
                                              int extra, int tid, int nwarps, int csize,
                                              int rank) {
  v = warp_tree(v);
  if ((tid & 31) == 0) warp_part[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) mbar_expect(bar, (csize + extra) * static_cast<int>(sizeof(T)));
  if (tid < csize) {
    st_async(mapa(smem_u32(slots + rank), tid), fixed_sum(warp_part, nwarps), mapa(bar, tid));
  }
}

// A cluster's sum of one value a thread into one place, in a fixed order
// (si_rows.cu): each block sums its threads' values by warp_tree, then its
// warps' partials (at most 32, in warp_part) by warp_tree again; block
// `rank` sends its total to slot `rank` of block 0's `slots` (at least
// csize <= 32 of them) over distributed shared memory, counted on block 0's
// mbarrier `bar`, and block 0 sums the slots by warp_tree into *out. No
// atomics: a rerun is bitwise the same. cluster_sum_begin, called by every
// thread once before cluster_sum, arms block 0's `bar` for the csize totals
// of `bytes` each and arrives on the split cluster barrier, on which
// cluster_sum waits (so block 0 has armed it) before any store.
__device__ __forceinline__ void cluster_sum_begin(unsigned bar, int rank, int csize, int bytes) {
  if (rank == 0 && threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init_fence();
    mbar_expect(bar, csize * bytes);
  }
  cluster_arrive_relaxed();
}
template <typename T>
__device__ __forceinline__ void cluster_sum(T v, T* slots, T* warp_part, unsigned bar, int rank,
                                            int csize, T* out) {
  v = warp_tree(v);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) warp_part[tid >> 5] = v;
  __syncthreads();
  cluster_wait();
  if (tid < 32) {
    const T total = warp_tree(tid < static_cast<int>(blockDim.x >> 5) ? warp_part[tid] : T(0));
    if (tid == 0) st_async(mapa(smem_u32(slots + rank), 0), total, mapa(bar, 0));
    if (rank == 0) {
      mbar_wait(bar, 0);
      const T sum = warp_tree(tid < csize ? slots[tid] : T(0));
      if (tid == 0) *out = sum;
    }
  }
}

}  // namespace odinn
