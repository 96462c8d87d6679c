// One s-stage RKC2 step of length dt for a batch of glaciers (A target,
// per-glacier scalar laws), in one launch.
//
// Replaces the TPU kernel odinn_tpu/ops/pallas/rkc_kernel.py::
// rkc_interval_pallas (pallas_call in _forward), which kept H, B and the
// three stage carries of a block of glaciers in VMEM for all s stages.
// Plain PyTorch version: ops/cuda/rkc_kernel.py::rkc_interval_reference.
//
//   f0 = f(H),  y1 = H + (mu1~ dt) f0
//   yj = (1 - mu_j - nu_j) H + mu_j y(j-1) + nu_j y(j-2)
//        + (mu~_j dt) f(y(j-1)) + (gamma~_j dt) f0,   j = 2..s
//
// with f the fused SIA2D right-hand side (sia_common.cuh, the arithmetic of
// sia2d_rhs.cu), the per-glacier table (n_g, 4) = (dx, dy, creep, slide),
// the batch's exponents as arguments, and the coefficient table (5, s+1)
// rows mu, nu, mu~, gamma~, mu1~ in the planes' dtype, built once per
// (s, dtype) by the wrapper.
//
// What bounds it on the H100: operations. The step reads H and B once and
// writes H' once (3 planes, 0.79 MB at 4 x 128^2 float32, 0.23 us at
// 3.35 TB/s), while each stage forms the four corner diffusivities and the
// fluxes of every cell (~100 flops a cell), s times.
//
// Design: one thread-block cluster of 8 blocks per glacier. Each stage needs
// the whole plane's previous stage with a one-row halo, and H, B, f0 and the
// two stage carries of a 128^2 float64 plane are 5 x 128 KB, more than one
// block's 227 KB of shared memory. Block `rank` of the cluster owns rows
// [rank*rows, rank*rows + rows) and keeps them in shared memory with a halo
// row above and below: B (halo loaded once from device memory), H, f0, two
// alternating stage buffers and the corner diffusivities of the stage. At
// the start of each stage, after a cluster barrier, each block copies its
// neighbours' boundary rows of the previous stage into its halo through
// distributed shared memory, forms each corner diffusivity its rows touch
// once, then forms the new stage on its own rows into the buffer that held
// y(j-2). One cluster barrier per stage orders every write before the
// neighbours' reads and every read before the buffer is overwritten two
// stages later. H and B are read from device memory once and H' written
// once, as on the TPU. With `stages` non-null the kernel also writes
// y1 .. y(s-1) to it (the backward's rematerialisation). Sizes above what
// shared memory holds are refused by the wrapper (check_rkc_shape in
// ops/cuda/rkc_kernel.py, the same 6 slabs of rows/8 + 2 rows).
#include <cooperative_groups.h>

#include "sia_common.cuh"

namespace cg = cooperative_groups;

namespace {

using odinn::Patch;
using odinn::Scalars;

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kSlabs = 6;   // B, H, f0, two stage buffers, corner diffusivities

int rows_per_block(int nx) { return (nx + kCluster - 1) / kCluster; }

long smem_bytes(int nx, int ny, int itemsize) {
  return static_cast<long>(kSlabs) * (rows_per_block(nx) + 2) * ny * itemsize;
}

// The corner diffusivities of the corner rows [row0-1, row0+nrows-1] (those
// around the block's own cells) from the stage buffer Y with its halo rows
// filled: corner (a, c) at Ds[(a - row0 + 1)*ny + c], formed from the cells
// (a..a+1, c..c+1).
template <typename T>
__device__ __forceinline__ void form_corners(const T* Y, const T* Bs, T* Ds,
                                             int row0, int nrows, int nx,
                                             int ny, const Scalars<T>& k) {
  for (int idx = threadIdx.x; idx < (nrows + 1) * (ny - 1); idx += blockDim.x) {
    const int lc = idx / (ny - 1), c = idx - lc * (ny - 1);
    const int a = row0 - 1 + lc;
    if (a < 0 || a > nx - 2) continue;
    const int i0 = lc * ny + c, i1 = (lc + 1) * ny + c;
    const T h00 = odinn::relu(Y[i0]), h01 = odinn::relu(Y[i0 + 1]);
    const T h10 = odinn::relu(Y[i1]), h11 = odinn::relu(Y[i1 + 1]);
    Ds[lc * ny + c] = odinn::stag_D(h00, h10, h01, h11, Bs[i0] + h00, Bs[i1] + h10,
                                    Bs[i0 + 1] + h01, Bs[i1 + 1] + h11, k);
  }
}

// dH/dt at own row li (1-based in the slab, global row gi), column j, from
// the stage buffer Y with its halo rows filled and the stage's corner
// diffusivities; 0 on the ring.
template <typename T>
__device__ __forceinline__ T stage_rhs(const T* Y, const T* Bs, const T* Ds,
                                       int li, int gi, int j, int nx, int ny,
                                       const Scalars<T>& k, T eta0) {
  if (gi == 0 || j == 0 || gi == nx - 1 || j == ny - 1) return T(0);
  Patch<T> p;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int idx = (li - 1 + a) * ny + (j - 1 + c);
      p.h[a][c] = odinn::relu(Y[idx]);
      p.s[a][c] = Bs[idx] + p.h[a][c];
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) p.d[a][c] = Ds[(li - 1 + a) * ny + (j - 1 + c)];
  }
  return odinn::rhs_cell(p, k, eta0);
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
rkc_interval_kernel(const T* __restrict__ H, const T* __restrict__ B,
                    const T* __restrict__ table, const T* __restrict__ coef,
                    T* __restrict__ out, T* __restrict__ stages, int n_g,
                    int nx, int ny, int s, T dt, T eta0, T e_hc, T e_sc,
                    T e_hs, T e_ss) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int glacier = blockIdx.x / kCluster;
  const int rows = (nx + kCluster - 1) / kCluster;
  const int row0 = rank * rows;
  const int nrows = max(0, min(rows, nx - row0));
  const long plane = static_cast<long>(nx) * ny;
  const long goff = static_cast<long>(glacier) * plane;
  const long stage_stride = static_cast<long>(n_g) * plane;

  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int slab = (rows + 2) * ny;
  T* Bs = sm;
  T* Hs = sm + slab;
  T* F0 = sm + 2 * slab;
  T* Y[2] = {sm + 3 * slab, sm + 4 * slab};
  T* Ds = sm + 5 * slab;

  const T* trow = table + 4L * glacier;   // (n_g, 4): dx, dy, creep, slide
  const Scalars<T> k{trow[0], trow[1], trow[2], trow[3], e_hc, e_sc, e_hs, e_ss};
  const int tid = threadIdx.x;
  const int own = nrows * ny;

  // B with its halo rows; H into Hs and Y[0] (y0 = H)
  for (int idx = tid; idx < (nrows + 2) * ny; idx += blockDim.x) {
    const int li = idx / ny, j = idx - li * ny;
    const int gi = row0 - 1 + li;
    const bool in = gi >= 0 && gi < nx;
    const long gidx = goff + static_cast<long>(gi) * ny + j;
    Bs[idx] = in ? B[gidx] : T(0);
    if (li >= 1 && li <= nrows) {
      const T h = H[gidx];
      Hs[idx] = h;
      Y[0][idx] = h;
    } else {
      Y[0][idx] = T(0);
      Y[1][idx] = T(0);
    }
  }

  // halo rows of stage buffer Yb from the neighbours' own rows
  auto exchange = [&](T* Yb) {
    if (nrows == 0) return;
    if (row0 > 0) {
      const T* up = cluster.map_shared_rank(Yb, rank - 1);
      for (int j = tid; j < ny; j += blockDim.x) Yb[j] = up[rows * ny + j];
    }
    if (row0 + nrows < nx) {
      const T* down = cluster.map_shared_rank(Yb, rank + 1);
      for (int j = tid; j < ny; j += blockDim.x) Yb[(nrows + 1) * ny + j] = down[ny + j];
    }
  };

  cluster.sync();
  exchange(Y[0]);
  __syncthreads();
  form_corners(Y[0], Bs, Ds, row0, nrows, nx, ny, k);
  __syncthreads();
  {
    const T mu1dt = coef[4 * (s + 1)] * dt;
    for (int c = tid; c < own; c += blockDim.x) {
      const int li = c / ny + 1, j = c - (li - 1) * ny;
      const int idx = li * ny + j;
      const int gi = row0 + li - 1;
      const T f = stage_rhs(Y[0], Bs, Ds, li, gi, j, nx, ny, k, eta0);
      F0[idx] = f;
      const T y = Hs[idx] + mu1dt * f;
      Y[1][idx] = y;
      const long gidx = goff + static_cast<long>(gi) * ny + j;
      if (stages != nullptr) stages[gidx] = y;
      if (s == 1) out[gidx] = y;
    }
  }
  for (int st = 2; st <= s; ++st) {
    T* prev = Y[(st - 1) & 1];
    T* next = Y[st & 1];   // holds y(st-2) until overwritten cell by cell
    cluster.sync();
    exchange(prev);
    __syncthreads();
    form_corners(prev, Bs, Ds, row0, nrows, nx, ny, k);
    __syncthreads();
    const T mu = coef[st], nu = coef[(s + 1) + st];
    const T mutdt = coef[2 * (s + 1) + st] * dt;
    const T gamdt = coef[3 * (s + 1) + st] * dt;
    const T a = T(1) - mu - nu;
    for (int c = tid; c < own; c += blockDim.x) {
      const int li = c / ny + 1, j = c - (li - 1) * ny;
      const int idx = li * ny + j;
      const int gi = row0 + li - 1;
      const T f = stage_rhs(prev, Bs, Ds, li, gi, j, nx, ny, k, eta0);
      const T y = a * Hs[idx] + mu * prev[idx] + nu * next[idx] + mutdt * f
                + gamdt * F0[idx];
      next[idx] = y;
      const long gidx = goff + static_cast<long>(gi) * ny + j;
      if (st == s) {
        out[gidx] = y;
      } else if (stages != nullptr) {
        stages[(st - 1) * stage_stride + gidx] = y;
      }
    }
  }
  // no block may leave while a neighbour can still read its shared memory
  cluster.sync();
}

template <typename T>
int launch(const T* H, const T* B, const T* table, const T* coef, T* out,
           T* stages, int n_g, int nx, int ny, int s, double dt, double eta0,
           double e_hc, double e_sc, double e_hs, double e_ss, void* stream) {
  const long bytes = smem_bytes(nx, ny, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      rkc_interval_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  rkc_interval_kernel<T><<<n_g * kCluster, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      H, B, table, coef, out, stages, n_g, nx, ny, s, static_cast<T>(dt),
      static_cast<T>(eta0), static_cast<T>(e_hc), static_cast<T>(e_sc),
      static_cast<T>(e_hs), static_cast<T>(e_ss));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rkc_interval_f32(const float* H, const float* B,
                                const float* table, const float* coef,
                                float* out, float* stages, int n_g, int nx,
                                int ny, int s, double dt, double eta0,
                                double e_hc, double e_sc, double e_hs,
                                double e_ss, void* stream) {
  return launch<float>(H, B, table, coef, out, stages, n_g, nx, ny, s, dt,
                       eta0, e_hc, e_sc, e_hs, e_ss, stream);
}

extern "C" int rkc_interval_f64(const double* H, const double* B,
                                const double* table, const double* coef,
                                double* out, double* stages, int n_g, int nx,
                                int ny, int s, double dt, double eta0,
                                double e_hc, double e_sc, double e_hs,
                                double e_ss, void* stream) {
  return launch<double>(H, B, table, coef, out, stages, n_g, nx, ny, s, dt,
                        eta0, e_hc, e_sc, e_hs, e_ss, stream);
}
