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
// with f the fused SIA2D right-hand side (sia_common.cuh), the derived
// per-glacier table (n_g, 8) = (dx, dy, creep, slide, exponents), and the
// coefficient table (5, s+1) rows mu, nu, mu~, gamma~, mu1~ in the planes'
// dtype, built once per (s, dtype) by the wrapper.
//
// What bounds it on the H100: operations, and before them latency. The step
// reads H and B once and writes H' once (3 planes, 0.79 MB at 4 x 128^2
// float32, 0.23 us at 3.35 TB/s), while each stage forms the corner
// diffusivities and the fluxes of every cell (~100 flops a cell), s times,
// with a barrier across the glacier between stages.
//
// Design. One thread-block cluster per glacier, of 16 blocks when the
// occupancy API says that all the batch's clusters of 16 are resident at
// once (or when the plane fits only at 16 rows a block), else of 8; the
// wrapper chooses (ops/cuda/rkc_kernel.py::_plan) and launches through
// cudaLaunchKernelEx. Block `rank` owns rows [rank*rows, rank*rows + rows),
// rows = ceil(nx / cluster); blocks past the last row own none and only
// join the barriers. Threads map in 2-D, lanes along the contiguous ny axis
// and warps along rows, and each thread owns fixed cells for the whole step
// (at most 8), keeping H, f0 and y(j-2) of those cells in registers.
// Shared memory holds only what neighbours read, 4 slabs of rows + 2 rows:
// B with its halo rows, two alternating stage buffers with halo rows, and
// the stage's corner diffusivities. Per stage a block forms each corner its
// rows touch once (each thread the corner below-right of its own cells,
// plus a share of the row above the block), one __syncthreads(), then the
// new stage of its own cells into the other buffer; a block stores its
// first and last new rows straight into its neighbours' halo rows of that
// buffer through distributed shared memory, and one cluster barrier ends
// the stage. The neighbour last read that halo in the previous stage,
// before the barrier that ended it, so one barrier per stage orders both.
// The exponent set (5, 2, 4, 2) is a template specialisation whose powers
// are fixed multiplies (GlenExps); any other set takes pow_pos at run time.
// No stencil divides: 1/dx and 1/dy are formed once per glacier, and no
// index divides by ny. H and B are read from device memory once and H'
// written once, as on the TPU. With `stages` non-null the kernel also
// writes y1 .. y(s-1) to it (the backward's rematerialisation). No atomics.
// The source is built without fused multiply-add contraction (build.py):
// the Chebyshev recursion carries each stage's rounding into the next, and
// only the plain version's rounding of each product and sum keeps the
// float32 gradient as close to float64 as the plain version's.
//
// Time at 4 x 128^2, s = 25, float32 on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py): 0.477 ms with the previous design (8-block
// clusters, 6 slabs, runtime exponents, three barriers a stage), 0.0500 ms
// with this one (16-block clusters; 0.0395 ms at 16 x 128^2, s = 8,
// 8-block).
#include <cooperative_groups.h>

#include "sia_common.cuh"

namespace cg = cooperative_groups;

namespace {

using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::relu;

constexpr int kMaxThreads = 512;  // blockDim.x * blockDim.y at most

// what an own cell does besides its update
constexpr int kRing = 1;      // on the plane's ring: dH/dt = 0
constexpr int kCorner = 2;    // forms the corner below-right of it
constexpr int kPushUp = 4;    // first row of the block: the upper neighbour's halo
constexpr int kPushDown = 8;  // last row of the block: the lower neighbour's halo

// D of the corner whose upper-left cell has slab index i (cells i, i+1,
// i+ny, i+ny+1 of the stage buffer Y).
template <typename T, class E>
__device__ __forceinline__ T form_corner(const T* Y, const T* Bs, int i, int ny,
                                         const Recip<T>& k, const E& e) {
  const T h00 = relu(Y[i]), h01 = relu(Y[i + 1]);
  const T h10 = relu(Y[i + ny]), h11 = relu(Y[i + ny + 1]);
  return odinn::corner_D(h00, h10, h01, h11, Bs[i] + h00, Bs[i + ny] + h10,
                         Bs[i + 1] + h01, Bs[i + ny + 1] + h11, k, e);
}

// dH/dt of the interior cell with slab index i; the corner below-right of
// slab cell c sits at Ds[c].
template <typename T>
__device__ __forceinline__ T cell_rhs(const T* Y, const T* Bs, const T* Ds, int i,
                                      int ny, const Recip<T>& k, T eta_dx, T eta_dy) {
  const T h_c = relu(Y[i]), h_xp = relu(Y[i + ny]), h_xm = relu(Y[i - ny]);
  const T h_yp = relu(Y[i + 1]), h_ym = relu(Y[i - 1]);
  const T d[2][2] = {{Ds[i - ny - 1], Ds[i - ny]}, {Ds[i - 1], Ds[i]}};
  return odinn::rhs_cell_recip(h_c, h_xp, h_xm, h_yp, h_ym, Bs[i] + h_c,
                               Bs[i + ny] + h_xp, Bs[i - ny] + h_xm,
                               Bs[i + 1] + h_yp, Bs[i - 1] + h_ym, d, k, eta_dx,
                               eta_dy);
}

// K: the cells a thread owns at most (2, 4 or 8; rkc_layout's cells,
// rounded up). At K <= 4 two blocks fit an SM (64 registers a thread).
template <typename T, class E, int K>
__global__ void __launch_bounds__(kMaxThreads, K <= 4 ? 2 : 1)
rkc_interval_kernel(const T* __restrict__ H, const T* __restrict__ B,
                    const T* __restrict__ table, const T* __restrict__ coef,
                    T* __restrict__ out, T* __restrict__ stages, int n_g, int nx,
                    int ny, int s, T dt, T eta0, E e) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int glacier = blockIdx.x / csize;
  const int rows = (nx + csize - 1) / csize;
  const int row0 = rank * rows;
  const int nrows = max(0, min(rows, nx - row0));
  const long plane = static_cast<long>(nx) * ny;
  const long stage_stride = static_cast<long>(n_g) * plane;
  // device index of slab index 0: slab row li is the plane's row row0-1+li
  const long gbase = static_cast<long>(glacier) * plane + static_cast<long>(row0 - 1) * ny;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int slab = (rows + 2) * ny;
  T* Bs = sm;
  T* Y0 = sm + slab;   // stage buffer b is Y0 + b * slab
  T* Ds = sm + 3 * slab;

  const Recip<T> k = odinn::recip_row(table + 8L * glacier);
  const T eta_dx = eta0 * k.inv_dx, eta_dy = eta0 * k.inv_dy;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int tid = ty * bx + tx, nthreads = bx * by;

  if (nrows > 0) {
    // B and y0 = H with their halo rows; the second buffer's halo rows zeroed
    for (int li = ty; li < nrows + 2; li += by) {
      const int gi = row0 - 1 + li;
      const bool in = gi >= 0 && gi < nx;
      for (int j = tx; j < ny; j += bx) {
        const long g = gbase + static_cast<long>(li) * ny + j;
        Bs[li * ny + j] = in ? B[g] : T(0);
        Y0[li * ny + j] = in ? H[g] : T(0);
      }
    }
    for (int j = tid; j < ny; j += nthreads) {
      Y0[slab + j] = T(0);
      Y0[slab + (nrows + 1) * ny + j] = T(0);
    }
  }

  // the thread's own cells: row ty + by*rr, column tx + bx*cc, in registers
  const int cols = (ny + bx - 1) / bx;
  int sidx[K], flags[K];
  T Hr[K], F0[K], Ym2[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int rr = q / cols, cc = q - rr * cols;
    const int lr = ty + by * rr, j = tx + bx * cc;
    const int gi = row0 + lr;
    const bool mine = lr < nrows && j < ny;
    sidx[q] = mine ? (lr + 1) * ny + j : -1;
    int f = 0;
    if (gi == 0 || gi == nx - 1 || j == 0 || j == ny - 1) f |= kRing;
    if (gi <= nx - 2 && j <= ny - 2) f |= kCorner;
    if (lr == 0 && row0 > 0) f |= kPushUp;
    if (lr == nrows - 1 && row0 + nrows < nx) f |= kPushDown;
    flags[q] = f;
  }
  // the neighbours' first stage buffers (same layout): the upper one's
  // last halo row is rows + 1 (it owns all its rows), the lower one's first 0
  T* up = nullptr;
  T* down = nullptr;
  if (nrows > 0 && row0 > 0) up = cluster.map_shared_rank(Y0, rank - 1);
  if (nrows > 0 && row0 + nrows < nx) down = cluster.map_shared_rank(Y0, rank + 1);
  // own cell q's new value y of stage buffer b into the neighbours' halos
  auto push = [&](int b, int q, T y) {
    if (flags[q] & kPushUp) up[b * slab + rows * ny + sidx[q]] = y;       // row 1 -> rows + 1
    if (flags[q] & kPushDown) down[b * slab + sidx[q] - nrows * ny] = y;  // row nrows -> 0
  };
  // the stage's corner diffusivities from stage buffer Yb
  auto corners = [&](const T* Yb) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (sidx[q] >= 0 && (flags[q] & kCorner)) Ds[sidx[q]] = form_corner(Yb, Bs, sidx[q], ny, k, e);
    }
    if (nrows > 0 && row0 > 0) {   // the corner row above the block
      for (int j = tid; j < ny - 1; j += nthreads) Ds[j] = form_corner(Yb, Bs, j, ny, k, e);
    }
  };

  // every block of the cluster has started (its shared memory may be
  // written) and has loaded its slabs
  cluster.sync();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    Hr[q] = sidx[q] >= 0 ? Y0[sidx[q]] : T(0);
    Ym2[q] = Hr[q];
  }
  corners(Y0);
  __syncthreads();
  {
    const T mu1dt = coef[4 * (s + 1)] * dt;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (sidx[q] < 0) continue;
      const T f = (flags[q] & kRing) ? T(0) : cell_rhs(Y0, Bs, Ds, sidx[q], ny, k, eta_dx, eta_dy);
      F0[q] = f;
      const T y = Hr[q] + mu1dt * f;
      const long g = gbase + sidx[q];
      if (s == 1) {
        out[g] = y;
      } else {
        Y0[slab + sidx[q]] = y;
        push(1, q, y);
        if (stages != nullptr) stages[g] = y;
      }
    }
  }
  for (int st = 2; st <= s; ++st) {
    const T* prev = Y0 + ((st - 1) & 1) * slab;
    T* next = Y0 + (st & 1) * slab;
    cluster.sync();   // stage st-1 complete in every block, halos included
    corners(prev);
    __syncthreads();
    const T mu = coef[st], nu = coef[(s + 1) + st];
    const T mutdt = coef[2 * (s + 1) + st] * dt;
    const T gamdt = coef[3 * (s + 1) + st] * dt;
    const T a = T(1) - mu - nu;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (sidx[q] < 0) continue;
      const T yc = prev[sidx[q]];
      const T f = (flags[q] & kRing) ? T(0) : cell_rhs(prev, Bs, Ds, sidx[q], ny, k, eta_dx, eta_dy);
      const T y = a * Hr[q] + mu * yc + nu * Ym2[q] + mutdt * f + gamdt * F0[q];
      Ym2[q] = yc;
      const long g = gbase + sidx[q];
      if (st == s) {
        out[g] = y;
      } else {
        next[sidx[q]] = y;
        push(st & 1, q, y);
        if (stages != nullptr) stages[(st - 1) * stage_stride + g] = y;
      }
    }
  }
  // the last stage reads and writes only the block's own shared memory, so
  // a block may leave without waiting for its neighbours
}

// Once per instantiation: the opt-in dynamic shared memory and the
// non-portable cluster size of 16.
template <typename T, class E, int K>
int prepare() {
  static int state = -1;
  if (state < 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rkc_interval_kernel<T, E, K>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rkc_interval_kernel<T, E, K>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    state = 0;
  }
  return state;
}

struct Shape {
  int n_g, cluster, bx, by, smem, cells;
};

cudaLaunchConfig_t config(const Shape& sh, cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.n_g * sh.cluster, 1, 1);
  cfg.blockDim = dim3(sh.bx, sh.by, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(sh.smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = sh.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, class E, int K>
int launch_k(const T* H, const T* B, const T* table, const T* coef, T* out, T* stages,
             int nx, int ny, int s, double dt, double eta0, E e, const Shape& sh,
             void* stream) {
  const int ready = prepare<T, E, K>();
  if (ready != 0) return ready;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(sh, &attr, static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaLaunchKernelEx(&cfg, rkc_interval_kernel<T, E, K>, H, B, table, coef,
                                       out, stages, sh.n_g, nx, ny, s, static_cast<T>(dt),
                                       static_cast<T>(eta0), e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class E>
int launch(const T* H, const T* B, const T* table, const T* coef, T* out, T* stages,
           int nx, int ny, int s, double dt, double eta0, E e, const Shape& sh,
           void* stream) {
  if (sh.cells <= 2) return launch_k<T, E, 2>(H, B, table, coef, out, stages, nx, ny, s, dt, eta0, e, sh, stream);
  if (sh.cells <= 4) return launch_k<T, E, 4>(H, B, table, coef, out, stages, nx, ny, s, dt, eta0, e, sh, stream);
  if (sh.cells <= 8) return launch_k<T, E, 8>(H, B, table, coef, out, stages, nx, ny, s, dt, eta0, e, sh, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, class E, int K>
int occupancy_k(const Shape& sh, int* active) {
  const int ready = prepare<T, E, K>();
  if (ready != 0) return ready;
  cudaLaunchAttribute attr;
  Shape one = sh;
  one.n_g = 1;
  const cudaLaunchConfig_t cfg = config(one, &attr, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(active, rkc_interval_kernel<T, E, K>, &cfg));
}

template <typename T, class E>
int occupancy(const Shape& sh, int* active) {
  if (sh.cells <= 2) return occupancy_k<T, E, 2>(sh, active);
  if (sh.cells <= 4) return occupancy_k<T, E, 4>(sh, active);
  if (sh.cells <= 8) return occupancy_k<T, E, 8>(sh, active);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_any(const T* H, const T* B, const T* table, const T* coef, T* out, T* stages,
               int n_g, int nx, int ny, int s, double dt, double eta0, int glen,
               double e_hc, double e_sc, double e_hs, double e_ss, int cluster, int bx,
               int by, int smem, int cells, void* stream) {
  const Shape sh{n_g, cluster, bx, by, smem, cells};
  if (glen) {
    return launch<T>(H, B, table, coef, out, stages, nx, ny, s, dt, eta0, GlenExps<T>{},
                     sh, stream);
  }
  const RuntimeExps<T> e{static_cast<T>(e_hc), static_cast<T>(e_sc), static_cast<T>(e_hs),
                         static_cast<T>(e_ss)};
  return launch<T>(H, B, table, coef, out, stages, nx, ny, s, dt, eta0, e, sh, stream);
}

}  // namespace

// `glen` != 0 takes the (5, 2, 4, 2) specialisation and ignores e_*;
// `cluster`, `bx`, `by`, `smem` and `cells` are the wrapper's layout
// (rkc_layout).
extern "C" int rkc_interval_f32(const float* H, const float* B, const float* table,
                                const float* coef, float* out, float* stages, int n_g,
                                int nx, int ny, int s, double dt, double eta0, int glen,
                                double e_hc, double e_sc, double e_hs, double e_ss,
                                int cluster, int bx, int by, int smem, int cells,
                                void* stream) {
  return launch_any<float>(H, B, table, coef, out, stages, n_g, nx, ny, s, dt, eta0, glen,
                           e_hc, e_sc, e_hs, e_ss, cluster, bx, by, smem, cells, stream);
}

extern "C" int rkc_interval_f64(const double* H, const double* B, const double* table,
                                const double* coef, double* out, double* stages, int n_g,
                                int nx, int ny, int s, double dt, double eta0, int glen,
                                double e_hc, double e_sc, double e_hs, double e_ss,
                                int cluster, int bx, int by, int smem, int cells,
                                void* stream) {
  return launch_any<double>(H, B, table, coef, out, stages, n_g, nx, ny, s, dt, eta0, glen,
                            e_hc, e_sc, e_hs, e_ss, cluster, bx, by, smem, cells, stream);
}

// cudaOccupancyMaxActiveClusters for the kernel of that dtype (f64 != 0)
// and exponent path at one layout, into *active.
extern "C" int rkc_interval_occupancy(int f64, int glen, int cluster, int bx, int by,
                                      int smem, int cells, int* active) {
  const Shape sh{1, cluster, bx, by, smem, cells};
  if (f64) {
    return glen ? occupancy<double, GlenExps<double>>(sh, active)
                : occupancy<double, RuntimeExps<double>>(sh, active);
  }
  return glen ? occupancy<float, GlenExps<float>>(sh, active)
              : occupancy<float, RuntimeExps<float>>(sh, active);
}
