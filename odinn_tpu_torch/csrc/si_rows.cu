// The row-sharded semi-implicit step's PCG iteration, split at its two
// reductions.
//
// On a rows mesh (odinn_tpu_torch/parallel/spatial.py) a rank holds its own
// rows [r0, r1) of each glacier's plane inside a slab with up to two ghost
// rows on each side. The step's assembly is csrc/si_plane.cu's si_assemble
// on that slab (D's corners, b and the inverse Jacobi diagonal into the
// first planes of a scratch of the Plane layout). The PCG cannot
// run in one launch, as the TPU kernel odinn_tpu/ops/pallas/si_kernel.py::
// si_step_pallas and si_step_cluster run it: its two dot products span
// every rank of the row group, and p needs its neighbours' rows each
// iteration. So each iteration is two launches with a host exchange after
// each (ops/si_math.py::rows_cg):
//  - si_rows_apply: p = z + beta*p over the whole slab (into a second p
//    plane: the ghost rows of z came from their owners with the last r.z
//    partials, so every rank forms its ghost rows of p as their owner forms
//    them, bit for bit), then Ap = A p on the own rows and each glacier's
//    partial p.Ap. Its start mode forms x = x0, r = b - A x0, z = M^-1 r and
//    the partial r.z.
//  - si_rows_update: x += alpha*p, r -= alpha*Ap, z = M^-1 r on the own rows
//    and the partial r.z.
// The host sums each glacier's partials over the row group in rank order
// and forms alpha and beta with ops/si_math.py::cg's guards (denom > 0,
// rz > 0, tiny), so they are bitwise the same on every rank. The forward,
// transpose and tangent solves differ only in b and the guess, which the
// assembly and the caller set.
//
// Plain versions: ops/cuda/si_kernel.py::si_rows_apply_reference and
// si_rows_update_reference.
//
// What bounds them on the H100: bytes, by count. At a rank's 16 x 66 x 128
// float32 slab the apply moves 2.7 MB (0.80 us at 3.35 TB/s) and the update
// 4.2 MB (1.25 us). There they take 3.47 and 2.70 us (NVIDIA H100 80GB
// HBM3, 700 W; profile_rows.py, PERF.md), of which 1.47 us is the launch of
// 128 blocks in clusters of 8 with the fixed-order sum and no work; the
// rest is one load round trip, the arithmetic and the stores' drain. At 4
// x 516 x 1024 (50.0 and 24.6 us against 12.6 and 20.0) 4 glaciers use 32
// of the 132 SMs.
//
// Design: one thread-block cluster of up to 8 blocks (portable) per
// glacier, the plan computed on the host (ops/cuda/si_kernel.py::
// rows_layout, RowsLayout) and launched through cudaLaunchKernelEx. Block
// `rank` of a cluster of `csize` owns the band of own rows r0 + rank * own
// / csize .. r0 + (rank + 1) * own / csize, the full width, and walks it in
// a fixed order, V values a thread a step: 16 bytes where ny is a multiple
// of 16 bytes and the pointers are 16-byte aligned (template flag kVec),
// else one value. At 16 x 66 x 128 that is 8 rows a block, 128 blocks in
// one wave.
//  - si_rows_apply reads its cells straight from device memory through L1:
//    per own cell a thread forms p = z + beta*p[src] at the cell and its
//    four neighbours from z and p[src] as it reads them (no pass of its
//    own, no barrier), writes p[dst], takes A p from D's corners, writes
//    Ap and adds p*Ap to its partial. The slab's ghost rows of p[dst],
//    outside every band, are formed by the first and last block, their
//    loads issued with the band's. The start mode does the same with x0 in
//    place of p. (Staging a band in shared memory first, by cp.async, was
//    0.74 us slower at a rank's slab, where a block has one band to wait
//    for; PERF.md.)
//  - p has the same bits in every copy: form_p rounds z + beta*p[src] once
//    (an explicit fused multiply-add) wherever it is formed, a band's own
//    cells, a neighbour cell read across a band's edge or a ghost row,
//    whatever contraction the compiler applies elsewhere; so a band's halo
//    equals its neighbour band's own rows, and a rank's ghost rows its
//    neighbour rank's.
//  - si_rows_update walks the same bands, elementwise; a thread loads up
//    to kBatch vectors before it stores any, so more bytes are in flight
//    where it has several.
//  - The sums: each thread its cells in a fixed order, then
//    cluster_exchange.cuh's cluster_sum: a warp shuffle tree, one over the
//    warps' partials, each block's total into block 0's slot `rank` over
//    distributed shared memory (st.async, counted on block 0's mbarrier),
//    and block 0's tree over the slots into partial[g]. No atomics: a rerun
//    is bitwise the same.
#include <cooperative_groups.h>

#include "cluster_exchange.cuh"
#include "sia_common.cuh"

namespace cg = cooperative_groups;

namespace {

using odinn::Recip;
using odinn::cluster_sum;
using odinn::cluster_sum_begin;
using odinn::smem_u32;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
static_assert(kMaxWarps <= 32 && kMaxCluster <= 32, "one warp sums the partials");
// Vectors a thread of si_rows_update loads before it stores any, and of
// si_rows_apply's ghost rows of p before its band.
constexpr int kBatch = 4;
constexpr int kGhost = 2;
// The dynamic shared memory, as rows_layout counts it: the mbarrier (padded
// to 16 bytes), then kHeadValues values (block 0's kMaxCluster slots, the
// kMaxWarps warp partials).
constexpr int kBarBytes = 16;
constexpr int kHeadValues = 32;
static_assert(kMaxCluster + kMaxWarps <= kHeadValues, "the head holds the slots and partials");

// Scratch planes, each (n_g, nx, ny): si_plane.cu's Plane layout up to Ap,
// then z and a second p (ops/si_math.py, ROWS_*).
enum Plane { kD = 0, kRhs, kInvDiag, kX, kR, kP, kAp, kZ, kP2, kPlanes };

template <typename T, bool kVec>
constexpr int kV = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;

// p = z + beta*p[src], rounded once (module note).
__device__ __forceinline__ float form_p(float z, float beta, float ps) {
  return __fmaf_rn(beta, ps, z);
}
__device__ __forceinline__ double form_p(double z, double beta, double ps) {
  return __fma_rn(beta, ps, z);
}

// V values at s (16-byte aligned where V > 1).
__device__ __forceinline__ void load_v(float (&v)[4], const float* s) {
  const float4 w = *reinterpret_cast<const float4*>(s);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}
__device__ __forceinline__ void load_v(double (&v)[2], const double* s) {
  const double2 w = *reinterpret_cast<const double2*>(s);
  v[0] = w.x, v[1] = w.y;
}
template <typename T>
__device__ __forceinline__ void load_v(T (&v)[1], const T* s) {
  v[0] = *s;
}
__device__ __forceinline__ void store_v(float* d, const float (&v)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_v(double* d, const double (&v)[2]) {
  *reinterpret_cast<double2*>(d) = make_double2(v[0], v[1]);
}
template <typename T>
__device__ __forceinline__ void store_v(T* d, const T (&v)[1]) {
  *d = v[0];
}

// A u = u - coef*M*div(D grad(M u)) at the V cells (i, j0 .. j0 + V - 1) of
// the glacier's nx x ny planes us, zs and D (D(i, j) at cell (i, j)), the
// cell (i, j0) at index s; M masks the slab's ring. u is us, or with kForm
// p = form_p(z, beta, us) formed from z and p[src] as it is read. Nothing
// off the slab is read. Also returns u there.
template <typename T, int V, bool kForm>
__device__ __forceinline__ void apply_A(const T* __restrict__ us, const T* __restrict__ zs,
                                        T beta, const T* __restrict__ D, int s, int nx, int ny,
                                        int i, int j0, T coef, const Recip<T>& k, T (&uc)[V],
                                        T (&out)[V]) {
  auto get = [&](T (&v)[V], int at) {
    load_v(v, us + at);
    if (kForm) {
      T z[V];
      load_v(z, zs + at);
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = form_p(z[q], beta, v[q]);
    }
  };
  auto get1 = [&](int at) { return kForm ? form_p(zs[at], beta, us[at]) : us[at]; };
  T um[V], up[V], dm[V + 1], dc[V + 1];
  get(uc, s);
  if (i == 0 || i == nx - 1) {   // a ring row: A u = u
#pragma unroll
    for (int t = 0; t < V; ++t) out[t] = uc[t];
    return;
  }
  get(um, s - ny);
  get(up, s + ny);
  dm[0] = j0 > 0 ? D[s - ny - 1] : T(0);
  dc[0] = j0 > 0 ? D[s - 1] : T(0);
  {
    T a[V], b[V];
    load_v(a, D + s - ny);
    load_v(b, D + s);
#pragma unroll
    for (int t = 0; t < V; ++t) dm[t + 1] = a[t], dc[t + 1] = b[t];
  }
  const T ul = j0 > 0 ? get1(s - 1) : T(0), ur = j0 + V < ny ? get1(s + V) : T(0);
  const bool up_in = i + 1 < nx - 1, um_in = i - 1 > 0;
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int j = j0 + t;
    if (j == 0 || j == ny - 1) {
      out[t] = uc[t];
      continue;
    }
    // the neighbours, masked where they lie on the ring
    const T n_xp = up_in ? up[t] : T(0);
    const T n_xm = um_in ? um[t] : T(0);
    const T n_yp = j + 1 < ny - 1 ? (t + 1 < V ? uc[t + 1] : ur) : T(0);
    const T n_ym = j - 1 > 0 ? (t > 0 ? uc[t - 1] : ul) : T(0);
    const T d00 = dm[t], d01 = dm[t + 1], d10 = dc[t], d11 = dc[t + 1];
    const T xe = T(0.5) * (d10 + d11), xw = T(0.5) * (d00 + d01);
    const T yn = T(0.5) * (d01 + d11), ys = T(0.5) * (d00 + d10);
    const T c = uc[t];
    const T fxp = xe * ((n_xp - c) * k.inv_dx);
    const T fxm = xw * ((c - n_xm) * k.inv_dx);
    const T fyp = yn * ((n_yp - c) * k.inv_dy);
    const T fym = ys * ((c - n_ym) * k.inv_dy);
    out[t] = c - coef * ((fxp - fxm) * k.inv_dx + (fyp - fym) * k.inv_dy);
  }
}

template <typename T>
struct ApplyArgs {
  T* work;
  const T* x0;
  const T* table;
  const T* beta;
  T* partial;
  int src, dst, n_g, nx, ny, r0, r1;
  T coef;
};

template <typename T>
struct UpdateArgs {
  T* work;
  const T* alpha;
  T* partial;
  int p_plane, n_g, nx, ny, r0, r1;
};

// The cluster's size and rank, its glacier and the block's band of own
// rows [a, b).
struct Band {
  int csize, rank, g, a, b;
  __device__ Band(int r0, int r1) {
    cg::cluster_group cluster = cg::this_cluster();
    csize = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    g = blockIdx.x / csize;
    const long own = r1 - r0;
    a = r0 + static_cast<int>(rank * own / csize);
    b = r0 + static_cast<int>((rank + 1) * own / csize);
  }
};

// kInit: x = x0, r = b - A x0, z = M^-1 r, partial r.z. Else p[dst] = z +
// beta*p[src] on the whole slab, Ap = A p[dst] on the own rows, partial
// p.Ap. kJ: Jacobi; without it z is r.
template <typename T, bool kJ, bool kInit, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) si_rows_apply(ApplyArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = kV<T, kVec>;
  const Band w(p.r0, p.r1);
  const unsigned bar = smem_u32(smem);
  T* const slots = reinterpret_cast<T*>(smem + kBarBytes);   // [kMaxCluster], block 0's
  T* const warp_part = slots + kMaxCluster;                  // [kMaxWarps]
  cluster_sum_begin(bar, w.rank, w.csize, sizeof(T));

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int nx = p.nx, ny = p.ny, r0 = p.r0, r1 = p.r1;
  const long plane = static_cast<long>(nx) * ny;
  const long batch = plane * p.n_g;
  const long off = static_cast<long>(w.g) * plane;
  const T* const D = p.work + kD * batch + off;
  T* const Z = p.work + kZ * batch + off;
  const T* const U = kInit ? p.x0 + off : p.work + static_cast<long>(p.src) * batch + off;
  const Recip<T> k = odinn::recip_row(p.table + 4L * w.g);
  const T coef = p.coef;
  const T beta = kInit ? T(0) : p.beta[w.g];
  T* const Pd = p.work + static_cast<long>(p.dst) * batch + off;
  // The slab's ghost rows of p[dst]: rows [0, r0) by block 0, [r1, nx) by
  // the last block, as one run of n_ghost vectors, the top rows first. A
  // thread loads its first kGhost before its band, so they share the
  // band's round trip, and stores them after; any more after that.
  const long top = kInit || w.rank ? 0 : static_cast<long>(r0) * ny / V;
  const long n_ghost =
      top + (kInit || w.rank != w.csize - 1 ? 0 : static_cast<long>(nx - r1) * ny / V);
  auto ghost_at = [&](long v) {   // the ghost vector v's first cell
    return v < top ? v * V : static_cast<long>(r1) * ny + (v - top) * V;
  };
  T gz[kGhost][V], gs[kGhost][V];
#pragma unroll
  for (int b = 0; b < kGhost; ++b) {
    const long v = tid + static_cast<long>(b) * nthreads;
    if (v < n_ghost) {
      load_v(gz[b], Z + ghost_at(v));
      load_v(gs[b], U + ghost_at(v));
    }
  }

  T acc = T(0);
  const int wv = ny / V;
  for (int e = tid; e < (w.b - w.a) * wv; e += nthreads) {
    const int tr = e / wv, tv = e - tr * wv;
    const int i = w.a + tr, j0 = tv * V;
    const int gi = i * ny + j0;
    T uc[V], au[V];
    apply_A<T, V, !kInit>(U, Z, beta, D, gi, nx, ny, i, j0, coef, k, uc, au);
    if (kInit) {
      T rhs[V], inv[V], rc[V], zc[V];
      load_v(rhs, p.work + kRhs * batch + off + gi);
      if (kJ) load_v(inv, p.work + kInvDiag * batch + off + gi);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        rc[q] = rhs[q] - au[q];
        zc[q] = kJ ? rc[q] * inv[q] : rc[q];
        acc += rc[q] * zc[q];
      }
      store_v(p.work + kX * batch + off + gi, uc);
      store_v(p.work + kR * batch + off + gi, rc);
      store_v(Z + gi, zc);
    } else {
      store_v(Pd + gi, uc);
      store_v(p.work + kAp * batch + off + gi, au);
#pragma unroll
      for (int q = 0; q < V; ++q) acc += uc[q] * au[q];
    }
  }
#pragma unroll
  for (int b = 0; b < kGhost; ++b) {
    const long v = tid + static_cast<long>(b) * nthreads;
    if (v < n_ghost) {
      T pd[V];
#pragma unroll
      for (int q = 0; q < V; ++q) pd[q] = form_p(gz[b][q], beta, gs[b][q]);
      store_v(Pd + ghost_at(v), pd);
    }
  }
  for (long v = tid + static_cast<long>(kGhost) * nthreads; v < n_ghost; v += nthreads) {
    T zv[V], sv[V], pd[V];
    load_v(zv, Z + ghost_at(v));
    load_v(sv, U + ghost_at(v));
#pragma unroll
    for (int q = 0; q < V; ++q) pd[q] = form_p(zv[q], beta, sv[q]);
    store_v(Pd + ghost_at(v), pd);
  }
  cluster_sum(acc, slots, warp_part, bar, w.rank, w.csize, p.partial + w.g);
}

// x += alpha*p, r -= alpha*Ap, z = M^-1 r on the own rows, partial r.z.
template <typename T, bool kJ, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) si_rows_update(UpdateArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = kV<T, kVec>;
  const Band w(p.r0, p.r1);
  const unsigned bar = smem_u32(smem);
  T* const slots = reinterpret_cast<T*>(smem + kBarBytes);
  T* const warp_part = slots + kMaxCluster;
  cluster_sum_begin(bar, w.rank, w.csize, sizeof(T));

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long plane = static_cast<long>(p.nx) * p.ny;
  const long batch = plane * p.n_g;
  const long off = static_cast<long>(w.g) * plane + static_cast<long>(w.a) * p.ny;
  const T a = p.alpha[w.g];
  const T* const P = p.work + static_cast<long>(p.p_plane) * batch + off;
  const T* const Ap = p.work + kAp * batch + off;
  const T* const inv = p.work + kInvDiag * batch + off;
  T* const X = p.work + kX * batch + off;
  T* const R = p.work + kR * batch + off;
  T* const Z = p.work + kZ * batch + off;
  // the band's cells are contiguous: vector e at cell e * V
  const int n = (w.b - w.a) * (p.ny / V);
  T acc = T(0);
  for (int e0 = tid; e0 < n; e0 += kBatch * nthreads) {
    // up to kBatch vectors e0, e0 + nthreads, ..., all loads first
    T x[kBatch][V], pv[kBatch][V], r[kBatch][V], ap[kBatch][V], iv[kBatch][V];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = (e0 + b * nthreads) * V;
      if (e0 + b * nthreads >= n) break;
      load_v(x[b], X + c);
      load_v(pv[b], P + c);
      load_v(r[b], R + c);
      load_v(ap[b], Ap + c);
      if (kJ) load_v(iv[b], inv + c);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = (e0 + b * nthreads) * V;
      if (e0 + b * nthreads >= n) break;
      T z[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        x[b][q] = x[b][q] + a * pv[b][q];
        r[b][q] = r[b][q] - a * ap[b][q];
        z[q] = kJ ? r[b][q] * iv[b][q] : r[b][q];
        acc += r[b][q] * z[q];
      }
      store_v(X + c, x[b]);
      store_v(R + c, r[b]);
      store_v(Z + c, z);
    }
  }
  cluster_sum(acc, slots, warp_part, bar, w.rank, w.csize, p.partial + w.g);
}

// Whether the slab is one the kernels take (the planes' 32-bit cell
// indices included) and the plan one they run: a portable cluster of at
// most one block an own row, whole warps, the head of shared memory, and
// 16-byte vectors that stay whole.
template <typename T>
bool valid(int src, int dst, int n_g, int nx, int ny, int r0, int r1, int cluster, int threads,
           int smem, int vec) {
  const bool planes = (src == kP || src == kP2) && (dst == kP || dst == kP2) && src != dst;
  const bool slab = n_g > 0 && nx >= 3 && ny >= 3 && static_cast<long>(nx) * ny <= 0x7fffffffL &&
                    r0 >= 0 && r0 < r1 && r1 <= nx;
  const bool plan = cluster >= 1 && cluster <= kMaxCluster && cluster <= r1 - r0 &&
                    threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
                    smem >= kBarBytes + kHeadValues * static_cast<int>(sizeof(T)) &&
                    (!vec || ny % (16 / static_cast<int>(sizeof(T))) == 0);
  return planes && slab && plan;
}

cudaLaunchConfig_t config(int n_g, int cluster, int threads, int smem,
                          cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_g * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename K, typename A>
int launch(K kernel, const A& args, int cluster, int threads, int smem, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(args.n_g, cluster, threads, smem, &attr, static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kJ, bool kInit>
int launch_apply(const ApplyArgs<T>& a, int vec, int cluster, int threads, int smem,
                 void* stream) {
  return vec ? launch(si_rows_apply<T, kJ, kInit, true>, a, cluster, threads, smem, stream)
             : launch(si_rows_apply<T, kJ, kInit, false>, a, cluster, threads, smem, stream);
}

template <typename T>
int apply(T* work, const T* x0, const T* table, const T* beta, int src, int dst, int n_g, int nx,
          int ny, int r0, int r1, double coef, int init, int precondition, int cluster,
          int threads, int smem, int vec, T* partial, void* stream) {
  if (!valid<T>(init ? kP2 : src, init ? kP : dst, n_g, nx, ny, r0, r1, cluster, threads, smem,
                vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ApplyArgs<T> a{work, x0, table, beta, partial, src, dst, n_g, nx, ny, r0, r1,
                       static_cast<T>(coef)};
  if (init) {
    return precondition ? launch_apply<T, true, true>(a, vec, cluster, threads, smem, stream)
                        : launch_apply<T, false, true>(a, vec, cluster, threads, smem, stream);
  }
  // the Jacobi flag only shapes the start mode's z
  return launch_apply<T, true, false>(a, vec, cluster, threads, smem, stream);
}

template <typename T>
int update(T* work, const T* alpha, int p_plane, int n_g, int nx, int ny, int r0, int r1,
           int precondition, int cluster, int threads, int smem, int vec, T* partial,
           void* stream) {
  if (!valid<T>(p_plane, p_plane == kP ? kP2 : kP, n_g, nx, ny, r0, r1, cluster, threads, smem,
                vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const UpdateArgs<T> a{work, alpha, partial, p_plane, n_g, nx, ny, r0, r1};
  if (precondition) {
    return vec ? launch(si_rows_update<T, true, true>, a, cluster, threads, smem, stream)
               : launch(si_rows_update<T, true, false>, a, cluster, threads, smem, stream);
  }
  return vec ? launch(si_rows_update<T, false, true>, a, cluster, threads, smem, stream)
             : launch(si_rows_update<T, false, false>, a, cluster, threads, smem, stream);
}

template <typename T>
int occupancy(int vec, int cluster, int threads, int smem, int* active) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, cluster, threads, smem, &attr, nullptr);
  return static_cast<int>(
      vec ? cudaOccupancyMaxActiveClusters(active, si_rows_apply<T, true, false, true>, &cfg)
          : cudaOccupancyMaxActiveClusters(active, si_rows_apply<T, true, false, false>, &cfg));
}

}  // namespace

// `work`: the scratch of kPlanes planes of (n_g, nx, ny); `table`: (n_g, 4)
// rows (dx, dy, ...); `beta`, `alpha`, `partial`: (n_g,) on the device;
// [r0, r1): the own rows; `coef`: theta*dt. `init` != 0 runs the start mode
// (x0 read, beta, src and dst unread); `precondition` == 0 runs plain CG.
// `cluster` (blocks a glacier), `threads`, `smem` and `vec` (16-byte
// vectors) are the host's plan (RowsLayout); a slab or plan the kernels do
// not take is refused with cudaErrorInvalidValue.
extern "C" int si_rows_apply_f32(float* work, const float* x0, const float* table,
                                 const float* beta, int src, int dst, int n_g, int nx, int ny,
                                 int r0, int r1, double coef, int init, int precondition,
                                 int cluster, int threads, int smem, int vec, float* partial,
                                 void* stream) {
  return apply<float>(work, x0, table, beta, src, dst, n_g, nx, ny, r0, r1, coef, init,
                      precondition, cluster, threads, smem, vec, partial, stream);
}

extern "C" int si_rows_apply_f64(double* work, const double* x0, const double* table,
                                 const double* beta, int src, int dst, int n_g, int nx, int ny,
                                 int r0, int r1, double coef, int init, int precondition,
                                 int cluster, int threads, int smem, int vec, double* partial,
                                 void* stream) {
  return apply<double>(work, x0, table, beta, src, dst, n_g, nx, ny, r0, r1, coef, init,
                       precondition, cluster, threads, smem, vec, partial, stream);
}

extern "C" int si_rows_update_f32(float* work, const float* alpha, int p_plane, int n_g, int nx,
                                  int ny, int r0, int r1, int precondition, int cluster,
                                  int threads, int smem, int vec, float* partial, void* stream) {
  return update<float>(work, alpha, p_plane, n_g, nx, ny, r0, r1, precondition, cluster, threads,
                       smem, vec, partial, stream);
}

extern "C" int si_rows_update_f64(double* work, const double* alpha, int p_plane, int n_g,
                                  int nx, int ny, int r0, int r1, int precondition, int cluster,
                                  int threads, int smem, int vec, double* partial, void* stream) {
  return update<double>(work, alpha, p_plane, n_g, nx, ny, r0, r1, precondition, cluster,
                        threads, smem, vec, partial, stream);
}

// cudaOccupancyMaxActiveClusters for si_rows_apply's iteration mode of that
// dtype and vector width at a cluster size, threads and shared memory.
extern "C" int si_rows_occupancy(int f64, int vec, int cluster, int threads, int smem,
                                 int* active) {
  return f64 ? occupancy<double>(vec, cluster, threads, smem, active)
             : occupancy<float>(vec, cluster, threads, smem, active);
}
