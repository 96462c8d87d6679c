// Fused semi-implicit theta-step: frozen diffusivity, right-hand side,
// Jacobi preconditioner and a fixed number of PCG iterations, then relu; and,
// as two more modes of the same kernels, the transpose solve of its backward
// and the tangent solve of its forward-mode derivative.
//
// Replaces the TPU kernel odinn_tpu/ops/pallas/si_kernel.py::si_step_pallas
// (pallas_call in _forward), which ran the whole step for one glacier in one
// program with ~9 live planes in VMEM and read (H, H_D, B, x0) once. Plain
// PyTorch version: ops/cuda/si_kernel.py::si_step_reference.
//
// What bounds it on the H100: neither bytes nor flops but latency. The step
// reads 4 planes and writes one (0.33 MB at 4 x 128^2 float32, 0.1 us at
// 3.35 TB/s), but each of the cg_iters iterations needs two whole-plane dot
// products before the next can start: a chain of barriers across all the
// threads that hold a glacier.
//
// Design (si_step_cluster). One launch a step, one thread-block cluster per
// glacier, of 16 blocks when the occupancy API says all the batch's
// clusters of 16 are resident at once (or when the plane fits only at 16),
// else of 8; the wrapper chooses (ops/cuda/si_kernel.py::si_plan) and
// launches through cudaLaunchKernelEx. Block `rank` owns rows [rank*rows,
// rank*rows + rows), rows = ceil(nx / cluster); blocks past the last row own
// none and only join the barriers and sums. Threads map in 2-D, lanes along
// the contiguous ny axis and warps along rows, and each thread owns fixed
// cells (at most K) for the whole step.
//  - Assembly reads H, H_D, B and x0 straight from device memory, halo rows
//    included, so it needs no exchange: each corner diffusivity the block's
//    rows touch is formed once into shared memory, then each thread forms
//    its cells' four face coefficients, b, the inverse Jacobi diagonal and
//    the initial residual b - A x0.
//  - Each thread keeps its cells' x, r, p, inverse diagonal and faces in
//    registers; Ap and z never leave it. Only M p (p with a zero ring) lives
//    in shared memory: the block's rows plus one halo row on each side.
//  - Dot products are deterministic and identical in every block: each
//    block reduces its partial in a fixed order (registers, warp shuffles,
//    the warps' partials in shared memory) and stores it into slot `rank` of
//    every block's slot array with st.async, whose arrival counts its bytes
//    on the receiving block's mbarrier (complete_tx). A block waits on its
//    own mbarrier until all the cluster's partials have landed, then sums
//    the slots in the same fixed order as every other block. Every block
//    gets bit-identical alpha and beta, so the blocks' iterates stay one
//    recursion. No atomics.
//  - The halo rows of p are formed locally. In the r.z round a block also
//    sends its first and last rows of M z into its neighbours' two halo
//    rows of z, counted on the same mbarrier; after the round every block
//    knows the same beta and updates its halo rows of p as their owner
//    updates them, p = fma(beta, p, z), bit for bit. So p needs no exchange
//    of its own.
//  Synchronisation a step: one cluster barrier at the start, split (arrive
//  first, wait after the assembly): the blocks have started and initialised
//  their mbarriers before any remote store. After it, no cluster barrier:
//  2*cg_iters rounds (r0.z0, then p.Ap and r.z an iteration, less the last
//  iteration's r.z, which no one reads), each one all-to-all exchange of
//  the partials through two mbarriers, one for the p.Ap rounds and one for
//  the r.z rounds. A round's data cannot be overtaken by the next round on
//  the same mbarrier: a block sends round k+1 of one kind only after it has
//  received every block's round of the other kind in between, which each
//  block sends only after it has read round k. The two mbarriers sit at the
//  start of the dynamic shared memory, so si_layout counts every byte a
//  block holds. The exchange's PTX is in cluster_exchange.cuh, and
//  profile_exchange.py times one round of it alone: on an H100 80GB HBM3
//  (700 W) about 1.7 us at 16 blocks, against about 2.4 us for plain remote
//  stores closed by a cluster barrier (PERF.md).
//  The PCG is the plain version's, with its guards (denom > 0, rz > 0,
//  tiny); 1/dx and 1/dy are formed once, and the exponent set (5, 2, 4, 2)
//  is a specialisation with fixed multiplies (GlenExps), any other set
//  takes pow_pos at run time (RuntimeExps).
//
// The transpose-solve mode (kMode kTranspose; ops/cuda/si_kernel.py::
// si_step_transpose, plain version si_step_transpose_reference) is the first
// half of the step's implicit-function adjoint, the gradient JAX gives
// odinn_tpu/simulation/implicit.py::semi_implicit_step through
// lax.custom_linear_solve: lambda = PCG(A, g) from the guess g, with
// g = gbar*[x > 0] formed in the kernel from the output cotangent gbar and
// the forward's pre-relu solution x (read where the forward reads H and x0).
// A and the Jacobi preconditioner are symmetric, so it is the forward's
// recursion on another right-hand side: the same assembly of D at H_D, the
// faces and the inverse diagonal, the same rounds of the same exchange, and
// lambda written without relu. Under grad the forward also writes x (xout).
//
// The tangent-solve mode (kMode kTangent; ops/cuda/si_kernel.py::
// si_step_tangent, plain version si_step_tangent_reference) is the jvp JAX
// gives the same step through lax.custom_linear_solve: xdot = PCG(A, rdot)
// run by the forward's solve closure, from the forward's guess x0 (not from
// zero), then xdot*[x > 0] with x the forward's pre-relu solution. The
// residual's tangent rdot is read where the forward reads H, the guess where
// it reads x0, and x through xout, which this mode reads instead of writing.
// The operator, faces, inverse diagonal, layout and exchange rounds are the
// forward's; only b (rdot as given, ring included) and the output differ.
//
// Without the preconditioner (template flag kJ false; precondition=False of
// si_step, si_step_transpose and si_step_tangent, plain version si_math.cg
// with no preconditioner) every mode runs plain CG: the inverse diagonal is 1, so z
// is r and its register copy and the multiply go. This is the solve the
// hand-written SI/SI2 transposes of odinn_tpu/inverse/gradient.py run
// (_cg without precond): the rematerialised step from H0 and the adjoint
// solve from gbar*[x > 0].
//
// A plane whose layout fits no cluster (more than 8 cells a thread or
// 227 KB of shared memory a block) takes the large-plane path of
// csrc/si_plane.cu, an assembly over tiles and one cooperative PCG launch
// across the card, whose assembly alone is also the row-sharded step's
// first launch; the plan chooses by shape alone.
#include <cooperative_groups.h>

#include "cluster_exchange.cuh"
#include "sia_common.cuh"

namespace cg = cooperative_groups;

namespace {

using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::cluster_arrive_relaxed;
using odinn::cluster_wait;
using odinn::fixed_sum;
using odinn::mapa;
using odinn::mbar_init;
using odinn::mbar_wait;
using odinn::relu;
using odinn::share_partial;
using odinn::smem_u32;
using odinn::st_async;

// ---------------------------------------------------------------------------
// The cluster kernel
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 512;   // blockDim.x * blockDim.y at most
constexpr int kMaxCluster = 16;    // blocks a glacier at most
constexpr int kMaxWarps = kMaxThreads / 32;
static_assert(kMaxCluster <= 16 && kMaxWarps <= 16, "fixed_sum sums at most 16 partials");
constexpr int kBarBytes = 16;      // the two mbarriers at the start of the shared memory

// the kernels' modes (the wrapper's `mode` argument)
constexpr int kForward = 0;
constexpr int kTranspose = 1;
constexpr int kTangent = 2;

// what an own cell does besides its update
constexpr int kRing = 1;       // on the plane's ring: A is the identity there
constexpr int kCorner = 2;     // forms the corner below-right of it
constexpr int kPushUp = 4;     // first row of the block: the upper neighbour's halo
constexpr int kPushDown = 8;   // last row of the block: the lower neighbour's halo
constexpr int kInXp = 16;      // the neighbour at row i+1 is interior
constexpr int kInXm = 32;      // ... at row i-1
constexpr int kInYp = 64;      // ... at column j+1
constexpr int kInYm = 128;     // ... at column j-1

// div(D grad u) at an interior cell from its face coefficients (x east,
// x west, y north, y south) and the 5-point values of u.
template <typename T>
__device__ __forceinline__ T div_faces(T xe, T xw, T yn, T ys, T uc, T uxp, T uxm, T uyp,
                                       T uym, T inv_dx, T inv_dy) {
  const T fxp = xe * ((uxp - uc) * inv_dx);
  const T fxm = xw * ((uc - uxm) * inv_dx);
  const T fyp = yn * ((uyp - uc) * inv_dy);
  const T fym = ys * ((uc - uym) * inv_dy);
  return (fxp - fxm) * inv_dx + (fyp - fym) * inv_dy;
}

// D of the corner whose upper-left cell is device index g of (H_D, B).
template <typename T, class E>
__device__ __forceinline__ T corner_at(const T* __restrict__ HD, const T* __restrict__ B,
                                       long g, int ny, const Recip<T>& k, const E& e) {
  const T h00 = relu(HD[g]), h01 = relu(HD[g + 1]);
  const T h10 = relu(HD[g + ny]), h11 = relu(HD[g + ny + 1]);
  return odinn::corner_D(h00, h10, h01, h11, B[g] + h00, B[g + ny] + h10, B[g + 1] + h01,
                         B[g + ny + 1] + h11, k, e);
}

// K: the cells a thread owns at most (2, 4 or 8; si_layout's cells,
// rounded up).
// kMode: kForward; kTranspose (H is gbar, x0 the forward's x); kTangent (H
// is rdot, x0 the forward's guess, xout the forward's x, read).
// kJ: Jacobi-preconditioned CG; without it plain CG (inverse diagonal 1).
template <typename T, class E, int K, int kMode, bool kJ>
__global__ void __launch_bounds__(kMaxThreads, 1)
si_step_cluster(const T* __restrict__ H, const T* __restrict__ HD, const T* __restrict__ B,
                const T* __restrict__ x0, const T* __restrict__ table, T* __restrict__ out,
                T* __restrict__ xout, int nx, int ny, T dt, T coef, T one_minus_theta,
                int cg_iters, E e) {
  cg::cluster_group cluster = cg::this_cluster();
  // dynamic shared memory, as si_layout counts it: the two mbarriers (of
  // the p.Ap and of the r.z rounds), then the T arrays below
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned bar_pap = smem_u32(smem_raw), bar_rz = bar_pap + 8;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    mbar_init(bar_pap);
    mbar_init(bar_rz);
    odinn::mbar_init_fence();
  }
  cluster_arrive_relaxed();   // this block has started; waited on before the first remote store
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int glacier = blockIdx.x / csize;
  const int rows = (nx + csize - 1) / csize;
  const int row0 = rank * rows;
  const int nrows = max(0, min(rows, nx - row0));
  const long plane = static_cast<long>(nx) * ny;
  // device index of slab index 0: slab row li is the plane's row row0-1+li
  const long gbase = static_cast<long>(glacier) * plane + static_cast<long>(row0 - 1) * ny;

  // M p, rows + 2 rows; the corner D during assembly
  T* P = reinterpret_cast<T*>(smem_raw + kBarBytes);
  const int slab = (rows + 2) * ny;
  T* Zh = P + slab;                        // M z of the halo rows: row 0 above, row 1 below
  T* slots_pap = Zh + 2 * ny;              // the blocks' partials of p.Ap, by rank
  T* slots_rz = slots_pap + kMaxCluster;   // ... of r.z
  // the warps' partials, [2][16] alternating by round: a thread may still
  // read one round's while the block's other warps, past the round's wait,
  // write the next round's
  T* warp_part = slots_rz + kMaxCluster;

  const Recip<T> k = odinn::recip_row(table + 4L * glacier);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockDim.x, by = blockDim.y;
  const int tid = ty * bx + tx, nthreads = bx * by;
  const int nwarps = nthreads >> 5;
  const T tiny = static_cast<T>(1e-300);   // 0 in float32, as in the plain version

  // the thread's own cells: row ty + by*rr, column tx + bx*cc
  const int cols = (ny + bx - 1) / bx;
  int sidx[K], flags[K];
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
    if (gi + 1 <= nx - 2) f |= kInXp;
    if (gi - 1 >= 1) f |= kInXm;
    if (j + 1 <= ny - 2) f |= kInYp;
    if (j - 1 >= 1) f |= kInYm;
    flags[q] = f;
  }
  const bool has_up = nrows > 0 && row0 > 0;
  const bool has_down = nrows > 0 && row0 + nrows < nx;
  // the neighbours' z halo rows: the upper one's row 1, the lower one's row 0
  const unsigned up = has_up ? mapa(smem_u32(Zh + ny), rank - 1) : 0u;
  const unsigned down = has_down ? mapa(smem_u32(Zh), rank + 1) : 0u;
  const unsigned up_bar = has_up ? mapa(bar_rz, rank - 1) : 0u;
  const unsigned down_bar = has_down ? mapa(bar_rz, rank + 1) : 0u;
  const int halo_values = (has_up ? ny : 0) + (has_down ? ny : 0);
  unsigned par_pap = 0, par_rz = 0;
  int round = 0;
  T w[K];   // per own cell: z, or Ap between the matvec and the update
  // M z of the block's first and last rows into the neighbours' halo rows
  auto push_z = [&]() {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (sidx[q] < 0) continue;
      const T zm = (flags[q] & kRing) ? T(0) : w[q];
      if (flags[q] & kPushUp) st_async(up + (sidx[q] - ny) * sizeof(T), zm, up_bar);
      if (flags[q] & kPushDown) st_async(down + (sidx[q] - nrows * ny) * sizeof(T), zm, down_bar);
    }
  };

  // assembly: the corners the block's rows touch, once each
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (sidx[q] >= 0 && (flags[q] & kCorner)) {
      P[sidx[q]] = corner_at(HD, B, gbase + sidx[q], ny, k, e);
    }
  }
  if (has_up) {   // the corner row above the block
    for (int j = tid; j < ny - 1; j += nthreads) P[j] = corner_at(HD, B, gbase + j, ny, k, e);
  }
  __syncthreads();

  constexpr bool kT = kMode == kTranspose;
  // the guess at device index gg: x0, or g = gbar*[x > 0] in the transpose
  // mode, which is also its right-hand side
  auto guess = [&](long gg) { return kT ? (x0[gg] > T(0) ? H[gg] : T(0)) : x0[gg]; };
  // faces, b, the inverse diagonal, r0 = b - A x0, z0 = r0/diag, p0 = z0
  T x[K], r[K], p[K], inv[K], fxe[K], fxw[K], fyn[K], fys[K];
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    x[q] = r[q] = p[q] = w[q] = fxe[q] = fxw[q] = fyn[q] = fys[q] = T(0);
    inv[q] = T(1);
    if (sidx[q] < 0) continue;
    const int s = sidx[q], f = flags[q];
    const long g = gbase + s;
    const T xc = guess(g);
    T b, ax;
    if (f & kRing) {
      b = kT ? xc : H[g];
      ax = xc;
    } else {
      const T d00 = P[s - ny - 1], d01 = P[s - ny], d10 = P[s - 1], d11 = P[s];
      fxe[q] = T(0.5) * (d10 + d11);
      fxw[q] = T(0.5) * (d00 + d01);
      fyn[q] = T(0.5) * (d01 + d11);
      fys[q] = T(0.5) * (d00 + d10);
      if (kT) {
        b = xc;
      } else if (kMode == kTangent) {
        b = H[g];
      } else {
        // u = B + ring*H + (1-theta)*M*H on the 5 points
        auto u = [&](long gg, bool in) {
          return in ? B[gg] + one_minus_theta * H[gg] : B[gg] + H[gg];
        };
        const T div_b = div_faces(fxe[q], fxw[q], fyn[q], fys[q], u(g, true),
                                  u(g + ny, f & kInXp), u(g - ny, f & kInXm),
                                  u(g + 1, f & kInYp), u(g - 1, f & kInYm), k.inv_dx, k.inv_dy);
        b = H[g] + dt * div_b;
      }
      if (kJ) {
        const T sx = (fxw[q] + fxe[q]) * (k.inv_dx * k.inv_dx);
        const T sy = (fys[q] + fyn[q]) * (k.inv_dy * k.inv_dy);
        inv[q] = T(1) / (T(1) + coef * (sx + sy));
      }
      // M x0 on the 5 points
      auto m = [&](long gg, bool in) { return in ? guess(gg) : T(0); };
      const T div_x = div_faces(fxe[q], fxw[q], fyn[q], fys[q], xc, m(g + ny, f & kInXp),
                                m(g - ny, f & kInXm), m(g + 1, f & kInYp),
                                m(g - 1, f & kInYm), k.inv_dx, k.inv_dy);
      ax = xc - coef * div_x;
    }
    x[q] = xc;
    r[q] = b - ax;
    w[q] = kJ ? r[q] * inv[q] : r[q];   // z0
    p[q] = w[q];
    acc += r[q] * w[q];
  }
  __syncthreads();   // every thread has read its corners: the slab becomes M p
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (sidx[q] >= 0) P[sidx[q]] = (flags[q] & kRing) ? T(0) : p[q];
  }
  // r0.z0 and the halo rows of z0, after every block of the cluster has
  // started (its shared memory may be written)
  cluster_wait();
  share_partial(acc, warp_part + 16 * (round++ & 1), slots_rz, bar_rz, halo_values, tid, nwarps,
                csize, rank);
  push_z();
  mbar_wait(bar_rz, par_rz);
  par_rz ^= 1u;
  T rz = fixed_sum(slots_rz, csize);
  if (has_up) {
    for (int j = tid; j < ny; j += nthreads) P[j] = Zh[j];
  }
  if (has_down) {
    for (int j = tid; j < ny; j += nthreads) P[(nrows + 1) * ny + j] = Zh[ny + j];
  }
  __syncthreads();

  for (int it = 0; it < cg_iters; ++it) {
    // Ap (into w) and p.Ap
    acc = T(0);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (sidx[q] < 0) continue;
      const int s = sidx[q];
      if (flags[q] & kRing) {
        w[q] = p[q];
      } else {
        const T div = div_faces(fxe[q], fxw[q], fyn[q], fys[q], p[q], P[s + ny], P[s - ny],
                                P[s + 1], P[s - 1], k.inv_dx, k.inv_dy);
        w[q] = p[q] - coef * div;
      }
      acc += p[q] * w[q];
    }
    share_partial(acc, warp_part + 16 * (round++ & 1), slots_pap, bar_pap, 0, tid, nwarps,
                  csize, rank);
    mbar_wait(bar_pap, par_pap);
    par_pap ^= 1u;
    const T denom = fixed_sum(slots_pap, csize);
    const T alpha = denom > T(0) ? rz / fmax(denom, tiny) : T(0);
    // x, r, z (into w) and r.z
    acc = T(0);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (sidx[q] < 0) continue;
      x[q] = x[q] + alpha * p[q];
      r[q] = r[q] - alpha * w[q];
      w[q] = kJ ? r[q] * inv[q] : r[q];
      acc += r[q] * w[q];
    }
    if (it == cg_iters - 1) break;   // x is final; no one reads the last r.z
    share_partial(acc, warp_part + 16 * (round++ & 1), slots_rz, bar_rz, halo_values, tid,
                  nwarps, csize, rank);
    push_z();
    mbar_wait(bar_rz, par_rz);
    par_rz ^= 1u;
    const T rz_new = fixed_sum(slots_rz, csize);
    const T beta = rz > T(0) ? rz_new / fmax(rz, tiny) : T(0);
    // p = z + beta p: own cells, and the halo rows as their owners form them
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (sidx[q] < 0) continue;
      p[q] = fma(beta, p[q], w[q]);
      P[sidx[q]] = (flags[q] & kRing) ? T(0) : p[q];
    }
    if (has_up) {
      for (int j = tid; j < ny; j += nthreads) P[j] = fma(beta, P[j], Zh[j]);
    }
    if (has_down) {
      T* h = P + (nrows + 1) * ny;
      for (int j = tid; j < ny; j += nthreads) h[j] = fma(beta, h[j], Zh[ny + j]);
    }
    rz = rz_new;
    __syncthreads();   // the next matvec reads other threads' p
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (sidx[q] < 0) continue;
    const long g = gbase + sidx[q];
    if (kMode == kForward) {
      out[g] = relu(x[q]);
      if (xout != nullptr) xout[g] = x[q];
    } else if (kMode == kTangent) {
      out[g] = xout[g] > T(0) ? x[q] : T(0);
    } else {
      out[g] = x[q];
    }
  }
  // every store into this block's shared memory has landed before its last
  // wait returned, so a block may leave without waiting for its neighbours
}

// Once per instantiation: all the opt-in shared memory as dynamic (the
// kernel has no static shared memory), and the non-portable cluster size
// of 16.
template <typename T, class E, int K, int kMode, bool kJ>
int prepare() {
  static int state = -1;
  if (state < 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(si_step_cluster<T, E, K, kMode, kJ>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(si_step_cluster<T, E, K, kMode, kJ>,
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

// In the transpose mode H is gbar and x0 the forward's x; in the tangent
// mode H is rdot and xout the forward's x (see above).
template <typename T>
struct StepArgs {
  const T *H, *HD, *B, *x0, *table;
  T *out, *xout;
  int nx, ny, cg_iters, mode, precondition;
  double dt, theta;
};

template <typename T, class E, int K, int kMode, bool kJ>
int launch_mode(const StepArgs<T>& a, E e, const Shape& sh, void* stream) {
  const int ready = prepare<T, E, K, kMode, kJ>();
  if (ready != 0) return ready;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(sh, &attr, static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, si_step_cluster<T, E, K, kMode, kJ>, a.H, a.HD, a.B, a.x0, a.table, a.out, a.xout,
      a.nx, a.ny, static_cast<T>(a.dt), static_cast<T>(a.theta * a.dt),
      static_cast<T>(1.0 - a.theta), a.cg_iters, e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class E, int K, int kMode>
int launch_pre(const StepArgs<T>& a, E e, const Shape& sh, void* stream) {
  return a.precondition ? launch_mode<T, E, K, kMode, true>(a, e, sh, stream)
                        : launch_mode<T, E, K, kMode, false>(a, e, sh, stream);
}

template <typename T, class E, int K>
int launch_k(const StepArgs<T>& a, E e, const Shape& sh, void* stream) {
  switch (a.mode) {
    case kForward: return launch_pre<T, E, K, kForward>(a, e, sh, stream);
    case kTranspose: return launch_pre<T, E, K, kTranspose>(a, e, sh, stream);
    case kTangent: return launch_pre<T, E, K, kTangent>(a, e, sh, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, class E>
int launch_cells(const StepArgs<T>& a, E e, const Shape& sh, void* stream) {
  if (sh.cells <= 2) return launch_k<T, E, 2>(a, e, sh, stream);
  if (sh.cells <= 4) return launch_k<T, E, 4>(a, e, sh, stream);
  if (sh.cells <= 8) return launch_k<T, E, 8>(a, e, sh, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Call launch(e) with the step's exponent set e: the (5, 2, 4, 2)
// specialisation when `glen` != 0, else e_* at run time.
template <typename T, class F>
int with_exps(int glen, double e_hc, double e_sc, double e_hs, double e_ss, F&& launch) {
  if (glen) return launch(GlenExps<T>{});
  return launch(RuntimeExps<T>{static_cast<T>(e_hc), static_cast<T>(e_sc),
                               static_cast<T>(e_hs), static_cast<T>(e_ss)});
}

// The preconditioned forward's instance; the other modes launch at the
// same layout.
template <typename T, class E, int K>
int occupancy_k(const Shape& sh, int* active) {
  const int ready = prepare<T, E, K, kForward, true>();
  if (ready != 0) return ready;
  cudaLaunchAttribute attr;
  Shape one = sh;
  one.n_g = 1;
  const cudaLaunchConfig_t cfg = config(one, &attr, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(active, si_step_cluster<T, E, K, kForward, true>, &cfg));
}

template <typename T, class E>
int occupancy(const Shape& sh, int* active) {
  if (sh.cells <= 2) return occupancy_k<T, E, 2>(sh, active);
  if (sh.cells <= 4) return occupancy_k<T, E, 4>(sh, active);
  if (sh.cells <= 8) return occupancy_k<T, E, 8>(sh, active);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
StepArgs<T> step_args(const T* H, const T* HD, const T* B, const T* x0, const T* table,
                      T* out, T* xout, int nx, int ny, double dt, double theta, int cg_iters,
                      int mode, int precondition) {
  return StepArgs<T>{H, HD, B, x0, table, out, xout, nx, ny, cg_iters, mode, precondition, dt,
                     theta};
}

}  // namespace

// The cluster kernel. `glen` != 0 takes the (5, 2, 4, 2) specialisation and
// ignores e_*; `cluster`, `bx`, `by`, `smem` and `cells` are the wrapper's
// layout (si_layout). `table` is the (n_g, 4) table (dx, dy, creep, slide).
// `xout` (may be null) receives the pre-relu solution; `mode` 1 runs the
// transpose-solve mode, with gbar in H and the forward's x in x0; `mode` 2
// the tangent-solve mode, with rdot in H, the forward's guess in x0 and its x
// in xout (read); `precondition` == 0 runs plain CG in any mode.
extern "C" int si_step_cluster_f32(const float* H, const float* HD, const float* B,
                                   const float* x0, const float* table, float* out,
                                   float* xout, int n_g, int nx, int ny, double dt,
                                   double theta, int cg_iters, int mode, int precondition,
                                   int glen, double e_hc, double e_sc, double e_hs, double e_ss,
                                   int cluster, int bx, int by, int smem, int cells,
                                   void* stream) {
  const StepArgs<float> a =
      step_args(H, HD, B, x0, table, out, xout, nx, ny, dt, theta, cg_iters, mode,
                precondition);
  const Shape sh{n_g, cluster, bx, by, smem, cells};
  return with_exps<float>(glen, e_hc, e_sc, e_hs, e_ss,
                          [&](auto e) { return launch_cells<float>(a, e, sh, stream); });
}

extern "C" int si_step_cluster_f64(const double* H, const double* HD, const double* B,
                                   const double* x0, const double* table, double* out,
                                   double* xout, int n_g, int nx, int ny, double dt,
                                   double theta, int cg_iters, int mode, int precondition,
                                   int glen, double e_hc, double e_sc, double e_hs, double e_ss,
                                   int cluster, int bx, int by, int smem, int cells,
                                   void* stream) {
  const StepArgs<double> a =
      step_args(H, HD, B, x0, table, out, xout, nx, ny, dt, theta, cg_iters, mode,
                precondition);
  const Shape sh{n_g, cluster, bx, by, smem, cells};
  return with_exps<double>(glen, e_hc, e_sc, e_hs, e_ss,
                           [&](auto e) { return launch_cells<double>(a, e, sh, stream); });
}

// cudaOccupancyMaxActiveClusters for the cluster kernel of that dtype
// (f64 != 0) and exponent path at one layout, into *active.
extern "C" int si_step_occupancy(int f64, int glen, int cluster, int bx, int by, int smem,
                                 int cells, int* active) {
  const Shape sh{1, cluster, bx, by, smem, cells};
  if (f64) {
    return with_exps<double>(glen, 0, 0, 0, 0, [&](auto e) {
      return occupancy<double, decltype(e)>(sh, active);
    });
  }
  return with_exps<float>(glen, 0, 0, 0, 0,
                          [&](auto e) { return occupancy<float, decltype(e)>(sh, active); });
}
