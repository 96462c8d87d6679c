// Pullback of the fused semi-implicit theta-step (A target, per-glacier
// scalar laws), the second half of its implicit-function adjoint: given
// lambda, the transpose solve's solution (si_step.cu's transpose mode), the
// cotangents of H, H_D, B and of each glacier's creep and slide prefactors.
//
// Replaces, with the production contract, the backward of the TPU kernel
// odinn_tpu/ops/pallas/si_kernel.py::si_step_pallas (_fwd/_bwd, which
// differentiated the unrolled jnp mirror of the PCG). The gradient here is
// the one JAX gives odinn_tpu/simulation/implicit.py::semi_implicit_step
// through lax.custom_linear_solve: x0, the spacings and the Jacobi
// preconditioner get none. Plain PyTorch version:
// ops/cuda/si_kernel.py::si_step_vjp_reference.
//
// The math. x is the forward's pre-relu solution, M the interior mask,
// L_D(u) = div(D grad u) on the interior with D frozen at H_D (S = B +
// relu(H_D)). The residual b - A(D) x, with x held fixed, is H - x +
// dt M L_D(u), u = B + ring*H + (1-theta)*M*H + theta*M*x, since L_D is
// linear in u. Its vector-Jacobian product at lambda is one pullback of the
// pairing P = <w, L_D(u)>, w = dt*M*lambda:
//  - per cell, ubar = dP/du = L_D(w) at every cell (the ring too; w is zero
//    there), from the cell's four face diffusivities;
//    dH = lambda + ubar*(ring ? 1 : 1 - theta), dB = ubar + Sbar;
//  - per corner (a, c), Dbar = dP/dD = -(Gx(a, c) + Gx(a, c+1))/2
//    - (Gy(a, c) + Gy(a+1, c))/2, with G the product of the u and w
//    differences across an x- or y-face over dx^2 or dy^2 (zero on faces
//    with w zero at both ends, so no face needs a mask);
//  - Dbar through D = creep*hbar^(n+2)|grad S|^(n-1) + slide*hbar^(p-q+1)
//    |grad S|^(p-1): to the four cells' relu(H_D) (Q) and S (PX, PY, whose
//    sum Sbar goes to B and, through relu, to H_D), and d(creep), d(slide)
//    = sum over corners of Dbar times the two power products.
//
// What bounds it on the H100: bytes, by count. Per cell it reads lambda, H,
// H_D, B and x and writes three planes, 32 bytes in float32, against ~160
// operations a cell: 8 MB at 16 x 128^2 (2.5 us at 3.35 TB/s), 2 MB at
// 4 x 128^2. At those sizes a launch is a few microseconds, and what it
// loses is latency and issue: a cluster launch with its barrier and sums
// costs about 2 us before any work, the tile's bytes arrive over about
// 2 us, and the arithmetic runs at ~16 warps an SM (a cluster per glacier
// holds at most 16 blocks, and at 16 glaciers the GPCs hold 16 clusters
// only at two blocks an SM or more), so each SM works through its ~16 rows
// with few warps to hide latency (PERF.md; profile_vjp.py).
//
// Design: one thread-block cluster of 8 or 16 blocks per glacier, 256
// threads a block, chosen by occupancy (ops/cuda/si_kernel.py::si_vjp_plan,
// si_vjp_layout) and launched through cudaLaunchKernelEx. The plane is cut
// into tiles of `rows` full-width rows (or, where a row does not fit the
// shared memory, column chunks of `cols` cells); block `rank` walks tiles
// rank, rank + cluster, ... Per tile:
//  - Loads. The block copies its tile and a one-cell ring of lambda, H,
//    H_D, B and x into shared memory with cp.async, asynchronously: 16-byte
//    cp.async.cg where a row's byte stride and the planes' addresses are
//    multiples of 16 (template flag kVec), else one element a copy. Every
//    copy of the tile is issued before the block waits on any, and where a
//    block walks more than one tile the copies go into a two-stage ring:
//    the next tile's copies are issued before this tile computes. Each
//    input byte is read once, plus the ring rows (1.25x at the 8-row tiles
//    of 16-block clusters over 128 rows); where H_D is H (the SI
//    trainings' call) its copy is skipped and H is read in its place.
//  - Phases, each over all threads in equal shares (within one item), an
//    item two vertically adjacent rows of one column, which share their
//    loads and overlap their latencies: (a) each ring cell's u and w, over
//    the staged planes (x, and H or the uncopied H_D); (b) every corner of
//    the tile, once, from its cells' relu(H_D), S = B + relu(H_D), u and
//    w: D, the four
//    face products, Dbar, and the three numbers a cell takes from it (Q,
//    PX, PY), with the two power products summed into the thread's
//    d(creep) and d(slide) for the corners the tile owns (only the corner
//    row and column shared with the tiles above and to the left are formed
//    twice); (c) each cell gathers its four corners and stores dH, dH_D and
//    dB. With the Glen exponents |grad S| enters D only squared, so a
//    corner takes |grad S|^2 itself, with no square root or division.
//  - d(creep), d(slide): each block reduces its threads' sums in a fixed
//    order (warp shuffle trees, then one over the warps' partials) and its
//    thread 0 stores the two into block 0's slots over distributed shared
//    memory (st.async, counted on block 0's mbarrier); block 0 waits on its
//    mbarrier and sums the slots in block order. No global partials, no
//    fence, no counter; repeated launches are bitwise equal. One split
//    cluster barrier (arrive at the start, wait before the stores) makes
//    sure block 0 has started and initialised its mbarrier.
// The corner and cell arithmetic is si_vjp_common.cuh's, which the
// large-plane pullback si_plane_vjp.cu shares: every plane that fits no
// cluster of si_step.cu takes that kernel instead of this one.
// The exponent set is one per launch, from the host: (5, 2, 4, 2) takes
// fixed multiplies (GlenExps), any other pow_pos at run time (RuntimeExps).
// The table is read in place, in H's dtype or in float64 (cast to H's as
// the plain version casts it): row g at table + g * table_stride.
#include <cooperative_groups.h>

#include <type_traits>

#include "cluster_exchange.cuh"
#include "sia_common.cuh"
#include "si_vjp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using odinn::CellTerms;
using odinn::Corner;
using odinn::CornerTerms;
using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::cluster_arrive_relaxed;
using odinn::cluster_wait;
using odinn::mapa;
using odinn::mbar_init;
using odinn::mbar_wait;
using odinn::relu;
using odinn::smem_u32;
using odinn::st_async;
using odinn::warp_tree;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
static_assert(kWarps <= 32 && kMaxCluster <= 32, "one warp sums the partials");
// The dynamic shared memory, as si_vjp_layout counts it: the mbarrier
// (padded to 16 bytes), 2 x 16 slots and 2 x 16 warp partials of T, then
// `stages` x 5 staged planes of (rows + 2) x pitch values, each 16-byte
// aligned, then (rows + 1) x (cols + 1) corners of 4 values (D, Q, PX,
// PY). pitch = cols + 2 * kOff, and shared column m holds the plane's
// column c0 - kOff + m.
constexpr int kBarBytes = 16;
constexpr int kHeadValues = 64;
constexpr int kPlanes = 5;   // lambda, H, H_D, B, x; after (a) x holds u, and H (or H_D) w

template <typename T>
constexpr int kOff = 16 / static_cast<int>(sizeof(T));

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

template <typename T>
struct VjpArgs {
  const T *lam, *H, *HD, *B, *x;
  const void* table;    // row g at table + g * table_stride: dx, dy, creep, slide
  long table_stride;
  int table_f64;        // the table is float64 (else T)
  int hd_is_h;          // H_D is H (the same plane): its copy is skipped
  T *dH, *dHD, *dB;
  T *dcreep, *dslide;   // (n_g,)
  int nx, ny, rows, cols;
  T dt, theta;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The items start, start + kThreads, ... of a grid `width` wide, walked as
// (row r, column c) and the index i = r * stride + c, with no division per
// step.
struct Walk {
  int r, c, i, dr, dc, di, w, wrap;
  __device__ __forceinline__ Walk(int start, int width, int stride) : w(width) {
    r = start / width;
    c = start - r * width;
    i = r * stride + c;
    dr = kThreads / width;
    dc = kThreads - dr * width;
    di = dr * stride + dc;
    wrap = stride - width;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    i += di;
    if (c >= w) {
      c -= w;
      ++r;
      i += wrap;
    }
  }
};

__device__ __forceinline__ bool below(int v, int n) {   // 0 <= v < n
  return static_cast<unsigned>(v) < static_cast<unsigned>(n);
}

template <typename T, class E, bool kVec>
__global__ void __launch_bounds__(kThreads, 3) si_step_vjp_kernel(VjpArgs<T> p, E e) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const unsigned bar = smem_u32(smem);
  T* slots = reinterpret_cast<T*>(smem + kBarBytes);   // [2][kMaxCluster], block 0's
  T* warp_part = slots + 2 * kMaxCluster;              // [2][kWarps]
  if (rank == 0 && tid == 0) {
    mbar_init(bar);
    odinn::mbar_init_fence();
    // the phase completes when the cluster's 2 x csize values have landed
    odinn::mbar_expect(bar, 2 * csize * static_cast<int>(sizeof(T)));
  }
  cluster_arrive_relaxed();   // this block has started; waited on before the stores

  constexpr int O = kOff<T>;
  const int nx = p.nx, ny = p.ny, R = p.rows, C = p.cols;
  const int pitch = C + 2 * O;
  const int g = blockIdx.x / csize;
  const long off = static_cast<long>(g) * nx * ny;
  const int ntc = (ny + C - 1) / C;
  const int ntiles = ((nx + R - 1) / R) * ntc;
  const bool two_stages = (ntiles + csize - 1) / csize > 1;
  const int plane_vals = align16((R + 2) * pitch * static_cast<int>(sizeof(T))) /
                         static_cast<int>(sizeof(T));
  T* const staged = reinterpret_cast<T*>(smem + kBarBytes) + kHeadValues;
  Corner<T>* const corners =
      reinterpret_cast<Corner<T>*>(staged + (two_stages ? 2 : 1) * kPlanes * plane_vals);

  // the copies of tile `tile` into stage `s`, one commit group: shared
  // (kr, m) is the plane's cell (r0 - 1 + kr, c0 - O + m)
  auto issue = [&](int tile, int s) {
    const int r0 = (tile / ntc) * R, c0 = (tile % ntc) * C;
    T* const dst = staged + s * kPlanes * plane_vals;
    const long base = off + static_cast<long>(r0 - 1) * ny + (c0 - O);
    auto copy = [&](int kr, int m, int si) {
      if (!below(r0 - 1 + kr, nx) || !below(c0 - O + m, ny)) return;
      const long gi = base + static_cast<long>(kr) * ny + m;
      T* const d = dst + si;
      if (kVec) {
        cp_async16(d, p.lam + gi);
        cp_async16(d + plane_vals, p.H + gi);
        if (!p.hd_is_h) cp_async16(d + 2 * plane_vals, p.HD + gi);
        cp_async16(d + 3 * plane_vals, p.B + gi);
        cp_async16(d + 4 * plane_vals, p.x + gi);
      } else {
        cp_async_ca<sizeof(T)>(d, p.lam + gi);
        cp_async_ca<sizeof(T)>(d + plane_vals, p.H + gi);
        if (!p.hd_is_h) cp_async_ca<sizeof(T)>(d + 2 * plane_vals, p.HD + gi);
        cp_async_ca<sizeof(T)>(d + 3 * plane_vals, p.B + gi);
        cp_async_ca<sizeof(T)>(d + 4 * plane_vals, p.x + gi);
      }
    };
    if (kVec) {   // 16-byte vectors: the tile's rows whole, ring and padding
      for (Walk it(tid, pitch / O, pitch / O); it.r < R + 2; it.next()) {
        copy(it.r, it.c * O, it.r * pitch + it.c * O);
      }
    } else {      // one value a copy: the tile's columns and its ring
      for (Walk it(tid, C + 2, pitch); it.r < R + 2; it.next()) {
        copy(it.r, O - 1 + it.c, it.i + O - 1);
      }
    }
    cp_async_commit();
  };

  T creep_part = T(0), slide_part = T(0);
  if (rank < ntiles) issue(rank, 0);
  // read while the first tile's copies are in flight
  const Recip<T> k = odinn::vjp_table_row<T>(p.table, p.table_stride, p.table_f64, g);
  const T dt = p.dt, theta = p.theta, one_minus_theta = T(1) - p.theta;
  int s = 0;
  for (int tile = rank; tile < ntiles; tile += csize, s ^= 1) {
    if (tile + csize < ntiles) {
      issue(tile + csize, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (tile / ntc) * R, c0 = (tile % ntc) * C;
    T* const sl = staged + s * kPlanes * plane_vals;   // lambda
    T* const sH = sl + plane_vals;                     // H
    T* const sD = sH + plane_vals;                     // H_D
    T* const sB = sD + plane_vals;                     // B
    T* const sx = sB + plane_vals;                     // x
    // relu(H_D) is read from H_D, or from H where H_D is H (its copy was
    // skipped); (a) writes u over x, and w over the plane it no longer
    // needs (H, or the H_D never copied)
    const T* const hsrc = p.hd_is_h ? sH : sD;
    T* const su = sx;
    T* const sw = p.hd_is_h ? sD : sH;

    // Each thread takes items of two vertically adjacent rows, which share
    // loads and overlap their latencies; a second row past the grid is
    // formed from rows the grid has and discarded.

    // (a) the ring cell (kr, O - 1 + c) of shared memory, the plane's cell
    // (r0 - 1 + kr, c0 - 1 + c): u = B + ring*H + (1-theta)*M*H + theta*M*x
    // and w = dt*M*lambda, zero off the plane. Off the plane the staged
    // values were never copied: they are read and discarded (relu(H_D) and
    // S are formed where (b) needs them, on the plane).
    auto transform = [&](int kr, int c, T& u, T& w) {
      const int gr = r0 - 1 + kr, gc = c0 - 1 + c, si = kr * pitch + O - 1 + c;
      const bool in = below(gr, nx) && below(gc, ny);
      const bool interior = below(gr - 1, nx - 2) && below(gc - 1, ny - 2);
      const T b = sB[si], hh = sH[si], xx = sx[si], lam = sl[si];
      const T ui = interior ? b + one_minus_theta * hh + theta * xx : b + hh;
      u = in ? ui : T(0);
      w = interior ? dt * lam : T(0);
    };
    for (Walk it(tid, C + 2, C + 2); it.r < (R + 3) / 2; it.next()) {
      const int kr = 2 * it.r, kr2 = min(kr + 1, R + 1);
      T u0, w0, u1, w1;
      transform(kr, it.c, u0, w0);
      transform(kr2, it.c, u1, w1);
      const int si = kr * pitch + O - 1 + it.c;
      su[si] = u0;
      sw[si] = w0;
      if (kr + 1 <= R + 1) {
        su[si + pitch] = u1;
        sw[si + pitch] = w1;
      }
    }
    __syncthreads();

    // (b) corner (lr, lc) is the plane's corner (r0 - 1 + lr, c0 - 1 + lc),
    // formed from the cells (lr .. lr+1, O-1+lc .. O+lc) in shared memory;
    // the tile owns those with lr, lc >= 1, and sums their two power
    // products into the thread's d(creep) and d(slide). Corners off the
    // plane are formed from the zeros and discarded.
    for (Walk it(tid, C + 1, C + 1); it.r < (R + 2) / 2; it.next()) {
      const int lr = 2 * it.r, lc = it.c;
      const bool second = lr + 1 <= R;
      // cell rows lr, lr+1, lr+2 (the last clamped to the staged rows)
      const int i0 = lr * pitch + O - 1 + lc, i1 = i0 + pitch;
      const int i2 = second ? i1 + pitch : i1;
      // relu(H_D) and S = B + relu(H_D) of the six cells
      const T h0a = relu(hsrc[i0]), h0b = relu(hsrc[i0 + 1]), h1a = relu(hsrc[i1]);
      const T h1b = relu(hsrc[i1 + 1]), h2a = relu(hsrc[i2]), h2b = relu(hsrc[i2 + 1]);
      const T s0a = sB[i0] + h0a, s0b = sB[i0 + 1] + h0b, s1a = sB[i1] + h1a;
      const T s1b = sB[i1 + 1] + h1b, s2a = sB[i2] + h2a, s2b = sB[i2 + 1] + h2b;
      const T u0a = su[i0], u0b = su[i0 + 1], u1a = su[i1], u1b = su[i1 + 1];
      const T u2a = su[i2], u2b = su[i2 + 1];
      const T w0a = sw[i0], w0b = sw[i0 + 1], w1a = sw[i1], w1b = sw[i1 + 1];
      const T w2a = sw[i2], w2b = sw[i2 + 1];
      const CornerTerms<T> t0 = form_corner(h0a, h1a, h0b, h1b, s0a, s1a, s0b, s1b, u0a, u1a,
                                            u0b, u1b, w0a, w1a, w0b, w1b, k, e);
      const CornerTerms<T> t1 = form_corner(h1a, h2a, h1b, h2b, s1a, s2a, s1b, s2b, u1a, u2a,
                                            u1b, u2b, w1a, w2a, w1b, w2b, k, e);
      const int a = r0 - 1 + lr, c = c0 - 1 + lc;
      const bool col_on = below(c, ny - 1), col_own = col_on && lc >= 1;
      const bool on0 = col_on && below(a, nx - 1), on1 = col_on && below(a + 1, nx - 1);
      const Corner<T> zero{T(0), T(0), T(0), T(0)};
      const int ci = lr * (C + 1) + lc;
      corners[ci] = on0 ? t0.v : zero;
      if (on0 && col_own && lr >= 1) {
        creep_part += t0.creep;
        slide_part += t0.slide;
      }
      if (second) {
        corners[ci + C + 1] = on1 ? t1.v : zero;
        if (on1 && col_own) {
          creep_part += t1.creep;
          slide_part += t1.slide;
        }
      }
    }
    __syncthreads();

    // (c) tile cell (li, lj) is the plane's cell (r0 + li, c0 + lj); its
    // corners are (li + ca, lj + cc), and it sits at the + end of a
    // corner's slopes when ca = 0 (x) or cc = 0 (y)
    const long tile_base = off + static_cast<long>(r0) * ny + c0;
    for (Walk it(tid, C, C); it.r < (R + 1) / 2; it.next()) {
      const int li = 2 * it.r, lj = it.c;
      const bool second = li + 1 < R;
      // corner rows li, li+1, li+2 (the last clamped to the corner rows)
      const int c0i = li * (C + 1) + lj, c1i = c0i + C + 1;
      const int c2i = second ? c1i + C + 1 : c1i;
      const Corner<T> k0a = corners[c0i], k0b = corners[c0i + 1];
      const Corner<T> k1a = corners[c1i], k1b = corners[c1i + 1];
      const Corner<T> k2a = corners[c2i], k2b = corners[c2i + 1];
      // w in column O + lj at rows li .. li+3, and beside the two cells
      const int si = (li + 1) * pitch + O + lj;
      const int s3 = second ? si + 2 * pitch : si + pitch;
      const T wm = sw[si - pitch], wa = sw[si], wb = sw[si + pitch], wp = sw[s3];
      const T wa_l = sw[si - 1], wa_r = sw[si + 1];
      const T wb_l = sw[si + pitch - 1], wb_r = sw[si + pitch + 1];
      const CellTerms<T> ta = gather_cell(k0a, k0b, k1a, k1b, wa, wb, wm, wa_r, wa_l, k);
      const CellTerms<T> tb = gather_cell(k1a, k1b, k2a, k2b, wb, wp, wa, wb_r, wb_l, k);
      const int i = r0 + li, j = c0 + lj;
      if (j >= ny || i >= nx) continue;
      const bool ring_col = j == 0 || j == ny - 1;
      const long gi = tile_base + (li * ny + lj);
      const bool ring_a = ring_col || i == 0 || i == nx - 1;
      p.dH[gi] = sl[si] + ta.ubar * (ring_a ? T(1) : one_minus_theta);
      p.dB[gi] = ta.ubar + ta.sbar;
      p.dHD[gi] = hsrc[si] > T(0) ? ta.q + ta.sbar : T(0);
      if (second && i + 1 < nx) {
        const bool ring_b = ring_col || i + 1 == nx - 1;
        p.dH[gi + ny] = sl[si + pitch] + tb.ubar * (ring_b ? T(1) : one_minus_theta);
        p.dB[gi + ny] = tb.ubar + tb.sbar;
        p.dHD[gi + ny] = hsrc[si + pitch] > T(0) ? tb.q + tb.sbar : T(0);
      }
    }
    // every thread is done with this stage and the corner arrays before
    // the next tile's copies or corners overwrite them
    __syncthreads();
  }

  // d(creep), d(slide): the block's sums in a fixed order (each warp's
  // shuffle tree, then warp 0's over the warps' partials), into block 0's
  // slot `rank`; block 0's warp 0 sums the slots in block order, again by a
  // shuffle tree
  creep_part = warp_tree(creep_part);
  slide_part = warp_tree(slide_part);
  const int lane = tid & 31;
  if (lane == 0) {
    warp_part[tid >> 5] = creep_part;
    warp_part[kWarps + (tid >> 5)] = slide_part;
  }
  __syncthreads();
  cluster_wait();   // every block has started: block 0's mbarrier is armed
  if (tid < 32) {
    const T c = warp_tree(lane < kWarps ? warp_part[lane] : T(0));
    const T sl = warp_tree(lane < kWarps ? warp_part[kWarps + lane] : T(0));
    if (lane == 0) {
      const unsigned bar0 = mapa(bar, 0);
      st_async(mapa(smem_u32(slots + rank), 0), c, bar0);
      st_async(mapa(smem_u32(slots + kMaxCluster + rank), 0), sl, bar0);
    }
    if (rank == 0) {
      mbar_wait(bar, 0);
      const T dc = warp_tree(lane < csize ? slots[lane] : T(0));
      const T ds = warp_tree(lane < csize ? slots[kMaxCluster + lane] : T(0));
      if (lane == 0) {
        p.dcreep[g] = dc;
        p.dslide[g] = ds;
      }
    }
  }
}

// Once per instantiation: the opt-in shared memory as dynamic (the kernel
// has no static shared memory), and the non-portable cluster size of 16.
template <typename T, class E, bool kVec>
int prepare() {
  static int state = -1;
  if (state < 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(si_step_vjp_kernel<T, E, kVec>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(si_step_vjp_kernel<T, E, kVec>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    state = 0;
  }
  return state;
}

cudaLaunchConfig_t config(int n_g, int cluster, int smem, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_g * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
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

template <typename T, class E, bool kVec>
int launch(const VjpArgs<T>& a, E e, int n_g, int cluster, int smem, void* stream) {
  const int ready = prepare<T, E, kVec>();
  if (ready != 0) return ready;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(n_g, cluster, smem, &attr,
                                        static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, si_step_vjp_kernel<T, E, kVec>, a, e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Call f(e, vec) with the launch's exponent set e (the (5, 2, 4, 2)
// specialisation when `glen` != 0, else e_* at run time) and copy route.
template <typename T, class F>
int dispatch(int glen, int vec, double e_hc, double e_sc, double e_hs, double e_ss, F&& f) {
  const RuntimeExps<T> rt{static_cast<T>(e_hc), static_cast<T>(e_sc), static_cast<T>(e_hs),
                          static_cast<T>(e_ss)};
  if (glen) {
    return vec ? f(GlenExps<T>{}, std::true_type{}) : f(GlenExps<T>{}, std::false_type{});
  }
  return vec ? f(rt, std::true_type{}) : f(rt, std::false_type{});
}

template <typename T>
int run(const T* lam, const T* H, const T* HD, const T* B, const T* x, const void* table,
        long table_stride, int table_f64, T* dH, T* dHD, T* dB, T* dcreep, T* dslide, int n_g, int nx, int ny,
        double dt, double theta, int glen, double e_hc, double e_sc, double e_hs, double e_ss,
        int cluster, int rows, int cols, int smem, int vec, void* stream) {
  const VjpArgs<T> a{lam, H, HD, B, x, table, table_stride, table_f64, HD == H ? 1 : 0,
                     dH, dHD, dB, dcreep, dslide, nx, ny, rows, cols, static_cast<T>(dt),
                     static_cast<T>(theta)};
  return dispatch<T>(glen, vec, e_hc, e_sc, e_hs, e_ss, [&](auto e, auto v) {
    return launch<T, decltype(e), decltype(v)::value>(a, e, n_g, cluster, smem, stream);
  });
}

template <typename T>
int occupancy(int glen, int vec, int cluster, int smem, int* active) {
  return dispatch<T>(glen, vec, 0.0, 0.0, 0.0, 0.0, [&](auto e, auto v) {
    constexpr bool kVec = decltype(v)::value;
    const int ready = prepare<T, decltype(e), kVec>();
    if (ready != 0) return ready;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(1, cluster, smem, &attr, nullptr);
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(active, si_step_vjp_kernel<T, decltype(e), kVec>, &cfg));
  });
}

}  // namespace

// The pullback. `table` holds row g at table + g * table_stride (dx, dy,
// creep, slide first), in float64 when `table_f64` != 0, else in the
// planes' dtype; `glen` != 0 takes the (5, 2, 4, 2) specialisation
// and ignores e_*; `cluster`, `rows`, `cols` and `smem` are the wrapper's
// layout (si_vjp_layout); `vec` != 0 takes the 16-byte copies, which need
// ny * sizeof(T) and every plane's address to be multiples of 16.
extern "C" int si_step_vjp_f32(const float* lam, const float* H, const float* HD,
                               const float* B, const float* x, const void* table,
                               long table_stride, int table_f64, float* dH, float* dHD, float* dB,
                               float* dcreep, float* dslide, int n_g, int nx, int ny, double dt,
                               double theta, int glen, double e_hc, double e_sc, double e_hs,
                               double e_ss, int cluster, int rows, int cols, int smem, int vec,
                               void* stream) {
  return run<float>(lam, H, HD, B, x, table, table_stride, table_f64, dH, dHD, dB, dcreep, dslide, n_g, nx,
                    ny, dt, theta, glen, e_hc, e_sc, e_hs, e_ss, cluster, rows, cols, smem, vec,
                    stream);
}

extern "C" int si_step_vjp_f64(const double* lam, const double* H, const double* HD,
                               const double* B, const double* x, const void* table,
                               long table_stride, int table_f64, double* dH, double* dHD, double* dB,
                               double* dcreep, double* dslide, int n_g, int nx, int ny,
                               double dt, double theta, int glen, double e_hc, double e_sc,
                               double e_hs, double e_ss, int cluster, int rows, int cols,
                               int smem, int vec, void* stream) {
  return run<double>(lam, H, HD, B, x, table, table_stride, table_f64, dH, dHD, dB, dcreep, dslide, n_g,
                     nx, ny, dt, theta, glen, e_hc, e_sc, e_hs, e_ss, cluster, rows, cols, smem,
                     vec, stream);
}

// cudaOccupancyMaxActiveClusters for the instance of that dtype, exponent
// path and copy route at a cluster size and shared memory.
extern "C" int si_step_vjp_occupancy(int f64, int glen, int vec, int cluster, int smem,
                                     int* active) {
  return f64 ? occupancy<double>(glen, vec, cluster, smem, active)
             : occupancy<float>(glen, vec, cluster, smem, active);
}
