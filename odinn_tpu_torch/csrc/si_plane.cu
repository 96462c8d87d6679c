// The large-plane path of the fused semi-implicit theta-step, and the
// step's assembly alone (the rows axis's first launch): for a plane whose
// layout fits no thread-block cluster of csrc/si_step.cu, the step is two
// launches, the assembly over tiles of the batch, then one cooperative
// launch across the whole card that runs the PCG recursion.
//
// Replaces the TPU kernel odinn_tpu/ops/pallas/si_kernel.py::si_step_pallas
// (pallas_call in _forward) at the planes it does not take (above ~576^2 in
// float32 it needs more VMEM than a TPU core has). Plain PyTorch versions:
// ops/cuda/si_kernel.py::si_step_reference (and the transpose and tangent
// references), si_assemble_reference.
//
// What bounds it on the H100: at 1024^2 float32 the step reads 4 planes and
// writes one (21 MB, 6.3 us at 3.35 TB/s), but each of the cg_iters
// iterations needs two whole-plane dot products before the next can start,
// and moves ~52 MB of CG vectors between them, which an L2 of 50 MB holds
// at 1024^2 and not at 2048^2. So: one grid barrier a dot product, and
// every block streaming its share of the vectors between the barriers.
//
// si_assemble: a block of 128 threads (four warps) over a tile of 32
// cells along y (one a lane) by 4R rows (R rows a warp; R = 4 or 1, the
// wrapper's plan ops/cuda/si_kernel.py::assemble_plan), the glacier in
// blockIdx.z. Every global load of a block is issued before its first
// barrier, into registers: the tile's H_D, B and H with a one-cell ring, as
// 16-byte vectors along y where the wrapper found ny a multiple of the
// vector and the planes aligned (the ring's two edge columns as single
// values), and each thread's own cells of H and, in the transpose mode, X.
// The ring goes to shared memory as relu(H_D), S = B + relu(H_D) and, in
// the forward mode, u = B + ring*H + (1-theta)*M*H; after the first barrier
// each corner diffusivity of the tile's (4R + 1) x 33 grid is formed once
// (the step's exponent set; the Glen set without |grad S|'s root, which it
// squares), after the second each thread
// forms its cells' four faces, b and the inverse Jacobi diagonal, and
// writes D (its own corner), b and the inverse diagonal to the scratch in
// the Plane layout below. Modes (run time, uniform in a launch): the
// forward (b = H + dt*M*div(D grad u)), the transpose solve (b = H*[X > 0],
// H the cotangent gbar, X the forward's x) and the tangent solve (b = H as
// given); without the preconditioner the inverse diagonal is 1.
//
// si_pcg: one cooperative launch (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative) of as many blocks of kPcgThreads threads
// as cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SM count
// allows (on an H100 one block of 512 an SM, which beat two of 256 at every
// large plane timed: fewer blocks at each barrier and in each sum); the
// host plan (si_kernel.plane_layout) gives each glacier an
// equal share of the blocks (every glacier of a batch has the same cells),
// each block a band of full rows of one glacier, rows k*nx/bands ..
// (k+1)*nx/bands; with more glaciers than blocks, one band a glacier, and a
// block walks bands blockIdx.x, blockIdx.x + gridDim.x, ... . A band is
// walked V values a thread a step, V = 16 bytes where ny and the pointers
// allow (template flag kVec), else one. The CG vectors stay in the global
// scratch (x, r, two planes of p, Ap beside D, b and the inverse diagonal).
//  - The start: x = x0, r = b - A x0 and the partial r.z (z = M^-1 r).
//  - Each iteration: the matvec pass forms p = z + beta*p_old at its band's
//    cells and, as it reads them, at the neighbours across the band's edges,
//    from r, the inverse diagonal and p_old, rounded once (an explicit fma)
//    wherever it is formed, so every copy has the owner's bits (the trick of
//    si_step_cluster and si_rows_apply) and p needs no barrier of its own;
//    it writes p and Ap = A p at its own cells and adds p.Ap to its
//    partial. p is double-buffered: read from plane P[it & 1] and written to
//    P[(it + 1) & 1], so no block overwrites a row its neighbour still
//    reads. Then the update pass: x += alpha*p, r -= alpha*Ap and the
//    partial r.z; the last iteration writes the outputs instead.
//  - Two grid barriers an iteration (cg::this_grid().sync()), after the
//    p.Ap partials and after the r.z partials (the last iteration's r.z is
//    not formed), and one after the start: 2*cg_iters in all. Each block
//    reduces its partial in a fixed order (registers, a warp butterfly, the
//    warps' partials in order) into slot [glacier][band] of a global slot
//    array; after the barrier every warp of every block of the glacier sums
//    the glacier's slots in one fixed order (a strided sum a lane, its loads
//    in flight together, then a butterfly, whose lanes all end with the same
//    bits). So alpha and beta
//    are bit-identical in every block and a repeat is bitwise equal; no
//    atomics but the barrier's own. The r.z slots are double-buffered by
//    iteration: beta reads this round's and the last.
//  The guards are the plain version's (denom > 0, rz > 0, tiny; tiny is 0
//  in float32). Modes and the preconditioner are run-time flags: the
//  forward writes relu(x) and, where xout is given, x; the transpose solve
//  writes x (its guess is the assembled b, which the wrapper passes as x0);
//  the tangent solve writes x*[xout > 0], xout the forward's x.
//  Data written by other blocks during the launch (the slots, r and p) is
//  read by plain or L2 loads, never through the read-only path.
#include <cooperative_groups.h>

#include <cstdint>

#include "sia_common.cuh"

namespace cg = cooperative_groups;

namespace {

using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::ld_wide;
using odinn::ldg_wide;
using odinn::relu;
using odinn::st_wide;

// the kernels' modes (the wrapper's `mode` argument)
constexpr int kForward = 0;
constexpr int kTranspose = 1;
constexpr int kTangent = 2;

// Scratch planes, each (n_g, nx, ny): D (D(i, j) at cell (i, j), the last
// row and column unwritten), b, the inverse diagonal, then the PCG's x, r,
// p, Ap and p's second buffer. The assembly writes the first three; the
// rows axis's scratch (si_rows.cu) shares them.
enum Plane { kD = 0, kRhs, kInvDiag, kX, kR, kP, kAp, kP2, kPlanes };

// ---------------------------------------------------------------------------
// si_assemble
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;                  // cells along y a tile, one a lane
constexpr int kGroups = 4;                  // warps a block, R rows each
constexpr int kAsmThreads = kLanes * kGroups;
constexpr int kRingX = kLanes + 2;          // the tile's columns with its ring
constexpr int kCornerX = kLanes + 1;        // the tile's corner columns

// A tile of 4R rows. Ring column c (0 = the column left of the tile) sits at
// shared column kPad + c, so that the tile's own columns start on 16 bytes.
template <typename T, int R>
struct Plan {
  static constexpr int kRows = kGroups * R;
  static constexpr int kRingY = kRows + 2;
  static constexpr int kCornerY = kRows + 1;
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPad = kV - 1;
  static constexpr int kRow = (kPad + kRingX + kV - 1) / kV * kV;
};

template <typename T, int R>
struct Tile {
  using P = Plan<T, R>;
  alignas(16) T h[P::kRingY][P::kRow];   // relu(H_D)
  alignas(16) T s[P::kRingY][P::kRow];   // B + relu(H_D)
  alignas(16) T u[P::kRingY][P::kRow];   // forward: B + ring*H + (1-theta)*M*H
  T d[P::kCornerY][kCornerX];   // corner D: grid point (lr, lc) is corner (i0-1+lr, j0-1+lc)
};

template <typename T>
struct AsmArgs {
  const T *H, *HD, *B, *X, *table;
  T* work;
  int n_g, nx, ny, mode, precondition;
  T dt, coef, one_minus_theta;
};

// The block's loads: the ring's rows of H_D, B and H, each its 32 own columns
// in vectors of W values and its two edge columns; each thread's R own
// cells of H and, in the transpose mode, X. Out-of-plane points read 0.
template <typename T, int R, bool kVec>
struct Loads {
  using P = Plan<T, R>;
  static constexpr int kW = kVec ? P::kV : 1;
  static constexpr int kUnits = P::kRingY * (kLanes / kW);
  static constexpr int kPasses = (kUnits + kAsmThreads - 1) / kAsmThreads;
  T hd[kPasses][kW], b[kPasses][kW], h[kPasses][kW];
  T hde, be, he;                 // one edge point (threads < 2 kRingY)
  T own_h[R], own_x[R];

  __device__ __forceinline__ void issue(const AsmArgs<T>& p, long off, int i0, int j0, int tid) {
    const int nx = p.nx, ny = p.ny;
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int u = tid + k * kAsmThreads;
      const int r = u / (kLanes / kW), q = u - r * (kLanes / kW);
      const int ii = i0 - 1 + r, jj = j0 + q * kW;
      if (u < kUnits && ii >= 0 && ii < nx && jj < ny) {
        const long g = off + static_cast<long>(ii) * ny + jj;
        ldg_wide<T, kW>(hd[k], p.HD + g);
        ldg_wide<T, kW>(b[k], p.B + g);
        ldg_wide<T, kW>(h[k], p.H + g);
      } else {
#pragma unroll
        for (int w = 0; w < kW; ++w) hd[k][w] = b[k][w] = h[k][w] = T(0);
      }
    }
    hde = be = he = T(0);
    if (tid < 2 * P::kRingY) {
      const int ii = i0 - 1 + (tid >> 1), jj = (tid & 1) ? j0 + kLanes : j0 - 1;
      if (ii >= 0 && ii < nx && jj >= 0 && jj < ny) {
        const long g = off + static_cast<long>(ii) * ny + jj;
        hde = __ldg(p.HD + g);
        be = __ldg(p.B + g);
        he = __ldg(p.H + g);
      }
    }
    const int lane = tid % kLanes, grp = tid / kLanes, j = j0 + lane;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = i0 + grp * R + q;
      own_h[q] = own_x[q] = T(0);
      if (i < nx && j < ny) {
        const long g = off + static_cast<long>(i) * ny + j;
        own_h[q] = __ldg(p.H + g);
        if (p.mode == kTranspose) own_x[q] = __ldg(p.X + g);
      }
    }
  }

  // relu(H_D), S and, in the forward mode, u into the ring
  __device__ __forceinline__ void stage(Tile<T, R>& t, const AsmArgs<T>& p, int i0, int j0,
                                        int tid) const {
    const bool fwd = p.mode == kForward;
    auto u_of = [&](T bv, T hv, int ii, int jj) {
      const bool in = ii > 0 && jj > 0 && ii < p.nx - 1 && jj < p.ny - 1;
      return in ? bv + p.one_minus_theta * hv : bv + hv;
    };
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int u = tid + k * kAsmThreads;
      if (u < kUnits) {
        const int r = u / (kLanes / kW), q = u - r * (kLanes / kW);
        const int x = P::kPad + 1 + q * kW;
        T hv[kW], sv[kW], uv[kW];
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          hv[w] = relu(hd[k][w]);
          sv[w] = b[k][w] + hv[w];
          uv[w] = u_of(b[k][w], h[k][w], i0 - 1 + r, j0 + q * kW + w);
        }
        st_wide<T, kW>(&t.h[r][x], hv);
        st_wide<T, kW>(&t.s[r][x], sv);
        if (fwd) st_wide<T, kW>(&t.u[r][x], uv);
      }
    }
    if (tid < 2 * P::kRingY) {
      const int r = tid >> 1, x = P::kPad + ((tid & 1) ? kRingX - 1 : 0);
      const int jj = (tid & 1) ? j0 + kLanes : j0 - 1;
      const T hv = relu(hde);
      t.h[r][x] = hv;
      t.s[r][x] = be + hv;
      if (fwd) t.u[r][x] = u_of(be, he, i0 - 1 + r, jj);
    }
  }
};

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

// D at a corner from its 2x2 block of relu'd thickness h and surface s
// (h00 = (a, c), h10 = (a+1, c), h01 = (a, c+1), h11 = (a+1, c+1)): any
// exponent set through odinn::corner_D; the (5, 2, 4, 2) set as
// (slide*h^4 + creep*h^5)*|grad S|^2, with |grad S|^2 formed as it is,
// not squared back from its root (as sia2d_rhs_jvp.cu's Glen corner).
template <typename T, class E>
__device__ __forceinline__ T corner(T h00, T h10, T h01, T h11, T s00, T s10, T s01, T s11,
                                    const Recip<T>& k, const E& e) {
  return odinn::corner_D(h00, h10, h01, h11, s00, s10, s01, s11, k, e);
}
template <typename T>
__device__ __forceinline__ T corner(T h00, T h10, T h01, T h11, T s00, T s10, T s01, T s11,
                                    const Recip<T>& k, const GlenExps<T>&) {
  const T gsx = T(0.5) * ((s10 - s00) * k.inv_dx + (s11 - s01) * k.inv_dx);
  const T gsy = T(0.5) * ((s01 - s00) * k.inv_dy + (s11 - s10) * k.inv_dy);
  const T sq = gsx * gsx + gsy * gsy;
  const T hb = T(0.25) * (h00 + h10 + h01 + h11);
  const T h2 = hb * hb, h4 = h2 * h2;
  return (k.slide * h4 + k.creep * (h4 * hb)) * sq;
}

template <typename T, int R, class E>
__device__ __forceinline__ void assemble_block(const AsmArgs<T>& p, const E& e, Tile<T, R>& t,
                                               const T (&own_h)[R], const T (&own_x)[R],
                                               const Recip<T>& k, int i0, int j0, long off) {
  using P = Plan<T, R>;
  const int tid = threadIdx.x;
  const int nx = p.nx, ny = p.ny;
  constexpr int kCorners = P::kCornerY * kCornerX;
#pragma unroll
  for (int c0 = 0; c0 < kCorners; c0 += kAsmThreads) {
    const int idx = c0 + tid;
    if (idx < kCorners) {
      const int lr = idx / kCornerX, lc = idx - lr * kCornerX;
      const int a = i0 - 1 + lr, c = j0 - 1 + lc;
      T D = T(0);
      if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {
        const int x = P::kPad + lc;
        D = corner(t.h[lr][x], t.h[lr + 1][x], t.h[lr][x + 1], t.h[lr + 1][x + 1], t.s[lr][x],
                   t.s[lr + 1][x], t.s[lr][x + 1], t.s[lr + 1][x + 1], k, e);
      }
      t.d[lr][lc] = D;
    }
  }
  __syncthreads();

  // cell (i, j) = (i0 + ty, j0 + lane) sits at ring point (ty + 1, lane + 1)
  const long batch = static_cast<long>(p.n_g) * nx * ny;
  T* const Dw = p.work + kD * batch + off;
  T* const rhs = p.work + kRhs * batch + off;
  T* const inv = p.work + kInvDiag * batch + off;
  const int lane = tid % kLanes, grp = tid / kLanes;
  const int j = j0 + lane, x = P::kPad + 1 + lane;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int ty = grp * R + q, r = ty + 1;
    const int i = i0 + ty;
    if (i >= nx || j >= ny) continue;
    const long c = static_cast<long>(i) * ny + j;
    if (i <= nx - 2 && j <= ny - 2) Dw[c] = t.d[r][lane + 1];
    const T gc = own_x[q] > T(0) ? own_h[q] : T(0);
    if (i == 0 || j == 0 || i == nx - 1 || j == ny - 1) {
      rhs[c] = p.mode == kTranspose ? gc : own_h[q];
      inv[c] = T(1);
      continue;
    }
    const T d00 = t.d[r - 1][lane], d01 = t.d[r - 1][lane + 1];
    const T d10 = t.d[r][lane], d11 = t.d[r][lane + 1];
    const T xe = T(0.5) * (d10 + d11), xw = T(0.5) * (d00 + d01);
    const T yn = T(0.5) * (d01 + d11), ys = T(0.5) * (d00 + d10);
    if (p.mode == kTranspose) {
      rhs[c] = gc;
    } else if (p.mode == kTangent) {
      rhs[c] = own_h[q];
    } else {
      const T div = div_faces(xe, xw, yn, ys, t.u[r][x], t.u[r + 1][x], t.u[r - 1][x],
                              t.u[r][x + 1], t.u[r][x - 1], k.inv_dx, k.inv_dy);
      rhs[c] = own_h[q] + p.dt * div;
    }
    if (p.precondition) {
      const T sx = (xw + xe) * (k.inv_dx * k.inv_dx);
      const T sy = (ys + yn) * (k.inv_dy * k.inv_dy);
      inv[c] = T(1) / (T(1) + p.coef * (sx + sy));
    } else {
      inv[c] = T(1);
    }
  }
}

// The block's loads are issued first, the table's after them; then the
// ring goes to shared memory.
template <typename T, class E, int R, bool kVec>
__global__ void __launch_bounds__(kAsmThreads) si_assemble(AsmArgs<T> p, E e) {
  __shared__ Tile<T, R> tile;
  const int i0 = blockIdx.y * Plan<T, R>::kRows, j0 = blockIdx.x * kLanes;
  const long off = static_cast<long>(blockIdx.z) * p.nx * p.ny;
  Loads<T, R, kVec> in;
  in.issue(p, off, i0, j0, threadIdx.x);
  const Recip<T> k = odinn::recip_row(p.table + 4L * blockIdx.z);
  in.stage(tile, p, i0, j0, threadIdx.x);
  __syncthreads();
  assemble_block<T, R, E>(p, e, tile, in.own_h, in.own_x, k, i0, j0, off);
}

bool aligned16(const void* ptr) { return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0; }

template <typename T, class E, int R>
int launch_assemble_rows(const AsmArgs<T>& p, E e, bool vec, cudaStream_t s) {
  const dim3 grid((p.ny + kLanes - 1) / kLanes, (p.nx + Plan<T, R>::kRows - 1) / Plan<T, R>::kRows,
                  p.n_g);
  if (vec) {
    si_assemble<T, E, R, true><<<grid, kAsmThreads, 0, s>>>(p, e);
  } else {
    si_assemble<T, E, R, false><<<grid, kAsmThreads, 0, s>>>(p, e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The assembly on the plan (rows a thread 1 or 4, 16-byte vectors), or
// cudaErrorInvalidValue for a plan or plane it does not take.
template <typename T, class E>
int launch_assemble(const AsmArgs<T>& p, E e, int rows, int vec, cudaStream_t s) {
  if (p.n_g < 1 || p.nx < 3 || p.ny < 3 || p.n_g > 65535 || (rows != 1 && rows != 4) ||
      p.mode < kForward || p.mode > kTangent)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((p.nx + kGroups * rows - 1) / (kGroups * rows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (p.ny % Plan<T, 1>::kV != 0 || !aligned16(p.H) || !aligned16(p.HD) ||
              !aligned16(p.B)))
    return static_cast<int>(cudaErrorInvalidValue);
  return rows == 4 ? launch_assemble_rows<T, E, 4>(p, e, vec != 0, s)
                   : launch_assemble_rows<T, E, 1>(p, e, vec != 0, s);
}

// ---------------------------------------------------------------------------
// si_pcg
// ---------------------------------------------------------------------------

constexpr int kPcgThreads = 512;
constexpr int kPcgWarps = kPcgThreads / 32;
// Vectors a thread of the update pass loads before it stores any.
constexpr int kBatch = 2;

template <typename T>
struct PcgArgs {
  T* work;
  const T* x0;        // the guess: x0, or in the transpose mode the plane b
  const T* table;
  T* slots;           // [3][n_g * bands]: p.Ap, then r.z of even and odd rounds
  T* out;
  T* xout;
  int n_g, nx, ny, bands, cg_iters, mode, precondition;
  T coef;
};

// p = z + beta*p_old, rounded once wherever it is formed (module note).
__device__ __forceinline__ float form_p(float z, float beta, float po) {
  return __fmaf_rn(beta, po, z);
}
__device__ __forceinline__ double form_p(double z, double beta, double po) {
  return __fma_rn(beta, po, z);
}

// The sum of v over a warp by a butterfly: every lane ends with the same
// bits (each step adds the same two values on both lanes of a pair).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K slot arrays of a glacier, n slots each, summed in one fixed order: lane
// l the slots l, l+32, ... in turn (loaded kSlotBatch at a time, all in
// flight together), then the butterfly. Every warp of every block that
// calls it on the same slots gets the same bits. Through L2: other blocks
// wrote them.
constexpr int kSlotBatch = 8;

template <typename T, int K>
__device__ __forceinline__ void glacier_sums(const T* const (&s)[K], int n, T (&out)[K]) {
  const int lane = threadIdx.x & 31;
  T v[K];
#pragma unroll
  for (int a = 0; a < K; ++a) v[a] = T(0);
  for (int q0 = lane; q0 < n; q0 += 32 * kSlotBatch) {
    T buf[K][kSlotBatch];
#pragma unroll
    for (int b = 0; b < kSlotBatch; ++b) {
      const int q = q0 + 32 * b;
#pragma unroll
      for (int a = 0; a < K; ++a) buf[a][b] = q < n ? __ldcg(s[a] + q) : T(0);
    }
#pragma unroll
    for (int b = 0; b < kSlotBatch; ++b) {
#pragma unroll
      for (int a = 0; a < K; ++a) v[a] += buf[a][b];
    }
  }
#pragma unroll
  for (int a = 0; a < K; ++a) out[a] = warp_sum(v[a]);
}

// The block's partial, in a fixed order, into *slot: each warp's butterfly,
// then thread 0 sums the warps' in order. `buf` alternates between calls
// (a thread may still read one call's while others write the next's).
template <typename T>
__device__ __forceinline__ void block_partial(T acc, T* buf, T* slot) {
  const T w = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
#pragma unroll
    for (int q = 0; q < kPcgWarps; ++q) s += buf[q];
    __stcg(slot, s);
  }
}

// The output of the solution x at cell index g (module note).
template <typename T>
__device__ __forceinline__ void write_out(const PcgArgs<T>& p, long g, T x) {
  if (p.mode == kForward) {
    p.out[g] = relu(x);
    if (p.xout != nullptr) p.xout[g] = x;
  } else if (p.mode == kTangent) {
    p.out[g] = p.xout[g] > T(0) ? x : T(0);
  } else {
    p.out[g] = x;
  }
}

// The planes of one glacier.
template <typename T>
struct Glacier {
  const T* D;
  const T* rhs;
  const T* inv;
  const T* x0;
  T *X, *R, *Ap, *P0, *P1;
  long off;
};

template <typename T>
__device__ __forceinline__ Glacier<T> glacier(const PcgArgs<T>& p, int g) {
  const long plane = static_cast<long>(p.nx) * p.ny;
  const long batch = plane * p.n_g;
  const long off = static_cast<long>(g) * plane;
  T* w = p.work;
  return Glacier<T>{w + kD * batch + off,  w + kRhs * batch + off, w + kInvDiag * batch + off,
                    p.x0 + off,            w + kX * batch + off,   w + kR * batch + off,
                    w + kAp * batch + off, w + kP * batch + off,   w + kP2 * batch + off, off};
}

// A u = u - coef*M*div(D grad(M u)) at the V cells (i, j0 .. j0 + V - 1)
// (index s of the cell (i, j0)); M masks the plane's ring. With kForm u is
// p = form_p(z, beta, p_old) formed from r, the inverse diagonal and p_old
// as they are read (z = r*inv, or r without the preconditioner; p = z in
// the first iteration); else u is read from `us`. Returns u there too.
template <typename T, int V, bool kForm>
__device__ __forceinline__ void apply_A(const T* us, const T* rs, const T* __restrict__ ivs,
                                        T beta, bool first, bool jac, const T* __restrict__ D,
                                        int s, int nx, int ny, int i, int j0, T coef,
                                        const Recip<T>& k, T (&uc)[V], T (&out)[V]) {
  auto get = [&](T (&v)[V], int at) {
    if constexpr (kForm) {
      T r[V], iv[V], po[V];
      ld_wide<T, V>(r, rs + at);
      if (jac) ldg_wide<T, V>(iv, ivs + at);
      if (!first) ld_wide<T, V>(po, us + at);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T z = jac ? r[q] * iv[q] : r[q];
        v[q] = first ? z : form_p(z, beta, po[q]);
      }
    } else {
      ldg_wide<T, V>(v, us + at);
    }
  };
  auto get1 = [&](int at) {
    if constexpr (kForm) {
      const T z = jac ? rs[at] * __ldg(ivs + at) : rs[at];
      return first ? z : form_p(z, beta, us[at]);
    }
    else {
      return __ldg(us + at);
    }
  };
  get(uc, s);
  if (i == 0 || i == nx - 1) {   // a ring row: A u = u
#pragma unroll
    for (int t = 0; t < V; ++t) out[t] = uc[t];
    return;
  }
  const bool up_in = i + 1 < nx - 1, um_in = i - 1 > 0;
  T um[V], up[V], dm[V + 1], dc[V + 1];
#pragma unroll
  for (int t = 0; t < V; ++t) um[t] = up[t] = T(0);
  if (um_in) get(um, s - ny);
  if (up_in) get(up, s + ny);
  dm[0] = j0 > 0 ? __ldg(D + s - ny - 1) : T(0);
  dc[0] = j0 > 0 ? __ldg(D + s - 1) : T(0);
  {
    T a[V], b[V];
    ldg_wide<T, V>(a, D + s - ny);
    ldg_wide<T, V>(b, D + s);
#pragma unroll
    for (int t = 0; t < V; ++t) dm[t + 1] = a[t], dc[t + 1] = b[t];
  }
  const T ul = j0 - 1 > 0 ? get1(s - 1) : T(0);
  const T ur = j0 + V < ny - 1 ? get1(s + V) : T(0);
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int j = j0 + t;
    if (j == 0 || j == ny - 1) {
      out[t] = uc[t];
      continue;
    }
    // the neighbours, masked where they lie on the ring
    const T n_xp = up[t];
    const T n_xm = um[t];
    const T n_yp = j + 1 < ny - 1 ? (t + 1 < V ? uc[t + 1] : ur) : T(0);
    const T n_ym = j - 1 > 0 ? (t > 0 ? uc[t - 1] : ul) : T(0);
    const T d00 = dm[t], d01 = dm[t + 1], d10 = dc[t], d11 = dc[t + 1];
    const T xe = T(0.5) * (d10 + d11), xw = T(0.5) * (d00 + d01);
    const T yn = T(0.5) * (d01 + d11), ys = T(0.5) * (d00 + d10);
    out[t] = uc[t] - coef * div_faces(xe, xw, yn, ys, uc[t], n_xp, n_xm, n_yp, n_ym, k.inv_dx,
                                      k.inv_dy);
  }
}

// The band [a, b) of rows of a glacier, from its index in the launch.
struct Band {
  int g, a, b;
  __device__ Band(int index, int bands, int nx) {
    g = index / bands;
    const long k = index - static_cast<long>(g) * bands;
    a = static_cast<int>(k * nx / bands);
    b = static_cast<int>((k + 1) * nx / bands);
  }
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kPcgThreads) si_pcg(PcgArgs<T> p) {
  constexpr int V = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  __shared__ T warp_part[2][kPcgWarps];
  cg::grid_group grid = cg::this_grid();
  const int nx = p.nx, ny = p.ny, tid = threadIdx.x;
  const int total = p.n_g * p.bands;
  const int wv = ny / V;
  const bool jac = p.precondition != 0;
  const T coef = p.coef;
  const T tiny = static_cast<T>(1e-300);   // 0 in float32, as in the plain version
  T* const slots_pap = p.slots;
  T* const slots_rz[2] = {p.slots + total, p.slots + 2L * total};
  int red = 0;

  // the start: x = x0, r = b - A x0, partial r.z
  for (int bi = blockIdx.x; bi < total; bi += gridDim.x) {
    const Band bd(bi, p.bands, nx);
    const Glacier<T> G = glacier(p, bd.g);
    const Recip<T> k = odinn::recip_row(p.table + 4L * bd.g);
    T acc = T(0);
    for (int e = tid; e < (bd.b - bd.a) * wv; e += kPcgThreads) {
      const int tr = e / wv, tv = e - tr * wv;
      const int i = bd.a + tr, j0 = tv * V, s = i * ny + j0;
      T xc[V], ax[V], rhs[V], iv[V], r[V];
      apply_A<T, V, false>(G.x0, nullptr, nullptr, T(0), true, false, G.D, s, nx, ny, i, j0,
                           coef, k, xc, ax);
      ldg_wide<T, V>(rhs, G.rhs + s);
      if (jac) ldg_wide<T, V>(iv, G.inv + s);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        r[q] = rhs[q] - ax[q];
        acc += r[q] * (jac ? r[q] * iv[q] : r[q]);
      }
      if (p.cg_iters == 0) {
#pragma unroll
        for (int q = 0; q < V; ++q) write_out(p, G.off + s + q, xc[q]);
      } else {
        st_wide<T, V>(G.X + s, xc);
        st_wide<T, V>(G.R + s, r);
      }
    }
    block_partial(acc, warp_part[red++ & 1], slots_rz[0] + bi);
  }
  if (p.cg_iters == 0) return;
  grid.sync();

  for (int it = 0; it < p.cg_iters; ++it) {
    const bool first = it == 0, last = it == p.cg_iters - 1;
    // p = z + beta*p_old (into P[(it + 1) & 1]), Ap, partial p.Ap
    for (int bi = blockIdx.x; bi < total; bi += gridDim.x) {
      const Band bd(bi, p.bands, nx);
      const Glacier<T> G = glacier(p, bd.g);
      const Recip<T> k = odinn::recip_row(p.table + 4L * bd.g);
      T beta = T(0);
      if (!first) {
        const T* const rounds[2] = {slots_rz[it & 1] + bd.g * p.bands,
                                    slots_rz[(it + 1) & 1] + bd.g * p.bands};
        T rz[2];   // this round's r.z and the last
        glacier_sums(rounds, p.bands, rz);
        beta = rz[1] > T(0) ? rz[0] / fmax(rz[1], tiny) : T(0);
      }
      const T* const Pold = (it & 1) ? G.P1 : G.P0;
      T* const Pnew = (it & 1) ? G.P0 : G.P1;
      T acc = T(0);
      for (int e = tid; e < (bd.b - bd.a) * wv; e += kPcgThreads) {
        const int tr = e / wv, tv = e - tr * wv;
        const int i = bd.a + tr, j0 = tv * V, s = i * ny + j0;
        T pc[V], ap[V];
        apply_A<T, V, true>(Pold, G.R, G.inv, beta, first, jac, G.D, s, nx, ny, i, j0, coef, k,
                            pc, ap);
        st_wide<T, V>(Pnew + s, pc);
        st_wide<T, V>(G.Ap + s, ap);
#pragma unroll
        for (int q = 0; q < V; ++q) acc += pc[q] * ap[q];
      }
      block_partial(acc, warp_part[red++ & 1], slots_pap + bi);
    }
    grid.sync();
    // x += alpha*p, r -= alpha*Ap, partial r.z; the outputs in the last
    for (int bi = blockIdx.x; bi < total; bi += gridDim.x) {
      const Band bd(bi, p.bands, nx);
      const Glacier<T> G = glacier(p, bd.g);
      const T* const sums[2] = {slots_pap + bd.g * p.bands, slots_rz[it & 1] + bd.g * p.bands};
      T dr[2];   // p.Ap and r.z
      glacier_sums(sums, p.bands, dr);
      const T alpha = dr[0] > T(0) ? dr[1] / fmax(dr[0], tiny) : T(0);
      const T* const Pc = (it & 1) ? G.P0 : G.P1;
      const int base = bd.a * ny;
      const int n = (bd.b - bd.a) * wv;
      T acc = T(0);
      for (int e0 = tid; e0 < n; e0 += kBatch * kPcgThreads) {
        // up to kBatch vectors e0, e0 + kPcgThreads, ..., all loads first
        T x[kBatch][V], pv[kBatch][V], r[kBatch][V], ap[kBatch][V], iv[kBatch][V];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int c = base + (e0 + q * kPcgThreads) * V;
          if (e0 + q * kPcgThreads >= n) break;
          ld_wide<T, V>(x[q], G.X + c);
          ld_wide<T, V>(pv[q], Pc + c);
          ld_wide<T, V>(r[q], G.R + c);
          ld_wide<T, V>(ap[q], G.Ap + c);
          if (jac) ldg_wide<T, V>(iv[q], G.inv + c);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int c = base + (e0 + q * kPcgThreads) * V;
          if (e0 + q * kPcgThreads >= n) break;
#pragma unroll
          for (int t = 0; t < V; ++t) {
            x[q][t] = x[q][t] + alpha * pv[q][t];
            r[q][t] = r[q][t] - alpha * ap[q][t];
            acc += r[q][t] * (jac ? r[q][t] * iv[q][t] : r[q][t]);
          }
          if (last) {
#pragma unroll
            for (int t = 0; t < V; ++t) write_out(p, G.off + c + t, x[q][t]);
          } else {
            st_wide<T, V>(G.X + c, x[q]);
            st_wide<T, V>(G.R + c, r[q]);
          }
        }
      }
      if (!last) block_partial(acc, warp_part[red++ & 1], slots_rz[(it + 1) & 1] + bi);
    }
    if (last) break;
    grid.sync();
  }
}

template <typename T, bool kVec>
int launch_pcg(const PcgArgs<T>& p, int blocks, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kPcgThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, si_pcg<T, kVec>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Call launch(e) with the step's exponent set e: the (5, 2, 4, 2)
// specialisation when `glen` != 0, else e_* at run time.
template <typename T, class F>
int with_exps(int glen, double e_hc, double e_sc, double e_hs, double e_ss, F&& launch) {
  if (glen) return launch(GlenExps<T>{});
  return launch(RuntimeExps<T>{static_cast<T>(e_hc), static_cast<T>(e_sc),
                               static_cast<T>(e_hs), static_cast<T>(e_ss)});
}

template <typename T>
AsmArgs<T> asm_args(const T* H, const T* HD, const T* B, const T* X, const T* table, T* work,
                    int n_g, int nx, int ny, double dt, double theta, int mode,
                    int precondition) {
  return AsmArgs<T>{H,  HD, B,    X,  table, work, n_g, nx, ny, mode, precondition,
                    static_cast<T>(dt), static_cast<T>(theta * dt),
                    static_cast<T>(1.0 - theta)};
}

template <typename T>
int assemble(const T* H, const T* HD, const T* B, const T* X, const T* table, T* work, int n_g,
             int nx, int ny, double dt, double theta, int mode, int precondition, int glen,
             double e_hc, double e_sc, double e_hs, double e_ss, int rows, int vec,
             void* stream) {
  const AsmArgs<T> a =
      asm_args(H, HD, B, X, table, work, n_g, nx, ny, dt, theta, mode, precondition);
  return with_exps<T>(glen, e_hc, e_sc, e_hs, e_ss, [&](auto e) {
    return launch_assemble<T>(a, e, rows, vec, static_cast<cudaStream_t>(stream));
  });
}

template <typename T>
int step(const T* H, const T* HD, const T* B, const T* x0, const T* table, T* work, T* slots,
         T* out, T* xout, int n_g, int nx, int ny, double dt, double theta, int cg_iters,
         int mode, int precondition, int glen, double e_hc, double e_sc, double e_hs,
         double e_ss, int rows, int a_vec, int blocks, int bands, int threads, int vec,
         void* stream) {
  // the plan: whole bands of at least one row, 16-byte vectors that stay
  // whole, 32-bit cell indices within a plane
  const bool ok = n_g >= 1 && nx >= 3 && ny >= 3 && static_cast<long>(nx) * ny <= 0x7fffffffL &&
                  cg_iters >= 0 && bands >= 1 && bands <= nx && blocks >= 1 &&
                  threads == kPcgThreads &&
                  static_cast<long>(n_g) * bands <= 0x7fffffffL / 3 &&
                  (!vec || (ny % (16 / static_cast<int>(sizeof(T))) == 0 && aligned16(work) &&
                            aligned16(x0) && aligned16(out))) &&
                  (mode != kTangent || xout != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AsmArgs<T> a = asm_args(H, HD, B, x0, table, work, n_g, nx, ny, dt, theta, mode,
                                precondition);
  int err = with_exps<T>(glen, e_hc, e_sc, e_hs, e_ss,
                         [&](auto e) { return launch_assemble<T>(a, e, rows, a_vec, s); });
  if (err != 0) return err;
  // the transpose mode's guess is its right-hand side, the assembled b
  const long batch = static_cast<long>(n_g) * nx * ny;
  const T* guess = mode == kTranspose ? work + kRhs * batch : x0;
  const PcgArgs<T> p{work, guess, table, slots, out, xout, n_g, nx, ny, bands, cg_iters, mode,
                     precondition, static_cast<T>(theta * dt)};
  return vec ? launch_pcg<T, true>(p, blocks, s) : launch_pcg<T, false>(p, blocks, s);
}

template <typename T>
int occupancy(int vec, int threads, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, si_pcg<T, true>, threads, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, si_pcg<T, false>, threads,
                                                              0);
  }
  return static_cast<int>(err);
}

}  // namespace

// The assembly alone into `work` (planes of the batch's shape, the Plane
// layout's D, b and inverse diagonal written): the row-sharded step's
// first launch. `X` is the forward's x in the transpose mode (b = H*[X > 0])
// and unread otherwise; `mode` 0/1/2 forward, transpose, tangent;
// `precondition` == 0 writes an inverse diagonal of 1; `glen` != 0 takes
// the (5, 2, 4, 2) specialisation and ignores e_*. `rows` (1 or 4) and
// `vec` are the wrapper's plan (si_kernel.assemble_plan); a plan or plane
// the kernel does not take is refused with cudaErrorInvalidValue.
extern "C" int si_assemble_f32(const float* H, const float* HD, const float* B, const float* X,
                               const float* table, float* work, int n_g, int nx, int ny,
                               double dt, double theta, int mode, int precondition, int glen,
                               double e_hc, double e_sc, double e_hs, double e_ss, int rows,
                               int vec, void* stream) {
  return assemble<float>(H, HD, B, X, table, work, n_g, nx, ny, dt, theta, mode, precondition,
                         glen, e_hc, e_sc, e_hs, e_ss, rows, vec, stream);
}

extern "C" int si_assemble_f64(const double* H, const double* HD, const double* B,
                               const double* X, const double* table, double* work, int n_g,
                               int nx, int ny, double dt, double theta, int mode,
                               int precondition, int glen, double e_hc, double e_sc,
                               double e_hs, double e_ss, int rows, int vec, void* stream) {
  return assemble<double>(H, HD, B, X, table, work, n_g, nx, ny, dt, theta, mode, precondition,
                          glen, e_hc, e_sc, e_hs, e_ss, rows, vec, stream);
}

// The large-plane step: the assembly into `work` (kPlanes planes of the
// batch's shape), then the cooperative PCG with `slots` (3 * n_g * bands
// values). In the transpose mode H is gbar and x0 the forward's x; in the
// tangent mode H is rdot, x0 the forward's guess and xout the forward's x
// (read); the forward writes x to xout when it is not null. `rows` and
// `a_vec` are the assembly's plan, `blocks`, `bands`, `threads` and `vec`
// the PCG's (si_kernel.plane_layout); a launch the card cannot co-schedule
// returns its CUDA error.
extern "C" int si_plane_f32(const float* H, const float* HD, const float* B, const float* x0,
                            const float* table, float* work, float* slots, float* out,
                            float* xout, int n_g, int nx, int ny, double dt, double theta,
                            int cg_iters, int mode, int precondition, int glen, double e_hc,
                            double e_sc, double e_hs, double e_ss, int rows, int a_vec,
                            int blocks, int bands, int threads, int vec, void* stream) {
  return step<float>(H, HD, B, x0, table, work, slots, out, xout, n_g, nx, ny, dt, theta,
                     cg_iters, mode, precondition, glen, e_hc, e_sc, e_hs, e_ss, rows, a_vec,
                     blocks, bands, threads, vec, stream);
}

extern "C" int si_plane_f64(const double* H, const double* HD, const double* B,
                            const double* x0, const double* table, double* work, double* slots,
                            double* out, double* xout, int n_g, int nx, int ny, double dt,
                            double theta, int cg_iters, int mode, int precondition, int glen,
                            double e_hc, double e_sc, double e_hs, double e_ss, int rows,
                            int a_vec, int blocks, int bands, int threads, int vec,
                            void* stream) {
  return step<double>(H, HD, B, x0, table, work, slots, out, xout, n_g, nx, ny, dt, theta,
                      cg_iters, mode, precondition, glen, e_hc, e_sc, e_hs, e_ss, rows, a_vec,
                      blocks, bands, threads, vec, stream);
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of si_pcg (that dtype,
// f64 != 0, and vector width) at `threads` a block into *per_sm, and the
// device's SM count into *sms.
extern "C" int si_pcg_occupancy(int f64, int vec, int threads, int* per_sm, int* sms) {
  return f64 ? occupancy<double>(vec, threads, per_sm, sms)
             : occupancy<float>(vec, threads, per_sm, sms);
}
