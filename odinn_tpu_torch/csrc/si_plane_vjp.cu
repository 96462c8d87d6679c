// The pullback of the SI step on a large plane: for a plane whose step takes
// the large-plane path (si_plane.cu, the planes that fit no thread-block
// cluster of si_step.cu), the cotangents of H, H_D, B and of each glacier's
// creep and slide prefactors at lambda, the transpose solve's solution, in
// one launch over tiles of the whole batch.
//
// Replaces, with the production contract, the backward of the TPU kernel
// odinn_tpu/ops/pallas/si_kernel.py::si_step_pallas (_bwd, :222) at the
// planes the cluster kernel si_step_vjp.cu gave one cluster of at most 16
// blocks (16 of an H100's 132 SMs). It computes what si_step_vjp.cu
// computes (the math in that file's header, the arithmetic in
// si_vjp_common.cuh): per cell ubar = L_D(w), w = dt*M*lambda, dH = lambda +
// ubar*(ring ? 1 : 1 - theta), dB = ubar + Sbar, dH_D = [H_D > 0](Q + Sbar);
// per corner D, Dbar and its routes to Q, PX and PY; d(creep) and d(slide),
// the sums over the corners. Plain PyTorch version:
// ops/cuda/si_kernel.py::si_step_vjp_reference.
//
// What bounds it on the H100: bytes. Per cell it reads lambda, H, B, x and
// H_D (unless H_D is H) and writes dH, dH_D and dB, 28-32 bytes in float32,
// against ~126 operations a cell: at 1 x 1024^2 29-34 MB, 0.0088-0.010 ms at
// 3.35 TB/s, four times that at 2048^2.
//
// Design: a block of 128 threads (four warps) over a tile of 32 cells along
// y (one a lane) by 4R rows (R rows a warp; R = 4 or 1, the wrapper's plan
// ops/cuda/si_kernel.py::plane_vjp_layout), the glacier in blockIdx.z, as
// si_plane.cu's si_assemble tiles the batch: at 1 x 1024^2 that is 2048
// blocks over every SM.
//  - Loads. Every global load of the block is issued before its first
//    barrier, into registers: lambda, H, H_D, B and x on the tile and its
//    one-cell ring, as 16-byte vectors along y where the wrapper found ny a
//    multiple of the vector and the planes aligned (template flag kVec; the
//    ring's two edge columns as single values), else one value a load; and
//    each thread's own cells of lambda. H_D's loads are skipped where H_D is
//    H (the SI trainings' and the ice sheet's call). The table's row is read
//    after them.
//  - The ring goes to shared memory as relu(H_D), S = B + relu(H_D), u = B +
//    ring*H + (1-theta)*M*H + theta*M*x and w = dt*M*lambda (zero off the
//    plane); after the first barrier each of the tile's (4R + 1) x 33
//    corners is formed once (D, Q, PX, PY into shared memory), each thread
//    summing the creep and slide terms of the corners the tile owns (those
//    right of and below the ring's); after the second each thread gathers
//    its R cells' four corners and stores dH, dH_D and dB.
//  - d(creep) and d(slide): each block reduces its threads' sums in a fixed
//    order (a warp shuffle tree, then the warps' partials in order) into its
//    slot of the glacier, then takes a ticket on the glacier's counter; the
//    glacier's last block sums the glacier's slots in block order (each
//    thread a strided sum, loads in flight together, then the shuffle tree
//    and the warps in order), writes the two sums and resets the counter.
//    The result does not depend on which block finishes last: repeated
//    launches are bitwise equal. No floating-point atomics. One launch a
//    call.
// The exponent set is one per launch, from the host: (5, 2, 4, 2) takes
// fixed multiplies (GlenExps), any other pow_pos at run time (RuntimeExps).
// The table is read in place, in H's dtype or in float64: row g at table +
// g * table_stride.
#include <cstdint>

#include "sia_common.cuh"
#include "si_vjp_common.cuh"

namespace {

using odinn::CellTerms;
using odinn::Corner;
using odinn::CornerTerms;
using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::ldg_wide;
using odinn::relu;
using odinn::st_wide;

constexpr int kLanes = 32;                  // cells along y a tile, one a lane
constexpr int kGroups = 4;                  // warps a block, R rows each
constexpr int kThreads = kLanes * kGroups;
constexpr int kRingX = kLanes + 2;          // the tile's columns with its ring
constexpr int kCornerX = kLanes + 1;        // the tile's corner columns
// slots a thread of the glacier's last block loads before it adds any
constexpr int kSlotBatch = 8;

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
  alignas(16) T u[P::kRingY][P::kRow];   // B + ring*H + (1-theta)*M*H + theta*M*x
  alignas(16) T w[P::kRingY][P::kRow];   // dt*M*lambda
  // corner grid point (lr, lc) is the plane's corner (i0-1+lr, j0-1+lc)
  Corner<T> c[P::kCornerY][kCornerX];
  T part[2][kGroups];                    // the warps' partials of d(creep), d(slide)
  int last;                              // this block is its glacier's last
};

template <typename T>
struct PlaneVjpArgs {
  const T *lam, *H, *HD, *B, *x;
  const void* table;    // row g at table + g * table_stride: dx, dy, creep, slide
  long table_stride;
  int table_f64;        // the table is float64 (else T)
  int hd_is_h;          // H_D is H (the same plane): its loads are skipped
  T *dH, *dHD, *dB;
  T* partial;           // [n_g][2][blocks a glacier]: the blocks' d(creep), d(slide)
  unsigned* counter;    // (n_g,), zero between launches
  T *dcreep, *dslide;   // (n_g,)
  int nx, ny;
  T dt, theta;
};

// relu(H_D), S, u and w of the ring point (ii, jj) from its loads of
// lambda, H, H_D, B and x (zero off the plane).
template <typename T>
__device__ __forceinline__ void ring_point(const PlaneVjpArgs<T>& p, T one_minus_theta, int ii,
                                           int jj, T lv, T hv, T hdv, T bv, T xv, T& ho, T& so,
                                           T& uo, T& wo) {
  const bool in = ii >= 0 && jj >= 0 && ii < p.nx && jj < p.ny;
  const bool interior = ii > 0 && jj > 0 && ii < p.nx - 1 && jj < p.ny - 1;
  ho = relu(hdv);
  so = bv + ho;
  const T ui = interior ? bv + one_minus_theta * hv + p.theta * xv : bv + hv;
  uo = in ? ui : T(0);
  wo = interior ? p.dt * lv : T(0);
}

// The block's loads: the ring's rows of lambda, H, H_D, B and x, each its 32
// own columns in vectors of W values and its two edge columns; each
// thread's R own cells of lambda. Out-of-plane points read 0.
template <typename T, int R, bool kVec>
struct Loads {
  using P = Plan<T, R>;
  static constexpr int kW = kVec ? P::kV : 1;
  static constexpr int kUnits = P::kRingY * (kLanes / kW);
  static constexpr int kPasses = (kUnits + kThreads - 1) / kThreads;
  T lam[kPasses][kW], h[kPasses][kW], hd[kPasses][kW], b[kPasses][kW], x[kPasses][kW];
  T lame, he, hde, be, xe;       // one edge point (threads < 2 kRingY)
  T own_lam[R];

  __device__ __forceinline__ void issue(const PlaneVjpArgs<T>& p, long off, int i0, int j0,
                                        int tid) {
    const int nx = p.nx, ny = p.ny;
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int u = tid + k * kThreads;
      const int r = u / (kLanes / kW), q = u - r * (kLanes / kW);
      const int ii = i0 - 1 + r, jj = j0 + q * kW;
      if (u < kUnits && ii >= 0 && ii < nx && jj < ny) {
        const long g = off + static_cast<long>(ii * ny + jj);
        ldg_wide<T, kW>(lam[k], p.lam + g);
        ldg_wide<T, kW>(h[k], p.H + g);
        if (p.hd_is_h) {
#pragma unroll
          for (int w = 0; w < kW; ++w) hd[k][w] = h[k][w];
        } else {
          ldg_wide<T, kW>(hd[k], p.HD + g);
        }
        ldg_wide<T, kW>(b[k], p.B + g);
        ldg_wide<T, kW>(x[k], p.x + g);
      } else {
#pragma unroll
        for (int w = 0; w < kW; ++w) lam[k][w] = h[k][w] = hd[k][w] = b[k][w] = x[k][w] = T(0);
      }
    }
    lame = he = hde = be = xe = T(0);
    if (tid < 2 * P::kRingY) {
      const int ii = i0 - 1 + (tid >> 1), jj = (tid & 1) ? j0 + kLanes : j0 - 1;
      if (ii >= 0 && ii < nx && jj >= 0 && jj < ny) {
        const long g = off + static_cast<long>(ii * ny + jj);
        lame = __ldg(p.lam + g);
        he = __ldg(p.H + g);
        hde = p.hd_is_h ? he : __ldg(p.HD + g);
        be = __ldg(p.B + g);
        xe = __ldg(p.x + g);
      }
    }
    const int lane = tid % kLanes, grp = tid / kLanes, j = j0 + lane;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = i0 + grp * R + q;
      const long g = off + static_cast<long>(i * ny + j);
      own_lam[q] = (i < nx && j < ny) ? __ldg(p.lam + g) : T(0);
    }
  }

  __device__ __forceinline__ void stage(Tile<T, R>& t, const PlaneVjpArgs<T>& p,
                                        T one_minus_theta, int i0, int j0, int tid) const {
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int u = tid + k * kThreads;
      if (u < kUnits) {
        const int r = u / (kLanes / kW), q = u - r * (kLanes / kW);
        const int c = P::kPad + 1 + q * kW;
        T hv[kW], sv[kW], uv[kW], wv[kW];
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          ring_point(p, one_minus_theta, i0 - 1 + r, j0 + q * kW + w, lam[k][w], h[k][w],
                     hd[k][w], b[k][w], x[k][w], hv[w], sv[w], uv[w], wv[w]);
        }
        st_wide<T, kW>(&t.h[r][c], hv);
        st_wide<T, kW>(&t.s[r][c], sv);
        st_wide<T, kW>(&t.u[r][c], uv);
        st_wide<T, kW>(&t.w[r][c], wv);
      }
    }
    if (tid < 2 * P::kRingY) {
      const int r = tid >> 1, c = P::kPad + ((tid & 1) ? kRingX - 1 : 0);
      const int jj = (tid & 1) ? j0 + kLanes : j0 - 1;
      ring_point(p, one_minus_theta, i0 - 1 + r, jj, lame, he, hde, be, xe, t.h[r][c],
                 t.s[r][c], t.u[r][c], t.w[r][c]);
    }
  }
};

// The sum of v over a warp by a shuffle tree (lane 0 holds it).
template <typename T>
__device__ __forceinline__ T warp_tree(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's two sums in a fixed order: each warp's tree, then thread 0
// adds the warps' partials in order. Returns them in thread 0.
template <typename T, int R>
__device__ __forceinline__ void block_sums(Tile<T, R>& t, T& a, T& b) {
  a = warp_tree(a);
  b = warp_tree(b);
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    t.part[0][tid >> 5] = a;
    t.part[1][tid >> 5] = b;
  }
  __syncthreads();
  if (tid == 0) {
    a = b = T(0);
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      a += t.part[0][q];
      b += t.part[1][q];
    }
  }
}

template <typename T, class E, int R, bool kVec>
__global__ void __launch_bounds__(kThreads) si_plane_vjp(PlaneVjpArgs<T> p, E e) {
  using P = Plan<T, R>;
  __shared__ Tile<T, R> t;
  const int tid = threadIdx.x, nx = p.nx, ny = p.ny;
  const int i0 = blockIdx.y * P::kRows, j0 = blockIdx.x * kLanes, g = blockIdx.z;
  const long off = static_cast<long>(g) * nx * ny;
  const T one_minus_theta = T(1) - p.theta;
  Loads<T, R, kVec> in;
  in.issue(p, off, i0, j0, tid);
  const Recip<T> k = odinn::vjp_table_row<T>(p.table, p.table_stride, p.table_f64, g);
  in.stage(t, p, one_minus_theta, i0, j0, tid);
  __syncthreads();

  // every corner of the tile once; the tile owns those with lr, lc >= 1,
  // and sums their two power products into the thread's d(creep) and
  // d(slide). Corners off the plane are zero.
  T creep = T(0), slide = T(0);
  constexpr int kCorners = P::kCornerY * kCornerX;
  for (int c0 = 0; c0 < kCorners; c0 += kThreads) {
    const int idx = c0 + tid;
    if (idx < kCorners) {
      const int lr = idx / kCornerX, lc = idx - lr * kCornerX;
      const int a = i0 - 1 + lr, c = j0 - 1 + lc;
      Corner<T> v{T(0), T(0), T(0), T(0)};
      if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {
        const int x = P::kPad + lc;
        const CornerTerms<T> ct = odinn::form_corner(
            t.h[lr][x], t.h[lr + 1][x], t.h[lr][x + 1], t.h[lr + 1][x + 1], t.s[lr][x],
            t.s[lr + 1][x], t.s[lr][x + 1], t.s[lr + 1][x + 1], t.u[lr][x], t.u[lr + 1][x],
            t.u[lr][x + 1], t.u[lr + 1][x + 1], t.w[lr][x], t.w[lr + 1][x], t.w[lr][x + 1],
            t.w[lr + 1][x + 1], k, e);
        v = ct.v;
        if (lr >= 1 && lc >= 1) {
          creep += ct.creep;
          slide += ct.slide;
        }
      }
      t.c[lr][lc] = v;
    }
  }
  __syncthreads();

  // cell (i, j) = (i0 + ty, j0 + lane) sits at ring point (ty + 1, lane + 1)
  // and between the corner grid points (ty .. ty + 1, lane .. lane + 1)
  const int lane = tid % kLanes, grp = tid / kLanes;
  const int j = j0 + lane, x = P::kPad + 1 + lane;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int ty = grp * R + q, r = ty + 1, i = i0 + ty;
    if (i >= nx || j >= ny) continue;
    const CellTerms<T> ct = odinn::gather_cell(
        t.c[ty][lane], t.c[ty][lane + 1], t.c[ty + 1][lane], t.c[ty + 1][lane + 1], t.w[r][x],
        t.w[r + 1][x], t.w[r - 1][x], t.w[r][x + 1], t.w[r][x - 1], k);
    const bool ring = i == 0 || j == 0 || i == nx - 1 || j == ny - 1;
    const long gi = off + static_cast<long>(i * ny + j);
    p.dH[gi] = in.own_lam[q] + ct.ubar * (ring ? T(1) : one_minus_theta);
    p.dB[gi] = ct.ubar + ct.sbar;
    p.dHD[gi] = t.h[r][x] > T(0) ? ct.q + ct.sbar : T(0);
  }

  // d(creep), d(slide): the block's sums into its slots, then the glacier's
  // last block sums the slots in block order
  block_sums(t, creep, slide);
  const int nblk = gridDim.x * gridDim.y;
  T* const slots = p.partial + 2L * g * nblk;
  if (tid == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    slots[b] = creep;
    slots[nblk + b] = slide;
    __threadfence();
    t.last = atomicAdd(p.counter + g, 1u) == static_cast<unsigned>(nblk - 1);
  }
  __syncthreads();
  if (!t.last) return;
  __threadfence();
  T sc = T(0), ss = T(0);
  for (int q0 = tid; q0 < nblk; q0 += kSlotBatch * kThreads) {
    T bc[kSlotBatch], bs[kSlotBatch];
#pragma unroll
    for (int q = 0; q < kSlotBatch; ++q) {
      const int at = q0 + q * kThreads;
      bc[q] = at < nblk ? __ldcg(slots + at) : T(0);
      bs[q] = at < nblk ? __ldcg(slots + nblk + at) : T(0);
    }
#pragma unroll
    for (int q = 0; q < kSlotBatch; ++q) {
      sc += bc[q];
      ss += bs[q];
    }
  }
  block_sums(t, sc, ss);
  if (tid == 0) {
    p.dcreep[g] = sc;
    p.dslide[g] = ss;
    p.counter[g] = 0u;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0; }

template <typename T, class E, int R>
int launch_rows(const PlaneVjpArgs<T>& p, E e, int n_g, bool vec, cudaStream_t s) {
  constexpr int kRows = Plan<T, R>::kRows;
  const dim3 grid((p.ny + kLanes - 1) / kLanes, (p.nx + kRows - 1) / kRows, n_g);
  if (vec) {
    si_plane_vjp<T, E, R, true><<<grid, kThreads, 0, s>>>(p, e);
  } else {
    si_plane_vjp<T, E, R, false><<<grid, kThreads, 0, s>>>(p, e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const T* lam, const T* H, const T* HD, const T* B, const T* x, const void* table,
        long table_stride, int table_f64, T* dH, T* dHD, T* dB, T* partial, unsigned* counter,
        T* dcreep, T* dslide, int n_g, int nx, int ny, double dt, double theta, int glen,
        double e_hc, double e_sc, double e_hs, double e_ss, int rows, int vec, void* stream) {
  // the plan: rows a thread 1 or 4, the launch's grid, 32-bit cell indices
  // within a plane, 16-byte vectors that stay whole and aligned
  const long tiles_x = (static_cast<long>(nx) + kGroups * rows - 1) / (kGroups * rows);
  const bool ok = n_g >= 1 && n_g <= 65535 && nx >= 3 && ny >= 3 && (rows == 1 || rows == 4) &&
                  tiles_x <= 65535 && static_cast<long>(nx) * ny <= 0x7fffffffL &&
                  (!vec || (ny % Plan<T, 1>::kV == 0 && aligned16(lam) && aligned16(H) &&
                            aligned16(HD) && aligned16(B) && aligned16(x)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const PlaneVjpArgs<T> a{lam, H, HD, B, x, table, table_stride, table_f64, HD == H ? 1 : 0,
                          dH, dHD, dB, partial, counter, dcreep, dslide, nx, ny,
                          static_cast<T>(dt), static_cast<T>(theta)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto e) {
    using E = decltype(e);
    return rows == 4 ? launch_rows<T, E, 4>(a, e, n_g, vec != 0, s)
                     : launch_rows<T, E, 1>(a, e, n_g, vec != 0, s);
  };
  if (glen) return go(GlenExps<T>{});
  return go(RuntimeExps<T>{static_cast<T>(e_hc), static_cast<T>(e_sc), static_cast<T>(e_hs),
                           static_cast<T>(e_ss)});
}

}  // namespace

// The large-plane pullback. `table` holds row g at table + g * table_stride
// (dx, dy, creep, slide first), in float64 when `table_f64` != 0, else in
// the planes' dtype; `partial` holds 2 * n_g * (blocks a glacier) values and
// `counter` n_g unsigned ints, zero before the launch and left zero by it;
// `glen` != 0 takes the (5, 2, 4, 2) specialisation and ignores e_*;
// `rows` (1 or 4) and `vec` are the wrapper's plan
// (si_kernel.plane_vjp_layout); `vec` != 0 takes the 16-byte loads, which
// need ny a multiple of the vector and every input plane 16-byte aligned. A
// plan or plane the kernel does not take is refused with
// cudaErrorInvalidValue.
extern "C" int si_plane_vjp_f32(const float* lam, const float* H, const float* HD,
                                const float* B, const float* x, const void* table,
                                long table_stride, int table_f64, float* dH, float* dHD,
                                float* dB, float* partial, unsigned* counter, float* dcreep,
                                float* dslide, int n_g, int nx, int ny, double dt, double theta,
                                int glen, double e_hc, double e_sc, double e_hs, double e_ss,
                                int rows, int vec, void* stream) {
  return run<float>(lam, H, HD, B, x, table, table_stride, table_f64, dH, dHD, dB, partial,
                    counter, dcreep, dslide, n_g, nx, ny, dt, theta, glen, e_hc, e_sc, e_hs,
                    e_ss, rows, vec, stream);
}

extern "C" int si_plane_vjp_f64(const double* lam, const double* H, const double* HD,
                                const double* B, const double* x, const void* table,
                                long table_stride, int table_f64, double* dH, double* dHD,
                                double* dB, double* partial, unsigned* counter, double* dcreep,
                                double* dslide, int n_g, int nx, int ny, double dt,
                                double theta, int glen, double e_hc, double e_sc, double e_hs,
                                double e_ss, int rows, int vec, void* stream) {
  return run<double>(lam, H, HD, B, x, table, table_stride, table_f64, dH, dHD, dB, partial,
                     counter, dcreep, dslide, n_g, nx, ny, dt, theta, glen, e_hc, e_sc, e_hs,
                     e_ss, rows, vec, stream);
}
