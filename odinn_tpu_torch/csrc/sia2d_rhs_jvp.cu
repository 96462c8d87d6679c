// Tangent of the fused SIA2D right-hand side (A target, per-glacier scalar
// laws): given the tangent dH of H and the tangent dcreep of each glacier's
// creep prefactor, fdot = df/dH dH + df/dcreep dcreep; and, as a second mode
// of the same kernel, one stage of the RKC2 step's tangent around it.
//
// It replaces no TPU kernel. The TPU kernels have no tangent
// (odinn_tpu/ops/pallas/sia_kernel.py and rkc_kernel.py are
// jax.custom_vjp): the JAX package takes this one by jax.jvp of its
// production RHS, odinn_tpu/physics/sia2d.py::sia2d_rhs, and of
// odinn_tpu/simulation/solver.py::make_rkc2_step. Plain PyTorch version:
// ops/cuda/sia_kernel.py::sia2d_rhs_jvp_reference (both modes). The
// contract is the pullback's (sia2d_rhs_vjp.cu): H and the creep column
// only; B and the other scalars carry no tangent (the wrapper raises on
// one). The chain follows the forward's conventions: relu passes dH where
// H > 0, |grad S| has a zero tangent at the origin, the eta0 clamp passes
// the slope's tangent inside [lo, up] and the bounding thickness's outside
// it, integer exponents as products (0^e := 0 otherwise).
//
// What bounds it on the H100: latency, then the arithmetic. Per cell the
// plain mode reads dH, H and B and writes fdot, 16 bytes in float32,
// against ~130 operations; at 16 x 128^2 a call moves about 4 MB (1.25 us
// at 3.35 TB/s). Every block loads at once, so a launch is the launch
// itself (~1.2 us for 512 blocks), one round trip of loads that all SMs
// make together (~1.3 us), ~2 us of corners and fluxes that those loads
// cannot hide, and the stores (profile_jvp.py's trace and variants).
//
// Design. A block is 128 threads, four warps, over a tile of 32 cells
// along y (one a lane) by 4R rows (R rows a warp), R = 1, 2 or 4, the
// glacier in blockIdx.z. The wrapper's plan (sia_kernel.jvp_layout) takes
// the largest R that still gives every SM two blocks: more rows a thread
// share more corners and edges and launch fewer blocks, and a small plane
// spreads over the most SMs. Every global load of a block is issued before
// its first barrier, into registers: the tile's H, B and dH with a
// one-cell ring, as 16-byte vectors along y where the wrapper found ny a
// multiple of the vector and the planes aligned (the ring's two edge
// columns as single values), and in the stage mode each thread's own cells
// of dH0, dY2 and df0. The ring goes to shared memory as relu(H), S = B +
// relu(H) and dh = dH [H > 0], the tangent of both; in the stage mode the
// own cells' planes and raw dH beside it, so that no register holds them
// through the arithmetic. After the first barrier the block forms each
// corner of its (4R + 1) x 33 grid once, D and its tangent; after the
// second each thread forms the fluxes' tangents through its cells' edges,
// each edge once (a clamped slope, its tangent, the flux's tangent; the y
// edges shared with the neighbouring lane by a shuffle), then its R cells'
// negated divergence, and stores. Ring cells have fdot = 0. A glacier
// whose exponent set is (5, 2, 4, 2) takes a specialisation (GlenExps) in
// which both slope factors are |grad S|^2: the corner forms the squared
// norm and g . dg, the tangent of |grad S|^2 / 2, and so takes no square
// root and no division; any other set takes its exponents from the table
// (RuntimeExps) through |grad S|. The arithmetic is the plain version's
// with reciprocal spacings, half-sums and the Glen set's rate gathered, so
// its roundings differ from the plain version's by a few ulps.
//
// The stage mode (kStage) is stage j of the RKC2 step's tangent
// (ops/cuda/rkc_kernel.py::interval_tangent) at Y = y(j-1) with dH the
// tangent of y(j-1): per own cell
//   ydot(j) = a_j dH0 + mu_j dH + nu_j dY2 + mu~_j dt fdot + gamma~_j dt df0,
// the forward stage's combination in its order (rkc_interval.cu), dH0 the
// tangent of the step's H, dY2 of y(j-2), df0 of f(H); fdot is also written
// where `f` is given (the first stage, whose fdot is df0). Built without
// contraction (ops/cuda/build.py), so that the combination rounds as
// rkc_interval.cu's does: the stages carry each rounding on, as in the RKC
// step. (The RHS arithmetic above differs from the plain version's by a few
// ulps either way.) No atomics: a repeat is bitwise equal.
#include <cstdint>
#include <cstring>

#include "sia_common.cuh"

namespace {

using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::clamp_edge;
using odinn::relu;

constexpr int kLanes = 32;                  // cells along y a tile, one a lane
constexpr int kGroups = 4;                  // warps a block, R rows each
constexpr int kThreads = kLanes * kGroups;
constexpr int kRingX = kLanes + 2;          // the tile's columns with its ring
constexpr int kCornerX = kLanes + 1;        // the tile's corner columns

// A tile of 4R rows. Ring column c (0 = the column left of the tile) sits at
// shared column kPad + c, so that the tile's own columns start on 16 bytes.
template <typename T, int R>
struct Plan {
  static constexpr int kRows = kGroups * R;
  static constexpr int kRingY = kRows + 2;
  static constexpr int kCornerY = kRows + 1;
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));   // values a 16-byte vector
  static constexpr int kPad = kV - 1;
  static constexpr int kRow = (kPad + kRingX + kV - 1) / kV * kV;
};

template <typename T, int R>
struct Tile {
  using P = Plan<T, R>;
  alignas(16) T h[P::kRingY][P::kRow];    // relu(H)
  alignas(16) T s[P::kRingY][P::kRow];    // B + relu(H)
  alignas(16) T dh[P::kRingY][P::kRow];   // dH [H > 0], the tangent of relu(H) and S
  T d[P::kCornerY][kCornerX];   // corner D: grid point (lr, lc) is the corner (i0-1+lr, j0-1+lc)
  T dd[P::kCornerY][kCornerX];  // its tangent
};

// The stage mode's own planes at the tile's cells: dH (raw), dH0, dY2 and
// df0, read once the cell's fdot is known.
template <typename T, int R, bool kStage>
struct Own {
  alignas(16) T c1[Plan<T, R>::kRows][kLanes];
  T d0[Plan<T, R>::kRows][kLanes];
  T y2[Plan<T, R>::kRows][kLanes], f0[Plan<T, R>::kRows][kLanes];
};
template <typename T, int R>
struct Own<T, R, false> {};

// W values of a row as one load: a 16-byte vector, or one value.
template <typename T, int W>
struct Wide {
  using type = T;
};
template <>
struct Wide<float, 4> {
  using type = float4;
};
template <>
struct Wide<double, 2> {
  using type = double2;
};

// the planes are read-only for the launch: through the read-only path
template <typename T, int W>
__device__ __forceinline__ void load_wide(const T* src, T (&v)[W]) {
  using V = typename Wide<T, W>::type;
  const V w = __ldg(reinterpret_cast<const V*>(src));
  memcpy(v, &w, sizeof(w));
}

template <typename T, int W>
__device__ __forceinline__ void store_wide(T* dst, const T (&v)[W]) {
  using V = typename Wide<T, W>::type;
  V w;
  memcpy(&w, v, sizeof(w));
  *reinterpret_cast<V*>(dst) = w;
}

template <typename T>
struct JvpArgs {
  const T* dH;        // the tangent of H; of y(j-1) in the stage mode
  const T* H;         // the point; y(j-1) in the stage mode
  const T* B;
  const T* table;     // (n_g, 8) derived table
  const T* dcreep;    // (n_g,) or null (zero)
  const T* dH0;       // stage mode: the tangents of H, y(j-2) and f(H)
  const T* dY2;
  const T* df0;
  T* f;               // fdot; may be null in the stage mode
  T* y;               // stage mode: ydot(j)
  int nx, ny;
  T eta0;
  T a, mu, nu, mutdt, gamdt;   // stage mode: stage j's coefficients
};

// The corner's surface slopes and their tangents from its 2x2 block (h00 =
// (a, c), h10 = (a+1, c), h01 = (a, c+1), h11 = (a+1, c+1)); the tangents
// of h and s are one. hx = 1/(2 dx), hy = 1/(2 dy).
template <typename T>
struct Slopes {
  T gsx, gsy, tgx, tgy;
};

template <typename T>
__device__ __forceinline__ Slopes<T> slopes(T s00, T s10, T s01, T s11, T t00, T t10, T t01,
                                            T t11, T hx, T hy) {
  return Slopes<T>{hx * ((s10 - s00) + (s11 - s01)), hy * ((s01 - s00) + (s11 - s10)),
                   hx * ((t10 - t00) + (t11 - t01)), hy * ((t01 - t00) + (t11 - t10))};
}

// D at a corner and its tangent, for any exponent set: through |grad S| and
// its tangent (g . dg)/|grad S|, zero at the origin, as corner_D and the
// plain version form them.
template <typename T, class E>
__device__ __forceinline__ void corner_tangent(const Slopes<T>& g, T hb, T thb,
                                               const Recip<T>& k, T dcreep, const E& e, T& D,
                                               T& dD) {
  const T sq = g.gsx * g.gsx + g.gsy * g.gsy;
  const T gn = sq > T(0) ? sqrt(sq) : T(0);
  const T tgn = gn > T(0) ? (g.gsx * g.tgx + g.gsy * g.tgy) / gn : T(0);
  const T ph_s = e.hs(hb), pg_s = e.ss(gn), ph_c = e.hc(hb), pg_c = e.sc(gn);
  D = k.slide * ph_s * pg_s + k.creep * ph_c * pg_c;
  dD = k.creep * (e.d_hc(hb) * thb * pg_c + ph_c * e.d_sc(gn) * tgn) +
       k.slide * (e.d_hs(hb) * thb * pg_s + ph_s * e.d_ss(gn) * tgn) + dcreep * ph_c * pg_c;
}

// The (5, 2, 4, 2) set: both slope factors are |grad S|^2 = sq, whose
// tangent 2 |grad S| tgn is 2 (g . dg), so the corner needs neither the
// square root nor the division (and at the origin both are 0, as there);
// D = (slide H^4 + creep H^5) sq, the rate and its derivative in H gathered.
template <typename T>
__device__ __forceinline__ void corner_tangent(const Slopes<T>& g, T hb, T thb,
                                               const Recip<T>& k, T dcreep, const GlenExps<T>&,
                                               T& D, T& dD) {
  const T sq = g.gsx * g.gsx + g.gsy * g.gsy;
  const T dsq = T(2) * (g.gsx * g.tgx + g.gsy * g.tgy);
  const T h2 = hb * hb, h4 = h2 * h2, h5 = h4 * hb;
  const T rate = k.slide * h4 + k.creep * h5;
  const T drate = k.slide * (T(4) * (h2 * hb)) + k.creep * (T(5) * h4);
  D = rate * sq;
  dD = (drate * thb) * sq + rate * dsq + (dcreep * h5) * sq;
}

// The tangent of one clamped edge slope: raw = (sp - sm)/d, bounds
// up = hp eta/d and lo = -hm eta/d; (ds, its tangent).
template <typename T>
__device__ __forceinline__ void edge_tangent(T sp, T sm, T hp, T hm, T tp, T tm, T inv, T eta_d,
                                             T& ds, T& tds) {
  const T raw = (sp - sm) * inv;
  const T up = hp * eta_d, lo = -hm * eta_d;
  ds = clamp_edge(raw, up, lo);
  tds = raw > up ? tp * eta_d : (raw < lo ? -(tm * eta_d) : (tp - tm) * inv);
}

// The block's loads: the ring's rows, each its 32 own columns in vectors of
// W values (W = 16 bytes' worth with kVec, else 1) and its two edge
// columns, and in the stage mode each thread's own cells of dH0, dY2, df0.
// All are issued before the first value is used. Out-of-plane points read 0,
// so that h = s = dH = 0 there.
template <typename T, int R, bool kStage, bool kVec>
struct Loads {
  using P = Plan<T, R>;
  static constexpr int kW = kVec ? P::kV : 1;
  static constexpr int kUnits = P::kRingY * (kLanes / kW);
  static constexpr int kPasses = (kUnits + kThreads - 1) / kThreads;
  T h[kPasses][kW], b[kPasses][kW], d[kPasses][kW];
  T he, be, de;                        // one edge point (threads < 2 kRingY)
  T d0[R], y2[R], f0[R];               // stage mode: dH0, dY2, df0 at the own cells

  __device__ __forceinline__ void issue(const JvpArgs<T>& p, long off, int i0, int j0, int tid) {
    const int nx = p.nx, ny = p.ny;
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int u = tid + k * kThreads;
      const int r = u / (kLanes / kW), q = u - r * (kLanes / kW);
      const int ii = i0 - 1 + r, jj = j0 + q * kW;
      if (u < kUnits && ii >= 0 && ii < nx && jj < ny) {
        const long g = off + static_cast<long>(ii) * ny + jj;
        load_wide<T, kW>(p.H + g, h[k]);
        load_wide<T, kW>(p.B + g, b[k]);
        load_wide<T, kW>(p.dH + g, d[k]);
      } else {
#pragma unroll
        for (int w = 0; w < kW; ++w) h[k][w] = b[k][w] = d[k][w] = T(0);
      }
    }
    he = be = de = T(0);
    if (tid < 2 * P::kRingY) {
      const int ii = i0 - 1 + (tid >> 1), jj = (tid & 1) ? j0 + kLanes : j0 - 1;
      if (ii >= 0 && ii < nx && jj >= 0 && jj < ny) {
        const long g = off + static_cast<long>(ii) * ny + jj;
        he = __ldg(p.H + g);
        be = __ldg(p.B + g);
        de = __ldg(p.dH + g);
      }
    }
    if constexpr (kStage) {
      const int lane = tid % kLanes, grp = tid / kLanes, j = j0 + lane;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int i = i0 + grp * R + k;
        d0[k] = y2[k] = f0[k] = T(0);
        if (i < nx && j < ny) {
          const long g = off + static_cast<long>(i) * ny + j;
          d0[k] = __ldg(p.dH0 + g);
          y2[k] = __ldg(p.dY2 + g);
          f0[k] = __ldg(p.df0 + g);
        }
      }
    }
  }

  // relu(H), S and dh into the ring; the stage mode's own planes
  __device__ __forceinline__ void stage_ring(Tile<T, R>& t, Own<T, R, kStage>& own,
                                             int tid) const {
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int u = tid + k * kThreads;
      if (u < kUnits) {
        const int r = u / (kLanes / kW), q = u - r * (kLanes / kW);
        const int x = P::kPad + 1 + q * kW;
        T hv[kW], sv[kW], dv[kW];
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          hv[w] = relu(h[k][w]);
          sv[w] = b[k][w] + hv[w];
          dv[w] = h[k][w] > T(0) ? d[k][w] : T(0);
        }
        store_wide<T, kW>(&t.h[r][x], hv);
        store_wide<T, kW>(&t.s[r][x], sv);
        store_wide<T, kW>(&t.dh[r][x], dv);
        // the tile's own rows: the stage mode's raw dH
        if constexpr (kStage) {
          if (r >= 1 && r <= P::kRows) store_wide<T, kW>(&own.c1[r - 1][q * kW], d[k]);
        }
      }
    }
    if (tid < 2 * P::kRingY) {
      const int r = tid >> 1, x = P::kPad + ((tid & 1) ? kRingX - 1 : 0);
      const T hv = relu(he);
      t.h[r][x] = hv;
      t.s[r][x] = be + hv;
      t.dh[r][x] = he > T(0) ? de : T(0);
    }
    if constexpr (kStage) {
      const int lane = tid % kLanes, grp = tid / kLanes;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        own.d0[grp * R + k][lane] = d0[k];
        own.y2[grp * R + k][lane] = y2[k];
        own.f0[grp * R + k][lane] = f0[k];
      }
    }
  }
};

// The flux's tangent through the x edge between ring rows r - 1 and r at
// ring column x, with the corners (r - 1, lc) and (r - 1, lc + 1) of the grid
// at its ends: -(avg(dD) ds + avg(D) dds) of the clamped slope ds.
template <typename T, int R>
__device__ __forceinline__ T x_flux(const Tile<T, R>& t, int r, int x, int lc, const Recip<T>& k,
                                    T eta_dx) {
  T ds, tds;
  edge_tangent(t.s[r][x], t.s[r - 1][x], t.h[r][x], t.h[r - 1][x], t.dh[r][x], t.dh[r - 1][x],
               k.inv_dx, eta_dx, ds, tds);
  return T(-0.5) * ((t.dd[r - 1][lc] + t.dd[r - 1][lc + 1]) * ds +
                    (t.d[r - 1][lc] + t.d[r - 1][lc + 1]) * tds);
}

// ... and through the y edge between ring columns x - 1 and x of ring row r,
// with the corners (r - 1, lc) and (r, lc) at its ends.
template <typename T, int R>
__device__ __forceinline__ T y_flux(const Tile<T, R>& t, int r, int x, int lc, const Recip<T>& k,
                                    T eta_dy) {
  T ds, tds;
  edge_tangent(t.s[r][x], t.s[r][x - 1], t.h[r][x], t.h[r][x - 1], t.dh[r][x], t.dh[r][x - 1],
               k.inv_dy, eta_dy, ds, tds);
  return T(-0.5) * ((t.dd[r - 1][lc] + t.dd[r][lc]) * ds + (t.d[r - 1][lc] + t.d[r][lc]) * tds);
}

// The corners and cells of a block whose ring (and in the stage mode own
// planes) are in shared memory.
template <typename T, int R, class E, bool kStage>
__device__ __forceinline__ void jvp_block(const JvpArgs<T>& p, const E& e, Tile<T, R>& t,
                                          const Own<T, R, kStage>& own, const Recip<T>& k,
                                          T dcreep, int i0, int j0, long off) {
  using P = Plan<T, R>;
  const int tid = threadIdx.x;
  const int nx = p.nx, ny = p.ny;
  const T eta_dx = p.eta0 * k.inv_dx, eta_dy = p.eta0 * k.inv_dy;
  const T hx = T(0.5) * k.inv_dx, hy = T(0.5) * k.inv_dy;

  constexpr int kCorners = P::kCornerY * kCornerX;
#pragma unroll
  for (int c0 = 0; c0 < kCorners; c0 += kThreads) {
    const int idx = c0 + tid;
    if (idx < kCorners) {
      const int lr = idx / kCornerX, lc = idx - lr * kCornerX;
      const int a = i0 - 1 + lr, c = j0 - 1 + lc;
      T D = T(0), dD = T(0);
      if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {
        const int x = P::kPad + lc;
        const Slopes<T> g = slopes(t.s[lr][x], t.s[lr + 1][x], t.s[lr][x + 1],
                                   t.s[lr + 1][x + 1], t.dh[lr][x], t.dh[lr + 1][x],
                                   t.dh[lr][x + 1], t.dh[lr + 1][x + 1], hx, hy);
        const T hb = T(0.25) * (t.h[lr][x] + t.h[lr + 1][x] + t.h[lr][x + 1] +
                                t.h[lr + 1][x + 1]);
        const T thb = T(0.25) * (t.dh[lr][x] + t.dh[lr + 1][x] +
                                 t.dh[lr][x + 1] + t.dh[lr + 1][x + 1]);
        corner_tangent(g, hb, thb, k, dcreep, e, D, dD);
      }
      t.d[lr][lc] = D;
      t.dd[lr][lc] = dD;
    }
  }
  __syncthreads();

  // A warp's cells are rows grp R .. grp R + R - 1 of the tile at column
  // lane; cell (i, j) = (i0 + ty, j0 + lane) sits at ring point (ty + 1,
  // lane + 1). Each edge's flux is formed once: the R + 1 x edges down the
  // thread's column, each the west edge of one cell and the east edge of the
  // one above; the R y edges west of its cells, each the next lane's east
  // edge, and for the last lane's cells the R edges east of the tile, formed
  // by lanes 0 .. R-1.
  const int lane = tid % kLanes, grp = tid / kLanes;
  const int j = j0 + lane, x = P::kPad + 1 + lane;
  T fx[R + 1], fw[R], fe[R];
#pragma unroll
  for (int q = 0; q <= R; ++q) fx[q] = x_flux(t, grp * R + q + 1, x, lane, k, eta_dx);
#pragma unroll
  for (int q = 0; q < R; ++q) fw[q] = y_flux(t, grp * R + q + 1, x, lane, k, eta_dy);
  T last = T(0);
  if (lane < R) last = y_flux(t, grp * R + lane + 1, P::kPad + 1 + kLanes, kLanes, k, eta_dy);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const T next = __shfl_down_sync(0xffffffffu, fw[q], 1);
    const T from = __shfl_sync(0xffffffffu, last, q);
    fe[q] = lane == kLanes - 1 ? from : next;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = i0 + grp * R + q;
    if (i < nx && j < ny) {
      const bool inner = i > 0 && j > 0 && i < nx - 1 && j < ny - 1;
      const T v = inner ? -((fx[q + 1] - fx[q]) * k.inv_dx + (fe[q] - fw[q]) * k.inv_dy) : T(0);
      const long g = off + static_cast<long>(i) * ny + j;
      if (p.f != nullptr) p.f[g] = v;
      if constexpr (kStage) {
        const int ty = grp * R + q;
        p.y[g] = p.a * own.d0[ty][lane] + p.mu * own.c1[ty][lane] + p.nu * own.y2[ty][lane] +
                 p.mutdt * v + p.gamdt * own.f0[ty][lane];
      }
    }
  }
}

// The block's loads are issued first, the table's after them; then the
// ring goes to shared memory, and the glacier's exponent set picks the
// path of the rest (the branch is uniform in a block).
template <typename T, int R, bool kStage, bool kVec>
__global__ void __launch_bounds__(kThreads) sia2d_rhs_jvp_kernel(JvpArgs<T> p) {
  __shared__ Tile<T, R> tile;
  __shared__ Own<T, R, kStage> own;
  const int i0 = blockIdx.y * Plan<T, R>::kRows, j0 = blockIdx.x * kLanes;
  const long off = static_cast<long>(blockIdx.z) * p.nx * p.ny;
  Loads<T, R, kStage, kVec> in;
  in.issue(p, off, i0, j0, threadIdx.x);
  const T* row = p.table + 8L * blockIdx.z;
  const Recip<T> k = odinn::recip_row(row);
  const T dcreep = p.dcreep != nullptr ? p.dcreep[blockIdx.z] : T(0);
  const T e_hc = row[4], e_sc = row[5], e_hs = row[6], e_ss = row[7];
  in.stage_ring(tile, own, threadIdx.x);
  __syncthreads();
  if (e_hc == T(5) && e_sc == T(2) && e_hs == T(4) && e_ss == T(2)) {
    jvp_block<T, R, GlenExps<T>, kStage>(p, GlenExps<T>{}, tile, own, k, dcreep, i0, j0, off);
  } else {
    jvp_block<T, R, RuntimeExps<T>, kStage>(p, RuntimeExps<T>{e_hc, e_sc, e_hs, e_ss}, tile,
                                            own, k, dcreep, i0, j0, off);
  }
}

template <typename T, int R, bool kStage>
void launch_plan(const JvpArgs<T>& p, int n_g, bool vec, cudaStream_t s) {
  const dim3 grid((p.ny + kLanes - 1) / kLanes, (p.nx + Plan<T, R>::kRows - 1) / Plan<T, R>::kRows,
                  n_g);
  if (vec) {
    sia2d_rhs_jvp_kernel<T, R, kStage, true><<<grid, kThreads, 0, s>>>(p);
  } else {
    sia2d_rhs_jvp_kernel<T, R, kStage, false><<<grid, kThreads, 0, s>>>(p);
  }
}

template <typename T, bool kStage>
void launch_mode(const JvpArgs<T>& p, int n_g, int rows, bool vec, cudaStream_t s) {
  if (rows == 4) {
    launch_plan<T, 4, kStage>(p, n_g, vec, s);
  } else if (rows == 2) {
    launch_plan<T, 2, kStage>(p, n_g, vec, s);
  } else {
    launch_plan<T, 1, kStage>(p, n_g, vec, s);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0; }

template <typename T>
int launch(const T* dH, const T* H, const T* B, const T* table, const T* dcreep, const T* dH0,
           const T* dY2, const T* df0, T* f, T* y, int n_g, int nx, int ny, int rows, int vec,
           double eta0, double a, double mu, double nu, double mutdt, double gamdt, int stage,
           void* stream) {
  if (n_g < 1 || nx < 1 || ny < 1 || (rows != 1 && rows != 2 && rows != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan's vectors: ny a multiple of 16 bytes' worth, the planes aligned
  if (vec && (ny % Plan<T, 1>::kV != 0 || !aligned16(dH) || !aligned16(H) || !aligned16(B)))
    return static_cast<int>(cudaErrorInvalidValue);
  JvpArgs<T> p = {};
  p.dH = dH;
  p.H = H;
  p.B = B;
  p.table = table;
  p.dcreep = dcreep;
  p.dH0 = dH0;
  p.dY2 = dY2;
  p.df0 = df0;
  p.f = f;
  p.y = y;
  p.nx = nx;
  p.ny = ny;
  p.eta0 = static_cast<T>(eta0);
  p.a = static_cast<T>(a);
  p.mu = static_cast<T>(mu);
  p.nu = static_cast<T>(nu);
  p.mutdt = static_cast<T>(mutdt);
  p.gamdt = static_cast<T>(gamdt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage) {
    if (y == nullptr || dH0 == nullptr || dY2 == nullptr || df0 == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    launch_mode<T, true>(p, n_g, rows, vec != 0, s);
  } else {
    if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    launch_mode<T, false>(p, n_g, rows, vec != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fdot into `f` (plain mode, `stage` == 0); with `stage` != 0 stage j of the
// RKC2 tangent into `y`, fdot into `f` when it is not null. `dcreep` may be
// null (no creep tangent); the stage pointers are read in the stage mode
// only. `rows` (1, 2 or 4) and `vec` are the wrapper's plan
// (sia_kernel.jvp_layout): rows a thread, and 16-byte loads of dH, H and B.
extern "C" int sia2d_rhs_jvp_f32(const float* dH, const float* H, const float* B,
                                 const float* table, const float* dcreep, const float* dH0,
                                 const float* dY2, const float* df0, float* f, float* y,
                                 int n_g, int nx, int ny, int rows, int vec, double eta0,
                                 double a, double mu, double nu, double mutdt, double gamdt,
                                 int stage, void* stream) {
  return launch<float>(dH, H, B, table, dcreep, dH0, dY2, df0, f, y, n_g, nx, ny, rows, vec,
                       eta0, a, mu, nu, mutdt, gamdt, stage, stream);
}

extern "C" int sia2d_rhs_jvp_f64(const double* dH, const double* H, const double* B,
                                 const double* table, const double* dcreep, const double* dH0,
                                 const double* dY2, const double* df0, double* f, double* y,
                                 int n_g, int nx, int ny, int rows, int vec, double eta0,
                                 double a, double mu, double nu, double mutdt, double gamdt,
                                 int stage, void* stream) {
  return launch<double>(dH, H, B, table, dcreep, dH0, dY2, df0, f, y, n_g, nx, ny, rows, vec,
                        eta0, a, mu, nu, mutdt, gamdt, stage, stream);
}
