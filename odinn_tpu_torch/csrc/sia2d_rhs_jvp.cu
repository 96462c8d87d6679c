// Tangent of the fused SIA2D right-hand side (A target, per-glacier scalar
// laws): given the tangent dH of H and the tangent dcreep of each glacier's
// creep prefactor, fdot = df/dH dH + df/dcreep dcreep; and, as a second mode
// of the same kernel, one stage of the RKC2 step's tangent around it.
//
// The TPU kernels have no tangent (odinn_tpu/ops/pallas/sia_kernel.py and
// rkc_kernel.py are jax.custom_vjp): the JAX package takes this one by
// jax.jvp of its production RHS, odinn_tpu/physics/sia2d.py::sia2d_rhs, and
// of odinn_tpu/simulation/solver.py::make_rkc2_step. Plain PyTorch version:
// ops/cuda/sia_kernel.py::sia2d_rhs_jvp_reference (both modes). The
// contract is the pullback's (sia2d_rhs_vjp.cu): H and the creep column
// only; B and the other scalars carry no tangent (the wrapper raises on
// one). The chain follows the forward's conventions: relu passes dH where
// H > 0, |grad S| has a zero tangent at the origin, the eta0 clamp passes
// the slope's tangent inside [lo, up] and the bounding thickness's outside
// it, integer exponents as products (0^e := 0 otherwise).
//
// What bounds it on the H100: bytes, and before them latency. Per cell the
// plain mode reads dH, H and B and writes fdot, 16 bytes in float32, against
// ~150 operations; at 16 x 128^2 a call moves about 1 MB (0.3 us at
// 3.35 TB/s), so a launch is one round of loads, a chain of dependent
// arithmetic and one store.
//
// Design: the forward's (sia2d_rhs.cu). Tiles of 32 x 4 cells, blockIdx.z
// the glacier, 192 threads. A block loads relu(H), S = B + relu(H) and
// dh = dH*[H > 0] of its tile and a one-cell ring into shared memory once,
// coalesced; one thread per point of the tile's 33 x 5 corner grid forms that
// corner's D and its tangent once; after one __syncthreads() each cell forms
// its clamped edge slopes, their tangents, the fluxes' tangents and the
// negated divergence. Ring cells have fdot = 0. A glacier whose exponent set
// is (5, 2, 4, 2) takes a specialisation with fixed multiplies (GlenExps); any
// other takes its exponents from the table (RuntimeExps).
//
// The stage mode (kStage) is stage j of the RKC2 step's tangent
// (ops/cuda/rkc_kernel.py::interval_tangent) at Y = y(j-1) with dH the
// tangent of y(j-1): per own cell
//   ydot(j) = a_j dH0 + mu_j dH + nu_j dY2 + mu~_j dt fdot + gamma~_j dt df0,
// the forward stage's combination in its order (rkc_interval.cu), dH0 the
// tangent of the step's H, dY2 of y(j-2), df0 of f(H); fdot is also written
// where `f` is given (the first stage, whose fdot is df0). Built without
// contraction (ops/cuda/build.py): the stages carry each rounding on, as in
// the RKC step.
#include "sia_common.cuh"

namespace {

using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::clamp_edge;
using odinn::relu;

constexpr int kTX = 32;            // cells along y (contiguous)
constexpr int kTY = 4;             // cells along x
constexpr int kRX = kTX + 2;       // the tile with its ring
constexpr int kRY = kTY + 2;
constexpr int kCX = kTX + 1;       // the tile's corner grid
constexpr int kCY = kTY + 1;
constexpr int kThreads = (kCX * kCY + 31) / 32 * 32;

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

template <typename T>
struct Tile {
  T h[kRY][kRX];    // relu(H)
  T s[kRY][kRX];    // B + relu(H)
  T dh[kRY][kRX];   // dH*[H > 0], the tangent of both
  T d[kCY][kCX];    // corner D: grid point (lr, lc) is the corner (i0-1+lr, j0-1+lc)
  T dd[kCY][kCX];   // its tangent
};

// D at a corner from its 2x2 block (h00 = (a, c), h10 = (a+1, c), h01 =
// (a, c+1), h11 = (a+1, c+1)) and its tangent from the block's tangents
// (those of h and s are one), as corner_D and the plain version form them.
template <typename T, class E>
__device__ __forceinline__ void corner_tangent(T h00, T h10, T h01, T h11, T s00, T s10, T s01,
                                               T s11, T t00, T t10, T t01, T t11,
                                               const Recip<T>& k, T dcreep, const E& e, T& D,
                                               T& dD) {
  const T gsx = T(0.5) * ((s10 - s00) * k.inv_dx + (s11 - s01) * k.inv_dx);
  const T gsy = T(0.5) * ((s01 - s00) * k.inv_dy + (s11 - s10) * k.inv_dy);
  const T tgx = T(0.5) * ((t10 - t00) * k.inv_dx + (t11 - t01) * k.inv_dx);
  const T tgy = T(0.5) * ((t01 - t00) * k.inv_dy + (t11 - t10) * k.inv_dy);
  const T sq = gsx * gsx + gsy * gsy;
  const T gn = sq > T(0) ? sqrt(sq) : T(0);
  const T tgn = gn > T(0) ? (gsx * tgx + gsy * tgy) / gn : T(0);
  const T hb = T(0.25) * (h00 + h10 + h01 + h11);
  const T thb = T(0.25) * (t00 + t10 + t01 + t11);
  const T ph_s = e.hs(hb), pg_s = e.ss(gn), ph_c = e.hc(hb), pg_c = e.sc(gn);
  D = k.slide * ph_s * pg_s + k.creep * ph_c * pg_c;
  dD = k.creep * (e.d_hc(hb) * thb * pg_c + ph_c * e.d_sc(gn) * tgn) +
       k.slide * (e.d_hs(hb) * thb * pg_s + ph_s * e.d_ss(gn) * tgn) + dcreep * ph_c * pg_c;
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

template <typename T, class E, bool kStage>
__device__ __forceinline__ void jvp_block(const JvpArgs<T>& p, const E& e, Tile<T>& t) {
  const int tid = threadIdx.x;
  const int nx = p.nx, ny = p.ny;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;
  const long off = static_cast<long>(blockIdx.z) * nx * ny;
  const Recip<T> k = odinn::recip_row(p.table + 8L * blockIdx.z);
  const T dcreep = p.dcreep != nullptr ? p.dcreep[blockIdx.z] : T(0);
  const T eta_dx = p.eta0 * k.inv_dx, eta_dy = p.eta0 * k.inv_dy;

  for (int idx = tid; idx < kRY * kRX; idx += kThreads) {
    const int r = idx / kRX, c = idx - r * kRX;
    const int ii = i0 - 1 + r, jj = j0 - 1 + c;
    const bool in = ii >= 0 && ii < nx && jj >= 0 && jj < ny;
    const long g = off + static_cast<long>(ii) * ny + jj;
    const T hr = in ? p.H[g] : T(0);
    const T h = relu(hr);
    t.h[r][c] = h;
    t.s[r][c] = in ? p.B[g] + h : T(0);
    t.dh[r][c] = hr > T(0) ? p.dH[g] : T(0);
  }
  __syncthreads();

  if (tid < kCY * kCX) {
    const int lr = tid / kCX, lc = tid - lr * kCX;
    const int a = i0 - 1 + lr, c = j0 - 1 + lc;
    T D = T(0), dD = T(0);
    if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {
      corner_tangent(t.h[lr][lc], t.h[lr + 1][lc], t.h[lr][lc + 1], t.h[lr + 1][lc + 1],
                     t.s[lr][lc], t.s[lr + 1][lc], t.s[lr][lc + 1], t.s[lr + 1][lc + 1],
                     t.dh[lr][lc], t.dh[lr + 1][lc], t.dh[lr][lc + 1], t.dh[lr + 1][lc + 1], k,
                     dcreep, e, D, dD);
    }
    t.d[lr][lc] = D;
    t.dd[lr][lc] = dD;
  }
  __syncthreads();

  // cell (i, j) = (i0+ty, j0+tx) sits at ring point (ty+1, tx+1); its
  // corners are grid points (ty..ty+1, tx..tx+1)
  if (tid < kTX * kTY) {
    const int ty = tid / kTX, tx = tid - ty * kTX;
    const int i = i0 + ty, j = j0 + tx;
    if (i < nx && j < ny) {
      T v = T(0);
      if (i > 0 && j > 0 && i < nx - 1 && j < ny - 1) {
        const int r = ty + 1, c = tx + 1;
        const T d00 = t.d[ty][tx], d01 = t.d[ty][tx + 1];
        const T d10 = t.d[ty + 1][tx], d11 = t.d[ty + 1][tx + 1];
        const T e00 = t.dd[ty][tx], e01 = t.dd[ty][tx + 1];
        const T e10 = t.dd[ty + 1][tx], e11 = t.dd[ty + 1][tx + 1];
        T sx_e, tx_e, sx_w, tx_w, sy_n, ty_n, sy_s, ty_s;
        edge_tangent(t.s[r + 1][c], t.s[r][c], t.h[r + 1][c], t.h[r][c], t.dh[r + 1][c],
                     t.dh[r][c], k.inv_dx, eta_dx, sx_e, tx_e);
        edge_tangent(t.s[r][c], t.s[r - 1][c], t.h[r][c], t.h[r - 1][c], t.dh[r][c],
                     t.dh[r - 1][c], k.inv_dx, eta_dx, sx_w, tx_w);
        edge_tangent(t.s[r][c + 1], t.s[r][c], t.h[r][c + 1], t.h[r][c], t.dh[r][c + 1],
                     t.dh[r][c], k.inv_dy, eta_dy, sy_n, ty_n);
        edge_tangent(t.s[r][c], t.s[r][c - 1], t.h[r][c], t.h[r][c - 1], t.dh[r][c],
                     t.dh[r][c - 1], k.inv_dy, eta_dy, sy_s, ty_s);
        const T fx_e = -(T(0.5) * (e10 + e11)) * sx_e - (T(0.5) * (d10 + d11)) * tx_e;
        const T fx_w = -(T(0.5) * (e00 + e01)) * sx_w - (T(0.5) * (d00 + d01)) * tx_w;
        const T fy_n = -(T(0.5) * (e01 + e11)) * sy_n - (T(0.5) * (d01 + d11)) * ty_n;
        const T fy_s = -(T(0.5) * (e00 + e10)) * sy_s - (T(0.5) * (d00 + d10)) * ty_s;
        v = -((fx_e - fx_w) * k.inv_dx + (fy_n - fy_s) * k.inv_dy);
      }
      const long g = off + static_cast<long>(i) * ny + j;
      if (p.f != nullptr) p.f[g] = v;
      if (kStage) {
        p.y[g] = p.a * p.dH0[g] + p.mu * p.dH[g] + p.nu * p.dY2[g] + p.mutdt * v +
                 p.gamdt * p.df0[g];
      }
    }
  }
}

// The glacier's exponent set picks the path; the branch is uniform in a
// block, and both paths share the block's shared memory.
template <typename T, bool kStage>
__global__ void __launch_bounds__(kThreads) sia2d_rhs_jvp_kernel(JvpArgs<T> p) {
  __shared__ Tile<T> tile;
  const T* row = p.table + 8L * blockIdx.z;
  if (row[4] == T(5) && row[5] == T(2) && row[6] == T(4) && row[7] == T(2)) {
    jvp_block<T, GlenExps<T>, kStage>(p, GlenExps<T>{}, tile);
  } else {
    jvp_block<T, RuntimeExps<T>, kStage>(p, RuntimeExps<T>{row[4], row[5], row[6], row[7]},
                                         tile);
  }
}

template <typename T>
int launch(const T* dH, const T* H, const T* B, const T* table, const T* dcreep, const T* dH0,
           const T* dY2, const T* df0, T* f, T* y, int n_g, int nx, int ny, double eta0,
           double a, double mu, double nu, double mutdt, double gamdt, int stage,
           void* stream) {
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
  const dim3 grid((ny + kTX - 1) / kTX, (nx + kTY - 1) / kTY, n_g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage) {
    if (y == nullptr || dH0 == nullptr || dY2 == nullptr || df0 == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    sia2d_rhs_jvp_kernel<T, true><<<grid, kThreads, 0, s>>>(p);
  } else {
    if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    sia2d_rhs_jvp_kernel<T, false><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fdot into `f` (plain mode, `stage` == 0); with `stage` != 0 stage j of the
// RKC2 tangent into `y`, fdot into `f` when it is not null. `dcreep` may be
// null (no creep tangent); the stage pointers are read in the stage mode
// only.
extern "C" int sia2d_rhs_jvp_f32(const float* dH, const float* H, const float* B,
                                 const float* table, const float* dcreep, const float* dH0,
                                 const float* dY2, const float* df0, float* f, float* y,
                                 int n_g, int nx, int ny, double eta0, double a, double mu,
                                 double nu, double mutdt, double gamdt, int stage,
                                 void* stream) {
  return launch<float>(dH, H, B, table, dcreep, dH0, dY2, df0, f, y, n_g, nx, ny, eta0, a, mu,
                       nu, mutdt, gamdt, stage, stream);
}

extern "C" int sia2d_rhs_jvp_f64(const double* dH, const double* H, const double* B,
                                 const double* table, const double* dcreep, const double* dH0,
                                 const double* dY2, const double* df0, double* f, double* y,
                                 int n_g, int nx, int ny, double eta0, double a, double mu,
                                 double nu, double mutdt, double gamdt, int stage,
                                 void* stream) {
  return launch<double>(dH, H, B, table, dcreep, dH0, dY2, df0, f, y, n_g, nx, ny, eta0, a, mu,
                        nu, mutdt, gamdt, stage, stream);
}
