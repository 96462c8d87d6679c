// Pullback of the fused SIA2D right-hand side (A target, per-glacier scalar
// laws): given the cotangent lam of dH/dt, the cotangents of H and of the
// creep prefactor of each glacier; and, as a second mode of the same
// kernel, one stage of the RKC2 step's backward around that pullback.
//
// Replaces the backward of the TPU kernel
// odinn_tpu/ops/pallas/sia_kernel.py::sia2d_rhs_pallas (_bwd, a jnp vjp of
// _rhs_math), and serves the per-stage pullback of the backward of
// odinn_tpu/ops/pallas/rkc_kernel.py::rkc_interval_pallas. Plain PyTorch
// versions: ops/cuda/sia_kernel.py::sia2d_rhs_vjp_reference (autograd
// through the forward's plain version) and, for the stage,
// ops/cuda/rkc_kernel.py::stage_pullback_reference. B and the other
// scalars get no cotangent.
//
// The chain is the discrete adjoint of odinn_tpu/inverse/vjps.py
// (_flux_adjoint_chain, _vjp_dH_discrete) with the forward's conventions:
// relu with a zero subgradient at H = 0, |grad S| with a zero gradient at
// the origin, the eta0 clamp passing the cotangent to the slope inside
// [lo, up] and to the bounding thickness outside it, integer exponents as
// products (0^e := 0 otherwise).
//
// What bounds it on the H100: bytes. Per cell it reads lam, H and B and
// writes dH, 16 bytes in float32 (the stage mode also reads and writes the
// stage's three cotangent carries: 36 bytes), against ~150 flops a cell; at
// 16 x 128^2 a call moves about 1 MB, so a launch is latency-bound.
//
// Design: 32x8 tiles of cells, 256 threads, blockIdx.z the glacier. A block
// loads lam, H and B of its tile and a one-cell ring into shared memory
// once, coalesced (relu'd h, s = B + h, lam zeroed off the interior, whose
// dH/dt is a constant 0). Phase 1: one thread per corner of the tile's
// 33x9 corner grid forms the corner's D, its cotangent gD (from the four
// edges around it), the three numbers a cell takes from it
// (0.25 gD dD/dH̄ and the two grad-S components of gD dD/d|grad S| / |grad S|,
// already scaled by 0.5/dx and 0.5/dy) and its creep factor; the same
// thread forms the clamped slope and flux cotangent of the x- and y-edge at
// its grid point, as two weights, one for each cell of the edge. Phase 2,
// after one __syncthreads(): each cell gathers its four corners and four
// edges. Each corner and edge is formed once (corners of the tile's ring
// once per tile that needs them). A glacier whose exponent set is
// (5, 2, 4, 2) takes a specialisation with fixed multiplies (GlenExps);
// any other takes its exponents from the table (RuntimeExps). The block
// reads the set from the table, so a batch may mix sets and the host reads
// nothing. 1/dx and 1/dy are formed once per glacier.
//
// d(creep) = sum over corners of gD·H̄^(n+2)·|grad S|^(n-1), in the same
// launch: each block reduces its own corners in a fixed order (registers,
// warp shuffles, shared memory) to one partial, then takes a ticket on its
// glacier's counter; the last block of the glacier sums that glacier's
// partials in fixed block order, writes the result and resets the
// counter. The result does not depend on which block finishes last, so it
// is deterministic. No cell writes another's output.
//
// The stage mode (kStage) is stage j of the RKC2 backward
// (ops/cuda/rkc_kernel.py::_transpose) with the coefficients a_j, mu_j,
// nu_j, mu~_j dt, gamma~_j dt: lam = fl(c * mu~_j dt) on load, and per own
// cell c' = (pend + mu_j c) + g into a second c buffer (neighbours read c),
// pend' = nu_j c, cot_y += a_j c, cot_f0 += gamma~_j dt c (at the first
// stage, j = s, the carries are taken as zero), and the last block of a
// glacier adds its d(creep) to the running sum: stream order is stage order.
//
// Time at 16 x 128^2 float32 on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): 0.0630 ms with the previous design (one thread per
// cell forming its four corners, and a second reduction launch), 0.0107 ms
// with this one; the stage mode 0.0115 ms.
#include "sia_common.cuh"

namespace {

using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::relu;

constexpr int kTX = 32;            // cells along y (contiguous)
constexpr int kTY = 8;             // cells along x
constexpr int kThreads = kTX * kTY;
constexpr int kRX = kTX + 2;       // the tile with its ring
constexpr int kRY = kTY + 2;
constexpr int kCX = kTX + 1;       // the corner and edge grid of the tile
constexpr int kCY = kTY + 1;

template <typename T>
struct VjpArgs {
  const T* lam;         // the cotangent of dH/dt; c in the stage mode
  const T* H;           // the point; y(j-1) in the stage mode
  const T* B;
  const T* table;       // (n_g, 8) derived table
  T* dH;                // the cotangent of H; c' in the stage mode
  T* partial;           // (n_g, blocks per glacier)
  unsigned* counter;    // (n_g,), zero between launches
  T* dcreep;            // (n_g,)
  T* pend;              // stage mode: the three carries, updated in place
  T* cot_y;
  T* cot_f0;
  int nx, ny;
  T eta0;
  T a, mu, nu, mutdt, gamdt;  // stage mode: stage j's coefficients
  int first;                  // stage mode: j = s, the carries are zero
};

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = T(0);
  if (tid == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  }
  return total;   // valid in thread 0
}

// An edge of the tile's grid: its flux cotangent gF, raw slope and clamp
// bounds.
template <typename T>
struct Edge {
  T gF, raw, up, lo;
  __device__ __forceinline__ T ds() const { return odinn::clamp_edge(raw, up, lo); }
  __device__ __forceinline__ bool inside() const { return raw <= up && raw >= lo; }
};

// The x-edge between ring rows r, r+1 at column c, and the y-edge between
// ring columns c, c+1 at row r, from the tile's relu'd thickness h, surface
// s and cotangent L.
template <typename T>
__device__ __forceinline__ Edge<T> x_edge(const T (*h)[kRX], const T (*s)[kRX],
                                          const T (*L)[kRX], int r, int c,
                                          const Recip<T>& k, T eta_dx) {
  return Edge<T>{(L[r + 1][c] - L[r][c]) * k.inv_dx, (s[r + 1][c] - s[r][c]) * k.inv_dx,
                 h[r + 1][c] * eta_dx, -h[r][c] * eta_dx};
}

template <typename T>
__device__ __forceinline__ Edge<T> y_edge(const T (*h)[kRX], const T (*s)[kRX],
                                          const T (*L)[kRX], int r, int c,
                                          const Recip<T>& k, T eta_dy) {
  return Edge<T>{(L[r][c + 1] - L[r][c]) * k.inv_dy, (s[r][c + 1] - s[r][c]) * k.inv_dy,
                 h[r][c + 1] * eta_dy, -h[r][c] * eta_dy};
}

// A block's shared memory.
template <typename T>
struct Tile {
  T sh[kRY][kRX];    // relu(H)
  T ss[kRY][kRX];    // B + relu(H)
  T sL[kRY][kRX];    // lam, zero off the interior
  T cD[kCY][kCX];    // corner: D
  T cQ[kCY][kCX];    //   0.25 gD dD/dH̄
  T cPX[kCY][kCX];   //   0.5/dx gD dD/d|gS| gSx/|gS|
  T cPY[kCY][kCX];   //   0.5/dy gD dD/d|gS| gSy/|gS|
  T eXA[kCY][kCX];   // x-edge weight of its lower cell (row a+1)
  T eXB[kCY][kCX];   //   and of its upper cell (row a)
  T eYA[kCY][kCX];   // y-edge weight of its right cell (column c+1)
  T eYB[kCY][kCX];   //   and of its left cell (column c)
  T scratch[kThreads / 32];
  bool last;
};

template <typename T, class E, bool kStage>
__device__ __forceinline__ void vjp_block(const VjpArgs<T>& p, const E& e, Tile<T>& t) {
  auto& sh = t.sh;
  auto& ss = t.ss;
  auto& sL = t.sL;
  auto& cD = t.cD;
  auto& cQ = t.cQ;
  auto& cPX = t.cPX;
  auto& cPY = t.cPY;
  auto& eXA = t.eXA;
  auto& eXB = t.eXB;
  auto& eYA = t.eYA;
  auto& eYB = t.eYB;
  const int nx = p.nx, ny = p.ny;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;
  const int g = blockIdx.z;
  const long off = static_cast<long>(g) * nx * ny;
  const Recip<T> k = odinn::recip_row(p.table + 8L * g);
  const T eta_dx = p.eta0 * k.inv_dx, eta_dy = p.eta0 * k.inv_dy;

  for (int idx = tid; idx < kRY * kRX; idx += kThreads) {
    const int r = idx / kRX, c = idx - r * kRX;
    const int ii = i0 - 1 + r, jj = j0 - 1 + c;
    const bool in = ii >= 0 && ii < nx && jj >= 0 && jj < ny;
    const bool interior = ii >= 1 && ii < nx - 1 && jj >= 1 && jj < ny - 1;
    const long gi = off + static_cast<long>(ii) * ny + jj;
    const T h = in ? relu(p.H[gi]) : T(0);
    sh[r][c] = h;
    ss[r][c] = in ? p.B[gi] + h : T(0);
    if (kStage) {
      sL[r][c] = interior ? p.lam[gi] * p.mutdt : T(0);
    } else {
      sL[r][c] = interior ? p.lam[gi] : T(0);
    }
  }
  __syncthreads();

  // phase 1: grid point (lr, lc) is the corner (i0-1+lr, j0-1+lc), formed
  // from ring cells (lr..lr+1, lc..lc+1), the x-edge below ring cell
  // (lr, lc) and the y-edge right of it
  T creep_part = T(0);
  for (int idx = tid; idx < kCY * kCX; idx += kThreads) {
    const int lr = idx / kCX, lc = idx - lr * kCX;
    const int a = i0 - 1 + lr, c = j0 - 1 + lc;
    const Edge<T> ex = x_edge<T>(sh, ss, sL, lr, lc, k, eta_dx);
    const Edge<T> ey = y_edge<T>(sh, ss, sL, lr, lc, k, eta_dy);
    // the slope's cotangent is -gF·D̄: to the cell at the slope's + end
    // inside the clamp or above it (through the upper bound), to its - end
    // inside the clamp or below it
    const bool ex_in = ex.inside(), ey_in = ey.inside();
    eXA[lr][lc] = -ex.gF * k.inv_dx * (ex_in ? T(1) : (ex.raw > ex.up ? p.eta0 : T(0)));
    eXB[lr][lc] = -ex.gF * k.inv_dx * (ex_in ? T(1) : (ex.raw < ex.lo ? p.eta0 : T(0)));
    eYA[lr][lc] = -ey.gF * k.inv_dy * (ey_in ? T(1) : (ey.raw > ey.up ? p.eta0 : T(0)));
    eYB[lr][lc] = -ey.gF * k.inv_dy * (ey_in ? T(1) : (ey.raw < ey.lo ? p.eta0 : T(0)));
    T D = T(0), Q = T(0), PX = T(0), PY = T(0);
    if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {
      const T h00 = sh[lr][lc], h10 = sh[lr + 1][lc];
      const T h01 = sh[lr][lc + 1], h11 = sh[lr + 1][lc + 1];
      const T s00 = ss[lr][lc], s10 = ss[lr + 1][lc];
      const T s01 = ss[lr][lc + 1], s11 = ss[lr + 1][lc + 1];
      const T gsx = T(0.5) * ((s10 - s00) * k.inv_dx + (s11 - s01) * k.inv_dx);
      const T gsy = T(0.5) * ((s01 - s00) * k.inv_dy + (s11 - s10) * k.inv_dy);
      const T sq = gsx * gsx + gsy * gsy;
      const T gn = sq > T(0) ? sqrt(sq) : T(0);
      const T hb = T(0.25) * (h00 + h10 + h01 + h11);
      const T ph_s = e.hs(hb), pg_s = e.ss(gn);
      const T ph_c = e.hc(hb), pg_c = e.sc(gn);
      D = k.slide * ph_s * pg_s + k.creep * ph_c * pg_c;
      // the x-edges at columns c, c+1 of its rows and the y-edges at rows
      // a, a+1 of its columns average D
      const Edge<T> ex1 = x_edge<T>(sh, ss, sL, lr, lc + 1, k, eta_dx);
      const Edge<T> ey1 = y_edge<T>(sh, ss, sL, lr + 1, lc, k, eta_dy);
      const T gD = T(0.5) * (-ex1.gF * ex1.ds() - ex.gF * ex.ds())
                 + T(0.5) * (-ey1.gF * ey1.ds() - ey.gF * ey.ds());
      if (lr >= 1 && lc >= 1) creep_part += gD * (ph_c * pg_c);   // the tile's own corners
      const T dD_dhb = k.slide * e.d_hs(hb) * pg_s + k.creep * e.d_hc(hb) * pg_c;
      const T dD_dgn = k.slide * ph_s * e.d_ss(gn) + k.creep * ph_c * e.d_sc(gn);
      Q = T(0.25) * (gD * dD_dhb);
      if (gn > T(0)) {
        const T gg = gD * dD_dgn / gn;
        PX = T(0.5) * (gg * gsx) * k.inv_dx;
        PY = T(0.5) * (gg * gsy) * k.inv_dy;
      }
    }
    cD[lr][lc] = D;
    cQ[lr][lc] = Q;
    cPX[lr][lc] = PX;
    cPY[lr][lc] = PY;
  }
  __syncthreads();

  // phase 2: cell (i, j) = (i0+ty, j0+tx); its corners are grid points
  // (ty+ca, tx+cc), and the cell sits at the + end of a corner's slopes
  // when ca = 0 (x) or cc = 0 (y)
  const int i = i0 + ty, j = j0 + tx;
  if (i < nx && j < ny) {
    T gH = T(0);
#pragma unroll
    for (int ca = 0; ca < 2; ++ca) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        gH += cQ[ty + ca][tx + cc];
        const T px = cPX[ty + ca][tx + cc], py = cPY[ty + ca][tx + cc];
        gH += (ca == 0 ? px : -px) + (cc == 0 ? py : -py);
      }
    }
    const T d00 = cD[ty][tx], d01 = cD[ty][tx + 1];
    const T d10 = cD[ty + 1][tx], d11 = cD[ty + 1][tx + 1];
    gH += eXA[ty][tx + 1] * (T(0.5) * (d00 + d01));        // x-edge above
    gH -= eXB[ty + 1][tx + 1] * (T(0.5) * (d10 + d11));    // x-edge below
    gH += eYA[ty + 1][tx] * (T(0.5) * (d00 + d10));        // y-edge left
    gH -= eYB[ty + 1][tx + 1] * (T(0.5) * (d01 + d11));    // y-edge right
    const T dh = sh[ty + 1][tx + 1] > T(0) ? gH : T(0);
    const long gi = off + static_cast<long>(i) * ny + j;
    if (kStage) {
      const T c = p.lam[gi];
      const T pend = p.first ? T(0) : p.pend[gi];
      p.cot_y[gi] = p.first ? p.a * c : p.cot_y[gi] + p.a * c;
      p.cot_f0[gi] = p.first ? p.gamdt * c : p.cot_f0[gi] + p.gamdt * c;
      p.dH[gi] = (pend + p.mu * c) + dh;
      p.pend[gi] = c * p.nu;
    } else {
      p.dH[gi] = dh;
    }
  }

  // d(creep): the block's partial, then the glacier's last block sums the
  // partials in block order
  const T total = block_sum(creep_part, t.scratch);
  const unsigned nblk = gridDim.x * gridDim.y;
  T* partial = p.partial + static_cast<long>(g) * nblk;
  if (tid == 0) {
    partial[blockIdx.y * gridDim.x + blockIdx.x] = total;
    __threadfence();
    t.last = atomicAdd(p.counter + g, 1u) == nblk - 1;
  }
  __syncthreads();
  if (!t.last) return;
  __threadfence();
  T v = T(0);
  for (unsigned b = tid; b < nblk; b += kThreads) v += __ldcg(partial + b);
  const T sum = block_sum(v, t.scratch);
  if (tid == 0) {
    p.dcreep[g] = (kStage && !p.first) ? p.dcreep[g] + sum : sum;
    p.counter[g] = 0u;
  }
}

// The glacier's exponent set picks the path; the branch is uniform in a
// block, and both paths share the block's shared memory.
template <typename T, bool kStage>
__global__ void __launch_bounds__(kThreads)
sia2d_rhs_vjp_kernel(VjpArgs<T> p) {
  __shared__ Tile<T> tile;
  const T* row = p.table + 8L * blockIdx.z;
  if (row[4] == T(5) && row[5] == T(2) && row[6] == T(4) && row[7] == T(2)) {
    vjp_block<T, GlenExps<T>, kStage>(p, GlenExps<T>{}, tile);
  } else {
    vjp_block<T, RuntimeExps<T>, kStage>(p, RuntimeExps<T>{row[4], row[5], row[6], row[7]},
                                         tile);
  }
}

template <typename T, bool kStage>
int launch(const VjpArgs<T>& args, int n_g, void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((args.ny + kTX - 1) / kTX, (args.nx + kTY - 1) / kTY, n_g);
  sia2d_rhs_vjp_kernel<T, kStage><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
VjpArgs<T> make_args(const T* lam, const T* H, const T* B, const T* table, T* dH,
                     T* partial, unsigned* counter, T* dcreep, int nx, int ny,
                     double eta0) {
  VjpArgs<T> a = {};
  a.lam = lam;
  a.H = H;
  a.B = B;
  a.table = table;
  a.dH = dH;
  a.partial = partial;
  a.counter = counter;
  a.dcreep = dcreep;
  a.nx = nx;
  a.ny = ny;
  a.eta0 = static_cast<T>(eta0);
  return a;
}

template <typename T>
int pullback(const T* lam, const T* H, const T* B, const T* table, T* dH, T* partial,
             unsigned* counter, T* dcreep, int n_g, int nx, int ny, double eta0,
             void* stream) {
  const VjpArgs<T> a = make_args(lam, H, B, table, dH, partial, counter, dcreep, nx, ny, eta0);
  return launch<T, false>(a, n_g, stream);
}

template <typename T>
int stage(const T* c, const T* Y, const T* B, const T* table, T* c_out, T* pend, T* cot_y,
          T* cot_f0, T* partial, unsigned* counter, T* dcreep, int n_g, int nx, int ny,
          double eta0, double w_a, double mu, double nu, double mutdt, double gamdt,
          int first, void* stream) {
  VjpArgs<T> a = make_args(c, Y, B, table, c_out, partial, counter, dcreep, nx, ny, eta0);
  a.pend = pend;
  a.cot_y = cot_y;
  a.cot_f0 = cot_f0;
  a.a = static_cast<T>(w_a);
  a.mu = static_cast<T>(mu);
  a.nu = static_cast<T>(nu);
  a.mutdt = static_cast<T>(mutdt);
  a.gamdt = static_cast<T>(gamdt);
  a.first = first;
  return launch<T, true>(a, n_g, stream);
}

}  // namespace

// The wrapper allocates `partial` with sia2d_rhs_vjp_partials(nx, ny) values
// per glacier and keeps `counter` (n_g unsigned ints) zeroed once; each
// launch leaves it zero.
extern "C" int sia2d_rhs_vjp_partials(int nx, int ny) {
  return ((ny + kTX - 1) / kTX) * ((nx + kTY - 1) / kTY);
}

extern "C" int sia2d_rhs_vjp_f32(const float* lam, const float* H, const float* B,
                                 const float* table, float* dH, float* partial,
                                 unsigned* counter, float* dcreep, int n_g, int nx, int ny,
                                 double eta0, void* stream) {
  return pullback<float>(lam, H, B, table, dH, partial, counter, dcreep, n_g, nx, ny, eta0,
                         stream);
}

extern "C" int sia2d_rhs_vjp_f64(const double* lam, const double* H, const double* B,
                                 const double* table, double* dH, double* partial,
                                 unsigned* counter, double* dcreep, int n_g, int nx, int ny,
                                 double eta0, void* stream) {
  return pullback<double>(lam, H, B, table, dH, partial, counter, dcreep, n_g, nx, ny, eta0,
                          stream);
}

// Stage j of the RKC2 backward (the stage mode above): c -> c_out, the
// carries pend, cot_y, cot_f0 and the running d(creep) updated in place.
extern "C" int sia2d_rhs_vjp_stage_f32(const float* c, const float* Y, const float* B,
                                       const float* table, float* c_out, float* pend,
                                       float* cot_y, float* cot_f0, float* partial,
                                       unsigned* counter, float* dcreep, int n_g, int nx,
                                       int ny, double eta0, double a, double mu,
                                       double nu, double mutdt, double gamdt, int first,
                                       void* stream) {
  return stage<float>(c, Y, B, table, c_out, pend, cot_y, cot_f0, partial, counter, dcreep,
                      n_g, nx, ny, eta0, a, mu, nu, mutdt, gamdt, first, stream);
}

extern "C" int sia2d_rhs_vjp_stage_f64(const double* c, const double* Y, const double* B,
                                       const double* table, double* c_out, double* pend,
                                       double* cot_y, double* cot_f0, double* partial,
                                       unsigned* counter, double* dcreep, int n_g, int nx,
                                       int ny, double eta0, double a, double mu,
                                       double nu, double mutdt, double gamdt, int first,
                                       void* stream) {
  return stage<double>(c, Y, B, table, c_out, pend, cot_y, cot_f0, partial, counter, dcreep,
                       n_g, nx, ny, eta0, a, mu, nu, mutdt, gamdt, first, stream);
}
