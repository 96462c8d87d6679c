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
// What bounds it on the H100: bytes. Per cell it reads lambda, H, H_D, B
// and x and writes three planes, 32 bytes in float32, against ~160
// operations a cell; at 4 x 128^2 a call moves about 2 MB (8 MB at
// 16 x 128^2), so a launch is latency-bound.
//
// Design (as sia2d_rhs_vjp.cu): 32x8 tiles of cells, 256 threads,
// blockIdx.z the glacier. A block loads relu(H_D), S, u and w of its tile
// and a one-cell ring into shared memory once, coalesced. Phase 1: one
// thread per corner of the tile's 33x9 corner grid forms the corner's D,
// Dbar and the three numbers a cell takes from it, each corner once per
// tile that needs it. Phase 2, after one __syncthreads(): each cell gathers
// its four corners. The exponent set is one per launch, from the host:
// (5, 2, 4, 2) takes fixed multiplies (GlenExps), any other pow_pos at run
// time (RuntimeExps). d(creep) and d(slide) in the same launch: each block
// reduces its own corners in a fixed order (registers, warp shuffles,
// shared memory), stores the two partials and takes a ticket on its
// glacier's counter; the last block sums that glacier's partials in block
// order and resets the counter. No float atomics, so repeated launches are
// bitwise equal.
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
constexpr int kCX = kTX + 1;       // the corner grid of the tile
constexpr int kCY = kTY + 1;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct VjpArgs {
  const T *lam, *H, *HD, *B, *x;
  const T* table;       // (n_g, 4): dx, dy, creep, slide
  T *dH, *dHD, *dB;
  T* partial;           // (n_g, 2, blocks per glacier)
  unsigned* counter;    // (n_g,), zero between launches
  T *dcreep, *dslide;   // (n_g,)
  int nx, ny;
  T dt, theta;
};

// A block's shared memory.
template <typename T>
struct Tile {
  T sh[kRY][kRX];    // relu(H_D)
  T ss[kRY][kRX];    // S = B + relu(H_D)
  T su[kRY][kRX];    // u = B + ring*H + (1-theta)*M*H + theta*M*x
  T sw[kRY][kRX];    // w = dt*M*lambda
  T cD[kCY][kCX];    // corner: D
  T cQ[kCY][kCX];    //   0.25 Dbar dD/dhbar
  T cPX[kCY][kCX];   //   0.5/dx Dbar dD/d|gS| gSx/|gS|
  T cPY[kCY][kCX];   //   0.5/dy Dbar dD/d|gS| gSy/|gS|
  T scratch[2][kWarps];
  bool last;
};

// The block's sums of a and b in a fixed order, valid in thread 0.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T (*scratch)[kWarps], int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((tid & 31) == 0) {
    scratch[0][tid >> 5] = a;
    scratch[1][tid >> 5] = b;
  }
  __syncthreads();
  if (tid == 0) {
    a = b = T(0);
    for (int w = 0; w < kWarps; ++w) {
      a += scratch[0][w];
      b += scratch[1][w];
    }
  }
}

template <typename T, class E>
__global__ void __launch_bounds__(kThreads) si_step_vjp_kernel(VjpArgs<T> p, E e) {
  __shared__ Tile<T> t;
  const int nx = p.nx, ny = p.ny;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;
  const int g = blockIdx.z;
  const long off = static_cast<long>(g) * nx * ny;
  const Recip<T> k = odinn::recip_row(p.table + 4L * g);
  const T one_minus_theta = T(1) - p.theta;

  for (int idx = tid; idx < kRY * kRX; idx += kThreads) {
    const int r = idx / kRX, c = idx - r * kRX;
    const int ii = i0 - 1 + r, jj = j0 - 1 + c;
    const bool in = ii >= 0 && ii < nx && jj >= 0 && jj < ny;
    const bool interior = ii >= 1 && ii < nx - 1 && jj >= 1 && jj < ny - 1;
    const long gi = off + static_cast<long>(ii) * ny + jj;
    const T h = in ? relu(p.HD[gi]) : T(0);
    t.sh[r][c] = h;
    t.ss[r][c] = in ? p.B[gi] + h : T(0);
    T u = T(0);
    if (interior) {
      u = p.B[gi] + one_minus_theta * p.H[gi] + p.theta * p.x[gi];
    } else if (in) {
      u = p.B[gi] + p.H[gi];
    }
    t.su[r][c] = u;
    t.sw[r][c] = interior ? p.dt * p.lam[gi] : T(0);
  }
  __syncthreads();

  // phase 1: grid point (lr, lc) is the corner (i0-1+lr, j0-1+lc), formed
  // from ring cells (lr..lr+1, lc..lc+1)
  T creep_part = T(0), slide_part = T(0);
  for (int idx = tid; idx < kCY * kCX; idx += kThreads) {
    const int lr = idx / kCX, lc = idx - lr * kCX;
    const int a = i0 - 1 + lr, c = j0 - 1 + lc;
    T D = T(0), Q = T(0), PX = T(0), PY = T(0);
    if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {
      const T h00 = t.sh[lr][lc], h10 = t.sh[lr + 1][lc];
      const T h01 = t.sh[lr][lc + 1], h11 = t.sh[lr + 1][lc + 1];
      const T s00 = t.ss[lr][lc], s10 = t.ss[lr + 1][lc];
      const T s01 = t.ss[lr][lc + 1], s11 = t.ss[lr + 1][lc + 1];
      const T gsx = T(0.5) * ((s10 - s00) * k.inv_dx + (s11 - s01) * k.inv_dx);
      const T gsy = T(0.5) * ((s01 - s00) * k.inv_dy + (s11 - s10) * k.inv_dy);
      const T sq = gsx * gsx + gsy * gsy;
      const T gn = sq > T(0) ? sqrt(sq) : T(0);
      const T hb = T(0.25) * (h00 + h10 + h01 + h11);
      const T ph_s = e.hs(hb), pg_s = e.ss(gn);
      const T ph_c = e.hc(hb), pg_c = e.sc(gn);
      D = k.slide * ph_s * pg_s + k.creep * ph_c * pg_c;
      // the two x-faces (columns c, c+1) and the two y-faces (rows a, a+1)
      // that average this corner
      auto G = [&](int r0, int c0, int r1, int c1, T inv) {
        return ((t.su[r1][c1] - t.su[r0][c0]) * inv) * ((t.sw[r1][c1] - t.sw[r0][c0]) * inv);
      };
      const T gx = G(lr, lc, lr + 1, lc, k.inv_dx) + G(lr, lc + 1, lr + 1, lc + 1, k.inv_dx);
      const T gy = G(lr, lc, lr, lc + 1, k.inv_dy) + G(lr + 1, lc, lr + 1, lc + 1, k.inv_dy);
      const T Db = T(-0.5) * gx - T(0.5) * gy;
      if (lr >= 1 && lc >= 1) {   // the tile's own corners
        creep_part += Db * (ph_c * pg_c);
        slide_part += Db * (ph_s * pg_s);
      }
      const T dD_dhb = k.slide * e.d_hs(hb) * pg_s + k.creep * e.d_hc(hb) * pg_c;
      const T dD_dgn = k.slide * ph_s * e.d_ss(gn) + k.creep * ph_c * e.d_sc(gn);
      Q = T(0.25) * (Db * dD_dhb);
      if (gn > T(0)) {
        const T gg = Db * dD_dgn / gn;
        PX = T(0.5) * (gg * gsx) * k.inv_dx;
        PY = T(0.5) * (gg * gsy) * k.inv_dy;
      }
    }
    t.cD[lr][lc] = D;
    t.cQ[lr][lc] = Q;
    t.cPX[lr][lc] = PX;
    t.cPY[lr][lc] = PY;
  }
  __syncthreads();

  // phase 2: cell (i, j) = (i0+ty, j0+tx); its corners are grid points
  // (ty+ca, tx+cc), and the cell sits at the + end of a corner's slopes
  // when ca = 0 (x) or cc = 0 (y)
  const int i = i0 + ty, j = j0 + tx;
  if (i < nx && j < ny) {
    T q = T(0), sbar = T(0);
#pragma unroll
    for (int ca = 0; ca < 2; ++ca) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        q += t.cQ[ty + ca][tx + cc];
        const T px = t.cPX[ty + ca][tx + cc], py = t.cPY[ty + ca][tx + cc];
        sbar += (ca == 0 ? px : -px) + (cc == 0 ? py : -py);
      }
    }
    const T d00 = t.cD[ty][tx], d01 = t.cD[ty][tx + 1];
    const T d10 = t.cD[ty + 1][tx], d11 = t.cD[ty + 1][tx + 1];
    const T xe = T(0.5) * (d10 + d11), xw = T(0.5) * (d00 + d01);
    const T yn = T(0.5) * (d01 + d11), ys = T(0.5) * (d00 + d10);
    const T wc = t.sw[ty + 1][tx + 1];
    const T fxp = xe * ((t.sw[ty + 2][tx + 1] - wc) * k.inv_dx);
    const T fxm = xw * ((wc - t.sw[ty][tx + 1]) * k.inv_dx);
    const T fyp = yn * ((t.sw[ty + 1][tx + 2] - wc) * k.inv_dy);
    const T fym = ys * ((wc - t.sw[ty + 1][tx]) * k.inv_dy);
    const T ubar = (fxp - fxm) * k.inv_dx + (fyp - fym) * k.inv_dy;
    const bool ring = i == 0 || j == 0 || i == nx - 1 || j == ny - 1;
    const long gi = off + static_cast<long>(i) * ny + j;
    p.dH[gi] = p.lam[gi] + ubar * (ring ? T(1) : one_minus_theta);
    p.dB[gi] = ubar + sbar;
    p.dHD[gi] = t.sh[ty + 1][tx + 1] > T(0) ? q + sbar : T(0);
  }

  // d(creep), d(slide): the block's partials, then the glacier's last block
  // sums the partials in block order
  block_sum2(creep_part, slide_part, t.scratch, tid);
  const unsigned nblk = gridDim.x * gridDim.y;
  T* partial = p.partial + 2L * g * nblk;
  if (tid == 0) {
    const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
    partial[b] = creep_part;
    partial[nblk + b] = slide_part;
    __threadfence();
    t.last = atomicAdd(p.counter + g, 1u) == nblk - 1;
  }
  __syncthreads();
  if (!t.last) return;
  __threadfence();
  T vc = T(0), vs = T(0);
  for (unsigned b = tid; b < nblk; b += kThreads) {
    vc += __ldcg(partial + b);
    vs += __ldcg(partial + nblk + b);
  }
  block_sum2(vc, vs, t.scratch, tid);
  if (tid == 0) {
    p.dcreep[g] = vc;
    p.dslide[g] = vs;
    p.counter[g] = 0u;
  }
}

template <typename T>
int pullback(const VjpArgs<T>& a, int n_g, int glen, double e_hc, double e_sc, double e_hs,
             double e_ss, void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((a.ny + kTX - 1) / kTX, (a.nx + kTY - 1) / kTY, n_g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (glen) {
    si_step_vjp_kernel<T, GlenExps<T>><<<grid, block, 0, s>>>(a, GlenExps<T>{});
  } else {
    si_step_vjp_kernel<T, RuntimeExps<T>><<<grid, block, 0, s>>>(
        a, RuntimeExps<T>{static_cast<T>(e_hc), static_cast<T>(e_sc), static_cast<T>(e_hs),
                          static_cast<T>(e_ss)});
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const T* lam, const T* H, const T* HD, const T* B, const T* x, const T* table, T* dH,
        T* dHD, T* dB, T* partial, unsigned* counter, T* dcreep, T* dslide, int n_g, int nx,
        int ny, double dt, double theta, int glen, double e_hc, double e_sc, double e_hs,
        double e_ss, void* stream) {
  const VjpArgs<T> a{lam, H, HD, B, x, table, dH, dHD, dB, partial, counter, dcreep, dslide,
                     nx, ny, static_cast<T>(dt), static_cast<T>(theta)};
  return pullback(a, n_g, glen, e_hc, e_sc, e_hs, e_ss, stream);
}

}  // namespace

// The wrapper allocates `partial` with 2 * si_step_vjp_partials(nx, ny)
// values per glacier and keeps `counter` (n_g unsigned ints) zeroed once;
// each launch leaves it zero.
extern "C" int si_step_vjp_partials(int nx, int ny) {
  return ((ny + kTX - 1) / kTX) * ((nx + kTY - 1) / kTY);
}

// `table` is the (n_g, 4) table (dx, dy, creep, slide); `glen` != 0 takes
// the (5, 2, 4, 2) specialisation and ignores e_*.
extern "C" int si_step_vjp_f32(const float* lam, const float* H, const float* HD,
                               const float* B, const float* x, const float* table, float* dH,
                               float* dHD, float* dB, float* partial, unsigned* counter,
                               float* dcreep, float* dslide, int n_g, int nx, int ny, double dt,
                               double theta, int glen, double e_hc, double e_sc, double e_hs,
                               double e_ss, void* stream) {
  return run<float>(lam, H, HD, B, x, table, dH, dHD, dB, partial, counter, dcreep, dslide, n_g,
                    nx, ny, dt, theta, glen, e_hc, e_sc, e_hs, e_ss, stream);
}

extern "C" int si_step_vjp_f64(const double* lam, const double* H, const double* HD,
                               const double* B, const double* x, const double* table,
                               double* dH, double* dHD, double* dB, double* partial,
                               unsigned* counter, double* dcreep, double* dslide, int n_g,
                               int nx, int ny, double dt, double theta, int glen, double e_hc,
                               double e_sc, double e_hs, double e_ss, void* stream) {
  return run<double>(lam, H, HD, B, x, table, dH, dHD, dB, partial, counter, dcreep, dslide,
                     n_g, nx, ny, dt, theta, glen, e_hc, e_sc, e_hs, e_ss, stream);
}
