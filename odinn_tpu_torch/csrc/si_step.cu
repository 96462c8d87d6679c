// Fused semi-implicit theta-step: frozen diffusivity, right-hand side,
// Jacobi preconditioner and a fixed number of PCG iterations, then relu.
//
// Replaces the TPU kernel odinn_tpu/ops/pallas/si_kernel.py::si_step_pallas
// (pallas_call in _forward), which ran the whole step for one glacier in one
// program with ~9 live planes in VMEM. At 128^2 float32 those planes take
// ~590 KB, more than the 227 KB of shared memory a Hopper block may use, so
// the step is split in two. Plain PyTorch version:
// ops/cuda/si_kernel.py::si_step_reference.
//
// What bounds it on the H100: neither bytes nor flops but latency. Each of
// the cg_iters iterations needs two whole-plane dot products before the
// next can start, so every iteration is a chain of block-wide barriers, and
// at 4 glaciers only 4 of the 132 SMs work on the solve.
//
// Design:
//  1. si_assemble: one thread per cell over all glaciers (2-D tiles, the
//     glacier on blockIdx.z). It forms the staggered D at H_D, writes the
//     cell's own corner of D, and from the four corners around the cell the
//     right-hand side b and the inverse Jacobi diagonal.
//  2. si_pcg: one block of 32x32 threads per glacier runs the whole PCG
//     recursion. x, r, p and Ap live in a global scratch buffer (at 4 x 128^2
//     float32 all planes together are ~1.8 MB, resident in the 50 MB L2);
//     each thread owns a fixed 32-strided set of cells, so an update reads and
//     writes only its own cells and a barrier is needed only before the
//     5-point matvec reads its neighbours' p. The dot products are reduced
//     in registers, then by warp shuffles, then across warps in shared
//     memory: a fixed order, deterministic, no atomics.
// The solve stage is its own kernel so that a transpose solve can reuse it.
#include "sia_common.cuh"

namespace {

using odinn::Patch;
using odinn::Scalars;

// 32 x 32 threads: thread (ty, tx) owns the cells (ty + 32a, tx + 32b).
constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;

// Scratch planes, each (n_g, nx, ny).
enum Plane { kD = 0, kRhs, kInvDiag, kX, kR, kP, kAp, kPlanes };

template <typename T>
struct Faces {
  T xe, xw, yn, ys;   // face diffusivities: x east/west, y north/south
};

// Face diffusivities of interior cell (i, j) from the corner D plane.
template <typename T>
__device__ __forceinline__ Faces<T> faces(const T* __restrict__ D, int ny,
                                          int i, int j) {
  const long r0 = static_cast<long>(i - 1) * ny, r1 = static_cast<long>(i) * ny;
  const T d00 = D[r0 + j - 1], d01 = D[r0 + j];   // D(i-1, j-1), D(i-1, j)
  const T d10 = D[r1 + j - 1], d11 = D[r1 + j];   // D(i, j-1),   D(i, j)
  return {T(0.5) * (d10 + d11), T(0.5) * (d00 + d01), T(0.5) * (d01 + d11),
          T(0.5) * (d00 + d10)};
}

// div(D grad u) at interior cell (i, j) from the 5-point values of u.
template <typename T>
__device__ __forceinline__ T div_flux(const Faces<T>& f, T uc, T un_x, T us_x,
                                      T un_y, T us_y, T dx, T dy) {
  const T fxp = f.xe * ((un_x - uc) / dx);
  const T fxm = f.xw * ((uc - us_x) / dx);
  const T fyp = f.yn * ((un_y - uc) / dy);
  const T fym = f.ys * ((uc - us_y) / dy);
  return (fxp - fxm) / dx + (fyp - fym) / dy;
}

template <typename T>
__global__ void __launch_bounds__(256)
si_assemble(const T* __restrict__ H, const T* __restrict__ HD,
            const T* __restrict__ B, const T* __restrict__ table,
            T* __restrict__ work, int n_g, int nx, int ny, T dt, T dt_eff,
            T one_minus_theta, T e_hc, T e_sc, T e_hs, T e_ss) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const long plane = static_cast<long>(nx) * ny;
  const long batch = plane * n_g;
  const long off = static_cast<long>(blockIdx.z) * plane;
  const long c = static_cast<long>(i) * ny + j;
  const T* row = table + 4L * blockIdx.z;
  const Scalars<T> k{row[0], row[1], row[2], row[3], e_hc, e_sc, e_hs, e_ss};
  const T* h = H + off;
  const T* b = B + off;
  T* D = work + kD * batch + off;
  T* rhs = work + kRhs * batch + off;
  T* inv_diag = work + kInvDiag * batch + off;

  const bool interior = i > 0 && j > 0 && i < nx - 1 && j < ny - 1;
  if (!interior) {
    // the cell's own corner, for the ring cells that own one
    if (i < nx - 1 && j < ny - 1) {
      const T* hd = HD + off;
      const long c10 = c + ny;
      const T h00 = odinn::relu(hd[c]), h10 = odinn::relu(hd[c10]);
      const T h01 = odinn::relu(hd[c + 1]), h11 = odinn::relu(hd[c10 + 1]);
      D[c] = odinn::stag_D(h00, h10, h01, h11, b[c] + h00, b[c10] + h10,
                           b[c + 1] + h01, b[c10 + 1] + h11, k);
    }
    rhs[c] = h[c];
    inv_diag[c] = T(1);
    return;
  }
  Patch<T> p;
  odinn::load_patch(HD + off, b, ny, i, j, k, p);
  D[c] = p.d[1][1];
  const Faces<T> f{T(0.5) * (p.d[1][0] + p.d[1][1]),
                   T(0.5) * (p.d[0][0] + p.d[0][1]),
                   T(0.5) * (p.d[0][1] + p.d[1][1]),
                   T(0.5) * (p.d[0][0] + p.d[1][0])};
  // u = B + ring*H + (1-theta)*interior*H on the 5 points
  auto u = [&](int di, int dj) {
    const int ii = i + di, jj = j + dj;
    const long cc = static_cast<long>(ii) * ny + jj;
    const bool in = ii > 0 && jj > 0 && ii < nx - 1 && jj < ny - 1;
    return in ? b[cc] + one_minus_theta * h[cc] : b[cc] + h[cc];
  };
  const T div = div_flux(f, u(0, 0), u(1, 0), u(-1, 0), u(0, 1), u(0, -1),
                         k.dx, k.dy);
  rhs[c] = h[c] + dt * div;
  const T sx = (f.xw + f.xe) / (k.dx * k.dx);
  const T sy = (f.ys + f.yn) / (k.dy * k.dy);
  inv_diag[c] = T(1) / (T(1) + dt_eff * (sx + sy));
}

// Sum over the block in a fixed order: registers, warp shuffles, then the
// per-warp partials in shared memory. Every thread gets the total.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[kWarps] = v;
  }
  __syncthreads();
  const T total = sh[kWarps];
  __syncthreads();
  return total;
}

// A u = u - theta*dt*M*div(D grad(M u)) at cell (i, j); M masks the ring.
template <typename T>
__device__ __forceinline__ T matvec(const T* __restrict__ u,
                                    const T* __restrict__ D, int nx, int ny,
                                    int i, int j, T coef, T dx, T dy) {
  const long c = static_cast<long>(i) * ny + j;
  if (i == 0 || j == 0 || i == nx - 1 || j == ny - 1) return u[c];
  auto m = [&](int ii, int jj) {
    const bool in = ii > 0 && jj > 0 && ii < nx - 1 && jj < ny - 1;
    return in ? u[static_cast<long>(ii) * ny + jj] : T(0);
  };
  const T div = div_flux(faces(D, ny, i, j), u[c], m(i + 1, j), m(i - 1, j),
                         m(i, j + 1), m(i, j - 1), dx, dy);
  return u[c] - coef * div;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
si_pcg(const T* __restrict__ x0, const T* __restrict__ table, T* work,
       T* __restrict__ out, int n_g, int nx, int ny, T coef, int cg_iters) {
  __shared__ T sh[kThreads / 32 + 1];
  const long plane = static_cast<long>(nx) * ny;
  const long batch = plane * n_g;
  const long off = static_cast<long>(blockIdx.x) * plane;
  const T dx = table[4L * blockIdx.x], dy = table[4L * blockIdx.x + 1];
  const T* D = work + kD * batch + off;
  const T* rhs = work + kRhs * batch + off;
  const T* inv = work + kInvDiag * batch + off;
  T* x = work + kX * batch + off;
  T* r = work + kR * batch + off;
  T* p = work + kP * batch + off;
  T* Ap = work + kAp * batch + off;
  const T* xs = x0 + off;
  const T tiny = static_cast<T>(1e-300);   // 0 in float32, as in the reference

  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
// every cell (i, j) this thread owns, row by row; the inner loop is
// unrolled so that its loads are in flight together
#define FOR_OWN_CELLS(...)                                    \
  for (int i = ty; i < nx; i += kTile) {                      \
    _Pragma("unroll 4")                                       \
    for (int j = tx; j < ny; j += kTile) {                    \
      const long c = static_cast<long>(i) * ny + j;           \
      __VA_ARGS__                                             \
    }                                                         \
  }

  // r0 = b - A x0, z0 = r0/diag, p0 = z0
  T acc = T(0);
  FOR_OWN_CELLS({
    const T rc = rhs[c] - matvec(xs, D, nx, ny, i, j, coef, dx, dy);
    const T zc = rc * inv[c];
    x[c] = xs[c];
    r[c] = rc;
    p[c] = zc;
    acc += rc * zc;
  })
  T rz = block_sum(acc, sh);

  for (int it = 0; it < cg_iters; ++it) {
    acc = T(0);
    FOR_OWN_CELLS({
      const T a = matvec(p, D, nx, ny, i, j, coef, dx, dy);
      Ap[c] = a;
      acc += p[c] * a;
    })
    const T denom = block_sum(acc, sh);
    const T alpha = denom > T(0) ? rz / fmax(denom, tiny) : T(0);
    acc = T(0);
    FOR_OWN_CELLS({
      x[c] = x[c] + alpha * p[c];
      const T rc = r[c] - alpha * Ap[c];
      r[c] = rc;
      acc += rc * (rc * inv[c]);
    })
    const T rz_new = block_sum(acc, sh);
    const T beta = rz > T(0) ? rz_new / fmax(rz, tiny) : T(0);
    FOR_OWN_CELLS({ p[c] = r[c] * inv[c] + beta * p[c]; })
    rz = rz_new;
    __syncthreads();   // the next matvec reads the neighbours' p
  }
  FOR_OWN_CELLS({ out[off + c] = odinn::relu(x[c]); })
#undef FOR_OWN_CELLS
}

template <typename T>
int launch(const T* H, const T* HD, const T* B, const T* x0, const T* table,
           T* work, T* out, int n_g, int nx, int ny, double dt, double theta,
           int cg_iters, double e_hc, double e_sc, double e_hs, double e_ss,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 grid((ny + block.x - 1) / block.x, (nx + block.y - 1) / block.y,
                  n_g);
  si_assemble<T><<<grid, block, 0, s>>>(
      H, HD, B, table, work, n_g, nx, ny, static_cast<T>(dt),
      static_cast<T>(theta * dt), static_cast<T>(1.0 - theta),
      static_cast<T>(e_hc), static_cast<T>(e_sc), static_cast<T>(e_hs),
      static_cast<T>(e_ss));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  si_pcg<T><<<n_g, kThreads, 0, s>>>(x0, table, work, out, n_g, nx, ny,
                                     static_cast<T>(theta * dt), cg_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int si_step_f32(const float* H, const float* HD, const float* B,
                           const float* x0, const float* table, float* work,
                           float* out, int n_g, int nx, int ny, double dt,
                           double theta, int cg_iters, double e_hc, double e_sc,
                           double e_hs, double e_ss, void* stream) {
  return launch<float>(H, HD, B, x0, table, work, out, n_g, nx, ny, dt, theta,
                       cg_iters, e_hc, e_sc, e_hs, e_ss, stream);
}

extern "C" int si_step_f64(const double* H, const double* HD, const double* B,
                           const double* x0, const double* table, double* work,
                           double* out, int n_g, int nx, int ny, double dt,
                           double theta, int cg_iters, double e_hc, double e_sc,
                           double e_hs, double e_ss, void* stream) {
  return launch<double>(H, HD, B, x0, table, work, out, n_g, nx, ny, dt, theta,
                        cg_iters, e_hc, e_sc, e_hs, e_ss, stream);
}
