// The row-sharded semi-implicit step's PCG iteration, split at its two
// reductions.
//
// On a rows mesh (odinn_tpu_torch/parallel/spatial.py) a rank holds its own
// rows [r0, r1) of each glacier's plane inside a slab with up to two ghost
// rows on each side. The step's assembly is csrc/si_step.cu's si_assemble,
// unchanged, on that slab (D's corners, b and the inverse Jacobi diagonal
// into the first planes of a scratch of the Plane layout). The PCG cannot
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
// si_rows_update_reference. One block of 1024 threads a glacier, each
// thread its cells in a fixed order, then warp shuffles and the warps'
// partials: a rerun is bitwise the same, with no atomics. This is the simple
// design: the two host round trips an iteration cost far more than the
// launches (PERF.md).
#include "sia_common.cuh"

namespace {

using odinn::Recip;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Scratch planes, each (n_g, nx, ny): si_step.cu's Plane layout, then z and
// a second p (ops/si_math.py, ROWS_*).
enum Plane { kD = 0, kRhs, kInvDiag, kX, kR, kP, kAp, kZ, kP2, kPlanes };

// Sum over the block in a fixed order: registers, warp shuffles, then the
// warps' partials in shared memory.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;   // the total, in thread 0
}

// A u = u - coef*M*div(D grad(M u)) at cell (i, j) of the slab; M masks the
// slab's ring and D holds the corner diffusivities (D(i, j) at cell (i, j)).
template <typename T>
__device__ __forceinline__ T apply_A(const T* __restrict__ u, const T* __restrict__ D, int nx,
                                     int ny, int i, int j, T coef, const Recip<T>& k) {
  const long c = static_cast<long>(i) * ny + j;
  if (i == 0 || j == 0 || i == nx - 1 || j == ny - 1) return u[c];
  auto m = [&](int ii, int jj) {
    const bool in = ii > 0 && jj > 0 && ii < nx - 1 && jj < ny - 1;
    return in ? u[static_cast<long>(ii) * ny + jj] : T(0);
  };
  const long r0 = static_cast<long>(i - 1) * ny, r1 = static_cast<long>(i) * ny;
  const T d00 = D[r0 + j - 1], d01 = D[r0 + j], d10 = D[r1 + j - 1], d11 = D[r1 + j];
  const T xe = T(0.5) * (d10 + d11), xw = T(0.5) * (d00 + d01);
  const T yn = T(0.5) * (d01 + d11), ys = T(0.5) * (d00 + d10);
  const T uc = u[c];
  const T fxp = xe * ((m(i + 1, j) - uc) * k.inv_dx);
  const T fxm = xw * ((uc - m(i - 1, j)) * k.inv_dx);
  const T fyp = yn * ((m(i, j + 1) - uc) * k.inv_dy);
  const T fym = ys * ((uc - m(i, j - 1)) * k.inv_dy);
  return uc - coef * ((fxp - fxm) * k.inv_dx + (fyp - fym) * k.inv_dy);
}

// kInit: x = x0, r = b - A x0, z = M^-1 r, partial r.z. Else p[dst] = z +
// beta*p[src] on the whole slab, Ap = A p[dst] on the own rows, partial
// p.Ap. kJ: Jacobi; without it z is r.
template <typename T, bool kJ, bool kInit>
__global__ void __launch_bounds__(kThreads)
si_rows_apply(T* __restrict__ work, const T* __restrict__ x0, const T* __restrict__ table,
              const T* __restrict__ beta, int src, int dst, int n_g, int nx, int ny, int r0,
              int r1, T coef, T* __restrict__ partial) {
  __shared__ T sh[kWarps];
  const long plane = static_cast<long>(nx) * ny;
  const long batch = plane * n_g;
  const long off = static_cast<long>(blockIdx.x) * plane;
  const Recip<T> k = odinn::recip_row(table + 4L * blockIdx.x);
  const T* D = work + kD * batch + off;
  T* Z = work + kZ * batch + off;
  const long c0 = static_cast<long>(r0) * ny, c1 = static_cast<long>(r1) * ny;
  T acc = T(0);
  if (kInit) {
    const T* u = x0 + off;
    const T* rhs = work + kRhs * batch + off;
    const T* inv = work + kInvDiag * batch + off;
    T* X = work + kX * batch + off;
    T* R = work + kR * batch + off;
    for (long c = c0 + threadIdx.x; c < c1; c += kThreads) {
      const int i = static_cast<int>(c / ny), j = static_cast<int>(c % ny);
      const T rc = rhs[c] - apply_A(u, D, nx, ny, i, j, coef, k);
      const T zc = kJ ? rc * inv[c] : rc;
      X[c] = u[c];
      R[c] = rc;
      Z[c] = zc;
      acc += rc * zc;
    }
  } else {
    const T b = beta[blockIdx.x];
    const T* Ps = work + static_cast<long>(src) * batch + off;
    T* Pd = work + static_cast<long>(dst) * batch + off;
    T* Ap = work + kAp * batch + off;
    for (long c = threadIdx.x; c < plane; c += kThreads) Pd[c] = Z[c] + b * Ps[c];
    __syncthreads();
    for (long c = c0 + threadIdx.x; c < c1; c += kThreads) {
      const int i = static_cast<int>(c / ny), j = static_cast<int>(c % ny);
      const T a = apply_A(Pd, D, nx, ny, i, j, coef, k);
      Ap[c] = a;
      acc += Pd[c] * a;
    }
  }
  const T total = block_sum(acc, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// x += alpha*p, r -= alpha*Ap, z = M^-1 r on the own rows, partial r.z.
template <typename T, bool kJ>
__global__ void __launch_bounds__(kThreads)
si_rows_update(T* __restrict__ work, const T* __restrict__ alpha, int p_plane, int n_g, int nx,
               int ny, int r0, int r1, T* __restrict__ partial) {
  __shared__ T sh[kWarps];
  const long plane = static_cast<long>(nx) * ny;
  const long batch = plane * n_g;
  const long off = static_cast<long>(blockIdx.x) * plane;
  const T a = alpha[blockIdx.x];
  const T* P = work + static_cast<long>(p_plane) * batch + off;
  const T* Ap = work + kAp * batch + off;
  const T* inv = work + kInvDiag * batch + off;
  T* X = work + kX * batch + off;
  T* R = work + kR * batch + off;
  T* Z = work + kZ * batch + off;
  T acc = T(0);
  const long c1 = static_cast<long>(r1) * ny;
  for (long c = static_cast<long>(r0) * ny + threadIdx.x; c < c1; c += kThreads) {
    X[c] = X[c] + a * P[c];
    const T rc = R[c] - a * Ap[c];
    const T zc = kJ ? rc * inv[c] : rc;
    R[c] = rc;
    Z[c] = zc;
    acc += rc * zc;
  }
  const T total = block_sum(acc, sh);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

bool valid(int src, int dst, int n_g, int nx, int ny, int r0, int r1) {
  const bool planes = (src == kP || src == kP2) && (dst == kP || dst == kP2) && src != dst;
  return planes && n_g > 0 && nx >= 3 && ny >= 3 && r0 >= 0 && r0 < r1 && r1 <= nx;
}

template <typename T>
int apply(T* work, const T* x0, const T* table, const T* beta, int src, int dst, int n_g, int nx,
          int ny, int r0, int r1, double coef, int init, int precondition, T* partial,
          void* stream) {
  if (!valid(init ? kP2 : src, init ? kP : dst, n_g, nx, ny, r0, r1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T c = static_cast<T>(coef);
  if (init) {
    if (precondition) {
      si_rows_apply<T, true, true><<<n_g, kThreads, 0, s>>>(work, x0, table, beta, src, dst,
                                                            n_g, nx, ny, r0, r1, c, partial);
    } else {
      si_rows_apply<T, false, true><<<n_g, kThreads, 0, s>>>(work, x0, table, beta, src, dst,
                                                             n_g, nx, ny, r0, r1, c, partial);
    }
  } else {
    // the Jacobi flag only shapes the start mode's z
    si_rows_apply<T, true, false><<<n_g, kThreads, 0, s>>>(work, x0, table, beta, src, dst, n_g,
                                                           nx, ny, r0, r1, c, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update(T* work, const T* alpha, int p_plane, int n_g, int nx, int ny, int r0, int r1,
           int precondition, T* partial, void* stream) {
  if (!valid(p_plane, p_plane == kP ? kP2 : kP, n_g, nx, ny, r0, r1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (precondition) {
    si_rows_update<T, true><<<n_g, kThreads, 0, s>>>(work, alpha, p_plane, n_g, nx, ny, r0, r1,
                                                     partial);
  } else {
    si_rows_update<T, false><<<n_g, kThreads, 0, s>>>(work, alpha, p_plane, n_g, nx, ny, r0, r1,
                                                      partial);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `work`: the scratch of kPlanes planes of (n_g, nx, ny); `table`: (n_g, 4)
// rows (dx, dy, ...); `beta`, `alpha`, `partial`: (n_g,) on the device;
// [r0, r1): the own rows; `coef`: theta*dt. `init` != 0 runs the start mode
// (x0 read, beta, src and dst unread); `precondition` == 0 runs plain CG.
extern "C" int si_rows_apply_f32(float* work, const float* x0, const float* table,
                                 const float* beta, int src, int dst, int n_g, int nx, int ny,
                                 int r0, int r1, double coef, int init, int precondition,
                                 float* partial, void* stream) {
  return apply<float>(work, x0, table, beta, src, dst, n_g, nx, ny, r0, r1, coef, init,
                      precondition, partial, stream);
}

extern "C" int si_rows_apply_f64(double* work, const double* x0, const double* table,
                                 const double* beta, int src, int dst, int n_g, int nx, int ny,
                                 int r0, int r1, double coef, int init, int precondition,
                                 double* partial, void* stream) {
  return apply<double>(work, x0, table, beta, src, dst, n_g, nx, ny, r0, r1, coef, init,
                       precondition, partial, stream);
}

extern "C" int si_rows_update_f32(float* work, const float* alpha, int p_plane, int n_g, int nx,
                                  int ny, int r0, int r1, int precondition, float* partial,
                                  void* stream) {
  return update<float>(work, alpha, p_plane, n_g, nx, ny, r0, r1, precondition, partial,
                       stream);
}

extern "C" int si_rows_update_f64(double* work, const double* alpha, int p_plane, int n_g,
                                  int nx, int ny, int r0, int r1, int precondition,
                                  double* partial, void* stream) {
  return update<double>(work, alpha, p_plane, n_g, nx, ny, r0, r1, precondition, partial,
                        stream);
}
