// Fused SIA2D right-hand side dH/dt (A target, per-glacier scalar laws).
//
// Replaces the TPU kernel odinn_tpu/ops/pallas/sia_kernel.py::sia2d_rhs_pallas
// (pallas_call in _forward_impl), which kept one whole glacier plane in VMEM
// per program. Plain PyTorch version: ops/cuda/sia_kernel.py::sia2d_rhs_reference.
//
// What bounds it on the H100: bytes, and before them latency. Per cell it
// reads H and B and writes dH/dt, 12 bytes in float32, against ~90
// operations (a corner diffusivity, its share of the fluxes); at the main
// path's 4 x 128^2 planes the whole call moves 0.79 MB (0.23 us at
// 3.35 TB/s), so a launch is one round of loads, a chain of dependent
// arithmetic and one store: its time is latency.
//
// Design: tiles of 32 x 4 cells, blockIdx.z the glacier. A block loads
// relu(H) and S = B + relu(H) of its tile and a one-cell ring into shared
// memory once, coalesced; then one thread per point of the tile's 33 x 5
// corner grid forms that corner's diffusivity once (corner_D: reciprocal
// spacings, no division); after one __syncthreads() each cell forms its
// eta0-clamped edge slopes, fluxes and negated divergence from its 5-point
// values and its four corners (rhs_cell_recip). Ring cells write 0. The
// block has 192 threads, the 165 corners rounded up to whole warps, so each
// thread forms at most one corner and one cell. The tile is 4 rows so that
// the 4 x 128^2 launch is 512 blocks, about 4 on each of the 132 SMs in one
// wave, every SM with loads in flight from the start. A glacier whose
// exponent set is (5, 2, 4, 2) takes a specialisation with fixed multiplies
// (GlenExps); any other takes its exponents from the table (RuntimeExps).
// The block reads the set from the table, so a batch may mix sets and the
// host reads nothing.
#include "sia_common.cuh"

namespace {

using odinn::GlenExps;
using odinn::Recip;
using odinn::RuntimeExps;
using odinn::relu;

constexpr int kTX = 32;            // cells along y (contiguous)
constexpr int kTY = 4;             // cells along x
constexpr int kRX = kTX + 2;       // the tile with its ring
constexpr int kRY = kTY + 2;
constexpr int kCX = kTX + 1;       // the tile's corner grid
constexpr int kCY = kTY + 1;
constexpr int kThreads = (kCX * kCY + 31) / 32 * 32;

template <typename T>
struct Tile {
  T h[kRY][kRX];   // relu(H)
  T s[kRY][kRX];   // B + relu(H)
  T d[kCY][kCX];   // corner D: grid point (lr, lc) is the corner (i0-1+lr, j0-1+lc)
};

template <typename T, class E>
__device__ __forceinline__ void rhs_block(const T* __restrict__ H, const T* __restrict__ B,
                                          const T* __restrict__ row, T* __restrict__ out,
                                          int nx, int ny, T eta0, const E& e, Tile<T>& t) {
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTY, j0 = blockIdx.x * kTX;
  const long off = static_cast<long>(blockIdx.z) * nx * ny;
  const Recip<T> k = odinn::recip_row(row);
  const T eta_dx = eta0 * k.inv_dx, eta_dy = eta0 * k.inv_dy;

  for (int idx = tid; idx < kRY * kRX; idx += kThreads) {
    const int r = idx / kRX, c = idx - r * kRX;
    const int ii = i0 - 1 + r, jj = j0 - 1 + c;
    const bool in = ii >= 0 && ii < nx && jj >= 0 && jj < ny;
    const long g = off + static_cast<long>(ii) * ny + jj;
    const T h = in ? relu(H[g]) : T(0);
    t.h[r][c] = h;
    t.s[r][c] = in ? B[g] + h : T(0);
  }
  __syncthreads();

  if (tid < kCY * kCX) {
    const int lr = tid / kCX, lc = tid - lr * kCX;
    const int a = i0 - 1 + lr, c = j0 - 1 + lc;
    T D = T(0);
    if (a >= 0 && a <= nx - 2 && c >= 0 && c <= ny - 2) {
      D = odinn::corner_D(t.h[lr][lc], t.h[lr + 1][lc], t.h[lr][lc + 1], t.h[lr + 1][lc + 1],
                          t.s[lr][lc], t.s[lr + 1][lc], t.s[lr][lc + 1], t.s[lr + 1][lc + 1],
                          k, e);
    }
    t.d[lr][lc] = D;
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
        const T d[2][2] = {{t.d[ty][tx], t.d[ty][tx + 1]}, {t.d[ty + 1][tx], t.d[ty + 1][tx + 1]}};
        v = odinn::rhs_cell_recip(t.h[r][c], t.h[r + 1][c], t.h[r - 1][c], t.h[r][c + 1],
                                  t.h[r][c - 1], t.s[r][c], t.s[r + 1][c], t.s[r - 1][c],
                                  t.s[r][c + 1], t.s[r][c - 1], d, k, eta_dx, eta_dy);
      }
      out[off + static_cast<long>(i) * ny + j] = v;
    }
  }
}

// The glacier's exponent set picks the path; the branch is uniform in a
// block, and both paths share the block's shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sia2d_rhs_kernel(const T* __restrict__ H, const T* __restrict__ B,
                 const T* __restrict__ table, T* __restrict__ out, int nx, int ny, T eta0) {
  __shared__ Tile<T> tile;
  const T* row = table + 8L * blockIdx.z;
  if (row[4] == T(5) && row[5] == T(2) && row[6] == T(4) && row[7] == T(2)) {
    rhs_block<T, GlenExps<T>>(H, B, row, out, nx, ny, eta0, GlenExps<T>{}, tile);
  } else {
    rhs_block<T, RuntimeExps<T>>(H, B, row, out, nx, ny, eta0,
                                 RuntimeExps<T>{row[4], row[5], row[6], row[7]}, tile);
  }
}

template <typename T>
int launch(const T* H, const T* B, const T* table, T* out, int n_g, int nx,
           int ny, double eta0, void* stream) {
  const dim3 grid((ny + kTX - 1) / kTX, (nx + kTY - 1) / kTY, n_g);
  sia2d_rhs_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      H, B, table, out, nx, ny, static_cast<T>(eta0));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sia2d_rhs_f32(const float* H, const float* B, const float* table,
                             float* out, int n_g, int nx, int ny, double eta0,
                             void* stream) {
  return launch<float>(H, B, table, out, n_g, nx, ny, eta0, stream);
}

extern "C" int sia2d_rhs_f64(const double* H, const double* B,
                             const double* table, double* out, int n_g, int nx,
                             int ny, double eta0, void* stream) {
  return launch<double>(H, B, table, out, n_g, nx, ny, eta0, stream);
}
