// Fused SIA2D right-hand side dH/dt (A target, per-glacier scalar laws).
//
// Replaces the TPU kernel odinn_tpu/ops/pallas/sia_kernel.py::sia2d_rhs_pallas
// (pallas_call in _forward_impl), which kept one whole glacier plane in VMEM
// per program. Plain PyTorch version: ops/cuda/sia_kernel.py::sia2d_rhs_reference.
//
// What bounds it on the H100: bytes. Per cell it reads H and B and writes
// dH/dt, 12 bytes in float32, against ~4x40 flops for the four corner
// diffusivities it forms; at the main path's 4 x 128^2 planes the whole
// call moves under 1 MB, so a launch is latency-bound well before either
// roofline.
//
// Design: a 2-D grid of 32x8 thread tiles per glacier (blockIdx.z is the
// glacier), one thread per cell, so neighbouring threads read neighbouring
// addresses. Each interior thread reads its 3x3 halo through L1, forms the
// four staggered diffusivities around its cell (each corner is formed by
// the four cells that share it: the recompute costs flops, which are free
// here, and saves a pass through device memory), the eta0-clamped edge
// gradients and fluxes, and writes the negated divergence. Ring cells and
// the ragged edge are masked by index. Exponents are read per glacier from
// the derived table: an integer-valued one is a product, any other exp/log.
#include "sia_common.cuh"

namespace {

using odinn::Patch;
using odinn::Scalars;

template <typename T>
__global__ void __launch_bounds__(256)
sia2d_rhs_kernel(const T* __restrict__ H, const T* __restrict__ B,
                 const T* __restrict__ table, T* __restrict__ out, int nx,
                 int ny, T eta0) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const long plane = static_cast<long>(nx) * ny;
  const long off = static_cast<long>(blockIdx.z) * plane;
  T* o = out + off;
  if (i == 0 || j == 0 || i == nx - 1 || j == ny - 1) {
    o[static_cast<long>(i) * ny + j] = T(0);
    return;
  }
  const T* row = table + 8L * blockIdx.z;
  const Scalars<T> k{row[0], row[1], row[2], row[3],
                     row[4], row[5], row[6], row[7]};
  Patch<T> p;
  odinn::load_patch(H + off, B + off, ny, i, j, k, p);
  o[static_cast<long>(i) * ny + j] = odinn::rhs_cell(p, k, eta0);
}

template <typename T>
int launch(const T* H, const T* B, const T* table, T* out, int n_g, int nx,
           int ny, double eta0, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((ny + block.x - 1) / block.x, (nx + block.y - 1) / block.y,
                  n_g);
  sia2d_rhs_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
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
