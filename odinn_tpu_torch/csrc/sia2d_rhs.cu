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
__device__ __forceinline__ T clamp_edge(T ds, T upper, T lower) {
  return ds > upper ? upper : (ds < lower ? lower : ds);
}

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

  const T dx = k.dx, dy = k.dy;
  // x-faces: east between rows i and i+1, west between i-1 and i (column j)
  const T dsx_e = clamp_edge((p.s[2][1] - p.s[1][1]) / dx,
                             eta0 * p.h[2][1] / dx, -eta0 * p.h[1][1] / dx);
  const T dsx_w = clamp_edge((p.s[1][1] - p.s[0][1]) / dx,
                             eta0 * p.h[1][1] / dx, -eta0 * p.h[0][1] / dx);
  // y-faces: north between columns j and j+1, south between j-1 and j (row i)
  const T dsy_n = clamp_edge((p.s[1][2] - p.s[1][1]) / dy,
                             eta0 * p.h[1][2] / dy, -eta0 * p.h[1][1] / dy);
  const T dsy_s = clamp_edge((p.s[1][1] - p.s[1][0]) / dy,
                             eta0 * p.h[1][1] / dy, -eta0 * p.h[1][0] / dy);
  const T fx_e = -(T(0.5) * (p.d[1][0] + p.d[1][1])) * dsx_e;
  const T fx_w = -(T(0.5) * (p.d[0][0] + p.d[0][1])) * dsx_w;
  const T fy_n = -(T(0.5) * (p.d[0][1] + p.d[1][1])) * dsy_n;
  const T fy_s = -(T(0.5) * (p.d[0][0] + p.d[1][0])) * dsy_s;
  const T div = (fx_e - fx_w) / dx + (fy_n - fy_s) / dy;
  o[static_cast<long>(i) * ny + j] = -div;
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
