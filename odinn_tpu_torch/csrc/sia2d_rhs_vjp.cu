// Pullback of the fused SIA2D right-hand side (A target, per-glacier scalar
// laws): given the cotangent lam of dH/dt, the cotangents of H and of the
// creep prefactor of each glacier.
//
// Replaces the backward of the TPU kernel
// odinn_tpu/ops/pallas/sia_kernel.py::sia2d_rhs_pallas (_bwd, a jnp vjp of
// _rhs_math), and serves the per-stage pullback of the backward of
// odinn_tpu/ops/pallas/rkc_kernel.py::rkc_interval_pallas. Plain PyTorch
// version: ops/cuda/sia_kernel.py::sia2d_rhs_vjp_reference (autograd through
// the forward's plain version). B and the other scalars get no cotangent.
//
// The chain is the discrete adjoint of odinn_tpu/inverse/vjps.py
// (_flux_adjoint_chain, _vjp_dH_discrete) written out per cell, with the
// forward's conventions: relu with a zero subgradient at H = 0, |grad S| with
// a zero gradient at the origin, the eta0 clamp passing the cotangent to the
// slope inside [lo, up] and to the bounding thickness outside it, integer
// exponents as products (0^e := 0 otherwise).
//
// What bounds it on the H100: bytes. Per cell it reads lam, H and B and
// writes dH, 16 bytes in float32, against ~4x70 flops; at 4 x 128^2 the call
// moves about 1 MB, so a launch is latency-bound.
//
// Design: gather form, one thread per cell on 32x8 tiles (blockIdx.z is the
// glacier). A cell's H and B reach dH/dt through the four corner
// diffusivities around it and the four edge slopes it bounds; each of those
// depends only on the 2x2 block of cells that forms it, so the thread reads
// lam, H and B in its 3x3 neighbourhood (zero outside the plane, lam zero on
// the ring, whose dH/dt is a constant 0), forms the cotangent of each corner
// diffusivity itself and sums the contributions to its own cell. No cell
// writes another's output, so there are no atomics. d(creep) is the sum over
// corners of cot(D)·H̄^(n+2)·|grad S|^(n-1): the thread owning corner (i, j)
// adds it, each block reduces in a fixed order (registers, warp shuffles,
// shared memory) to one partial, and a second launch reduces each glacier's
// partials in a fixed order. The result does not depend on scheduling.
#include "sia_common.cuh"

namespace {

using odinn::Scalars;

constexpr int kTileX = 32;   // threads along y (contiguous)
constexpr int kTileY = 8;    // threads along x
constexpr int kThreads = kTileX * kTileY;
constexpr int kReduceThreads = 256;

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = (blockDim.x * blockDim.y + 31) >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = T(0);
  if (tid == 0) {
    for (int w = 0; w < nwarps; ++w) total += scratch[w];
  }
  return total;   // valid in thread 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sia2d_rhs_vjp_kernel(const T* __restrict__ lam, const T* __restrict__ H,
                     const T* __restrict__ B, const T* __restrict__ table,
                     T* __restrict__ dH, T* __restrict__ partial, int nx,
                     int ny, T eta0) {
  __shared__ T scratch[kThreads / 32];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int g = blockIdx.z;
  const long plane = static_cast<long>(nx) * ny;
  const long off = static_cast<long>(g) * plane;
  const T* row = table + 8L * g;
  const Scalars<T> k{row[0], row[1], row[2], row[3],
                     row[4], row[5], row[6], row[7]};
  const T dx = k.dx, dy = k.dy;
  T creep_part = T(0);

  if (i < nx && j < ny) {
    // 3x3 neighbourhood: relu'd thickness h, surface s, cotangent L
    T h[3][3], s[3][3], L[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int ii = i - 1 + a, jj = j - 1 + c;
        const bool in = ii >= 0 && ii < nx && jj >= 0 && jj < ny;
        const bool interior = ii >= 1 && ii < nx - 1 && jj >= 1 && jj < ny - 1;
        const long idx = off + static_cast<long>(ii) * ny + jj;
        h[a][c] = in ? odinn::relu(H[idx]) : T(0);
        s[a][c] = in ? B[idx] + h[a][c] : T(0);
        L[a][c] = interior ? lam[idx] : T(0);
      }
    }
    // x-edges (between patch rows r and r+1, at patch column c) and
    // y-edges (at patch row r, between patch columns c and c+1): the raw
    // slope, its clamp bounds, the clamped slope and the flux cotangent.
    T xraw[2][3], xup[2][3], xlo[2][3], xds[2][3], xgF[2][3];
    T yraw[3][2], yup[3][2], ylo[3][2], yds[3][2], ygF[3][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xraw[r][c] = (s[r + 1][c] - s[r][c]) / dx;
        xup[r][c] = eta0 * h[r + 1][c] / dx;
        xlo[r][c] = -eta0 * h[r][c] / dx;
        xds[r][c] = odinn::clamp_edge(xraw[r][c], xup[r][c], xlo[r][c]);
        xgF[r][c] = (L[r + 1][c] - L[r][c]) / dx;
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        yraw[r][c] = (s[r][c + 1] - s[r][c]) / dy;
        yup[r][c] = eta0 * h[r][c + 1] / dy;
        ylo[r][c] = -eta0 * h[r][c] / dy;
        yds[r][c] = odinn::clamp_edge(yraw[r][c], yup[r][c], ylo[r][c]);
        ygF[r][c] = (L[r][c + 1] - L[r][c]) / dy;
      }
    }

    T gH = T(0);   // cotangent of relu(H) at the centre, through every route
    T D[2][2];
#pragma unroll
    for (int ca = 0; ca < 2; ++ca) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        // corner (i-1+ca, j-1+cc): its 2x2 block is patch rows ca..ca+1,
        // columns cc..cc+1
        const T h00 = h[ca][cc], h10 = h[ca + 1][cc];
        const T h01 = h[ca][cc + 1], h11 = h[ca + 1][cc + 1];
        const T s00 = s[ca][cc], s10 = s[ca + 1][cc];
        const T s01 = s[ca][cc + 1], s11 = s[ca + 1][cc + 1];
        const T gsx = T(0.5) * ((s10 - s00) / dx + (s11 - s01) / dx);
        const T gsy = T(0.5) * ((s01 - s00) / dy + (s11 - s10) / dy);
        const T sq = gsx * gsx + gsy * gsy;
        const T gn = sq > T(0) ? sqrt(sq) : T(0);
        const T hb = T(0.25) * (h00 + h10 + h01 + h11);
        const T ph_s = odinn::pow_pos(hb, k.e_hs), pg_s = odinn::pow_pos(gn, k.e_ss);
        const T ph_c = odinn::pow_pos(hb, k.e_hc), pg_c = odinn::pow_pos(gn, k.e_sc);
        D[ca][cc] = k.slide * ph_s * pg_s + k.creep * ph_c * pg_c;
        // cotangent of D: the x-edges at columns cc, cc+1 of its rows and
        // the y-edges at rows ca, ca+1 of its columns average it
        const T gD = T(0.5) * (-xgF[ca][cc + 1] * xds[ca][cc + 1]
                               - xgF[ca][cc] * xds[ca][cc])
                   + T(0.5) * (-ygF[ca + 1][cc] * yds[ca + 1][cc]
                               - ygF[ca][cc] * yds[ca][cc]);
        if (ca == 1 && cc == 1 && i < nx - 1 && j < ny - 1) {
          creep_part = gD * (ph_c * pg_c);
        }
        const T dD_dhb = k.slide * odinn::dpow_pos(hb, k.e_hs) * pg_s
                       + k.creep * odinn::dpow_pos(hb, k.e_hc) * pg_c;
        const T dD_dgn = k.slide * ph_s * odinn::dpow_pos(gn, k.e_ss)
                       + k.creep * ph_c * odinn::dpow_pos(gn, k.e_sc);
        gH += T(0.25) * (gD * dD_dhb);
        const T gg = gD * dD_dgn;
        const T ggsx = gn > T(0) ? gg * gsx / gn : T(0);
        const T ggsy = gn > T(0) ? gg * gsy / gn : T(0);
        // the centre is row 1-ca, column 1-cc of the corner's block
        const T sx = ca == 0 ? T(1) : T(-1);
        const T sy = cc == 0 ? T(1) : T(-1);
        gH += sx * (T(0.5) * ggsx / dx) + sy * (T(0.5) * ggsy / dy);
      }
    }
    // the edge slopes the centre bounds: x-edges above (r = 0, the centre
    // is the upper cell) and below (r = 1, the lower cell); y-edges left
    // (c = 0, the centre is the right cell) and right (c = 1, the left cell)
    {
      const T gds = -xgF[0][1] * (T(0.5) * (D[0][0] + D[0][1]));
      const bool in = xraw[0][1] <= xup[0][1] && xraw[0][1] >= xlo[0][1];
      gH += (in ? gds : T(0)) / dx;
      if (xraw[0][1] > xup[0][1]) gH += gds * eta0 / dx;
    }
    {
      const T gds = -xgF[1][1] * (T(0.5) * (D[1][0] + D[1][1]));
      const bool in = xraw[1][1] <= xup[1][1] && xraw[1][1] >= xlo[1][1];
      gH -= (in ? gds : T(0)) / dx;
      if (!(xraw[1][1] > xup[1][1]) && xraw[1][1] < xlo[1][1]) gH -= gds * eta0 / dx;
    }
    {
      const T gds = -ygF[1][0] * (T(0.5) * (D[0][0] + D[1][0]));
      const bool in = yraw[1][0] <= yup[1][0] && yraw[1][0] >= ylo[1][0];
      gH += (in ? gds : T(0)) / dy;
      if (yraw[1][0] > yup[1][0]) gH += gds * eta0 / dy;
    }
    {
      const T gds = -ygF[1][1] * (T(0.5) * (D[0][1] + D[1][1]));
      const bool in = yraw[1][1] <= yup[1][1] && yraw[1][1] >= ylo[1][1];
      gH -= (in ? gds : T(0)) / dy;
      if (!(yraw[1][1] > yup[1][1]) && yraw[1][1] < ylo[1][1]) gH -= gds * eta0 / dy;
    }
    const long idx = off + static_cast<long>(i) * ny + j;
    dH[idx] = H[idx] > T(0) ? gH : T(0);
  }

  const T total = block_sum(creep_part, scratch);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const long nblk = static_cast<long>(gridDim.x) * gridDim.y;
    partial[g * nblk + static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x] = total;
  }
}

// One block per glacier: its nblk partials in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const T* __restrict__ partial, T* __restrict__ out,
                       int nblk) {
  __shared__ T scratch[kReduceThreads / 32];
  const T* p = partial + static_cast<long>(blockIdx.x) * nblk;
  T v = T(0);
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) v += p[b];
  const T total = block_sum(v, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

template <typename T>
int launch(const T* lam, const T* H, const T* B, const T* table, T* dH,
           T* partial, T* dcreep, int n_g, int nx, int ny, double eta0,
           void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((ny + kTileX - 1) / kTileX, (nx + kTileY - 1) / kTileY, n_g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sia2d_rhs_vjp_kernel<T><<<grid, block, 0, st>>>(
      lam, H, B, table, dH, partial, nx, ny, static_cast<T>(eta0));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<T><<<n_g, kReduceThreads, 0, st>>>(
      partial, dcreep, static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper allocates `partial` with sia2d_rhs_vjp_partials(nx, ny) values
// per glacier.
extern "C" int sia2d_rhs_vjp_partials(int nx, int ny) {
  return ((ny + kTileX - 1) / kTileX) * ((nx + kTileY - 1) / kTileY);
}

extern "C" int sia2d_rhs_vjp_f32(const float* lam, const float* H,
                                 const float* B, const float* table, float* dH,
                                 float* partial, float* dcreep, int n_g, int nx,
                                 int ny, double eta0, void* stream) {
  return launch<float>(lam, H, B, table, dH, partial, dcreep, n_g, nx, ny,
                       eta0, stream);
}

extern "C" int sia2d_rhs_vjp_f64(const double* lam, const double* H,
                                 const double* B, const double* table,
                                 double* dH, double* partial, double* dcreep,
                                 int n_g, int nx, int ny, double eta0,
                                 void* stream) {
  return launch<double>(lam, H, B, table, dH, partial, dcreep, n_g, nx, ny,
                        eta0, stream);
}
