// Device helpers shared by the SIA2D kernels (sia2d_rhs.cu, si_step.cu,
// si_plane.cu, si_plane_vjp.cu, rkc_interval.cu, sia2d_rhs_vjp.cu).
//
// Planes are (n_g, nx, ny) row-major with y contiguous. The staggered
// diffusivity D[a][c] lives on the (nx-1, ny-1) grid of cell corners: it is
// formed from the 2x2 block of cells (a..a+1, c..c+1). The arithmetic, and
// its order, follows the plain PyTorch versions in ops/cuda/*.py; the
// helpers with reciprocal spacings (Recip) multiply where those divide.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace odinn {

// x^e for x >= 0. An integer-valued e is an integer power by binary
// exponentiation (the multiply sequence of XLA's integer_pow); any other e
// is exp(e*log x) with 0^e := 0.
template <typename T>
__device__ __forceinline__ T pow_pos(T x, T e) {
  const T r = rint(e);
  if (r == e && fabs(e) <= T(64)) {
    int k = static_cast<int>(r);
    const bool recip = k < 0;
    if (recip) k = -k;
    T acc = T(1);
    bool have = false;
    while (k > 0) {
      if (k & 1) {
        acc = have ? acc * x : x;
        have = true;
      }
      k >>= 1;
      if (k > 0) x = x * x;
    }
    return recip ? T(1) / acc : acc;
  }
  return x > T(0) ? exp(e * log(x)) : T(0);
}

// d/dx pow_pos(x, e), with the conventions autograd gives the plain
// version: e*x^(e-1) for an integer e (0 for e = 0), e*x^e/x for x > 0 and
// 0 at x = 0 for any other e.
template <typename T>
__device__ __forceinline__ T dpow_pos(T x, T e) {
  const T r = rint(e);
  if (r == e && fabs(e) <= T(64)) {
    return e == T(0) ? T(0) : e * pow_pos(x, e - T(1));
  }
  return x > T(0) ? e * exp(e * log(x)) / x : T(0);
}

// x^K for a compile-time K >= 1: the multiply sequence of pow_pos, unrolled.
template <int K, typename T>
__device__ __forceinline__ T pow_int(T x) {
  static_assert(K >= 1, "pow_int takes K >= 1");
  T acc = x;
  bool have = false;
#pragma unroll
  for (int k = K; k > 0; k >>= 1) {
    if (k & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    if (k > 1) x = x * x;
  }
  return acc;
}

// The four powers of the diffusivity, H̄^e_hc, |∇S|^e_sc, H̄^e_hs, |∇S|^e_ss,
// and their derivatives, for the exponent set (n+2, n-1, p-q+1, p-1).
// GlenExps is the set (5, 2, 4, 2) (n = 3, p = 3, q = 0) as fixed
// multiplies; RuntimeExps is any set, through pow_pos and dpow_pos.
template <typename T>
struct GlenExps {
  __device__ __forceinline__ T hc(T x) const { return pow_int<5>(x); }
  __device__ __forceinline__ T sc(T x) const { return pow_int<2>(x); }
  __device__ __forceinline__ T hs(T x) const { return pow_int<4>(x); }
  __device__ __forceinline__ T ss(T x) const { return pow_int<2>(x); }
  __device__ __forceinline__ T d_hc(T x) const { return T(5) * pow_int<4>(x); }
  __device__ __forceinline__ T d_sc(T x) const { return T(2) * x; }
  __device__ __forceinline__ T d_hs(T x) const { return T(4) * pow_int<3>(x); }
  __device__ __forceinline__ T d_ss(T x) const { return T(2) * x; }
};

template <typename T>
struct RuntimeExps {
  T e_hc, e_sc, e_hs, e_ss;
  __device__ __forceinline__ T hc(T x) const { return pow_pos(x, e_hc); }
  __device__ __forceinline__ T sc(T x) const { return pow_pos(x, e_sc); }
  __device__ __forceinline__ T hs(T x) const { return pow_pos(x, e_hs); }
  __device__ __forceinline__ T ss(T x) const { return pow_pos(x, e_ss); }
  __device__ __forceinline__ T d_hc(T x) const { return dpow_pos(x, e_hc); }
  __device__ __forceinline__ T d_sc(T x) const { return dpow_pos(x, e_sc); }
  __device__ __forceinline__ T d_hs(T x) const { return dpow_pos(x, e_hs); }
  __device__ __forceinline__ T d_ss(T x) const { return dpow_pos(x, e_ss); }
};

// The row's (dx, dy, creep, slide) with the spacings as reciprocals, formed
// once per glacier so that no stencil divides.
template <typename T>
struct Recip {
  T inv_dx, inv_dy, creep, slide;
};

template <typename T>
__device__ __forceinline__ Recip<T> recip_row(const T* row) {
  return Recip<T>{T(1) / row[0], T(1) / row[1], row[2], row[3]};
}

// D at the corner whose 2x2 block of relu'd thickness h and surface s is
// given as h00 = (a, c), h10 = (a+1, c), h01 = (a, c+1), h11 = (a+1, c+1):
//   D = slide*h̄^e_hs*|∇S|^e_ss + creep*h̄^e_hc*|∇S|^e_sc,
// with reciprocal spacings and the exponent set E.
template <typename T, class E>
__device__ __forceinline__ T corner_D(T h00, T h10, T h01, T h11, T s00, T s10,
                                      T s01, T s11, const Recip<T>& k,
                                      const E& e) {
  const T gsx = T(0.5) * ((s10 - s00) * k.inv_dx + (s11 - s01) * k.inv_dx);
  const T gsy = T(0.5) * ((s01 - s00) * k.inv_dy + (s11 - s10) * k.inv_dy);
  const T sq = gsx * gsx + gsy * gsy;
  const T grad_s = sq > T(0) ? sqrt(sq) : T(0);
  const T hbar = T(0.25) * (h00 + h10 + h01 + h11);
  return k.slide * e.hs(hbar) * e.ss(grad_s) + k.creep * e.hc(hbar) * e.sc(grad_s);
}

__device__ __forceinline__ float relu(float h) { return h > 0.0f ? h : 0.0f; }
__device__ __forceinline__ double relu(double h) { return h > 0.0 ? h : 0.0; }

template <typename T>
__device__ __forceinline__ T clamp_edge(T ds, T upper, T lower) {
  return ds > upper ? upper : (ds < lower ? lower : ds);
}

// dH/dt at an interior cell (i, j) with reciprocal spacings: the
// eta0-clamped edge gradients, the fluxes and the negated divergence, from
// the cell's 5-point neighbourhood: h, s at the centre c, at rows i+1 (xp)
// and i-1 (xm), at columns j+1 (yp) and j-1 (ym); d the four corner
// diffusivities around the cell, d[0][0] = D(i-1, j-1), d[1][0] =
// D(i, j-1), d[0][1] = D(i-1, j), d[1][1] = D(i, j); eta_dx = eta0/dx,
// eta_dy = eta0/dy.
template <typename T>
__device__ __forceinline__ T rhs_cell_recip(T h_c, T h_xp, T h_xm, T h_yp,
                                            T h_ym, T s_c, T s_xp, T s_xm,
                                            T s_yp, T s_ym, const T (&d)[2][2],
                                            const Recip<T>& k, T eta_dx,
                                            T eta_dy) {
  const T dsx_e = clamp_edge((s_xp - s_c) * k.inv_dx, h_xp * eta_dx, -h_c * eta_dx);
  const T dsx_w = clamp_edge((s_c - s_xm) * k.inv_dx, h_c * eta_dx, -h_xm * eta_dx);
  const T dsy_n = clamp_edge((s_yp - s_c) * k.inv_dy, h_yp * eta_dy, -h_c * eta_dy);
  const T dsy_s = clamp_edge((s_c - s_ym) * k.inv_dy, h_c * eta_dy, -h_ym * eta_dy);
  const T fx_e = -(T(0.5) * (d[1][0] + d[1][1])) * dsx_e;
  const T fx_w = -(T(0.5) * (d[0][0] + d[0][1])) * dsx_w;
  const T fy_n = -(T(0.5) * (d[0][1] + d[1][1])) * dsy_n;
  const T fy_s = -(T(0.5) * (d[0][0] + d[1][0])) * dsy_s;
  return -((fx_e - fx_w) * k.inv_dx + (fy_n - fy_s) * k.inv_dy);
}

// Loads and stores of W values along y: one 16-byte vector (float4, double2)
// where W fills it, else one value.
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

// through the read-only path: planes the launch does not write
template <typename T, int W>
__device__ __forceinline__ void ldg_wide(T (&v)[W], const T* src) {
  using V = typename Wide<T, W>::type;
  const V w = __ldg(reinterpret_cast<const V*>(src));
  memcpy(v, &w, sizeof(w));
}

// plain loads: planes other blocks of the launch write
template <typename T, int W>
__device__ __forceinline__ void ld_wide(T (&v)[W], const T* src) {
  using V = typename Wide<T, W>::type;
  const V w = *reinterpret_cast<const V*>(src);
  memcpy(v, &w, sizeof(w));
}

template <typename T, int W>
__device__ __forceinline__ void st_wide(T* dst, const T (&v)[W]) {
  using V = typename Wide<T, W>::type;
  V w;
  memcpy(&w, v, sizeof(w));
  *reinterpret_cast<V*>(dst) = w;
}

}  // namespace odinn
