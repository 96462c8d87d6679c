// The arithmetic of the SI step's pullback, shared by its two kernels: the
// cluster kernel si_step_vjp.cu (one cluster a glacier) and the large-plane
// kernel si_plane_vjp.cu (tiles over the whole batch). The math is set out
// in si_step_vjp.cu's header: per corner D, Dbar and the three numbers a
// cell takes from it; per cell ubar = L_D(w) and Sbar from its four corners.
#pragma once

#include <type_traits>

#include "sia_common.cuh"

namespace odinn {

// A corner's D and the three numbers a cell takes from it: Q = Dbar
// dD/dhbar / 4, PX = Dbar dD/d|gS| gSx/|gS| / (2 dx), PY likewise.
template <typename T>
struct alignas(16) Corner {
  T D, Q, PX, PY;
};

// Whether |grad S| enters D only squared (n - 1 = p - 1 = 2, the Glen
// specialisation): D then takes |grad S|^2 = gSx^2 + gSy^2 itself, and
// dD/d|grad S| / |grad S| is 2 (slide hbar^e_hs + creep hbar^e_hc), with no
// square root or division.
template <class E>
struct SquaredSlope : std::false_type {};
template <typename T>
struct SquaredSlope<GlenExps<T>> : std::true_type {};

// The glacier's (dx, dy, creep, slide) from a table read in place (row g at
// table + g * stride, in float64 when `f64`, else in T), cast to T, with the
// spacings as reciprocals.
template <typename T>
__device__ __forceinline__ Recip<T> vjp_table_row(const void* table, long stride, int f64,
                                                  int g) {
  if (f64) {
    const double* row = static_cast<const double*>(table) + stride * g;
    return Recip<T>{T(1) / static_cast<T>(row[0]), T(1) / static_cast<T>(row[1]),
                    static_cast<T>(row[2]), static_cast<T>(row[3])};
  }
  return recip_row(static_cast<const T*>(table) + stride * g);
}

// The corner formed from the four cells 00 = (a, c), 10 = (a+1, c), 01 =
// (a, c+1), 11 = (a+1, c+1) with relu(H_D) h, S s, u and w: its D, Q, PX
// and PY, and its terms of d(creep) and d(slide).
template <typename T>
struct CornerTerms {
  Corner<T> v;
  T creep, slide;
};
template <typename T, class E>
__device__ __forceinline__ CornerTerms<T> form_corner(T h00, T h10, T h01, T h11, T s00, T s10,
                                                      T s01, T s11, T u00, T u10, T u01, T u11,
                                                      T w00, T w10, T w01, T w11,
                                                      const Recip<T>& k, const E& e) {
  const T gsx = T(0.5) * ((s10 - s00) * k.inv_dx + (s11 - s01) * k.inv_dx);
  const T gsy = T(0.5) * ((s01 - s00) * k.inv_dy + (s11 - s10) * k.inv_dy);
  const T sq = gsx * gsx + gsy * gsy;
  const T hb = T(0.25) * (h00 + h10 + h01 + h11);
  const T ph_s = e.hs(hb), ph_c = e.hc(hb);
  // the two x-faces (columns c, c+1) and the two y-faces (rows a, a+1)
  // that average this corner
  auto G = [](T u0, T u1, T w0, T w1, T inv) { return ((u1 - u0) * inv) * ((w1 - w0) * inv); };
  const T gx = G(u00, u10, w00, w10, k.inv_dx) + G(u01, u11, w01, w11, k.inv_dx);
  const T gy = G(u00, u01, w00, w01, k.inv_dy) + G(u10, u11, w10, w11, k.inv_dy);
  const T Db = T(-0.5) * gx - T(0.5) * gy;
  // |grad S|'s powers, and gg = Dbar dD/d|grad S| / |grad S|
  T pg_s, pg_c, gg;
  if (SquaredSlope<E>::value) {
    pg_s = pg_c = sq;
    gg = Db * (T(2) * (k.slide * ph_s + k.creep * ph_c));
  } else {
    const T gn = sq > T(0) ? sqrt(sq) : T(0);
    pg_s = e.ss(gn);
    pg_c = e.sc(gn);
    const T dD_dgn = k.slide * ph_s * e.d_ss(gn) + k.creep * ph_c * e.d_sc(gn);
    gg = gn > T(0) ? Db * dD_dgn / gn : T(0);
  }
  const T dD_dhb = k.slide * e.d_hs(hb) * pg_s + k.creep * e.d_hc(hb) * pg_c;
  CornerTerms<T> t;
  t.v.D = k.slide * ph_s * pg_s + k.creep * ph_c * pg_c;
  t.v.Q = T(0.25) * (Db * dD_dhb);
  t.v.PX = T(0.5) * (gg * gsx) * k.inv_dx;
  t.v.PY = T(0.5) * (gg * gsy) * k.inv_dy;
  t.creep = Db * (ph_c * pg_c);
  t.slide = Db * (ph_s * pg_s);
  return t;
}

// A cell's ubar = L_D(w) and Sbar from its four corners (00 = upper left
// ... 11 = lower right), w at the cell (c) and its four neighbours.
template <typename T>
struct CellTerms {
  T ubar, sbar, q;
};
template <typename T>
__device__ __forceinline__ CellTerms<T> gather_cell(const Corner<T>& k00, const Corner<T>& k01,
                                                    const Corner<T>& k10, const Corner<T>& k11,
                                                    T wc, T wxp, T wxm, T wyp, T wym,
                                                    const Recip<T>& k) {
  CellTerms<T> t;
  t.q = ((k00.Q + k01.Q) + k10.Q) + k11.Q;
  t.sbar = (((k00.PX + k00.PY) + (k01.PX - k01.PY)) + (-k10.PX + k10.PY)) + (-k11.PX - k11.PY);
  const T xe = T(0.5) * (k10.D + k11.D), xw = T(0.5) * (k00.D + k01.D);
  const T yn = T(0.5) * (k01.D + k11.D), ys = T(0.5) * (k00.D + k10.D);
  const T fxp = xe * ((wxp - wc) * k.inv_dx);
  const T fxm = xw * ((wc - wxm) * k.inv_dx);
  const T fyp = yn * ((wyp - wc) * k.inv_dy);
  const T fym = ys * ((wc - wym) * k.inv_dy);
  t.ubar = (fxp - fxm) * k.inv_dx + (fyp - fym) * k.inv_dy;
  return t;
}

}  // namespace odinn
