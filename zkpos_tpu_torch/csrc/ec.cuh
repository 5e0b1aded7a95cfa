// Complete projective point addition on BN254 G1 and G2 (Renes, Costello
// and Batina 2015, a = 0), shared by the add kernels, the Horner kernels
// and the segmented scan.  The formula has no exceptional cases: the
// identity (0 : 1 : 0), P + P and P + (-P) all take the same path, which
// is what lets the MSM's Horner step double through the add.
//
//   t0 = X1X2  t1 = Y1Y2  t2 = Z1Z2   txy / tyz / txz = cross sums
//   u = t1 - 3b t2   v = t1 + 3b t2   w = 3b txz
//   X3 = txy u - tyz w   Y3 = u v + 3 t0 w   Z3 = tyz v + 3 t0 txy
//
// On fp_ec.cuh's lazy core: the operands are fully reduced (below p), every
// value inside stays below 2p, and each output coordinate is reduced once,
// so the stored point is the one a fully reduced computation gives, bit for
// bit.  The order keeps few values live (a G2 value is 16 registers): the
// operands are read where they are used (from memory, when the caller
// passes references into it) and are all read before the first output is
// written, so an output may overwrite an operand; then the last six
// products run around the cycle txy u, u v, v tyz, tyz w, w 3t0, 3t0 txy,
// each value dying at its second product and each output written as soon
// as it is complete (X3, Y3, Z3 in that order), at most seven values live.
#pragma once

#include "fp_ec.cuh"

namespace ff {

template <class E>
struct Point { E x, y, z; };

// out.x(X3), out.y(Y3), out.z(Z3) receive the sum p + q, in that order,
// after every read of p and q.
template <class E, class Out>
FF_HD void padd_emit(const Point<E>& p, const Point<E>& q, Out& out) {
  const E t0 = lmul(p.x, q.x);
  const E t1 = lmul(p.y, q.y);
  const E txy = lsub(lmul(lsum(p.x, p.y), lsum(q.x, q.y)), ladd(t0, t1));
  const E t2 = lmul(p.z, q.z);
  const E tyz = lsub(lmul(lsum(p.y, p.z), lsum(q.y, q.z)), ladd(t1, t2));
  const E w = mul_b3(lsub(lmul(lsum(p.x, p.z), lsum(q.x, q.z)),
                          ladd(t0, t2)));
  const E t0p = ladd(ladd(t0, t0), t0);
  const E bt2 = mul_b3(t2);
  const E u = lsub(t1, bt2);
  const E v = ladd(t1, bt2);
  const E x3 = lmul(txy, u);
  const E y3 = lmul(u, v);
  const E z3 = lmul(v, tyz);
  out.x(reduce(lsub(x3, lmul(tyz, w))));
  out.y(reduce(ladd(y3, lmul(w, t0p))));
  out.z(reduce(ladd(z3, lmul(t0p, txy))));
}

template <class E>
struct ToPoint {
  Point<E>* r;
  FF_HD void x(const E& v) { r->x = v; }
  FF_HD void y(const E& v) { r->y = v; }
  FF_HD void z(const E& v) { r->z = v; }
};

template <class E>
FF_HD Point<E> padd(const Point<E>& p, const Point<E>& q) {
  Point<E> r;
  ToPoint<E> out{&r};
  padd_emit(p, q, out);
  return r;
}

// Points live in memory as (N, NA, 8) int32 rows: NA = 3 coordinates for
// G1, NA = 6 (x.c0, x.c1, y.c0, y.c1, z.c0, z.c1) for G2.
template <class E> struct Layout;
template <> struct Layout<Fp1> { static const int NA = 3; };
template <> struct Layout<Fp2> { static const int NA = 6; };

FF_HD void load_coord(Fp1& e, const uint32_t* src) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) e.v[i] = src[i];
}
FF_HD void load_coord(Fp2& e, const uint32_t* src) {
  load_coord(e.c0, src);
  load_coord(e.c1, src + 8);
}
FF_HD void store_coord(uint32_t* dst, const Fp1& e) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) dst[i] = e.v[i];
}
FF_HD void store_coord(uint32_t* dst, const Fp2& e) {
  store_coord(dst, e.c0);
  store_coord(dst + 8, e.c1);
}

template <class E>
FF_HD Point<E> load_point(const uint32_t* src) {
  const int w = Layout<E>::NA / 3 * 8;  // words per coordinate
  Point<E> p;
  load_coord(p.x, src);
  load_coord(p.y, src + w);
  load_coord(p.z, src + 2 * w);
  return p;
}

template <class E>
FF_HD void store_point(uint32_t* dst, const Point<E>& p) {
  const int w = Layout<E>::NA / 3 * 8;
  store_coord(dst, p.x);
  store_coord(dst + w, p.y);
  store_coord(dst + 2 * w, p.z);
}

// The MSM's Horner over W window sums (rows of W points from rw): acc =
// rw[W - 1]; for w = W - 2 .. 0, c doublings of acc through the complete
// add, then acc + rw[w].  One add site, its second operand acc or rw[w].
template <class E>
FF_HD Point<E> horner(const uint32_t* rw, int W, int c) {
  const int pw = Layout<E>::NA * 8;
  Point<E> acc = load_point<E>(rw + (long long)(W - 1) * pw);
  for (int w = W - 2; w >= 0; --w)
    for (int s = 0; s <= c; ++s) {
      const Point<E> q = s < c ? acc : load_point<E>(rw + (long long)w * pw);
      acc = padd(acc, q);
    }
  return acc;
}

}  // namespace ff
