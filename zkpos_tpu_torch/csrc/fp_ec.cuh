// The Fp core of the EC kernels (ec.cuh): BN254 base-field arithmetic on
// 32-bit carry chains, with lazy reduction.
//
// Every step of a chain is one primitive below (mad_lo_cc, madc_hi_cc,
// addc_cc, ...).  On the card each is one PTX instruction that reads or
// writes the carry flag; under g++ each is C++ that keeps the carry in an
// explicit bit (Carry).  So the CPU rehearsal runs the very sequence of
// steps the card runs, and only the primitives differ.
//
// Bounds.  p < 2^254 and 4p < R = 2^256 (p / R = 0.189).  Coordinates in
// memory are fully reduced, below p.  Inside an add, values only need to
// stay below 2p:
//   lmul(a, b)   the Montgomery product a b / R with no final subtraction:
//                its result is below a b / R + p, so below 2p whenever
//                a b < p R (a, b < 2p: a b < 4 p^2 < p R since 4p < R).
//                The chains need a + p < 2^256 (a < 2p: a + p < 3p < R),
//                so no carry leaves the top word (see mont_lazy);
//   ladd(a, b)   a + b for a, b < 2p: the sum is below 4p < 2^256, and 2p
//                is taken off when it is not below 2p, so below 2p;
//   lsub(a, b)   a - b for a, b < 2p, plus 2p when it borrows: in [0, 2p);
//   lsum(a, b)   a + b unreduced, for a, b < p (coordinates as loaded):
//                below 2p;
//   reduce(a)    a < 2p -> the unique representative below p.
// An add therefore stores what a fully reduced computation of the same
// field expression stores, bit for bit.
//
// The generic mul<F> / add<F> / sub<F> of field.cuh (the Fr kernels, the
// NTT, ff_*, Poseidon and the probes) are not built on this core.
#pragma once

#include "field.cuh"

namespace ff {

// --- carry-chain primitives -------------------------------------------------
//
// x_cc writes the carry (or borrow) flag, xc reads it; PTX keeps the flag in
// the condition-code register, g++ in Carry::c.

struct Carry { uint32_t c; };

FF_HD void add_cc(Carry& k, uint32_t& d, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  const uint64_t s = (uint64_t)a + b;
  d = (uint32_t)s;
  k.c = (uint32_t)(s >> 32);
#endif
}

FF_HD void addc_cc(Carry& k, uint32_t& d, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  const uint64_t s = (uint64_t)a + b + k.c;
  d = (uint32_t)s;
  k.c = (uint32_t)(s >> 32);
#endif
}

FF_HD void addc(Carry& k, uint32_t& d, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  d = a + b + k.c;
#endif
}

FF_HD void sub_cc(Carry& k, uint32_t& d, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  d = a - b;
  k.c = a < b ? 1u : 0u;
#endif
}

FF_HD void subc_cc(Carry& k, uint32_t& d, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  const uint64_t s = (uint64_t)a - b - k.c;
  d = (uint32_t)s;
  k.c = (uint32_t)(s >> 63);
#endif
}

FF_HD void subc(Carry& k, uint32_t& d, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
#else
  d = a - b - k.c;
#endif
}

// d = lo(a b) + c, carry out
FF_HD void mad_lo_cc(Carry& k, uint32_t& d, uint32_t a, uint32_t b,
                     uint32_t c) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c;
  d = (uint32_t)s;
  k.c = (uint32_t)(s >> 32);
#endif
}

// d = lo(a b) + c + carry, carry out
FF_HD void madc_lo_cc(Carry& k, uint32_t& d, uint32_t a, uint32_t b,
                      uint32_t c) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
#else
  const uint64_t s = (uint64_t)(uint32_t)(a * b) + c + k.c;
  d = (uint32_t)s;
  k.c = (uint32_t)(s >> 32);
#endif
}

// d = hi(a b) + c + carry, carry out
FF_HD void madc_hi_cc(Carry& k, uint32_t& d, uint32_t a, uint32_t b,
                      uint32_t c) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + c + k.c;
  d = (uint32_t)s;
  k.c = (uint32_t)(s >> 32);
#endif
}

// d = hi(a b) + c + carry
FF_HD void madc_hi(Carry& k, uint32_t& d, uint32_t a, uint32_t b,
                   uint32_t c) {
#if defined(__CUDA_ARCH__)
  (void)k;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;"
               : "=r"(d) : "r"(a), "r"(b), "r"(c));
#else
  d = (uint32_t)(((uint64_t)a * b) >> 32) + c + k.c;
#endif
}

FF_HD uint32_t mul_hi(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// --- 2p ----------------------------------------------------------------------

FF_HD uint32_t p2_limb(int i) {
  switch (i) {
    case 0: return 0xb0f9fa8eu; case 1: return 0x7841182du;
    case 2: return 0xd0e3951au; case 3: return 0x2f02d522u;
    case 4: return 0x0302b0bbu; case 5: return 0x70a08b6du;
    case 6: return 0xc2634053u; default: return 0x60c89ce5u;
  }
}

// --- the Montgomery product on carry chains ---------------------------------
//
// CIOS with the running sum T split in two rows of 8 words, as
// T = ev + od 2^32: the products a[j] b_i of even j land in ev (lo at word j,
// hi at j + 1) and those of odd j in od, so neither row has two products
// overlapping and each is one unbroken chain of mad.lo / madc.hi.  Each
// step adds a b_i and m p (m = T[0] (-p^-1) mod 2^32) and drops the zero
// low word; the rows swap roles every step (the word dropped from one row
// shifts the other), so the two inner loops are:
//   first step:  ev, od = a b_0 (no additions);
//   later steps: ev[0] += od[1]; od = (od >> 2 words) + a_odd b_i (one chain
//                carried on from ev[0]); ev += a_even b_i (chain), its carry
//                into od[7];
//   every step:  od += p_odd m, ev += p_even m, the carry into od[7].
// T stays below (a + p) 2^32 < 2^288 before a step's shift and below a + p
// after it, so od as a number stays below 2^256: the carry out of od's
// chain is always 0 and is not kept.  32 x 32-bit multiplies a step, 264 a
// product with m's.

FF_HD void mont_mul_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  FF_UNROLL
  for (int j = 0; j < 8; j += 2) {
    acc[j] = a[j] * bi;
    acc[j + 1] = mul_hi(a[j], bi);
  }
}

// acc[0..7] += the 4 products a[0], a[2], a[4], a[6] times bi (a is given
// from its first even or odd limb), carry out in k
FF_HD void mont_cmad_n(Carry& k, uint32_t* acc, const uint32_t* a,
                       uint32_t bi) {
  mad_lo_cc(k, acc[0], a[0], bi, acc[0]);
  madc_hi_cc(k, acc[1], a[0], bi, acc[1]);
  FF_UNROLL
  for (int j = 2; j < 8; j += 2) {
    madc_lo_cc(k, acc[j], a[j], bi, acc[j]);
    madc_hi_cc(k, acc[j + 1], a[j], bi, acc[j + 1]);
  }
}

// od = (od >> 2 words) + a[1], a[3], a[5], a[7] times bi, continuing the
// carry in k
FF_HD void mont_madc_rshift(Carry& k, uint32_t* od, const uint32_t* a,
                            uint32_t bi) {
  FF_UNROLL
  for (int j = 0; j < 6; j += 2) {
    madc_lo_cc(k, od[j], a[j + 1], bi, od[j + 2]);
    madc_hi_cc(k, od[j + 1], a[j + 1], bi, od[j + 3]);
  }
  madc_lo_cc(k, od[6], a[7], bi, 0u);
  madc_hi(k, od[7], a[7], bi, 0u);
}

// m p into the rows: T's low word (ev[0]) becomes 0
template <class F>
FF_HD void mont_redc_step(uint32_t* ev, uint32_t* od) {
  const uint32_t pl[8] = {F::limb(0), F::limb(1), F::limb(2), F::limb(3),
                          F::limb(4), F::limb(5), F::limb(6), F::limb(7)};
  const uint32_t m = ev[0] * F::n0();
  Carry k;
  mont_cmad_n(k, od, pl + 1, m);
  mont_cmad_n(k, ev, pl, m);
  addc(k, od[7], od[7], 0u);
}

template <class F>
FF_HD void mont_step(uint32_t* ev, uint32_t* od, const uint32_t* a,
                     uint32_t bi, bool first) {
  if (first) {
    mont_mul_n(od, a + 1, bi);
    mont_mul_n(ev, a, bi);
  } else {
    Carry k;
    add_cc(k, ev[0], ev[0], od[1]);
    mont_madc_rshift(k, od, a, bi);
    mont_cmad_n(k, ev, a, bi);
    addc(k, od[7], od[7], 0u);
  }
  mont_redc_step<F>(ev, od);
}

// r = a b / R mod p, below a b / R + p (no final subtraction).  r may alias
// a or b.
template <class F>
FF_HD void mont_lazy(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t ev[8], od[8];
  FF_UNROLL
  for (int i = 0; i < 8; i += 2) {
    mont_step<F>(ev, od, a, b[i], i == 0);
    mont_step<F>(od, ev, a, b[i + 1], false);
  }
  // T = od + ev 2^32 with od[0] = 0: the result is od / 2^32 + ev
  Carry k;
  add_cc(k, ev[0], ev[0], od[1]);
  FF_UNROLL
  for (int i = 1; i < 7; ++i) addc_cc(k, ev[i], ev[i], od[i + 1]);
  addc(k, ev[7], ev[7], 0u);
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = ev[i];
}

// --- lazy Fp and Fp2 --------------------------------------------------------

FF_HD Fp1 lmul(const Fp1& a, const Fp1& b) {
  Fp1 r;
  mont_lazy<Fp>(r.v, a.v, b.v);
  return r;
}

FF_HD Fp1 lsum(const Fp1& a, const Fp1& b) {
  Fp1 r;
  Carry k;
  add_cc(k, r.v[0], a.v[0], b.v[0]);
  FF_UNROLL
  for (int i = 1; i < 7; ++i) addc_cc(k, r.v[i], a.v[i], b.v[i]);
  addc(k, r.v[7], a.v[7], b.v[7]);
  return r;
}

// s < 4p -> s mod 2p, branch-free: s - 2p unless that borrows
FF_HD Fp1 sub_2p_if_over(const Fp1& s) {
  Fp1 d;
  uint32_t m;
  Carry k;
  sub_cc(k, d.v[0], s.v[0], p2_limb(0));
  FF_UNROLL
  for (int i = 1; i < 8; ++i) subc_cc(k, d.v[i], s.v[i], p2_limb(i));
  subc(k, m, 0u, 0u);
  FF_UNROLL
  for (int i = 0; i < 8; ++i) d.v[i] = m ? s.v[i] : d.v[i];
  return d;
}

FF_HD Fp1 ladd(const Fp1& a, const Fp1& b) { return sub_2p_if_over(lsum(a, b)); }

FF_HD Fp1 lsub(const Fp1& a, const Fp1& b) {
  Fp1 d;
  uint32_t m;
  Carry k;
  sub_cc(k, d.v[0], a.v[0], b.v[0]);
  FF_UNROLL
  for (int i = 1; i < 8; ++i) subc_cc(k, d.v[i], a.v[i], b.v[i]);
  subc(k, m, 0u, 0u);
  add_cc(k, d.v[0], d.v[0], p2_limb(0) & m);
  FF_UNROLL
  for (int i = 1; i < 7; ++i) addc_cc(k, d.v[i], d.v[i], p2_limb(i) & m);
  addc(k, d.v[7], d.v[7], p2_limb(7) & m);
  return d;
}

FF_HD Fp1 reduce(const Fp1& a) {
  Fp1 d;
  uint32_t m;
  Carry k;
  sub_cc(k, d.v[0], a.v[0], Fp::limb(0));
  FF_UNROLL
  for (int i = 1; i < 8; ++i) subc_cc(k, d.v[i], a.v[i], Fp::limb(i));
  subc(k, m, 0u, 0u);
  FF_UNROLL
  for (int i = 0; i < 8; ++i) d.v[i] = m ? a.v[i] : d.v[i];
  return d;
}

FF_HD Fp2 lsum(const Fp2& a, const Fp2& b) {
  return Fp2{lsum(a.c0, b.c0), lsum(a.c1, b.c1)};
}
FF_HD Fp2 ladd(const Fp2& a, const Fp2& b) {
  return Fp2{ladd(a.c0, b.c0), ladd(a.c1, b.c1)};
}
FF_HD Fp2 lsub(const Fp2& a, const Fp2& b) {
  return Fp2{lsub(a.c0, b.c0), lsub(a.c1, b.c1)};
}
FF_HD Fp2 reduce(const Fp2& a) { return Fp2{reduce(a.c0), reduce(a.c1)}; }

// Karatsuba over u^2 = -1: three base-field products, inputs below 2p
FF_HD Fp2 lmul(const Fp2& a, const Fp2& b) {
  const Fp1 t0 = lmul(a.c0, b.c0);
  const Fp1 t1 = lmul(a.c1, b.c1);
  const Fp1 t2 = lmul(ladd(a.c0, a.c1), ladd(b.c0, b.c1));
  return Fp2{lsub(t0, t1), lsub(t2, ladd(t0, t1))};
}

// 3b of each curve times a: 9a for G1 (y^2 = x^3 + 3) by doublings, and
// 3b' = (81 - 9u)/82 of the G2 twist by Karatsuba with the constant's sum
// folded in
FF_HD Fp1 mul_b3(const Fp1& a) {
  const Fp1 a2 = ladd(a, a);
  const Fp1 a4 = ladd(a2, a2);
  return ladd(ladd(a4, a4), a);
}

// 3b of each curve in Montgomery form: 9 (G1) and (81 - 9u)/82 (G2)
FF_HD void b3_const(Fp1& k) {
  k = fp_const(0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
               0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u);
}
FF_HD void b3_const(Fp2& k) {
  k.c0 = fp_const(0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                  0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u);
  k.c1 = fp_const(0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                  0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au);
}

FF_HD Fp2 mul_b3(const Fp2& a) {
  Fp2 k;
  b3_const(k);
  const Fp1& k0 = k.c0;
  const Fp1& k1 = k.c1;
  const Fp1 ks = fp_const(0x2bc50b9fu, 0xe66258e3u, 0x8d208cb7u, 0x08f096cbu,
                          0x41614864u, 0x8964b0fbu, 0xe76460ddu, 0x123ae31bu);
  const Fp1 t0 = lmul(k0, a.c0);
  const Fp1 t1 = lmul(k1, a.c1);
  const Fp1 t2 = lmul(ks, ladd(a.c0, a.c1));
  return Fp2{lsub(t0, t1), lsub(t2, ladd(t0, t1))};
}

}  // namespace ff
