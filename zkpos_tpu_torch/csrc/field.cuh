// BN254 field arithmetic shared by every kernel of the port.
//
// Elements are 8 little-endian 32-bit limbs in Montgomery form with
// R = 2^256, for both Fr (the scalar field) and Fp (the base field), and
// every operation returns a fully reduced value below the modulus.  So a
// value has exactly one representation, and two correct computations of
// the same field expression agree bit for bit.
//
// The header compiles under nvcc (device code) and under g++ (host code,
// for the CPU rehearsal of the arithmetic): FF_HD expands to the right
// qualifiers for each.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define FF_HD __host__ __device__ __forceinline__
#define FF_UNROLL _Pragma("unroll")
#else
#define FF_HD inline
#define FF_UNROLL
#endif

namespace ff {

// Modulus limbs and -p^-1 mod 2^32 of each field.  limb(i) is called with
// constant indices after unrolling, so the switch folds to an immediate.
struct Fr {
  static FF_HD uint32_t limb(int i) {
    switch (i) {
      case 0: return 0xf0000001u; case 1: return 0x43e1f593u;
      case 2: return 0x79b97091u; case 3: return 0x2833e848u;
      case 4: return 0x8181585du; case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u; default: return 0x30644e72u;
    }
  }
  static FF_HD uint32_t n0() { return 0xefffffffu; }
};

struct Fp {
  static FF_HD uint32_t limb(int i) {
    switch (i) {
      case 0: return 0xd87cfd47u; case 1: return 0x3c208c16u;
      case 2: return 0x6871ca8du; case 3: return 0x97816a91u;
      case 4: return 0x8181585du; case 5: return 0xb85045b6u;
      case 6: return 0xe131a029u; default: return 0x30644e72u;
    }
  }
  static FF_HD uint32_t n0() { return 0xe4866389u; }
};

// r >= p ?  (r has 8 limbs; top is an extra carry word)
template <class F>
FF_HD bool geq_mod(const uint32_t* r, uint32_t top) {
  if (top) return true;
  FF_UNROLL
  for (int i = 7; i >= 0; --i) {
    uint32_t m = F::limb(i);
    if (r[i] > m) return true;
    if (r[i] < m) return false;
  }
  return true;
}

template <class F>
FF_HD void sub_mod_raw(uint32_t* r) {
  uint64_t borrow = 0;
  FF_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t d = (uint64_t)r[i] - F::limb(i) - borrow;
    r[i] = (uint32_t)d;
    borrow = (d >> 63) & 1;
  }
}

template <class F>
FF_HD void add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
  uint32_t t[8];
  FF_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)a[i] + b[i] + c;
    t[i] = (uint32_t)s;
    c = s >> 32;
  }
  if (geq_mod<F>(t, (uint32_t)c)) sub_mod_raw<F>(t);
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = t[i];
}

template <class F>
FF_HD void sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t borrow = 0;
  uint32_t t[8];
  FF_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    t[i] = (uint32_t)d;
    borrow = (d >> 63) & 1;
  }
  if (borrow) {
    uint64_t c = 0;
    FF_UNROLL
    for (int i = 0; i < 8; ++i) {
      uint64_t s = (uint64_t)t[i] + F::limb(i) + c;
      t[i] = (uint32_t)s;
      c = s >> 32;
    }
  }
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = t[i];
}

// Montgomery product a*b/R mod p, CIOS with 64-bit accumulators.  For
// moduli below R/4 (both BN254 fields) the pre-subtraction value is below
// 2p, so one conditional subtraction fully reduces it.
template <class F>
FF_HD void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[10];
  FF_UNROLL
  for (int i = 0; i < 10; ++i) t[i] = 0;
  FF_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    FF_UNROLL
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::n0();
    s = (uint64_t)m * F::limb(0) + t[0];
    c = s >> 32;
    FF_UNROLL
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * F::limb(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  if (geq_mod<F>(t, t[8])) sub_mod_raw<F>(t);
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = t[i];
}

// a^e for an exponent given as 8 little-endian limbs (square and multiply,
// most significant bit first).  `one` is 1 in Montgomery form.
template <class F>
FF_HD void powm(uint32_t* r, const uint32_t* a, const uint32_t* e,
                const uint32_t* one) {
  uint32_t acc[8];
  for (int i = 0; i < 8; ++i) acc[i] = one[i];
  for (int w = 7; w >= 0; --w) {
    for (int bit = 31; bit >= 0; --bit) {
      mul<F>(acc, acc, acc);
      if ((e[w] >> bit) & 1u) mul<F>(acc, acc, a);
    }
  }
  for (int i = 0; i < 8; ++i) r[i] = acc[i];
}

// --- point coordinates ------------------------------------------------------
//
// G1 coordinates are Fp elements; G2 coordinates are Fp2 = Fp[u]/(u^2 + 1)
// elements stored as (c0, c1).  Their arithmetic, for the complete add, is
// fp_ec.cuh's.  16-byte aligned, so that a point moves in 16-byte pieces.

struct alignas(16) Fp1 { uint32_t v[8]; };
struct Fp2 { Fp1 c0, c1; };

FF_HD Fp1 fp_const(uint32_t l0, uint32_t l1, uint32_t l2, uint32_t l3,
                   uint32_t l4, uint32_t l5, uint32_t l6, uint32_t l7) {
  Fp1 r;
  r.v[0] = l0; r.v[1] = l1; r.v[2] = l2; r.v[3] = l3;
  r.v[4] = l4; r.v[5] = l5; r.v[6] = l6; r.v[7] = l7;
  return r;
}

}  // namespace ff
