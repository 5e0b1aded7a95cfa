// Poseidon permutations over BN254 Fr on field.cuh: the plain round
// schedule at every width T = 2..17, the sparse-MDS schedule at T = 3, and
// the per-lane pieces that the warp-per-chain kernel is built from.
//
// Elements are 8 x 32-bit limbs in Montgomery form (R = 2^256), fully
// reduced after every operation, so each function here computes exactly
// the value of crypto/poseidon_ref.permutation and the results compare
// bit for bit with the plain PyTorch versions.  The round constants and
// MDS entries are not compiled in: the caller passes pointers to tables in
// Montgomery form (built by ops/poseidon.py and ops/poseidon_sparse.py from
// the port's own copies of crypto/poseidon_params and poseidon_opt).
//
// Like field.cuh the header compiles under nvcc and under g++, which is
// how tests/test_torch_rehearsal.py checks this arithmetic on the CPU.
#pragma once

#include "field.cuh"

namespace pos {

using ff::Fr;

const int kFullRounds = 8;
const int kHalfFull = 4;
const int kMaxWidth = 17;
// digest position within the permuted state (crypto/poseidon_ref.py)
const int kOutputIndex = 1;

// partial rounds for width t = 2..17 (crypto/poseidon_params.py)
FF_HD int partial_rounds(int t) {
  switch (t) {
    case 2: return 56;  case 3: return 57;  case 4: return 56;
    case 5: return 60;  case 6: return 60;  case 7: return 63;
    case 8: return 64;  case 9: return 63;  case 10: return 60;
    case 11: return 66; case 12: return 60; case 13: return 65;
    case 14: return 70; case 15: return 60; case 16: return 64;
    default: return 68;
  }
}

// one table entry (8 limbs) into registers; read-only cache on the card
FF_HD void ldc(uint32_t* r, const uint32_t* p) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) {
#if defined(__CUDA_ARCH__)
    r[i] = __ldg(p + i);
#else
    r[i] = p[i];
#endif
  }
}

FF_HD void copy8(uint32_t* r, const uint32_t* a) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = a[i];
}

FF_HD void zero8(uint32_t* r) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = 0;
}

// x <- x^5
FF_HD void sbox(uint32_t* x) {
  uint32_t x2[8], x4[8];
  ff::mul<Fr>(x2, x, x);
  ff::mul<Fr>(x4, x2, x2);
  ff::mul<Fr>(x, x4, x);
}

// x <- x + table entry
FF_HD void add_c(uint32_t* x, const uint32_t* c) {
  uint32_t k[8];
  ldc(k, c);
  ff::add<Fr>(x, x, k);
}

// acc <- acc + (table entry) * x
FF_HD void fma_c(uint32_t* acc, const uint32_t* c, const uint32_t* x) {
  uint32_t k[8], p[8];
  ldc(k, c);
  ff::mul<Fr>(p, k, x);
  ff::add<Fr>(acc, acc, p);
}

// --- plain schedule, one lane at a time ------------------------------------
//
// Round r of the plain schedule (crypto/poseidon_ref.permutation), split at
// the point where the lanes exchange their values: first each lane adds
// its round constant and, in a full round or on lane 0, applies the
// S-box; then each lane computes its row of the MDS product from the whole
// state.  C holds (8 + R_P) x t entries in round order, M the t x t matrix
// by rows.

FF_HD void lane_pre(uint32_t* x, int lane, int r, int t, int rp,
                    const uint32_t* C) {
  add_c(x, C + 8 * ((long)r * t + lane));
  if (r < kHalfFull || r >= kHalfFull + rp || lane == 0) sbox(x);
}

// out <- sum_j M[lane][j] * st[j]; st holds t entries of 8 limbs
FF_HD void lane_mix(uint32_t* out, int lane, int t, const uint32_t* st,
                    const uint32_t* M) {
  uint32_t acc[8];
  zero8(acc);
  for (int j = 0; j < t; ++j) fma_c(acc, M + 8 * (lane * t + j), st + 8 * j);
  copy8(out, acc);
}

// The whole permutation on one thread's state (T lanes of 8 limbs).
template <int T>
FF_HD void permute_plain(uint32_t (*st)[8], const uint32_t* C,
                         const uint32_t* M) {
  const int rp = partial_rounds(T);
  uint32_t nx[T][8];
  for (int r = 0; r < kFullRounds + rp; ++r) {
    for (int i = 0; i < T; ++i) lane_pre(st[i], i, r, T, rp, C);
    for (int i = 0; i < T; ++i) lane_mix(nx[i], i, T, &st[0][0], M);
    for (int i = 0; i < T; ++i) copy8(st[i], nx[i]);
  }
}

// --- the chaining rule of ops/poseidon.py:116-148 ----------------------------
//
// A hash of n inputs runs ceil-many permutations: block 0 absorbs the first
// min(n, 16) inputs into lanes 1.. (lane 0 is 0); every later block puts
// the running digest in lane 1 and the next (at most 15) inputs in lanes
// 2...  chain_block gives block b's first input, its input count and its
// width.

FF_HD int chain_blocks(int n) {
  return n <= kMaxWidth - 1 ? 1 : 1 + (n - 2) / (kMaxWidth - 2);
}

FF_HD void chain_block(int n, int b, int* start, int* count, int* width) {
  if (b == 0) {
    *start = 0;
    *count = n < kMaxWidth - 1 ? n : kMaxWidth - 1;
    *width = *count + 1;
  } else {
    *start = (kMaxWidth - 1) + (b - 1) * (kMaxWidth - 2);
    int left = n - *start;
    *count = left < kMaxWidth - 2 ? left : kMaxWidth - 2;
    *width = *count + 2;
  }
}

// --- sparse-MDS schedule at t = 3 (crypto/poseidon_opt.py) -----------------
//
// Table layout, in entries of 8 limbs (ops/poseidon_sparse.py writes it):
//   c_init (3) | c_full (3 x 3) | d_partial (57) | c_resume (3) |
//   c_full_2nd (3 x 3) | sparse rows (56 x (m00, v1, v2, w1, w2)) |
//   dense_last (3 x 3) | mds (3 x 3)
namespace sparse3 {
const int T = 3;
const int RP = 57;
const int kCInit = 0;
const int kCFull = T;
const int kD = 4 * T;
const int kCResume = kD + RP;
const int kCFull2 = kCResume + T;
const int kSparse = kCFull2 + 3 * T;
const int kRow = 2 * T - 1;
const int kDense = kSparse + (RP - 1) * kRow;
const int kMds = kDense + T * T;
const int kEntries = kMds + T * T;
}  // namespace sparse3

FF_HD void mix_dense3(uint32_t (*x)[8], const uint32_t* M) {
  uint32_t nx[3][8];
  for (int i = 0; i < 3; ++i) lane_mix(nx[i], i, 3, &x[0][0], M);
  for (int i = 0; i < 3; ++i) copy8(x[i], nx[i]);
}

FF_HD void full_round3(uint32_t (*x)[8], const uint32_t* K,
                       const uint32_t* c_next) {
  for (int i = 0; i < 3; ++i) sbox(x[i]);
  mix_dense3(x, K + 8 * sparse3::kMds);
  if (c_next)
    for (int i = 0; i < 3; ++i) add_c(x[i], c_next + 8 * i);
}

// Poseidon permutation of x (3 lanes) on the sparse schedule; K is the
// table above.
FF_HD void permute_sparse3(uint32_t (*x)[8], const uint32_t* K) {
  using namespace sparse3;
  const uint32_t* e = K;
  for (int i = 0; i < T; ++i) add_c(x[i], e + 8 * (kCInit + i));
  for (int r = 0; r < kHalfFull; ++r)
    full_round3(x, K, r < kHalfFull - 1 ? e + 8 * (kCFull + T * r) : 0);
  add_c(x[0], e + 8 * kD);
  for (int i = 0; i < RP; ++i) {
    sbox(x[0]);
    if (i < RP - 1) {
      const uint32_t* row = e + 8 * (kSparse + kRow * i);
      uint32_t x0[8];
      zero8(x0);
      for (int j = 0; j < T; ++j) fma_c(x0, row + 8 * j, x[j]);
      for (int j = 1; j < T; ++j) fma_c(x[j], row + 8 * (T - 1 + j), x[0]);
      copy8(x[0], x0);
      add_c(x[0], e + 8 * (kD + i + 1));
    } else {
      mix_dense3(x, e + 8 * kDense);
      for (int j = 0; j < T; ++j) add_c(x[j], e + 8 * (kCResume + j));
    }
  }
  for (int r = 0; r < kHalfFull; ++r)
    full_round3(x, K, r < kHalfFull - 1 ? e + 8 * (kCFull2 + T * r) : 0);
}

}  // namespace pos
