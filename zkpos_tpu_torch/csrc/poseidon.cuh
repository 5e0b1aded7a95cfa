// Poseidon permutations over BN254 Fr on field.cuh: the plain round
// schedule (the node hash at T = 3), the sparse-MDS schedule at T = 3
// (the tree's node hash; H hashes a thread), at T = 4..17 on one thread
// (the leaf hashes and the asset commitments' blocks), and at any width on
// one warp (the hash chains), written once over the warp's exchanges so
// that g++ runs it with one host thread per lane.
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

#if defined(__CUDACC__)
#define POS_ROLLED _Pragma("unroll 1")
#else
#define POS_ROLLED
#endif

namespace pos {

using ff::Fr;

const int kFullRounds = 8;
const int kHalfFull = 4;
const int kMaxWidth = 17;
// digest position within the permuted state (crypto/poseidon_ref.py)
const int kOutputIndex = 1;

// partial rounds for width t = 2..17 (crypto/poseidon_params.py)
FF_HD constexpr int partial_rounds(int t) {
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

// one entry of a table in shared memory (under g++: any memory), and its
// store: two 16-byte accesses on the card
FF_HD void ldk(uint32_t* r, const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = q[0], b = q[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
#else
  for (int i = 0; i < 8; ++i) r[i] = p[i];
#endif
}

FF_HD void stk(uint32_t* p, const uint32_t* r) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
#else
  for (int i = 0; i < 8; ++i) p[i] = r[i];
#endif
}

// one element of device memory, through the read-only cache on the card
FF_HD void ldg8(uint32_t* r, const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = __ldg(q), b = __ldg(q + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
#else
  for (int i = 0; i < 8; ++i) r[i] = p[i];
#endif
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

// --- sparse-MDS tables ---------------------------------------------------------
//
// Table layout of width t, in entries of 8 limbs (ops/poseidon_sparse.py
// writes it from crypto/poseidon_opt.opt_params(t)):
//   c_init (t) | c_full (3 x t) | d_partial (R_P) | c_resume (t) |
//   c_full_2nd (3 x t) | rows (R_P - 1 x (m00, v_1..v_t-1, w_1..w_t-1)) |
//   dense_last (t x t) | mds (t x t)
struct Sparse {
  int t, rp;
  FF_HD constexpr explicit Sparse(int width)
      : t(width), rp(partial_rounds(width)) {}
  FF_HD constexpr int c_init() const { return 0; }
  FF_HD constexpr int c_full(int r) const { return t * (1 + r); }
  FF_HD constexpr int d(int i) const { return 4 * t + i; }
  FF_HD constexpr int c_resume() const { return 4 * t + rp; }
  FF_HD constexpr int c_full2(int r) const { return t * (5 + r) + rp; }
  FF_HD constexpr int row(int i) const {
    return 8 * t + rp + (2 * t - 1) * i;
  }
  FF_HD constexpr int dense() const { return row(rp - 1); }
  FF_HD constexpr int mds() const { return dense() + t * t; }
  FF_HD constexpr int entries() const { return mds() + t * t; }
};

// --- sparse-MDS schedule at t = 3, H hashes a thread ------------------------
//
// The offsets of the width-3 table (struct Sparse at t = 3) as constants.
namespace sparse3 {
constexpr Sparse kLayout(3);
constexpr int T = kLayout.t;
constexpr int RP = kLayout.rp;
constexpr int kCInit = kLayout.c_init();
constexpr int kCFull = kLayout.c_full(0);
constexpr int kD = kLayout.d(0);
constexpr int kCResume = kLayout.c_resume();
constexpr int kCFull2 = kLayout.c_full2(0);
constexpr int kSparse = kLayout.row(0);
constexpr int kRow = kLayout.row(1) - kLayout.row(0);
constexpr int kDense = kLayout.dense();
constexpr int kMds = kLayout.mds();
constexpr int kEntries = kLayout.entries();
}  // namespace sparse3

// The lane loops stay rolled (the state sits in the thread's stack frame,
// as k_plain's does) so that the code of a round is small, and the hash
// loops unroll: each table entry is read once for the H hashes, whose
// products are independent.  The tree's kernel runs one hash a thread
// (poseidon.cu k_sparse3); two and four are variants of the probes path
// (probes.cu k_split_hashes), slower on the card (PERF.md).  With SYNC,
// block_sync() at every partial round keeps the warps of a block
// (poseidon.cu: one block of 1,024 threads fills an SM) in the same round,
// so they run the same instructions; on the card that is what brings the
// kernel near the multiply rate (PERF.md).

// every thread of the block arrives here before any goes on (on the card;
// under g++ nothing)
FF_HD void block_sync() {
#if defined(__CUDA_ARCH__)
  __syncthreads();
#endif
}

// x[h][lane] += entry c, for every hash h
template <int H>
FF_HD void add3(uint32_t (*x)[3][8], int lane, const uint32_t* c) {
  uint32_t k[8];
  ldc(k, c);
  FF_UNROLL
  for (int h = 0; h < H; ++h) ff::add<Fr>(x[h][lane], x[h][lane], k);
}

// x[h] <- M x[h] (M: 3 x 3 by rows), for every hash h
template <int H>
FF_HD void mix3(uint32_t (*x)[3][8], const uint32_t* M) {
  uint32_t nx[H][3][8];
  POS_ROLLED
  for (int i = 0; i < 3; ++i) {
    FF_UNROLL
    for (int h = 0; h < H; ++h) zero8(nx[h][i]);
    POS_ROLLED
    for (int j = 0; j < 3; ++j) {
      uint32_t k[8];
      ldc(k, M + 8 * (3 * i + j));
      FF_UNROLL
      for (int h = 0; h < H; ++h) {
        uint32_t p[8];
        ff::mul<Fr>(p, k, x[h][j]);
        ff::add<Fr>(nx[h][i], nx[h][i], p);
      }
    }
  }
  POS_ROLLED
  for (int i = 0; i < 3; ++i) {
    FF_UNROLL
    for (int h = 0; h < H; ++h) copy8(x[h][i], nx[h][i]);
  }
}

// a full round: every S-box, the MDS mix, then the next round's constants
// (c_next: 3 entries) if any
template <int H>
FF_HD void full3(uint32_t (*x)[3][8], const uint32_t* K,
                 const uint32_t* c_next) {
  POS_ROLLED
  for (int i = 0; i < 3; ++i) {
    FF_UNROLL
    for (int h = 0; h < H; ++h) sbox(x[h][i]);
  }
  mix3<H>(x, K + 8 * sparse3::kMds);
  if (c_next) {
    POS_ROLLED
    for (int i = 0; i < 3; ++i) add3<H>(x, i, c_next + 8 * i);
  }
}

// The Poseidon permutation of H states x[h] (3 lanes each) on the sparse
// schedule; K is the table above.  With SYNC it is a block barrier at
// every partial round: every thread of the block must call it, none may
// have left the kernel.
template <int H, bool SYNC>
FF_HD void permute_sparse3(uint32_t (*x)[3][8], const uint32_t* K) {
  using namespace sparse3;
  POS_ROLLED
  for (int i = 0; i < T; ++i) add3<H>(x, i, K + 8 * (kCInit + i));
  POS_ROLLED
  for (int r = 0; r < kHalfFull; ++r)
    full3<H>(x, K, r < kHalfFull - 1 ? K + 8 * (kCFull + T * r) : 0);
  add3<H>(x, 0, K + 8 * kD);
  POS_ROLLED
  for (int i = 0; i < RP - 1; ++i) {
    if (SYNC) block_sync();
    const uint32_t* row = K + 8 * (kSparse + kRow * i);
    uint32_t y[H][8], k[8];
    // y = m00 sbox(x_0) + v_1 x_1 + v_2 x_2; x_j += w_j sbox(x_0)
    FF_UNROLL
    for (int h = 0; h < H; ++h) {
      sbox(x[h][0]);
      zero8(y[h]);
    }
    POS_ROLLED
    for (int j = 0; j < T; ++j) {
      ldc(k, row + 8 * j);
      FF_UNROLL
      for (int h = 0; h < H; ++h) {
        uint32_t p[8];
        ff::mul<Fr>(p, k, x[h][j]);
        ff::add<Fr>(y[h], y[h], p);
      }
    }
    POS_ROLLED
    for (int j = 1; j < T; ++j) {
      ldc(k, row + 8 * (T - 1 + j));
      FF_UNROLL
      for (int h = 0; h < H; ++h) {
        uint32_t p[8];
        ff::mul<Fr>(p, k, x[h][0]);
        ff::add<Fr>(x[h][j], x[h][j], p);
      }
    }
    ldc(k, K + 8 * (kD + i + 1));
    FF_UNROLL
    for (int h = 0; h < H; ++h) ff::add<Fr>(x[h][0], y[h], k);
  }
  // the last partial round mixes with one dense matrix
  FF_UNROLL
  for (int h = 0; h < H; ++h) sbox(x[h][0]);
  mix3<H>(x, K + 8 * kDense);
  POS_ROLLED
  for (int i = 0; i < T; ++i) add3<H>(x, i, K + 8 * (kCResume + i));
  POS_ROLLED
  for (int r = 0; r < kHalfFull; ++r)
    full3<H>(x, K, r < kHalfFull - 1 ? K + 8 * (kCFull2 + T * r) : 0);
}

// --- sparse-MDS schedule at width T = 4..17, one permutation a thread -------
//
// The permutation of x (T lanes of 8 limbs) on the width-T table of struct
// Sparse, as the chain kernel's warp runs it but on one thread: 8(3T + T^2)
// + 3 R_P + (R_P - 1)(2T - 1) + T^2 products (5,424 at T = 17) where the
// plain schedule takes 8(3T + T^2) + R_P(3 + T^2) (22,576).  The lane loops
// stay rolled, as in permute_sparse3, so the state sits in the thread's
// stack frame and a round's code is a few products long.  In a partial
// round the loop over lanes 1..T-1 forms two independent products a step,
// v_j x_j for the new x_0 and w_j x_0^5 for x_j.  block_sync() at every
// partial round keeps the warps of a block in the same round (as
// permute_sparse3<H, true>), so every thread of the block must call it:
// none may leave early.

// x <- M x (M: T x T by rows)
template <int T>
FF_HD void mix_wide(uint32_t (*x)[8], const uint32_t* M) {
  uint32_t nx[T][8];
  POS_ROLLED
  for (int i = 0; i < T; ++i) {
    zero8(nx[i]);
    POS_ROLLED
    for (int j = 0; j < T; ++j) fma_c(nx[i], M + 8 * (T * i + j), x[j]);
  }
  POS_ROLLED
  for (int i = 0; i < T; ++i) copy8(x[i], nx[i]);
}

// every lane's S-box, the mix by M, then the constants c (T entries), if
// any
template <int T>
FF_HD void full_wide(uint32_t (*x)[8], const uint32_t* M, const uint32_t* c) {
  POS_ROLLED
  for (int i = 0; i < T; ++i) sbox(x[i]);
  mix_wide<T>(x, M);
  if (c) {
    POS_ROLLED
    for (int i = 0; i < T; ++i) add_c(x[i], c + 8 * i);
  }
}

template <int T>
FF_HD void permute_wide(uint32_t (*x)[8], const uint32_t* K) {
  constexpr Sparse L(T);
  POS_ROLLED
  for (int i = 0; i < T; ++i) add_c(x[i], K + 8 * (L.c_init() + i));
  POS_ROLLED
  for (int r = 0; r < kHalfFull; ++r)
    full_wide<T>(x, K + 8 * L.mds(),
                 r < kHalfFull - 1 ? K + 8 * L.c_full(r) : 0);
  add_c(x[0], K + 8 * L.d(0));
  POS_ROLLED
  for (int i = 0; i < L.rp - 1; ++i) {
    block_sync();
    // x_0 <- m00 x_0^5 + sum_j v_j x_j + d_(i+1); x_j += w_j x_0^5
    const uint32_t* row = K + 8 * L.row(i);
    uint32_t y[8];
    sbox(x[0]);
    zero8(y);
    fma_c(y, row, x[0]);
    POS_ROLLED
    for (int j = 1; j < T; ++j) {
      uint32_t a[8], b[8], kv[8], kw[8];
      ldc(kv, row + 8 * j);
      ldc(kw, row + 8 * (T - 1 + j));
      ff::mul<Fr>(a, kv, x[j]);
      ff::mul<Fr>(b, kw, x[0]);
      ff::add<Fr>(y, y, a);
      ff::add<Fr>(x[j], x[j], b);
    }
    copy8(x[0], y);
    add_c(x[0], K + 8 * L.d(i + 1));
  }
  // the last partial round mixes with one dense matrix
  sbox(x[0]);
  mix_wide<T>(x, K + 8 * L.dense());
  POS_ROLLED
  for (int i = 0; i < T; ++i) add_c(x[i], K + 8 * (L.c_resume() + i));
  POS_ROLLED
  for (int r = 0; r < kHalfFull; ++r)
    full_wide<T>(x, K + 8 * L.mds(),
                 r < kHalfFull - 1 ? K + 8 * L.c_full2(r) : 0);
}

// --- sparse-MDS schedule at any width, on one warp ---------------------------
//
// The width-t table is struct Sparse's.  Lane j < t of the warp holds state entry x_j; the other lanes take part
// in every step with zeros.  What crosses lanes goes through W, the warp's
// exchange (poseidon.cu: shuffles and shared memory; the g++ rehearsal:
// one host thread per lane and a barrier):
//   w.sync()        every lane's earlier writes to w.state / w.parts are
//                   seen by every lane
//   w.bcast(v, x)   v <- lane 0's x, on every lane
//   w.sum(s, c, t)  s <- the sum over the lanes of c, on lane 0 at least
//                   (lanes >= t hold 0)
//   w.state, w.parts  kMaxWidth and 2 x kLanes entries of exchange area
const int kLanes = 32;
const int kMaxShare = (kMaxWidth * kMaxWidth + kLanes - 1) / kLanes;
const int kExchange = kMaxWidth + 2 * kLanes;

// products each lane takes of a t x t mix
FF_HD int mix_share(int t) { return (t * t + kLanes - 1) / kLanes; }

// Lane's share of y = M s: the P = mix_share(t) products k = lane P ..
// lane P + P - 1 of the t x t products in row-major order, those of the
// share's first row summed into p0 and those of the next row into p1 (P
// <= t, so a share spans at most two rows).  st: the t entries of s.
FF_HD void mix_part(uint32_t* p0, uint32_t* p1, int lane, int t,
                    const uint32_t* st, const uint32_t* M) {
  const int P = mix_share(t);
  const int k0 = lane * P;
  const int r0 = k0 / t;
  zero8(p0);
  zero8(p1);
  FF_UNROLL
  for (int q = 0; q < kMaxShare; ++q) {
    const int k = k0 + q;
    if (q < P && k < t * t) {
      uint32_t m[8], s[8], p[8];
      ldk(m, M + 8 * k);
      ldk(s, st + 8 * (k % t));
      ff::mul<Fr>(p, m, s);
      if (k / t == r0) ff::add<Fr>(p0, p0, p);
      else ff::add<Fr>(p1, p1, p);
    }
  }
}

// y <- row `lane` of M s, from every lane's (p0, p1) in parts (entries
// 2 L and 2 L + 1): the lanes whose share meets the row
FF_HD void mix_gather(uint32_t* y, int lane, int t, const uint32_t* parts) {
  const int P = mix_share(t);
  zero8(y);
  for (int L = lane * t / P; L <= ((lane + 1) * t - 1) / P; ++L) {
    uint32_t v[8];
    ldk(v, parts + 8 * (2 * L + (L * P / t == lane ? 0 : 1)));
    ff::add<Fr>(y, y, v);
  }
}

// x <- x + entry lane of c, on lanes < t
FF_HD void lane_add(uint32_t* x, int lane, int t, const uint32_t* c) {
  if (lane < t) {
    uint32_t k[8];
    ldk(k, c + 8 * lane);
    ff::add<Fr>(x, x, k);
  }
}

// x <- M x over the warp: the state out through w.state, each lane's share
// of the t^2 products, the shares back through w.parts
template <class W>
FF_HD void warp_mix(W& w, uint32_t* x, int lane, int t, const uint32_t* M) {
  uint32_t p0[8], p1[8];
  w.sync();
  if (lane < t) stk(w.state + 8 * lane, x);
  w.sync();
  mix_part(p0, p1, lane, t, w.state, M);
  stk(w.parts + 16 * lane, p0);
  stk(w.parts + 16 * lane + 8, p1);
  w.sync();
  if (lane < t) mix_gather(x, lane, t, w.parts);
}

// A partial round i < R_P - 1, with lane 0 holding y = x_0 + d_i before
// its S-box.  The new x_0 is m00 y^5 + sum_j v_j x_j and lane j adds
// w_j y^5 to x_j; the round takes three products in a row on each lane:
//   step 1 (y broadcast): lane 0 forms a = y^2 and b = m00 y, lane j
//          a = v_j x_j and b = w_j y;
//   step 2: y^4 = a^2 on lane 0, broadcast;
//   step 3: p = b y^4: lane 0 gives p = m00 y^5 to the sum, lane j gives
//          a and adds p to x_j.
FF_HD void sparse_step1(uint32_t* a, uint32_t* b, int lane, int t,
                        const uint32_t* x, const uint32_t* y,
                        const uint32_t* row) {
  uint32_t ka[8], kb[8], o[8];
  if (lane == 0) {
    copy8(ka, y);
    ldk(kb, row);
  } else if (lane < t) {
    ldk(ka, row + 8 * lane);
    ldk(kb, row + 8 * (t - 1 + lane));
  } else {
    zero8(ka);
    zero8(kb);
  }
  FF_UNROLL
  for (int i = 0; i < 8; ++i) o[i] = lane == 0 ? y[i] : x[i];
  ff::mul<Fr>(a, ka, o);
  ff::mul<Fr>(b, kb, y);
}

FF_HD void sparse_step3(uint32_t* x, uint32_t* c, int lane, int t,
                        const uint32_t* a, const uint32_t* b,
                        const uint32_t* y4) {
  uint32_t p[8];
  ff::mul<Fr>(p, b, y4);
  if (lane == 0) {
    copy8(c, p);
  } else {
    copy8(c, a);
    if (lane < t) ff::add<Fr>(x, x, p);
  }
}

// The permutation of width t on the warp, on the sparse schedule of K.
template <class W>
FF_HD void permute_warp(W& w, uint32_t* x, int lane, int t,
                        const uint32_t* K) {
  const Sparse L(t);
  lane_add(x, lane, t, K + 8 * L.c_init());
  for (int r = 0; r < kHalfFull; ++r) {
    if (lane < t) sbox(x);
    warp_mix(w, x, lane, t, K + 8 * L.mds());
    if (r < kHalfFull - 1) lane_add(x, lane, t, K + 8 * L.c_full(r));
  }
  lane_add(x, lane, 1, K + 8 * L.d(0));
  for (int i = 0; i < L.rp - 1; ++i) {
    uint32_t y[8], a[8], b[8], q[8], c[8];
    w.bcast(y, x);
    sparse_step1(a, b, lane, t, x, y, K + 8 * L.row(i));
    ff::mul<Fr>(q, a, a);
    w.bcast(y, q);
    sparse_step3(x, c, lane, t, a, b, y);
    w.sum(q, c, t);
    if (lane == 0) copy8(x, q);
    lane_add(x, lane, 1, K + 8 * L.d(i + 1));
  }
  if (lane == 0) sbox(x);
  warp_mix(w, x, lane, t, K + 8 * L.dense());
  lane_add(x, lane, t, K + 8 * L.c_resume());
  for (int r = 0; r < kHalfFull; ++r) {
    if (lane < t) sbox(x);
    warp_mix(w, x, lane, t, K + 8 * L.mds());
    if (r < kHalfFull - 1) lane_add(x, lane, t, K + 8 * L.c_full2(r));
  }
}

// lane's entry of block b's state before the permutation (chain_block's
// rule): the block's inputs on lanes 1.. (block 0) or 2.. (later blocks),
// 0 elsewhere; the running digest, on lane 1, is not read here
FF_HD void chain_input(uint32_t* r, int lane, const uint32_t* src, int n,
                       int b) {
  int start, count, t;
  chain_block(n, b, &start, &count, &t);
  const int first = b == 0 ? 1 : 2;
  if (lane >= first && lane < t) ldg8(r, src + 8 * (start + lane - first));
  else zero8(r);
}

// The chained hash of the n inputs at src on the warp: on return lane
// kOutputIndex holds the digest.  Blocks of width 17 use K17, the chain's
// one narrower block (if any) Kt.  Each block's inputs are read while the
// block before it runs, and the digest stays on lane 1, where the next
// block wants it.
template <class W>
FF_HD void chain_warp(W& w, uint32_t* x, int lane, const uint32_t* src,
                      int n, const uint32_t* K17, const uint32_t* Kt) {
  const int blocks = chain_blocks(n);
  uint32_t next[8];
  chain_input(next, lane, src, n, 0);
  for (int b = 0; b < blocks; ++b) {
    int start, count, t;
    chain_block(n, b, &start, &count, &t);
    if (b == 0 || lane != kOutputIndex) copy8(x, next);
    if (b + 1 < blocks) chain_input(next, lane, src, n, b + 1);
    permute_warp(w, x, lane, t, t == kMaxWidth ? K17 : Kt);
  }
}

}  // namespace pos
