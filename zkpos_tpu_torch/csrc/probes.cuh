// Device functions of the measurement probes (zkpos_tpu_torch/probes/),
// the counterparts of the TPU probes in scripts/.  Each piece computes
// what its TPU probe computed; csrc/probes*.cu wrap them in kernels, and
// g++ compiles this header too, which is how tests/test_torch_rehearsal.py
// holds every piece against its plain PyTorch version on the CPU.
//
//   * instruction-rate bodies: one dependent step x <- f(x, b), run in
//     chains of kChain steps per load (scripts/micro_probe2.py:70,
//     scripts/micro_probe3.py:69-102), plus the field core's 64-bit wide
//     multiply-add (field.cuh:127);
//   * the 34-digit f32 convolution in three forms with the probe's fold
//     (scripts/probe_conv.py:27-71), and the grouped form's walk of a
//     persistent block over slabs of columns;
//   * the Montgomery product split into its stages: 8 x 8-limb schoolbook
//     product, reduction of 16 limbs to 8, and the CIOS product without
//     its final subtraction (scripts/debug_f32p.py:38,73);
//   * the sparse Poseidon(2) of poseidon.cuh as one template over an
//     ablation policy (scripts/probe_kernel_split.py:28);
//   * the three-pass segmented scan's serial block pass and fix-up on
//     ec.cuh's complete add (scripts/probe_segscan.py:101), and the
//     limb-wise wrapping add that the single-pass scan's structure probe
//     runs in place of it (scripts/probe_segscan.py:19);
//   * the weights-first product's FP32 register tile and its elementwise
//     steps (scripts/micro_probe3.py:117,146).
//
// Nothing here is on a main path: the kernels of seg_scan.cu and
// poseidon.cu are left as they are, and the ablations are copies of their
// schedules over policies, held to the originals by the `full` variants.
#pragma once

#include <math.h>

#include "ec.cuh"
#include "field.cuh"
#include "poseidon.cuh"

namespace probe {

using ff::Fr;

// CH of the TPU probes: dependent steps per load
const int kChain = 64;

// --- instruction-rate bodies ---------------------------------------------
//
// T is the chained state, U the per-element operand.  The comment names
// the instructions each step should compile to on sm_90a; the probe logs
// the counts cuobjdump finds.

// (x*b + b) & 0xFFFF: IMAD + LOP3 (micro_probe2.py:74)
struct U32Chain {
  typedef uint32_t T;
  typedef uint32_t U;
  static FF_HD T step(T x, U b) { return (x * b + b) & 0xFFFFu; }
};

// (x*b) & 0xFFFF: IMAD + LOP3 (micro_probe3.py:72)
struct U32MulMask {
  typedef uint32_t T;
  typedef uint32_t U;
  static FF_HD T step(T x, U b) { return (x * b) & 0xFFFFu; }
};

// x*b + b, wrapping: one IMAD (micro_probe3.py:82)
struct U32MulAdd {
  typedef uint32_t T;
  typedef uint32_t U;
  static FF_HD T step(T x, U b) { return x * b + b; }
};

// x*b + b: one FFMA, by contraction (micro_probe3.py:95)
struct F32Fma {
  typedef float T;
  typedef float U;
  static FF_HD T step(T x, U b) { return x * b + b; }
};

// f = floor(x / 256); x = (x - 256 f) + b: FMUL, FRND.FLOOR, FFMA, FADD
// (micro_probe3.py:105-107)
struct F32Floor {
  typedef float T;
  typedef float U;
  static FF_HD T step(T x, U b) {
    float f = floorf(x * (1.0f / 256.0f));
    return (x - 256.0f * f) + b;
  }
};

// The field core's step, s = a*b + t + c with a 64-bit result whose low
// word is the next limb and high word the next carry (field.cuh:127): the
// state s holds (carry, limb); IMAD.WIDE.U32 and the 64-bit adds.
struct U64WideMad {
  typedef uint64_t T;
  typedef uint32_t U;
  static FF_HD T step(T s, U b) {
    return (uint64_t)(uint32_t)s * b + b + (s >> 32);
  }
};

// iters x kChain dependent steps of body B from x; the outer loop is kept
// rolled, so that one pass of the compiled loop is kChain steps (the rate
// probe reads its instructions per step from that loop's SASS)
#if defined(__CUDACC__)
#define PROBE_ROLLED _Pragma("unroll 1")
#else
#define PROBE_ROLLED
#endif
template <class B>
FF_HD typename B::T chain(typename B::T x, typename B::U b, int iters) {
  PROBE_ROLLED
  for (int it = 0; it < iters; ++it) {
    FF_UNROLL
    for (int k = 0; k < kChain; ++k) x = B::step(x, b);
  }
  return x;
}

// --- the 34-digit f32 convolution (probe_conv.py) --------------------------

const int kDigits = 34;
const int kCoeffs = 2 * kDigits - 1;
const int kConvReps = 8;      // REPS: dependent convolutions per load

// c = a * b, 34 x 34 products summed in i order (conv_padloop, :27)
FF_HD void conv_padloop(float* c, const float* a, const float* b) {
  FF_UNROLL
  for (int k = 0; k < kCoeffs; ++k) c[k] = 0.0f;
  FF_UNROLL
  for (int i = 0; i < kDigits; ++i) {
    FF_UNROLL
    for (int j = 0; j < kDigits; ++j) c[i + j] += a[i] * b[j];
  }
}

// the same products grouped by residue class r = i mod 8, as the TPU's
// conv_grouped (:35) groups them: r, then q, then j, each product
// a[8q + r] * b[j] FMA'd straight into c[8q + r + j].  The TPU summed each
// class into a partial sum of its own and merged the eight shifted by r,
// which turned its 34 misaligned sublane shifts into 8; here a shift is a
// register's name, and the merge would only add its 414 adds a round.
FF_HD void conv_grouped(float* c, const float* a, const float* b) {
  FF_UNROLL
  for (int k = 0; k < kCoeffs; ++k) c[k] = 0.0f;
  FF_UNROLL
  for (int r = 0; r < 8; ++r)
    FF_UNROLL
    for (int q = 0; 8 * q + r < kDigits; ++q)
      FF_UNROLL
      for (int j = 0; j < kDigits; ++j)
        c[8 * q + r + j] += a[8 * q + r] * b[j];
}

// c = a * a from the products with i <= j, the off-diagonal ones doubled
// through 2a (conv_triangle, :51)
FF_HD void conv_triangle(float* c, const float* a) {
  FF_UNROLL
  for (int k = 0; k < kCoeffs; ++k) c[k] = 0.0f;
  FF_UNROLL
  for (int i = 0; i < kDigits; ++i) {
    c[2 * i] += a[i] * a[i];
    FF_UNROLL
    for (int j = i + 1; j < kDigits; ++j) c[i + j] += a[i] * (a[j] + a[j]);
  }
}

// the probe's fold back to 34 digits, so that the rounds depend on each
// other: x = c[:34] * 1e-7 + pad(c[34:], 1) * 1e-7 + b (probe_conv.py:71)
FF_HD void conv_fold(float* x, const float* c, const float* b) {
  FF_UNROLL
  for (int i = 0; i < kDigits; ++i) {
    float hi = i + kDigits < kCoeffs ? c[i + kDigits] : 0.0f;
    x[i] = c[i] * 1e-7f + hi * 1e-7f + b[i];
  }
}

// form: 0 padloop, 1 grouped, 2 triangle (x * x; b enters in the fold)
template <int FORM>
FF_HD void conv_rounds(float* x, const float* b) {
  float c[kCoeffs];
  for (int r = 0; r < kConvReps; ++r) {
    if (FORM == 0) conv_padloop(c, x, b);
    else if (FORM == 1) conv_grouped(c, x, b);
    else conv_triangle(c, x);
    conv_fold(x, c, b);
  }
}

// --- the grouped form's persistent walk (probes.cu k_conv_ring) -----------
//
// A block of kConvSlab threads, one a column, walks the slabs of kConvSlab
// columns blk, blk + blocks, blk + 2 blocks, ... (persistent blocks: as
// many as the card holds at once, no more than the slabs).  Thread t's
// k-th column is conv_column(blk, blocks, t, k); its columns grow with k,
// so its walk ends at its first column at or past n, in the last slab (a
// ragged one ends some threads' walks there) or after it.  Each thread
// owns its slots of the block's ring of kConvStages stages in shared
// memory (row i of thread t at i * kConvSlab + t, so a warp reads 32
// neighbouring words) and fetches its own columns' 68 digits into them,
// kConvStages - 1 columns ahead, through the Mem policy: 4-byte cp.async on the card, a plain
// copy under g++.  No other thread reads a thread's slots, so no barrier
// is needed; a column's 8 rounds run from registers while the thread's
// next columns load, and its 34 outputs leave from registers (a block's
// row of a digit is 512 contiguous bytes).

const int kConvSlab = 128;           // columns a slab: a block's threads
const int kConvRows = 2 * kDigits;   // a stage's rows: a's digits, b's
const int kConvStages = 2;           // the ring's stages

// the blocks of a launch: those resident at once, no more than the slabs
FF_HD long long conv_blocks(long long n, long long resident) {
  const long long slabs = (n + kConvSlab - 1) / kConvSlab;
  return resident < slabs ? resident : slabs;
}

FF_HD long long conv_column(long long blk, long long blocks, int t,
                            long long k) {
  return (blk + k * blocks) * kConvSlab + t;
}

// column c's digits into its slots (row i at slot[i * kConvSlab]) when c
// < n; then the group is committed (empty past n)
template <class Mem>
FF_HD void conv_fetch(float* slot, const float* a, const float* b,
                      long long n, long long c) {
  if (c < n) {
    const float* pa = a + c;
    const float* pb = b + c;
    FF_UNROLL
    for (int i = 0; i < kDigits; ++i, pa += n, pb += n) {
      Mem::fetch(slot + i * kConvSlab, pa);
      Mem::fetch(slot + (kDigits + i) * kConvSlab, pb);
    }
  }
  Mem::commit();
}

// Thread t of block blk: its walk over the block's ring of NS =
// kConvStages stages.  Column k
// sits in stage k % NS; column k + NS - 1 is fetched into the stage that
// column k - 1 was read from, whose digits the rounds have consumed.
template <class Mem>
FF_HD void conv_walk(float* out, const float* a, const float* b,
                     long long n, long long blk, long long blocks, int t,
                     float* ring) {
  const int NS = kConvStages, stage = kConvRows * kConvSlab;
  float* mine = ring + t;
  for (int k = 0; k < NS - 1; ++k)
    conv_fetch<Mem>(mine + k * stage, a, b, n,
                    conv_column(blk, blocks, t, k));
  int cur = 0;
  for (long long k = 0;; ++k) {
    const long long c = conv_column(blk, blocks, t, k);
    if (c >= n) break;
    conv_fetch<Mem>(mine + (cur == 0 ? NS - 1 : cur - 1) * stage, a, b, n,
                    conv_column(blk, blocks, t, k + NS - 1));
    Mem::template wait<NS - 1>();
    const float* s = mine + cur * stage;
    float x[kDigits], bb[kDigits];
    FF_UNROLL
    for (int i = 0; i < kDigits; ++i) {
      x[i] = s[i * kConvSlab];
      bb[i] = s[(kDigits + i) * kConvSlab];
    }
    conv_rounds<1>(x, bb);
    float* po = out + c;
    FF_UNROLL
    for (int i = 0; i < kDigits; ++i, po += n) Mem::put(po, x[i]);
    cur = cur + 1 == NS ? 0 : cur + 1;
  }
  Mem::template wait<0>();
}

// --- the Montgomery product in stages (R = 2^256) ---------------------------

// t = a * b, 16 limbs, operand scanning (the counterpart of k_conv)
FF_HD void prod8(uint32_t* t, const uint32_t* a, const uint32_t* b) {
  FF_UNROLL
  for (int k = 0; k < 16; ++k) t[k] = 0;
  FF_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    FF_UNROLL
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
}

// r = t / R mod p for t < p R, fully reduced: one m per limb, each row's
// carry kept in `ext` for the column above it (the counterpart of k_red's
// reduction half).  t + m p < 2 p R, so one subtraction reduces it.
template <class F>
FF_HD void redc8(uint32_t* r, const uint32_t* t_in) {
  uint32_t t[16];
  FF_UNROLL
  for (int k = 0; k < 16; ++k) t[k] = t_in[k];
  uint32_t ext = 0;
  FF_UNROLL
  for (int i = 0; i < 8; ++i) {
    uint32_t m = t[i] * F::n0();
    uint64_t c = 0;
    FF_UNROLL
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)m * F::limb(j) + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + 8] + c + ext;
    t[i + 8] = (uint32_t)s;
    ext = (uint32_t)(s >> 32);
  }
  if (ff::geq_mod<F>(t + 8, ext)) ff::sub_mod_raw<F>(t + 8);
  FF_UNROLL
  for (int k = 0; k < 8; ++k) r[k] = t[8 + k];
}

// ff::mul's CIOS loop without its final conditional subtraction: the low
// 256 bits of (a b + m p) / R, below 2p when a, b < 2p (a lazy bound)
template <class F>
FF_HD void mul_lazy(uint32_t* r, const uint32_t* a, const uint32_t* b) {
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
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = t[i];
}

// x <- x b (field.cuh's fused product in Fr) `steps` times, each product
// waiting on the one before: the latency of one product, as a lone warp of
// the chain kernel pays it on its critical path
FF_HD void mont_chain(uint32_t* x, const uint32_t* b, int steps) {
  for (int s = 0; s < steps; ++s) ff::mul<Fr>(x, x, b);
}

// --- the sparse Poseidon(2) over an ablation policy ---------------------------
//
// A policy gives the product (mul) and the read of a table entry (ld).
// Each variant keeps a data dependence on the inputs, so that only the
// work it names is removed.

// full: poseidon.cuh's own product and constant reads
struct PFull {
  FF_HD void init(const uint32_t*) {}
  FF_HD void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) const {
    ff::mul<Fr>(r, a, b);
  }
  FF_HD void ld(uint32_t* r, const uint32_t* p) const { pos::ldc(r, p); }
};

// noproduct (TPU noconv): a product becomes one limb-wise multiply, the
// top limb cut to 28 bits so that the value stays below r
struct PNoProduct : PFull {
  FF_HD void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) const {
    FF_UNROLL
    for (int i = 0; i < 8; ++i) r[i] = a[i] * b[i];
    r[7] &= 0x0FFFFFFFu;
  }
};

// noreduce (TPU nomm): the schoolbook product kept, the reduction skipped:
// the high half a b / 2^256, below r for a, b < r
struct PNoReduce : PFull {
  FF_HD void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) const {
    uint32_t t[16];
    prod8(t, a, b);
    FF_UNROLL
    for (int i = 0; i < 8; ++i) r[i] = t[8 + i];
  }
};

// nofinalsub (TPU noglue): the CIOS product without its final subtraction
struct PNoFinalSub : PFull {
  FF_HD void mul(uint32_t* r, const uint32_t* a, const uint32_t* b) const {
    mul_lazy<Fr>(r, a, b);
  }
};

// noconst: every table read replaced by a value computed from the entry's
// index e, limb i = (8 e + i + 1) * kNoConstMul mod 2^32 (the top limb cut
// to 28 bits): no load is issued.  The values differ by entry, as the
// table's do, so the compiler can merge no product that the full schedule
// makes; they fold into immediates where the index is known at compile
// time and cost an add a limb where it is not (the partial rounds' loop).
const uint32_t kNoConstMul = 0x9E3779B1u;
struct PNoConst : PFull {
  const uint32_t* base;
  FF_HD void init(const uint32_t* K) { base = K; }
  FF_HD void ld(uint32_t* r, const uint32_t* p) const {
    uint32_t w = (uint32_t)(p - base);          // 8 e
    FF_UNROLL
    for (int i = 0; i < 8; ++i) r[i] = (w + i + 1) * kNoConstMul;
    r[7] &= 0x0FFFFFFFu;
  }
};

// The sparse schedule at one hash a thread over a policy.  STACK sends
// every lane index through `z` (0 at run time, unknown to the compiler),
// which forces the state into a local array as k_plain's is.  SYNC puts a
// block barrier at every partial round (pos::block_sync), as the main
// kernel does.
template <class P, bool STACK, bool SYNC = false>
struct Sparse3 {
  const P& pol;
  int z;

  FF_HD uint32_t* lane(uint32_t (*x)[8], int j) const {
    return x[STACK ? (j ^ z) : j];
  }
  FF_HD void sbox(uint32_t* x) const {
    uint32_t x2[8], x4[8];
    pol.mul(x2, x, x);
    pol.mul(x4, x2, x2);
    pol.mul(x, x4, x);
  }
  FF_HD void add_c(uint32_t* x, const uint32_t* c) const {
    uint32_t k[8];
    pol.ld(k, c);
    ff::add<Fr>(x, x, k);
  }
  FF_HD void fma_c(uint32_t* acc, const uint32_t* c, const uint32_t* x) const {
    uint32_t k[8], p[8];
    pol.ld(k, c);
    pol.mul(p, k, x);
    ff::add<Fr>(acc, acc, p);
  }
  FF_HD void mix_dense3(uint32_t (*x)[8], const uint32_t* M) const {
    uint32_t nx[3][8];
    for (int i = 0; i < 3; ++i) {
      uint32_t acc[8];
      pos::zero8(acc);
      for (int j = 0; j < 3; ++j) fma_c(acc, M + 8 * (i * 3 + j), lane(x, j));
      pos::copy8(nx[i], acc);
    }
    for (int i = 0; i < 3; ++i) pos::copy8(lane(x, i), nx[i]);
  }
  FF_HD void full_round3(uint32_t (*x)[8], const uint32_t* K,
                         const uint32_t* c_next) const {
    for (int i = 0; i < 3; ++i) sbox(lane(x, i));
    mix_dense3(x, K + 8 * pos::sparse3::kMds);
    if (c_next)
      for (int i = 0; i < 3; ++i) add_c(lane(x, i), c_next + 8 * i);
  }
  FF_HD void permute(uint32_t (*x)[8], const uint32_t* K) const {
    using namespace pos::sparse3;
    const int half = pos::kHalfFull;
    for (int i = 0; i < T; ++i) add_c(lane(x, i), K + 8 * (kCInit + i));
    for (int r = 0; r < half; ++r)
      full_round3(x, K, r < half - 1 ? K + 8 * (kCFull + T * r) : 0);
    add_c(lane(x, 0), K + 8 * kD);
    for (int i = 0; i < RP; ++i) {
      if (SYNC) pos::block_sync();
      sbox(lane(x, 0));
      if (i < RP - 1) {
        const uint32_t* row = K + 8 * (kSparse + kRow * i);
        uint32_t x0[8];
        pos::zero8(x0);
        for (int j = 0; j < T; ++j) fma_c(x0, row + 8 * j, lane(x, j));
        for (int j = 1; j < T; ++j)
          fma_c(lane(x, j), row + 8 * (T - 1 + j), lane(x, 0));
        pos::copy8(lane(x, 0), x0);
        add_c(lane(x, 0), K + 8 * (kD + i + 1));
      } else {
        mix_dense3(x, K + 8 * kDense);
        for (int j = 0; j < T; ++j) add_c(lane(x, j), K + 8 * (kCResume + j));
      }
    }
    for (int r = 0; r < half; ++r)
      full_round3(x, K, r < half - 1 ? K + 8 * (kCFull2 + T * r) : 0);
  }
};

// one hash of the variant: out = lane 1 of the permuted (0, a, b)
template <class P, bool STACK, bool SYNC = false>
FF_HD void sparse3_hash(uint32_t* out, const uint32_t* a, const uint32_t* b,
                        const uint32_t* K, int z) {
  P pol;
  pol.init(K);
  Sparse3<P, STACK, SYNC> s{pol, z};
  uint32_t x[3][8];
  pos::zero8(x[0]);
  pos::copy8(x[1], a);
  pos::copy8(x[2], b);
  s.permute(x, K);
  pos::copy8(out, s.lane(x, pos::kOutputIndex));
}

// registers: the same schedule with every lane loop unrolled, so that each
// index into the state is known at compile time and the state stays in
// registers (no stack frame); one hash a thread, poseidon.cuh's product
FF_HD void sparse3_registers(uint32_t* out, const uint32_t* a,
                             const uint32_t* b, const uint32_t* K) {
  using namespace pos::sparse3;
  uint32_t x[3][8], k[8];
  pos::zero8(x[0]);
  pos::copy8(x[1], a);
  pos::copy8(x[2], b);
  auto full = [&](const uint32_t* c_next) {
    uint32_t nx[3][8];
    FF_UNROLL
    for (int i = 0; i < 3; ++i) pos::sbox(x[i]);
    FF_UNROLL
    for (int i = 0; i < 3; ++i) {
      pos::zero8(nx[i]);
      FF_UNROLL
      for (int j = 0; j < 3; ++j) pos::fma_c(nx[i], K + 8 * (kMds + 3 * i + j), x[j]);
    }
    FF_UNROLL
    for (int i = 0; i < 3; ++i) {
      pos::copy8(x[i], nx[i]);
      if (c_next) pos::add_c(x[i], c_next + 8 * i);
    }
  };
  FF_UNROLL
  for (int i = 0; i < T; ++i) pos::add_c(x[i], K + 8 * (kCInit + i));
  for (int r = 0; r < pos::kHalfFull; ++r)
    full(r < pos::kHalfFull - 1 ? K + 8 * (kCFull + T * r) : 0);
  pos::add_c(x[0], K + 8 * kD);
  for (int i = 0; i < RP - 1; ++i) {
    const uint32_t* row = K + 8 * (kSparse + kRow * i);
    uint32_t y[8];
    pos::sbox(x[0]);
    pos::zero8(y);
    FF_UNROLL
    for (int j = 0; j < T; ++j) pos::fma_c(y, row + 8 * j, x[j]);
    FF_UNROLL
    for (int j = 1; j < T; ++j) pos::fma_c(x[j], row + 8 * (T - 1 + j), x[0]);
    pos::ldc(k, K + 8 * (kD + i + 1));
    ff::add<Fr>(x[0], y, k);
  }
  pos::sbox(x[0]);
  {
    uint32_t nx[3][8];
    FF_UNROLL
    for (int i = 0; i < 3; ++i) {
      pos::zero8(nx[i]);
      FF_UNROLL
      for (int j = 0; j < 3; ++j) pos::fma_c(nx[i], K + 8 * (kDense + 3 * i + j), x[j]);
    }
    FF_UNROLL
    for (int i = 0; i < 3; ++i) {
      pos::copy8(x[i], nx[i]);
      pos::add_c(x[i], K + 8 * (kCResume + i));
    }
  }
  for (int r = 0; r < pos::kHalfFull; ++r)
    full(r < pos::kHalfFull - 1 ? K + 8 * (kCFull2 + T * r) : 0);
  pos::copy8(out, x[pos::kOutputIndex]);
}

// --- segmented-scan pieces ------------------------------------------------

// A limb-wise wrapping add of every coordinate, r = p + q (r may alias
// either): the scan's structure with almost no arithmetic (TPU stages 1-4
// combined with `x + part`).  It is associative and commutative limb by
// limb, so a scan over it equals the limb-wise prefix sums mod 2^32 in any
// order of adds.  seg_scan.cuh's pieces take it in place of the complete
// add (csrc/probes_scan.cu's structure kernels).
struct WrapAdd {
  static FF_HD ff::Fp1 wrap(const ff::Fp1& a, const ff::Fp1& b) {
    ff::Fp1 r;
    FF_UNROLL
    for (int i = 0; i < 8; ++i) r.v[i] = a.v[i] + b.v[i];
    return r;
  }
  static FF_HD ff::Fp2 wrap(const ff::Fp2& a, const ff::Fp2& b) {
    return ff::Fp2{wrap(a.c0, b.c0), wrap(a.c1, b.c1)};
  }
  template <class E>
  FF_HD void operator()(ff::Point<E>& r, const ff::Point<E>& p,
                        const ff::Point<E>& q) const {
    r = ff::Point<E>{wrap(p.x, q.x), wrap(p.y, q.y), wrap(p.z, q.z)};
  }
};

// The three-pass scan's pass 1 (the port's first seg_scan.cu) for the
// block [start, end) of a stream of points of w words: out holds its
// serial scan; returns the block's aggregate and whether the block held a
// head
template <class E>
FF_HD ff::Point<E> scan_block(const uint32_t* in, const uint8_t* heads,
                              uint32_t* out, long long start, long long end,
                              uint8_t* flag) {
  const int w = ff::Layout<E>::NA * 8;
  ff::Point<E> acc = ff::load_point<E>(in + w * start);
  uint8_t f = heads[start];
  ff::store_point(out + w * start, acc);
  for (long long i = start + 1; i < end; ++i) {
    ff::Point<E> p = ff::load_point<E>(in + w * i);
    if (heads[i]) {
      acc = p;
      f = 1;
    } else {
      acc = ff::padd(acc, p);
    }
    ff::store_point(out + w * i, acc);
  }
  *flag = f;
  return acc;
}

// The three-pass scan's fix-up of one block: the carry of the blocks
// before it added to its elements before its first head
template <class E>
FF_HD void fixup_block(uint32_t* out, const uint8_t* heads,
                       const ff::Point<E>& carry, long long start,
                       long long end) {
  const int w = ff::Layout<E>::NA * 8;
  for (long long i = start; i < end && !heads[i]; ++i)
    ff::store_point(out + w * i,
                    ff::padd(carry, ff::load_point<E>(out + w * i)));
}

// --- the weights-first product's FP32 tile --------------------------------
//
// Y = W(64, 64) X(64, 64) of one slab of 64 columns, one thread an outer
// product of 8 rows by TC columns (dot_tile).  Wt holds W transposed
// (Wt[k ldw + r] = W[r][k]), X the slab (X[k ldx + c]); both 16-byte
// aligned with 16-byte row strides.  For each k the thread reads W's
// column as two 16-byte pieces and X's row as TC / 4, and makes 8 TC FMAs
// (64 FMAs to 4 shared-memory loads at TC = 8).  Each sum runs over k in
// ascending order from 0.0f, one fmaf a product, as the one-FMA-a-load
// form before it did, so the products round alike.

const int kDotF = 64;     // features: W's rows and columns, X's rows

// r = p[0 .. 3], p 16-byte aligned: one 16-byte load on the card
FF_HD void ld4(float* r, const float* p) {
#if defined(__CUDACC__)
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
#else
  for (int i = 0; i < 4; ++i) r[i] = p[i];
#endif
}

// The tile's row i (0 .. 7): r0 + i for i < 4, r0 + 28 + i after; its
// column j (0 .. TC - 1): c0 + j, and for a tile of 8 columns c0 + 12 + j
// after the first 4.
FF_HD int dot_row(int r0, int i) { return r0 + (i < 4 ? i : 28 + i); }
FF_HD int dot_col(int c0, int j) { return c0 + (j < 4 ? j : 12 + j); }

// The tile of 8 rows by TC = 4 or 8 columns: per k, W's column as two
// 16-byte pieces and X's row as TC / 4, for 8 TC FMAs.
template <int TC>
FF_HD void dot_tile(float (&acc)[8][TC], const float* Wt, int ldw,
                    const float* X, int ldx, int r0, int c0) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i)
    FF_UNROLL
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;
#if defined(__CUDACC__)
#pragma unroll 8
#endif
  for (int k = 0; k < kDotF; ++k) {
    float a[8], x[TC];
    ld4(a, Wt + k * ldw + r0);
    ld4(a + 4, Wt + k * ldw + r0 + 32);
    FF_UNROLL
    for (int h = 0; h < TC / 4; ++h)
      ld4(x + 4 * h, X + k * ldx + c0 + 16 * h);
    FF_UNROLL
    for (int i = 0; i < 8; ++i)
      FF_UNROLL
      for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
  }
}

// k_mix's elementwise steps after its product y (micro_probe3.py:153-156):
// x = x 1e-2 + y 1e-3, then 16 dependent x = x 0.999 + 1
FF_HD float mix_tail(float x, float y) {
  x = x * 1e-2f + y * 1e-3f;
  FF_UNROLL
  for (int k = 0; k < 16; ++k) x = x * 0.999f + 1.0f;
  return x;
}

// One chain step's elementwise part for the tile: k_dot scales the
// product by 1e-2; k_mix runs mix_tail on the tile's old x (xo) and the
// product.  acc becomes the tile's new x.
template <bool MIX, int TC>
FF_HD void dot_step_tail(float (&acc)[8][TC], const float (&xo)[8][TC]) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i)
    FF_UNROLL
    for (int j = 0; j < TC; ++j)
      acc[i][j] = MIX ? mix_tail(xo[i][j], acc[i][j]) : acc[i][j] * 1e-2f;
}

}  // namespace probe
