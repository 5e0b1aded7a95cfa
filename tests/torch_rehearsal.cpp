// CPU rehearsal of the port's device arithmetic: the same headers the CUDA
// kernels include, compiled by g++ into a small shared library that
// tests/test_torch_rehearsal.py drives through ctypes.  It is a test aid,
// not a path of the port.
#include "field.cuh"
#include "ec.cuh"
#include "poseidon.cuh"

using namespace ff;

namespace {

template <int T>
void plain_rows(const uint32_t* st, const uint32_t* C, const uint32_t* M,
                uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[T][8];
    for (int j = 0; j < T; ++j) pos::copy8(x[j], st + 8 * (T * i + j));
    pos::permute_plain<T>(x, C, M);
    pos::copy8(out + 8 * i, x[pos::kOutputIndex]);
  }
}

}  // namespace

extern "C" {

// which: 0 = Fr, 1 = Fp.  Arrays are n rows of 8 uint32 limbs.
void rh_mont_mul(int which, const uint32_t* a, const uint32_t* b,
                 uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    if (which == 0) mul<Fr>(out + 8 * i, a + 8 * i, b + 8 * i);
    else mul<Fp>(out + 8 * i, a + 8 * i, b + 8 * i);
  }
}

void rh_fp2_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Fp2 x, y;
    load_coord(x, a + 16 * i);
    load_coord(y, b + 16 * i);
    store_coord(out + 16 * i, x * y);
  }
}

void rh_g1_add(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    store_point(out + 24 * i,
                padd(load_point<Fp1>(a + 24 * i), load_point<Fp1>(b + 24 * i)));
}

void rh_g2_add(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    store_point(out + 48 * i,
                padd(load_point<Fp2>(a + 48 * i), load_point<Fp2>(b + 48 * i)));
}

// Poseidon(2) on the sparse schedule; K is the table of poseidon.cuh.
void rh_poseidon_sparse3(const uint32_t* a, const uint32_t* b,
                         const uint32_t* K, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[3][8];
    pos::zero8(x[0]);
    pos::copy8(x[1], a + 8 * i);
    pos::copy8(x[2], b + 8 * i);
    pos::permute_sparse3(x, K);
    pos::copy8(out + 8 * i, x[pos::kOutputIndex]);
  }
}

// n states of t lanes -> their digests (t = 3, 6 or 17)
int rh_poseidon_plain(int t, const uint32_t* st, const uint32_t* C,
                      const uint32_t* M, uint32_t* out, long n) {
  switch (t) {
    case 3: plain_rows<3>(st, C, M, out, n); return 0;
    case 6: plain_rows<6>(st, C, M, out, n); return 0;
    case 17: plain_rows<17>(st, C, M, out, n); return 0;
    default: return 1;
  }
}

// One chain of n inputs, run as the warp kernel of poseidon.cu runs it:
// the same block schedule and the same per-lane round pieces, with the
// lanes taken one after another and the exchange through `sh`.
void rh_poseidon_chain(const uint32_t* in, int n, const uint32_t* C17,
                       const uint32_t* M17, const uint32_t* Ct,
                       const uint32_t* Mt, uint32_t* out) {
  uint32_t x[pos::kMaxWidth][8], sh[pos::kMaxWidth][8], digest[8];
  pos::zero8(digest);
  for (int b = 0; b < pos::chain_blocks(n); ++b) {
    int start, count, t;
    pos::chain_block(n, b, &start, &count, &t);
    const uint32_t* C = t == pos::kMaxWidth ? C17 : Ct;
    const uint32_t* M = t == pos::kMaxWidth ? M17 : Mt;
    const int rp = pos::partial_rounds(t);
    const int first = b == 0 ? 1 : 2;
    for (int lane = 0; lane < t; ++lane) {
      pos::zero8(x[lane]);
      if (b > 0 && lane == 1) pos::copy8(x[lane], digest);
      if (lane >= first) pos::copy8(x[lane], in + 8 * (start + lane - first));
    }
    for (int r = 0; r < pos::kFullRounds + rp; ++r) {
      for (int lane = 0; lane < t; ++lane)
        pos::lane_pre(x[lane], lane, r, t, rp, C);
      for (int lane = 0; lane < t; ++lane) pos::copy8(sh[lane], x[lane]);
      for (int lane = 0; lane < t; ++lane)
        pos::lane_mix(x[lane], lane, t, &sh[0][0], M);
    }
    pos::copy8(digest, x[pos::kOutputIndex]);
  }
  pos::copy8(out, digest);
}

}  // extern "C"
