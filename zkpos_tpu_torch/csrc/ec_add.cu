// Batched complete projective point add, G1 and G2: out[i] = a[i] + b[i];
// and the MSM's Horner over its window sums in one launch.
//
// Replaces zkpos_tpu/ops/ec_pallas.py:_padd_kernel (G1) and
// :_padd2_kernel (G2), the Pallas kernels behind point_add_pallas and
// point_add2_pallas.
//
// Bound on the H100: a G1 add is 12 Fp Montgomery products (9 = 3b by
// doublings) -- 3,168 32-bit multiplies -- against 288 bytes of traffic; a
// G2 add is 42 products (Karatsuba Fp2), 11,088 multiplies, against 576
// bytes.  Both are bounded by integer multiply throughput.  The TPU kernel
// emulated 256-bit products with bf16 matmuls over 8-bit digits; here a
// thread runs one add on fp_ec.cuh's carry-chain core, with values kept
// below 2p between products.  A block stages its operands in shared memory
// through 16-byte loads, neighbouring threads on neighbouring addresses
// (each point's slot padded by 16 bytes, so that a quarter-warp's 16-byte
// reads of eight slots fall on distinct banks), each thread reads its
// operands there where the formula uses them and writes its sum over its
// first operand's slot, and the block stores the sums as it loaded.  So a
// thread holds only the formula's live values.  Output may alias either
// input.
//
// The Horner kernel (zk_g1_horner / zk_g2_horner) is one launch of one
// warp: its (W - 1) c doublings and W - 1 adds are one dependent chain, so
// it runs ec.cuh's schedule of levels, each level's independent products
// on their own lanes, with a dedicated doubling (two product levels a
// doubling, two an add and one for b3 Z of its sum).  It replaces the
// MSM's loop of one-point add launches (two Python calls and two launches
// per window).
#include <cuda_runtime.h>

#include "ec.cuh"

using namespace ff;

namespace {

template <class E>
struct Rows {
  static const int W = Layout<E>::NA * 8;   // 32-bit words a point
  static const int C = W / 4;               // 16-byte pieces a point
  static const int S = W + 4;               // words a shared-memory slot
};

// Blocks of 128 threads; G1 at four blocks an SM (126 registers, no
// spills), G2 at two (238 registers, no spills: at three blocks, 168
// registers, it spills and runs slower, PERF.md)
template <class E> struct Shape;
template <> struct Shape<Fp1> { static const int kBlock = 128, kMin = 4; };
template <> struct Shape<Fp2> { static const int kBlock = 128, kMin = 2; };

template <class E>
__global__ void __launch_bounds__(Shape<E>::kBlock, Shape<E>::kMin)
k_padd(uint32_t* out, const uint32_t* a, const uint32_t* b, long long n,
       int sb) {
  typedef Rows<E> R;
  const int B = Shape<E>::kBlock;
  extern __shared__ uint4 padd_smem[];
  uint32_t* sa = reinterpret_cast<uint32_t*>(padd_smem);
  uint32_t* sq = sa + B * R::S;
  const long long i0 = (long long)blockIdx.x * B;
  const int cnt = n - i0 < B ? (int)(n - i0) : B;
  for (int k = threadIdx.x; k < cnt * R::C; k += B) {
    const int r = k / R::C, q = k % R::C;
    const long long g = (i0 + r) * R::W + 4 * q;
    *reinterpret_cast<uint4*>(sa + r * R::S + 4 * q) =
        *reinterpret_cast<const uint4*>(a + g);
    if (sb)
      *reinterpret_cast<uint4*>(sq + r * R::S + 4 * q) =
          *reinterpret_cast<const uint4*>(b + g);
  }
  if (!sb && threadIdx.x < R::C)
    *reinterpret_cast<uint4*>(sq + 4 * threadIdx.x) =
        *reinterpret_cast<const uint4*>(b + 4 * threadIdx.x);
  __syncthreads();
  if ((int)threadIdx.x < cnt) {
    Point<E>* p = reinterpret_cast<Point<E>*>(sa + threadIdx.x * R::S);
    const Point<E>* q =
        reinterpret_cast<const Point<E>*>(sq + (sb ? threadIdx.x * R::S : 0));
    ToPoint<E> to{p};
    padd_emit(*p, *q, to);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cnt * R::C; k += B) {
    const int r = k / R::C, q = k % R::C;
    *reinterpret_cast<uint4*>(out + (i0 + r) * R::W + 4 * q) =
        *reinterpret_cast<const uint4*>(sa + r * R::S + 4 * q);
  }
}

template <class E>
int launch(void* out, const void* a, const void* b, long long n, int sb,
           void* stream) {
  const int B = Shape<E>::kBlock;
  const int smem = 2 * B * Rows<E>::S * 4;
  if (n > 0) {
    cudaFuncSetAttribute(k_padd<E>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    k_padd<E><<<(unsigned)((n + B - 1) / B), B, smem,
                (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)a,
                                        (const uint32_t*)b, n, sb);
  }
  return (int)cudaGetLastError();
}

// ec.cuh's horner on the lanes of one warp
template <class E>
__global__ void __launch_bounds__(32)
k_horner(uint32_t* out, const uint32_t* rw, int W, int c) {
  __shared__ hs::Mem<E> m;
  hs::Lanes lanes;
  ff::horner<E>(out, rw, W, c, m, lanes);
}

template <class E>
int launch_horner(void* out, const void* rw, int W, int c, void* stream) {
  if (W > 0 && c >= 0)
    k_horner<E><<<1, 32, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)rw, W, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sb = 1: b is a vector of n points; sb = 0: b is one point for all.
int zk_g1_add(void* out, const void* a, const void* b, long long n, int sb,
              void* stream) {
  return launch<Fp1>(out, a, b, n, sb, stream);
}

int zk_g2_add(void* out, const void* a, const void* b, long long n, int sb,
              void* stream) {
  return launch<Fp2>(out, a, b, n, sb, stream);
}

// rw: W window sums (W, na, 8); out: one point.
int zk_g1_horner(void* out, const void* rw, int W, int c, void* stream) {
  return launch_horner<Fp1>(out, rw, W, c, stream);
}

int zk_g2_horner(void* out, const void* rw, int W, int c, void* stream) {
  return launch_horner<Fp2>(out, rw, W, c, stream);
}

}  // extern "C"
