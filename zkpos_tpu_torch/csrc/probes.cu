// The measurement probes on the card: the counterparts of the TPU probes
// in scripts/ (probe_conv.py, debug_f32p.py, micro_probe2.py,
// micro_probe3.py, probe_segscan.py), driven by zkpos_tpu_torch/probes/
// (the Poseidon ablations of probe_kernel_split.py are in
// probes_split.cu, the single-pass scan's stages in probes_scan.cu).  Each TPU probe answered a design question
// about one kernel on the TPU; these ask the same of this card:
//
//   * k_rate: the issue rate of one instruction class, from one chain of
//     dependent steps per element (enough elements to fill every SM);
//     bounded by the class's data-sheet rate;
//   * k_conv: the 34-digit f32 convolution, one thread per column with its
//     digits in registers; bounded by FP32 FMAs;
//   * k_prod / k_redc / k_cios: the Montgomery product's stages apart and
//     fused; bounded by 32-bit multiplies;
//   * k_latency: the fused product's latency, dependent products on one
//     warp;
//   * k_scan_local / k_scan_fixup: the port's first scan, three passes
//     (one thread a block of K elements), the yardstick of the single-pass scan of
//     seg_scan.cu; the single-pass scan's own floor and structure are in
//     probes_scan.cu;
//   * k_dot_ffma / k_dot_tf32: the weights-first product W(64,64) @ X(64,N)
//     chained in shared memory, on the FP32 pipes and on the TF32 tensor
//     cores (mma.sync m16n8k8), as the TPU's probe ran it on its MXU.
//
// None of these is on a main path.  Each is the plain form of its
// question, in the layout of the main-path kernel it asks about where one
// runs.  Every entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include "probes.cuh"

using namespace ff;

namespace {

const int kBlock = 128;

inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

__device__ __forceinline__ void ld8(uint32_t* r, const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 x = q[0], y = q[1];
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}

__device__ __forceinline__ void st8(uint32_t* p, const uint32_t* r) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// --- instruction rates -------------------------------------------------------

template <class B>
__global__ void k_rate(typename B::T* out, const typename B::T* x,
                       const typename B::U* b, long long n, int iters) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = probe::chain<B>(x[i], b[i], iters);
}

template <class B>
int launch_rate(void* out, const void* x, const void* b, long long n,
                int iters, void* stream) {
  typedef typename B::T T;
  typedef typename B::U U;
  if (n > 0)
    k_rate<B><<<grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
        (T*)out, (const T*)x, (const U*)b, n, iters);
  return (int)cudaGetLastError();
}

// --- digit convolution -------------------------------------------------------
//
// a, b and out are (34, n) digit planes: digit i of column c at i * n + c,
// so a warp reads 32 neighbouring words per digit.

template <int FORM>
__global__ void k_conv(float* out, const float* a, const float* b,
                       long long n) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float x[probe::kDigits], bb[probe::kDigits];
#pragma unroll
  for (int i = 0; i < probe::kDigits; ++i) {
    x[i] = a[i * n + c];
    bb[i] = b[i * n + c];
  }
  probe::conv_rounds<FORM>(x, bb);
#pragma unroll
  for (int i = 0; i < probe::kDigits; ++i) out[i * n + c] = x[i];
}

// --- the product's stages (Fr, rows of 8 or 16 limbs) -------------------------

__global__ void k_prod(uint32_t* t, const uint32_t* a, const uint32_t* b,
                       long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[16];
  ld8(x, a + 8 * i);
  ld8(y, b + 8 * i);
  probe::prod8(r, x, y);
  st8(t + 16 * i, r);
  st8(t + 16 * i + 8, r + 8);
}

__global__ void k_redc(uint32_t* out, const uint32_t* t, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[16], r[8];
  ld8(x, t + 16 * i);
  ld8(x + 8, t + 16 * i + 8);
  probe::redc8<Fr>(r, x);
  st8(out + 8 * i, r);
}

__global__ void k_cios(uint32_t* out, const uint32_t* a, const uint32_t* b,
                       long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  ld8(x, a + 8 * i);
  ld8(y, b + 8 * i);
  ff::mul<Fr>(r, x, y);
  st8(out + 8 * i, r);
}

// one warp, thread i: out[i] = a[i] b[i]^steps by `steps` dependent
// products (probe::mont_chain); n <= 32
__global__ void __launch_bounds__(32)
k_latency(uint32_t* out, const uint32_t* a, const uint32_t* b, int n,
          int steps) {
  const int i = threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8];
  ld8(x, a + 8 * i);
  ld8(y, b + 8 * i);
  probe::mont_chain(x, y, steps);
  st8(out + 8 * i, x);
}

// --- the three-pass scan --------------------------------------------------------
//
// Thread t owns the K elements from t * K.

template <class E>
__global__ void k_scan_local(const uint32_t* in, const uint8_t* heads,
                             uint32_t* out, uint32_t* agg, uint8_t* agg_flag,
                             long long n, int K) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long start = t * K;
  if (start >= n) return;
  long long end = start + K < n ? start + K : n;
  const int w = Layout<E>::NA * 8;
  Point<E> acc =
      probe::scan_block<E>(in, heads, out, start, end, agg_flag + t);
  store_point(agg + w * t, acc);
}

template <class E>
__global__ void k_scan_fixup(uint32_t* out, const uint8_t* heads,
                             const uint32_t* carry, long long n, int K) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long start = t * K;
  if (t == 0 || start >= n) return;
  long long end = start + K < n ? start + K : n;
  const int w = Layout<E>::NA * 8;
  probe::fixup_block<E>(out, heads, load_point<E>(carry + w * (t - 1)),
                        start, end);
}

template <class E>
int scan_local(const void* in, const void* heads, void* out, void* agg,
               void* agg_flag, long long n, int K, void* stream) {
  long long threads = (n + K - 1) / K;
  if (n > 0)
    k_scan_local<E><<<grid_for(threads, kBlock), kBlock, 0,
                      (cudaStream_t)stream>>>(
        (const uint32_t*)in, (const uint8_t*)heads, (uint32_t*)out,
        (uint32_t*)agg, (uint8_t*)agg_flag, n, K);
  return (int)cudaGetLastError();
}

template <class E>
int scan_fixup(void* out, const void* heads, const void* carry, long long n,
               int K, void* stream) {
  long long threads = (n + K - 1) / K;
  if (threads > 1)
    k_scan_fixup<E><<<grid_for(threads, kBlock), kBlock, 0,
                      (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint8_t*)heads, (const uint32_t*)carry, n, K);
  return (int)cudaGetLastError();
}

// --- weights-first product: Y = W(64,64) @ X(64,N), chained ------------------
//
// X and Y are (64, N) row-major: feature k of column c at k * N + c, the
// layout of the TPU probe (batch on the lanes).  A block owns a slab of
// kCols columns; W and the slab stay in shared memory through the whole
// chain, as the TPU kept them in VMEM.  MIX = false: 8 x (x = W x * 1e-2)
// (micro_probe3.py:117); MIX = true: 4 x (y = W x; x = x 1e-2 + y 1e-3;
// 16 x (x = x 0.999 + 1)) (micro_probe3.py:146).

const int kF = 64;          // features (rows of X, both sides of W)
const int kCols = 64;       // columns per block
const int kLdW = kF + 4;    // padded rows: conflict-free fragment reads
const int kLdX = kCols + 8;

__device__ __forceinline__ float mix_tail(float x, float y) {
  x = x * 1e-2f + y * 1e-3f;
#pragma unroll
  for (int k = 0; k < 16; ++k) x = x * 0.999f + 1.0f;
  return x;
}

__device__ void load_slab(float (*Ws)[kLdW], float (*Xs)[kLdX],
                          const float* W, const float* x, long long n,
                          long long c0) {
  for (int e = threadIdx.x; e < kF * kF; e += blockDim.x)
    Ws[e / kF][e % kF] = W[e];
  for (int e = threadIdx.x; e < kF * kCols; e += blockDim.x)
    Xs[e / kCols][e % kCols] = x[(long long)(e / kCols) * n + c0 + e % kCols];
  __syncthreads();
}

__device__ void store_slab(float* y, float (*Xs)[kLdX], long long n,
                           long long c0) {
  for (int e = threadIdx.x; e < kF * kCols; e += blockDim.x)
    y[(long long)(e / kCols) * n + c0 + e % kCols] = Xs[e / kCols][e % kCols];
}

// FP32: 256 threads; thread (g, c) owns rows 16g .. 16g + 15 of column c,
// summed over k in order with FFMA
template <bool MIX>
__global__ void __launch_bounds__(256) k_dot_ffma(float* y, const float* W,
                                                  const float* x,
                                                  long long n) {
  __shared__ float Ws[kF][kLdW];
  __shared__ float Xs[kF][kLdX];
  const long long c0 = (long long)blockIdx.x * kCols;
  load_slab(Ws, Xs, W, x, n, c0);
  const int c = threadIdx.x % kCols;
  const int r0 = (threadIdx.x / kCols) * 16;
  const int steps = MIX ? 4 : 8;
  for (int s = 0; s < steps; ++s) {
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.0f;
    for (int k = 0; k < kF; ++k) {
      float xk = Xs[k][c];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] += Ws[r0 + r][k] * xk;
    }
    if (MIX) {
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = mix_tail(Xs[r0 + r][c], acc[r]);
    } else {
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] *= 1e-2f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 16; ++r) Xs[r0 + r][c] = acc[r];
    __syncthreads();
  }
  store_slab(y, Xs, n, c0);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return u;
}

// TF32: 4 warps; warp w owns columns 16w .. 16w + 15 (two n-tiles of 8)
// over all 64 rows (four m-tiles of 16): 8 tiles of m16n8k8, 32
// accumulators a thread.  Fragment layouts of the PTX ISA for m16n8k8
// .tf32: g = lane / 4, q = lane % 4; A (row-major) a0 (g, q), a1 (g + 8,
// q), a2 (g, q + 4), a3 (g + 8, q + 4); B (column-major) b0 (q, g), b1
// (q + 4, g); C c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8,
// 2q + 1).
template <bool MIX>
__global__ void __launch_bounds__(128) k_dot_tf32(float* y, const float* W,
                                                  const float* x,
                                                  long long n) {
  __shared__ float Ws[kF][kLdW];
  __shared__ float Xs[kF][kLdX];
  const long long c0 = (long long)blockIdx.x * kCols;
  load_slab(Ws, Xs, W, x, n, c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int steps = MIX ? 4 : 8;
  for (int s = 0; s < steps; ++s) {
    float acc[4][2][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][t][i] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < kF; k0 += 8) {
      uint32_t bf[2][2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = warp * 16 + t * 8 + g;
        bf[t][0] = to_tf32(Xs[k0 + q][col]);
        bf[t][1] = to_tf32(Xs[k0 + q + 4][col]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int row = m * 16 + g;
        uint32_t a0 = to_tf32(Ws[row][k0 + q]);
        uint32_t a1 = to_tf32(Ws[row + 8][k0 + q]);
        uint32_t a2 = to_tf32(Ws[row][k0 + q + 4]);
        uint32_t a3 = to_tf32(Ws[row + 8][k0 + q + 4]);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float* d = acc[m][t];
          asm volatile(
              "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(bf[t][0]),
                "r"(bf[t][1]));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m * 16 + g + (i >= 2 ? 8 : 0);
          const int col = warp * 16 + t * 8 + 2 * q + (i & 1);
          acc[m][t][i] = MIX ? mix_tail(Xs[row][col], acc[m][t][i])
                             : acc[m][t][i] * 1e-2f;
        }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m * 16 + g + (i >= 2 ? 8 : 0);
          const int col = warp * 16 + t * 8 + 2 * q + (i & 1);
          Xs[row][col] = acc[m][t][i];
        }
    __syncthreads();
  }
  store_slab(y, Xs, n, c0);
}

template <bool MIX>
int launch_dot(int route, void* y, const void* W, const void* x, long long n,
               void* stream) {
  unsigned blocks = (unsigned)(n / kCols);
  if (blocks == 0) return (int)cudaGetLastError();
  if (route == 0)
    k_dot_ffma<MIX><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (float*)y, (const float*)W, (const float*)x, n);
  else
    k_dot_tf32<MIX><<<blocks, 128, 0, (cudaStream_t)stream>>>(
        (float*)y, (const float*)W, (const float*)x, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// body: 0 U32Chain, 1 U32MulMask, 2 U32MulAdd, 3 F32Fma, 4 F32Floor,
// 5 U64WideMad.  out[i] = iters x 64 steps of the body from x[i] with b[i].
int zk_probe_rate(int body, void* out, const void* x, const void* b,
                  long long n, int iters, void* stream) {
  switch (body) {
    case 0: return launch_rate<probe::U32Chain>(out, x, b, n, iters, stream);
    case 1: return launch_rate<probe::U32MulMask>(out, x, b, n, iters, stream);
    case 2: return launch_rate<probe::U32MulAdd>(out, x, b, n, iters, stream);
    case 3: return launch_rate<probe::F32Fma>(out, x, b, n, iters, stream);
    case 4: return launch_rate<probe::F32Floor>(out, x, b, n, iters, stream);
    case 5: return launch_rate<probe::U64WideMad>(out, x, b, n, iters, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// form: 0 padloop, 1 grouped, 2 triangle; a, b, out: (34, n) f32
int zk_probe_conv(int form, void* out, const void* a, const void* b,
                  long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  unsigned g = grid_for(n, kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  switch (form) {
    case 0: k_conv<0><<<g, kBlock, 0, s>>>((float*)out, pa, pb, n); break;
    case 1: k_conv<1><<<g, kBlock, 0, s>>>((float*)out, pa, pb, n); break;
    case 2: k_conv<2><<<g, kBlock, 0, s>>>((float*)out, pa, pb, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// stage: 0 product (a, b -> 16 limbs), 1 reduction (a: 16 limbs -> 8),
// 2 CIOS product (a, b -> 8 limbs); Fr
int zk_probe_product(int stage, void* out, const void* a, const void* b,
                     long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  unsigned g = grid_for(n, kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case 0:
      k_prod<<<g, kBlock, 0, s>>>((uint32_t*)out, (const uint32_t*)a,
                                  (const uint32_t*)b, n);
      break;
    case 1:
      k_redc<<<g, kBlock, 0, s>>>((uint32_t*)out, (const uint32_t*)a, n);
      break;
    case 2:
      k_cios<<<g, kBlock, 0, s>>>((uint32_t*)out, (const uint32_t*)a,
                                  (const uint32_t*)b, n);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// n <= 32 rows on one warp, each `steps` dependent products (Fr)
int zk_probe_latency(void* out, const void* a, const void* b, int n,
                     int steps, void* stream) {
  if (n <= 0 || n > 32 || steps < 0) return (int)cudaErrorInvalidValue;
  k_latency<<<1, 32, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, steps);
  return (int)cudaGetLastError();
}

// The three-pass scan on the complete add: the local pass (out, the
// per-thread aggregates and head flags), and the fix-up from the scanned
// aggregates; na = 3 (G1) or 6 (G2)
int zk_probe_scan_local(int na, const void* in, const void* heads, void* out,
                        void* agg, void* agg_flag, long long n, int K,
                        void* stream) {
  if (na == 3)
    return scan_local<Fp1>(in, heads, out, agg, agg_flag, n, K, stream);
  return scan_local<Fp2>(in, heads, out, agg, agg_flag, n, K, stream);
}

int zk_probe_scan_fixup(int na, void* out, const void* heads,
                        const void* carry, long long n, int K, void* stream) {
  if (na == 3) return scan_fixup<Fp1>(out, heads, carry, n, K, stream);
  return scan_fixup<Fp2>(out, heads, carry, n, K, stream);
}

// route: 0 FP32 FFMA, 1 TF32 mma.sync; mix: 0 k_dot, 1 k_mix.  W (64, 64),
// x and y (64, n) f32 row-major, n a multiple of 64.
int zk_probe_dot(int route, int mix, void* y, const void* W, const void* x,
                 long long n, void* stream) {
  if (n % kCols) return (int)cudaErrorInvalidValue;
  return mix ? launch_dot<true>(route, y, W, x, n, stream)
             : launch_dot<false>(route, y, W, x, n, stream);
}

}  // extern "C"
