// The measurement probes on the card: the counterparts of the TPU probes
// in scripts/ (probe_conv.py, debug_f32p.py, micro_probe2.py,
// micro_probe3.py, probe_segscan.py), driven by zkpos_tpu_torch/probes/
// (the Poseidon ablations of probe_kernel_split.py are in
// probes_split.cu, the single-pass scan's probes in probes_scan.cu and
// probes_stages*.cu).  Each TPU probe answered a design question
// about one kernel on the TPU; these ask the same of this card:
//
//   * k_rate: the issue rate of one instruction class, from one chain of
//     dependent steps per element (enough elements to fill every SM);
//     bounded by the class's data-sheet rate;
//   * k_conv: the 34-digit f32 convolution, one thread per column with its
//     digits in registers; bounded by FP32 FMAs.  The grouped form runs
//     k_conv_ring: persistent blocks, each thread's next columns streamed
//     into its shared-memory slots by cp.async while it computes;
//   * k_prod / k_redc / k_cios: the Montgomery product's stages apart and
//     fused; bounded by 32-bit multiplies;
//   * k_latency: the fused product's latency, dependent products on one
//     warp;
//   * k_scan_local / k_scan_fixup: the port's first scan, three passes
//     (one thread a block of K elements), the yardstick (three_pass) of
//     the single-pass scan of seg_scan.cu; the single-pass scan's own
//     floor and structure are in probes_scan.cu, its stages in
//     probes_stages.cu;
//   * k_dot_ffma / k_dot_tf32: the weights-first product W(64,64) @ X(64,N)
//     chained in shared memory, on the FP32 pipes (a register tile of 8 x
//     4 outputs a thread) and on the TF32 tensor cores (mma.sync m16n8k8,
//     W's fragments in registers), as the TPU's probe ran it on its MXU:
//     persistent blocks, slabs of X streamed through a cp.async ring.
//
// None of these is on a main path.  Each is the plain form of its
// question, in the layout of the main-path kernel it asks about where one
// runs.  Every entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include "probes.cuh"
#include "seg_scan.cuh"

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

// The grouped form (probes.cuh conv_grouped, conv_walk) in persistent
// blocks of kConvSlab threads.  Bound: the FP32 pipe (1,156 FMAs a round
// and the fold).  Its products go straight into the coefficients, and
// where k_conv's thread loads its 68 digits before its first FMA, here
// each thread fetches its next column's digits by 4-byte cp.async into
// its own slots of a ring of kConvStages stages in shared memory while
// its current column runs from registers, so the copy (408 bytes a
// column) overlaps the rounds.  4 bytes a copy, so any n (a digit row
// starts n words after the last; a 16-byte copy would need n a multiple
// of 4), and a warp still moves a 128-byte line a copy.  Two stages
// (probe::kConvStages; 69,632 bytes a block) hold three blocks an SM (12
// warps, up to 168 registers a thread).  What is left between the rounds
// and the pipe's rate is the compiler's schedule: an FFMA whose three
// sources all come from the register file, two of one parity, costs an
// issue cycle more (probes/conv_variants.py splits the time and reads the
// SASS).
const int kConvSmem =
    4 * probe::kConvStages * probe::kConvRows * probe::kConvSlab;

// conv_walk's memory on the card: 4-byte cp.async into the thread's own
// slots (only the thread itself waits for them), plain stores out
struct ConvAsync {
  static FF_HD void fetch(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(s), "l"(src) : "memory");
#endif
  }
  static FF_HD void commit() {
#if defined(__CUDA_ARCH__)
    scan::cp_commit();
#endif
  }
  template <int N>
  static FF_HD void wait() {
#if defined(__CUDA_ARCH__)
    scan::cp_wait<N>();
#endif
  }
  static FF_HD void put(float* p, float v) { *p = v; }
};

__global__ void __launch_bounds__(probe::kConvSlab, 3)
k_conv_ring(float* out, const float* a, const float* b, long long n) {
  extern __shared__ float4 conv_smem[];
  probe::conv_walk<ConvAsync>(out, a, b, n, blockIdx.x, gridDim.x,
                              threadIdx.x,
                              reinterpret_cast<float*>(conv_smem));
}

// k_conv_ring's blocks resident at once on the current device, which is
// the launch's (a stream of another device fails the launch), found at
// the device's first launch: its shared memory allowed, the occupancy
// asked, then kept.
long long conv_resident() {
  static long long resident[64];    // by device; 0 until found
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(k_conv_ring,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kConvSmem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k_conv_ring, probe::kConvSlab, kConvSmem);
    resident[dev] = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  }
  return resident[dev];
}

int launch_conv_ring(float* out, const float* a, const float* b, long long n,
                     cudaStream_t stream) {
  const long long blocks = probe::conv_blocks(n, conv_resident());
  k_conv_ring<<<(unsigned)blocks, probe::kConvSlab, kConvSmem, stream>>>(
      out, a, b, n);
  return (int)cudaGetLastError();
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
// layout of the TPU probe (batch on the lanes).  MIX = false: 8 x (x = W x
// * 1e-2) (micro_probe3.py:117); MIX = true: 4 x (y = W x; x = x 1e-2 +
// y 1e-3; 16 x (x = x 0.999 + 1)) (micro_probe3.py:146).
//
// Bound: the bytes (X read once, Y written once: 2 GiB at N = 2^22) for
// TF32, the FP32 FMAs (8 x 64 x 64 a column) for FFMA.  Both routes run
// persistent blocks (as many as fit on the card, each walking slabs s =
// blockIdx.x, + gridDim.x, ...) that take W once -- a block a slab would
// read it again each time, 1 GiB through L2 at N = 2^22 -- and stream the
// slabs of 64 columns through a ring of shared-memory buffers by cp.async
// (16 bytes a thread), the next slab or two loading while slab i runs its
// chain in place; each chain step's output goes back into its buffer, and
// Y leaves in 16-byte stores.

const int kF = probe::kDotF;  // features (rows of X, both sides of W)
const int kCols = 64;         // columns a slab
const int kDotSteps = 8;      // products a chain: k_dot's, k_mix's
const int kMixSteps = 4;

// Slab s of x (64 x kCols, 16-byte pieces) into a buffer of row stride
// ld, by cp.async; then the group is committed (empty when the block has
// no slab s).
__device__ __forceinline__ void slab_in(float* buf, int ld, const float* x,
                                        long long n, long long s,
                                        long long slabs) {
  if (s < slabs)
    for (int e = threadIdx.x; e < kF * kCols / 4; e += blockDim.x) {
      const int r = e / (kCols / 4), q = e % (kCols / 4);
      scan::cp_async16(reinterpret_cast<uint32_t*>(buf + r * ld + 4 * q),
                       reinterpret_cast<const uint32_t*>(
                           x + (long long)r * n + s * kCols + 4 * q));
    }
  scan::cp_commit();
}

// FP32: a thread the tile of 8 rows by TC = kTileC columns
// (probe::dot_tile), 512 / TC threads a block; warp w owns columns 4 TC w
// .. 4 TC w + 4 TC - 1 and all 64 rows, so its chain is its own: a warp
// barrier a step.  Lane (g = lane % 8, q = lane / 8) holds rows 4g .. 4g +
// 3 and 32 + 4g .. 35 + 4g, columns 4 TC w + 4q .. + 3 and + 16 .. + 19.
// NS = kFfmaStages slabs in flight a block (four blocks of two warps an
// SM).  The row stride of a slab buffer (68 floats) puts the 8 rows a warp
// stores at once on both halves of the banks.  The tile makes 4 shared
// loads of 16 bytes for 64 FMAs, where a tile of 8 x 4 makes 3 for 32
// (probes/dot_variants.py builds it and times the two).
const int kTileC = 8;
const int kFfmaStages = 2;
const int kLdF = kCols + 4;
const int kLdWt = kF;
const int kFfmaSmem = 4 * (kF * kLdWt + kFfmaStages * kF * kLdF);

template <bool MIX>
__global__ void __launch_bounds__(512 / kTileC, 4)
k_dot_ffma(float* y, const float* W, const float* x, long long n) {
  const int TC = kTileC, NS = kFfmaStages;
  extern __shared__ float4 dot_smem[];
  float* Wt = reinterpret_cast<float*>(dot_smem);
  float* ring = Wt + kF * kLdWt;
  const long long slabs = n / kCols;
  const long long s0 = blockIdx.x, ds = gridDim.x;
  for (int k = 0; k < NS - 1; ++k)
    slab_in(ring + k * kF * kLdF, kLdF, x, n, s0 + k * ds, slabs);
  for (int e = threadIdx.x; e < kF * kF; e += blockDim.x)
    Wt[(e % kF) * kLdWt + e / kF] = W[e];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 4 * (lane % 8), c0 = 4 * TC * warp + 4 * (lane / 8);
  const int steps = MIX ? kMixSteps : kDotSteps;
  for (long long it = 0;; ++it) {
    const long long s = s0 + it * ds;
    if (s >= slabs) break;
    slab_in(ring + ((it + NS - 1) % NS) * kF * kLdF, kLdF, x, n,
            s + (NS - 1) * ds, slabs);
    scan::cp_wait<NS - 1>();
    __syncthreads();
    float* X = ring + (it % NS) * kF * kLdF;
    for (int step = 0; step < steps; ++step) {
      float acc[8][TC], xo[8][TC];
      probe::dot_tile<TC>(acc, Wt, kLdWt, X, kLdF, r0, c0);
      if (MIX) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < TC / 4; ++h)
            probe::ld4(xo[i] + 4 * h,
                       X + probe::dot_row(r0, i) * kLdF + c0 + 16 * h);
      }
      probe::dot_step_tail<MIX, TC>(acc, xo);
      if (step + 1 == steps) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < TC / 4; ++h)
            *reinterpret_cast<float4*>(y + (long long)probe::dot_row(r0, i) * n +
                                       s * kCols + c0 + 16 * h) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
        break;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < TC / 4; ++h)
          *reinterpret_cast<float4*>(X + probe::dot_row(r0, i) * kLdF + c0 +
                                     16 * h) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                          acc[i][4 * h + 2], acc[i][4 * h + 3]);
      __syncwarp();
    }
    __syncthreads();    // the buffer is free for slab it + NS
  }
  scan::cp_wait<0>();
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return u;
}

// TF32: 4 warps; warp w owns rows 32 (w % 2) .. + 31 (two m-tiles of 16)
// and columns 32 (w / 2) .. + 31 (four n-tiles of 8): 8 tiles of m16n8k8,
// 32 accumulators a thread.  Its A fragments, W converted to tf32 once a
// block, stay in 64 registers.  Each chain step's output goes back into
// the slab buffer already rounded to tf32 (the last step's in full), so
// the B fragments of the next step need no conversion; k_mix's old x
// stays in registers at the thread's accumulator positions.  Fragment
// layouts of the PTX ISA for m16n8k8 .tf32: g = lane / 4, q = lane % 4;
// A (row-major) a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q +
// 4); B (column-major) b0 (q, g), b1 (q + 4, g); C c0 (g, 2q), c1 (g, 2q
// + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1).  The row stride (72 floats)
// puts a warp's B reads on 32 banks.
const int kLdT = kCols + 8;

template <bool CVT, int MT, int NT>
__device__ __forceinline__ void tf32_product(float (&acc)[MT][NT][4],
                                             const uint32_t (&a)[MT][8][4],
                                             const float* X, int col,
                                             int g, int q) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][t][i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kF / 8; ++kk) {
    uint32_t b[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = X[(8 * kk + q + 4 * h) * kLdT + col + 8 * t + g];
        b[t][h] = CVT ? to_tf32(v) : __float_as_uint(v);
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float* d = acc[m][t];
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[m][kk][0]), "r"(a[m][kk][1]), "r"(a[m][kk][2]),
              "r"(a[m][kk][3]), "r"(b[t][0]), "r"(b[t][1]));
      }
  }
}

// MT = kMT m-tiles by NT n-tiles a warp, (2, 4): warps share columns in
// pairs, and so a block barrier a step.  kStages slabs in flight a block.
// (probes/dot_variants.py builds a warp of (4, 2), all 64 rows of its 16
// columns at 128 registers of A fragments and a warp barrier a step.)
const int kStages = 3;
const int kMT = 2;

template <bool MIX>
__global__ void __launch_bounds__(128, 3)
k_dot_tf32(float* y, const float* W, const float* x, long long n) {
  const int MT = kMT, NT = 8 / kMT;
  extern __shared__ float4 dot_smem[];
  float* ring = reinterpret_cast<float*>(dot_smem);
  const long long slabs = n / kCols;
  const long long s0 = blockIdx.x, ds = gridDim.x;
  for (int k = 0; k < kStages - 1; ++k)
    slab_in(ring + k * kF * kLdT, kLdT, x, n, s0 + k * ds, slabs);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int row0 = 16 * MT * (warp % (4 / MT));
  const int col = 8 * NT * (warp / (4 / MT));
  uint32_t a[MT][8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int r = row0 + 16 * m + g, k = 8 * kk + q;
      a[m][kk][0] = to_tf32(W[r * kF + k]);
      a[m][kk][1] = to_tf32(W[(r + 8) * kF + k]);
      a[m][kk][2] = to_tf32(W[r * kF + k + 4]);
      a[m][kk][3] = to_tf32(W[(r + 8) * kF + k + 4]);
    }
  // the thread's accumulator positions: (m, t, i) at (row(m, i), col(t, i))
  auto at = [&](float* X, int m, int t, int i) -> float& {
    return X[(row0 + 16 * m + g + (i >= 2 ? 8 : 0)) * kLdT + col + 8 * t +
             2 * q + (i & 1)];
  };
  const int steps = MIX ? kMixSteps : kDotSteps;
  for (long long it = 0;; ++it) {
    const long long s = s0 + it * ds;
    if (s >= slabs) break;
    slab_in(ring + ((it + kStages - 1) % kStages) * kF * kLdT, kLdT, x, n,
            s + (kStages - 1) * ds, slabs);
    scan::cp_wait<kStages - 1>();
    __syncthreads();
    float* X = ring + (it % kStages) * kF * kLdT;
    float xo[MT][NT][4];
    if (MIX) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) xo[m][t][i] = at(X, m, t, i);
    }
    for (int step = 0; step < steps; ++step) {
      float acc[MT][NT][4];
      if (step == 0) tf32_product<true>(acc, a, X, col, g, q);
      else tf32_product<false>(acc, a, X, col, g, q);
      const bool last = step + 1 == steps;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float v = acc[m][t][i];
            v = MIX ? probe::mix_tail(xo[m][t][i], v) : v * 1e-2f;
            if (MIX) xo[m][t][i] = v;
            acc[m][t][i] = last ? v : __uint_as_float(to_tf32(v));
          }
      __syncthreads();    // the step's products read
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) at(X, m, t, i) = acc[m][t][i];
      __syncthreads();    // the step's outputs stored
    }
    // the warp's own rows and columns, 16 bytes a move
    for (int e = lane; e < 16 * MT * 2 * NT; e += 32) {
      const int r = row0 + e / (2 * NT), c = col + 4 * (e % (2 * NT));
      *reinterpret_cast<float4*>(y + (long long)r * n + s * kCols + c) =
          *reinterpret_cast<const float4*>(X + r * kLdT + c);
    }
    __syncthreads();    // the buffer is free for slab it + kStages
  }
  scan::cp_wait<0>();
}

// Persistent blocks: as many as the card holds at once, no more than the
// slabs.
template <bool MIX>
int launch_dot(int route, void* y, const void* W, const void* x, long long n,
               void* stream) {
  const long long slabs = n / kCols;
  if (slabs == 0) return (int)cudaGetLastError();
  void (*k)(float*, const float*, const float*, long long) =
      route == 0 ? k_dot_ffma<MIX> : k_dot_tf32<MIX>;
  const int smem = route == 0 ? kFfmaSmem : 4 * kStages * kF * kLdT;
  const int threads = route == 0 ? 512 / kTileC : 128;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
  const long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  k<<<(unsigned)(blocks < slabs ? blocks : slabs), threads, smem,
      (cudaStream_t)stream>>>((float*)y, (const float*)W, (const float*)x, n);
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
    case 1: return launch_conv_ring((float*)out, pa, pb, n, s);
    case 2: k_conv<2><<<g, kBlock, 0, s>>>((float*)out, pa, pb, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the blocks resident at once that a launch of the grouped form
// (k_conv_ring) on the current device spreads its slabs over
long long zk_probe_conv_resident() { return conv_resident(); }

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
