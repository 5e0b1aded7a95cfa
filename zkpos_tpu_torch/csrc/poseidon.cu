// Poseidon over BN254 Fr on the card: the account tree's node hash, the
// permutation at every width (plain schedule at t = 2, 3, sparse at
// t = 4..17), and whole hash chains.
//
// Replaces zkpos_tpu/ops/poseidon_f32_pallas.py:_perm2_kernel (the
// sparse-MDS Poseidon(2) behind hash2_mont_f32p: zk_poseidon_sparse3) and
// zkpos_tpu/ops/poseidon_pallas.py:_hash2_kernel (the plain-schedule
// Poseidon(2) behind hash2_mont_pallas: zk_poseidon_plain at t = 3).  At
// t = 4..17, zk_poseidon_sparse and zk_poseidon_chain take the place of
// what zkpos_tpu/ops/poseidon.py ran as XLA code (permute, hash_n_mont and
// the lax.scan of hash_chain_mont).  The TPU kernels emulated 256-bit products
// with bf16 matmuls over 8-bit digits and kept a lazy (1 + e)p bound; here
// a thread runs the fully reduced 8 x 32-bit CIOS product of field.cuh on
// the integer pipes.
//
// zk_poseidon_sparse3 and zk_poseidon_plain: one hash per thread, bounded
// by integer multiply throughput (a sparse Poseidon(2) is 604 Montgomery
// products, 159,456 32-bit multiplies, against 96 bytes; a plain one 828).
// The sparse kernel runs in blocks of 1,024 threads, one block to an SM,
// with a block barrier at every partial round: the warps of an SM then run
// the same round's instructions together.  On the 2^26-pair tree level
// that is 1,172 ms against 1,636 ms for the same schedule in blocks of 128
// (PERF.md, one H100 run), 91 % of the bound at the measured multiply
// rate; two or four hashes a thread, for independent products, were slower
// (1,217 and 1,357 ms: the probes path's split_hashes2 / split_hashes4).
//
// zk_poseidon_sparse (k_wide): one permutation a thread at t = 4..17 on the
// sparse schedule (poseidon.cuh permute_wide), for the account leaves
// (t = 6) and the blocks of their asset commitments (t = 17 and a
// narrower tail), all accounts of a tier side by side.  Bounded by integer
// multiplies: 5,424 products a t = 17 permutation, 4.2 times fewer than
// the plain schedule it replaces at these widths.  The state (t x 32 B,
// 544 B at t = 17) sits in the stack frame with the lane loops rolled, as
// the plain kernel's did, so a round's code stays a few products long;
// the tables are read at one address across the warp (a broadcast from
// the read-only cache).  A partial round has 2(t - 1) independent
// products, two a step of its lane loop.  The leaf launches are small
// (59,340 permutations, about 450 threads an SM), so the design cannot
// count on many resident warps to hide a product's latency.
//
// zk_poseidon_chain: one warp per chain, every chain of a launch side by
// side (the CEX commitments of a run of batches).  A chain is 667
// dependent t = 17 permutations, so it is bounded by latency along one
// lane's critical path, not by throughput.  The warp runs
// the sparse-MDS schedule (5,424 products a t = 17 permutation, not the
// plain schedule's 22,576): lane j holds x_j; a partial round takes three
// products in a row on each lane (poseidon.cuh sparse_step1/3) and a
// five-level shuffle sum, a full round the S-box and a share of 10 of the
// 289 mix products on each of 29 lanes, exchanged through shared memory.
// The block stages the tables in shared memory once (96 KB at t = 17).
// That is 318 products on a t = 17 permutation's critical path against
// about 1,520 on the plain schedule.  A 10,000-input chain takes 371 ms,
// 77 in one launch 367 ms (PERF.md): about 1.75 us for each product the
// schedule puts on the critical path, of which one product's latency on a
// lone warp (the probes path's latency_mont, 720 ns) is about 41 %; the
// rest (the exchanges, the adds, the products off that count) is not yet
// taken apart.
#include <cuda_runtime.h>

#include "poseidon.cuh"

using namespace pos;

namespace {

const int kBlock = 128;
const int kSparseBlock = 1024;
// k_wide: threads a block (probes/poseidon_variants.py times other
// choices)
const int kWideBlock = 128;
const int kChainWarps = 4;
const unsigned kFullMask = 0xffffffffu;

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

// out[i] = Poseidon(a[i], b[i]) on the sparse schedule, one hash a
// thread.  Row i of a and b starts at word i * stride, so a tree level
// (pairs side by side) is read in place: a = level, b = level + 8,
// stride = 16.  A block of kSparseBlock threads fills an SM (64 registers
// a thread).  No thread leaves early, since every partial round ends at a
// block barrier (permute_sparse3's SYNC): a thread past n (the tail of the
// last block) hashes zeros and stores nothing.
__global__ void __launch_bounds__(kSparseBlock, 1)
k_sparse3(uint32_t* out, const uint32_t* a, const uint32_t* b, long long n,
          long long stride, const uint32_t* K) {
  const long long i = (long long)blockIdx.x * kSparseBlock + threadIdx.x;
  uint32_t x[1][3][8];
  zero8(x[0][0]);
  zero8(x[0][1]);
  zero8(x[0][2]);
  if (i < n) {
    ld8(x[0][1], a + stride * i);
    ld8(x[0][2], b + stride * i);
  }
  permute_sparse3<1, true>(x, K);
  if (i < n) st8(out + 8 * i, x[0][kOutputIndex]);
}

// out[i] = lane kOutputIndex of the permuted state st[i] (T lanes), on
// the plain schedule (T = 2, 3).
template <int T>
__global__ void k_plain(uint32_t* out, const uint32_t* st, long long n,
                        const uint32_t* C, const uint32_t* M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[T][8];
  for (int j = 0; j < T; ++j) ld8(x[j], st + 8 * (T * i + j));
  permute_plain<T>(x, C, M);
  st8(out + 8 * i, x[kOutputIndex]);
}

template <int T>
int launch_plain(void* out, const void* st, long long n, const void* C,
                 const void* M, void* stream) {
  if (n > 0)
    k_plain<T><<<grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)st, n, (const uint32_t*)C,
        (const uint32_t*)M);
  return (int)cudaGetLastError();
}

// out[i] = lane kOutputIndex of the permuted state st[i] (T = 4..17
// lanes), on the sparse schedule of the width-T table K (permute_wide),
// one permutation a thread.  Every partial round ends at a block barrier,
// so no thread leaves early: a thread past n permutes zeros and stores
// nothing.  The state sits in the thread's stack frame (local memory:
// 32 T bytes, and as much again for the mix's result); in shared memory
// it was no faster on an H100 (probes/poseidon_variants.py, smem).
template <int T>
__global__ void __launch_bounds__(kWideBlock)
k_wide(uint32_t* out, const uint32_t* st, long long n, const uint32_t* K) {
  const long long i = (long long)blockIdx.x * kWideBlock + threadIdx.x;
  uint32_t x[T][8];
  for (int j = 0; j < T; ++j) {
    if (i < n) ld8(x[j], st + 8 * (T * i + j));
    else zero8(x[j]);
  }
  permute_wide<T>(x, K);
  if (i < n) st8(out + 8 * i, x[kOutputIndex]);
}

template <int T>
int launch_wide(void* out, const void* st, long long n, const void* K,
                void* stream) {
  if (n > 0)
    k_wide<T><<<grid_for(n, kWideBlock), kWideBlock, 0,
                (cudaStream_t)stream>>>((uint32_t*)out, (const uint32_t*)st,
                                        n, (const uint32_t*)K);
  return (int)cudaGetLastError();
}

// The warp's exchanges on the card (poseidon.cuh's W): broadcasts and the
// modular sum over shuffles, the dense mix through the warp's slice of
// shared memory.
struct WarpExchange {
  uint32_t* state;
  uint32_t* parts;
  // host versions are never called; the bodies exist on the card only
  FF_HD void sync() {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
  FF_HD void bcast(uint32_t* v, const uint32_t* x) {
#if defined(__CUDA_ARCH__)
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __shfl_sync(kFullMask, x[i], 0);
#endif
  }
  // a butterfly over the lowest power of two of lanes >= t: every lane of
  // that group ends with the group's sum
  FF_HD void sum(uint32_t* s, const uint32_t* c, int t) {
#if defined(__CUDA_ARCH__)
    copy8(s, c);
    int span = 1;
    while (span < t) span <<= 1;
    for (int off = span >> 1; off > 0; off >>= 1) {
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = __shfl_xor_sync(kFullMask, s[i], off);
      ff::add<Fr>(s, s, o);
    }
#endif
  }
};

// copy `entries` table entries from device memory into shared memory,
// 16 bytes a thread at a time
__device__ void stage(uint32_t* dst, const uint32_t* src, int entries) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < 2 * entries; i += blockDim.x) d[i] = __ldg(s + i);
}

// One warp per chain of n inputs (chain c reads in[c * n .. c * n + n)),
// kChainWarps chains a block.  The block first stages the sparse tables
// in shared memory: K17 (e17 entries, 0 when no block of the chain is 17
// wide) and Kt (et entries, the width of the chain's one narrower block,
// 0 when it has none); behind them each warp has kExchange entries of
// exchange area.
__global__ void __launch_bounds__(32 * kChainWarps)
k_chain(uint32_t* out, const uint32_t* in, long long chains, int n,
        const uint32_t* K17, int e17, const uint32_t* Kt, int et) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* k17 = smem;
  uint32_t* kt = k17 + 8 * e17;
  stage(k17, K17, e17);
  stage(kt, Kt, et);
  __syncthreads();
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c = (long long)blockIdx.x * kChainWarps + w;
  if (c >= chains) return;                 // whole warps leave together
  uint32_t* ex = kt + 8 * et + 8 * kExchange * w;
  WarpExchange wx{ex, ex + 8 * kMaxWidth};
  uint32_t x[8];
  chain_warp(wx, x, lane, in + 8 * c * n, n, k17, kt);
  if (lane == kOutputIndex) st8(out + 8 * c, x);
}

}  // namespace

extern "C" {

int zk_poseidon_sparse3(void* out, const void* a, const void* b, long long n,
                        long long stride, const void* K, void* stream) {
  if (n > 0)
    k_sparse3<<<grid_for(n, kSparseBlock), kSparseBlock, 0,
                (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, stride,
        (const uint32_t*)K);
  return (int)cudaGetLastError();
}

// st: n states of t = 2 or 3 lanes, (n, t, 8); C: (8 + R_P) x t entries;
// M: t x t.
int zk_poseidon_plain(int t, void* out, const void* st, long long n,
                      const void* C, const void* M, void* stream) {
  switch (t) {
    case 2: return launch_plain<2>(out, st, n, C, M, stream);
    case 3: return launch_plain<3>(out, st, n, C, M, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// st: n states of t = 4..17 lanes, (n, t, 8); K: the width-t sparse table
// (struct Sparse).
int zk_poseidon_sparse(int t, void* out, const void* st, long long n,
                       const void* K, void* stream) {
  switch (t) {
    case 4: return launch_wide<4>(out, st, n, K, stream);
    case 5: return launch_wide<5>(out, st, n, K, stream);
    case 6: return launch_wide<6>(out, st, n, K, stream);
    case 7: return launch_wide<7>(out, st, n, K, stream);
    case 8: return launch_wide<8>(out, st, n, K, stream);
    case 9: return launch_wide<9>(out, st, n, K, stream);
    case 10: return launch_wide<10>(out, st, n, K, stream);
    case 11: return launch_wide<11>(out, st, n, K, stream);
    case 12: return launch_wide<12>(out, st, n, K, stream);
    case 13: return launch_wide<13>(out, st, n, K, stream);
    case 14: return launch_wide<14>(out, st, n, K, stream);
    case 15: return launch_wide<15>(out, st, n, K, stream);
    case 16: return launch_wide<16>(out, st, n, K, stream);
    case 17: return launch_wide<17>(out, st, n, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// in: chains x n inputs, (chains, n, 8); out: (chains, 8).  K17 and Kt are
// the sparse tables of width 17 and of the width of the chain's one
// narrower block, e17 and et their entries (0: not used by this chain).
int zk_poseidon_chain(void* out, const void* in, long long chains, int n,
                      const void* K17, int e17, const void* Kt, int et,
                      void* stream) {
  if (chains <= 0) return 0;
  const int bytes = 32 * (e17 + et + kChainWarps * kExchange);
  cudaError_t e = cudaFuncSetAttribute(
      k_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k_chain<<<grid_for(chains, kChainWarps), 32 * kChainWarps, bytes,
            (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)in, chains, n, (const uint32_t*)K17,
      e17, (const uint32_t*)Kt, et);
  return (int)cudaGetLastError();
}

}  // extern "C"
