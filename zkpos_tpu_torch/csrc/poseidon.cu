// Poseidon over BN254 Fr on the card: the account tree's node hash, the
// plain-schedule permutation at every width, and whole hash chains.
//
// Replaces zkpos_tpu/ops/poseidon_f32_pallas.py:_perm2_kernel (the
// sparse-MDS Poseidon(2) behind hash2_mont_f32p: zk_poseidon_sparse3) and
// zkpos_tpu/ops/poseidon_pallas.py:_hash2_kernel (the plain-schedule
// Poseidon(2) behind hash2_mont_pallas: zk_poseidon_plain at t = 3).  At
// t = 6 and 17, zk_poseidon_plain and zk_poseidon_chain take the place of
// what zkpos_tpu/ops/poseidon.py ran as XLA code (hash_n_mont and the
// lax.scan of hash_chain_mont).
//
// Bound on the H100: a sparse Poseidon(2) is 604 Montgomery products
// (159,456 32-bit multiplies) against 96 bytes, a plain one 828; a plain
// t = 17 permutation is 22,576 products.  Every launch here is bounded by
// integer multiply throughput, and a chain by its latency: its
// permutations depend on each other.  The TPU kernels emulated 256-bit
// products with bf16 matmuls over 8-bit digits and kept a lazy (1 + e)p
// bound; here a thread runs the fully reduced 8 x 32-bit CIOS product of
// field.cuh on the integer pipes.  The tree and batch kernels run one
// thread per hash (state in registers or local memory, constants through
// the read-only cache, no shared memory).  The chain kernel runs one warp
// per chain: lane i owns state[i], applies its own S-box and computes its
// own row of the MDS product, and the lanes exchange the state through
// shared memory once per round.  Making either fast (sparse partial rounds
// in the chain, more lanes per product) is later work.
#include <cuda_runtime.h>

#include "poseidon.cuh"

using namespace pos;

namespace {

const int kBlock = 128;
const int kChainWarps = 4;

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

// out[i] = Poseidon(a[i], b[i]) on the sparse schedule.  Row i of a and b
// starts at word i * stride, so a tree level (pairs side by side) is read
// in place: a = level, b = level + 8, stride = 16.
__global__ void k_sparse3(uint32_t* out, const uint32_t* a,
                          const uint32_t* b, long long n, long long stride,
                          const uint32_t* K) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[3][8];
  zero8(x[0]);
  ld8(x[1], a + stride * i);
  ld8(x[2], b + stride * i);
  permute_sparse3(x, K);
  st8(out + 8 * i, x[kOutputIndex]);
}

// out[i] = lane kOutputIndex of the permuted state st[i] (T lanes).
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

// One warp per chain of n inputs (chain c reads in[c * n .. c * n + n)).
// Full-width blocks use (C17, M17); the one block of another width, if
// any (the last, or the only one when n < 16), uses (Ct, Mt).
__global__ void k_chain(uint32_t* out, const uint32_t* in, long long chains,
                        int n, const uint32_t* C17, const uint32_t* M17,
                        const uint32_t* Ct, const uint32_t* Mt) {
  __shared__ __align__(16) uint32_t sh[kChainWarps][kMaxWidth][8];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c = (long long)blockIdx.x * kChainWarps + w;
  if (c >= chains) return;                 // whole warps leave together
  const uint32_t* src = in + 8 * c * n;
  uint32_t x[8], digest[8];
  zero8(digest);
  const int blocks = chain_blocks(n);
  for (int b = 0; b < blocks; ++b) {
    int start, count, t;
    chain_block(n, b, &start, &count, &t);
    const uint32_t* C = t == kMaxWidth ? C17 : Ct;
    const uint32_t* M = t == kMaxWidth ? M17 : Mt;
    const int rp = partial_rounds(t);
    const int first = b == 0 ? 1 : 2;      // lane of the first input
    zero8(x);
    if (b > 0 && lane == 1) copy8(x, digest);
    if (lane >= first && lane < t) ld8(x, src + 8 * (start + lane - first));
    for (int r = 0; r < kFullRounds + rp; ++r) {
      if (lane < t) lane_pre(x, lane, r, t, rp, C);
      __syncwarp();
      if (lane < t) st8(sh[w][lane], x);
      __syncwarp();
      if (lane < t) lane_mix(x, lane, t, &sh[w][0][0], M);
    }
    __syncwarp();
    if (lane == kOutputIndex) st8(sh[w][0], x);
    __syncwarp();
    ld8(digest, sh[w][0]);
  }
  if (lane == 0) st8(out + 8 * c, digest);
}

}  // namespace

extern "C" {

int zk_poseidon_sparse3(void* out, const void* a, const void* b, long long n,
                        long long stride, const void* K, void* stream) {
  if (n > 0)
    k_sparse3<<<grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, stride,
        (const uint32_t*)K);
  return (int)cudaGetLastError();
}

// st: n states of t lanes, (n, t, 8); C: (8 + R_P) x t entries; M: t x t.
int zk_poseidon_plain(int t, void* out, const void* st, long long n,
                      const void* C, const void* M, void* stream) {
  switch (t) {
    case 2: return launch_plain<2>(out, st, n, C, M, stream);
    case 3: return launch_plain<3>(out, st, n, C, M, stream);
    case 4: return launch_plain<4>(out, st, n, C, M, stream);
    case 5: return launch_plain<5>(out, st, n, C, M, stream);
    case 6: return launch_plain<6>(out, st, n, C, M, stream);
    case 7: return launch_plain<7>(out, st, n, C, M, stream);
    case 8: return launch_plain<8>(out, st, n, C, M, stream);
    case 9: return launch_plain<9>(out, st, n, C, M, stream);
    case 10: return launch_plain<10>(out, st, n, C, M, stream);
    case 11: return launch_plain<11>(out, st, n, C, M, stream);
    case 12: return launch_plain<12>(out, st, n, C, M, stream);
    case 13: return launch_plain<13>(out, st, n, C, M, stream);
    case 14: return launch_plain<14>(out, st, n, C, M, stream);
    case 15: return launch_plain<15>(out, st, n, C, M, stream);
    case 16: return launch_plain<16>(out, st, n, C, M, stream);
    case 17: return launch_plain<17>(out, st, n, C, M, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// in: chains x n inputs, (chains, n, 8); out: (chains, 8).  (Ct, Mt) are
// the tables of the width of the chain's one narrower block, if it has one.
int zk_poseidon_chain(void* out, const void* in, long long chains, int n,
                      const void* C17, const void* M17, const void* Ct,
                      const void* Mt, void* stream) {
  if (chains > 0)
    k_chain<<<grid_for(chains, kChainWarps), 32 * kChainWarps, 0,
              (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)in, chains, n, (const uint32_t*)C17,
        (const uint32_t*)M17, (const uint32_t*)Ct, (const uint32_t*)Mt);
  return (int)cudaGetLastError();
}

}  // extern "C"
