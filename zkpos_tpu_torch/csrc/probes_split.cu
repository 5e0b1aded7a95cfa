// The sparse Poseidon(2) ablations of the probes path
// (zkpos_tpu_torch/probes/probe_kernel_split.py), the counterpart of
// scripts/probe_kernel_split.py: poseidon.cu's k_sparse3 (the tree's node
// hash) rebuilt over a policy of probes.cuh (probe::Sparse3) with one part
// of its work taken out at a time, in k_sparse3's layout (blocks of 1,024,
// a barrier each partial round) and in others, and k_split_hashes,
// k_sparse3 at two or four hashes a thread.  Bound: 32-bit multiplies at
// the INT32 rate.  Not on a main path.  A source of its own, so that nvcc
// builds these eleven permutations beside the rest of probes.cu.  Every
// entry point returns cudaGetLastError().
#include <cuda_runtime.h>

#include "probes.cuh"

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

// BLOCK threads a block; with SYNC a block barrier at every partial round,
// so no thread leaves early: one past n hashes zeros and stores nothing.
// REG runs probe::sparse3_registers in place of the policy's schedule.
// The ablations run at k_sparse3's layout (SYNC, BLOCK = 1024: at most 64
// registers a thread, one block an SM); a policy that needs more spills,
// which its ptxas line shows.

template <class P, bool STACK, bool SYNC, int BLOCK, bool REG>
__global__ void __launch_bounds__(BLOCK)
k_split(uint32_t* out, const uint32_t* a, const uint32_t* b, long long n,
        long long stride, const uint32_t* K, int z) {
  long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (!SYNC && i >= n) return;
  uint32_t x[8], y[8], h[8];
  pos::zero8(x);
  pos::zero8(y);
  if (i < n) {
    ld8(x, a + stride * i);
    ld8(y, b + stride * i);
  }
  if constexpr (REG) probe::sparse3_registers(h, x, y, K);
  else probe::sparse3_hash<P, STACK, SYNC>(h, x, y, K, z);
  if (i < n) st8(out + 8 * i, h);
}

template <class P, bool STACK, bool SYNC = false, int BLOCK = kBlock,
          bool REG = false>
int launch_split(void* out, const void* a, const void* b, long long n,
                 long long stride, const void* K, int z, void* stream) {
  if (n > 0)
    k_split<P, STACK, SYNC, BLOCK, REG><<<grid_for(n, BLOCK), BLOCK, 0,
                                          (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, stride,
        (const uint32_t*)K, z);
  return (int)cudaGetLastError();
}

// H hashes a thread: poseidon.cu's k_sparse3 (blocks of 1,024, a barrier at
// every partial round) with the hashes of pos::permute_sparse3<H>
// interleaved.  Thread x of block g takes hashes g 1024 H + x + 1024 h
// (h < H), so a warp's reads of hash h are neighbours; a hash past n runs
// on zeros and is not stored.
template <int H>
__global__ void __launch_bounds__(1024, 1)
k_split_hashes(uint32_t* out, const uint32_t* a, const uint32_t* b,
               long long n, long long stride, const uint32_t* K) {
  const long long base = (long long)blockIdx.x * 1024 * H + threadIdx.x;
  uint32_t x[H][3][8];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const long long i = base + (long long)h * 1024;
    pos::zero8(x[h][0]);
    pos::zero8(x[h][1]);
    pos::zero8(x[h][2]);
    if (i < n) {
      ld8(x[h][1], a + stride * i);
      ld8(x[h][2], b + stride * i);
    }
  }
  pos::permute_sparse3<H, true>(x, K);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const long long i = base + (long long)h * 1024;
    if (i < n) st8(out + 8 * i, x[h][pos::kOutputIndex]);
  }
}

template <int H>
int launch_split_hashes(void* out, const void* a, const void* b, long long n,
                        long long stride, const void* K, void* stream) {
  if (n > 0)
    k_split_hashes<H><<<grid_for(n, 1024 * H), 1024, 0,
                        (cudaStream_t)stream>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, stride,
        (const uint32_t*)K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 full, 1 noproduct, 2 noreduce, 3 nofinalsub, 4 noconst,
// 5 stackstate (z must be 0), all in k_sparse3's layout; 6 block1024 (no
// barrier), 7 block128 (the tree hash's first layout: 128 threads, no
// barrier), 8 registers, 9 hashes2, 10 hashes4; a, b, stride, K as
// zk_poseidon_sparse3
int zk_probe_split(int mode, void* out, const void* a, const void* b,
                   long long n, long long stride, const void* K, int z,
                   void* stream) {
  using namespace probe;
  switch (mode) {
    case 0: return launch_split<PFull, false, true, 1024>(out, a, b, n, stride, K, z, stream);
    case 1: return launch_split<PNoProduct, false, true, 1024>(out, a, b, n, stride, K, z, stream);
    case 2: return launch_split<PNoReduce, false, true, 1024>(out, a, b, n, stride, K, z, stream);
    case 3: return launch_split<PNoFinalSub, false, true, 1024>(out, a, b, n, stride, K, z, stream);
    case 4: return launch_split<PNoConst, false, true, 1024>(out, a, b, n, stride, K, z, stream);
    case 5: return launch_split<PFull, true, true, 1024>(out, a, b, n, stride, K, z, stream);
    case 6: return launch_split<PFull, false, false, 1024>(out, a, b, n, stride, K, z, stream);
    case 7: return launch_split<PFull, false>(out, a, b, n, stride, K, z, stream);
    case 8: return launch_split<PFull, false, false, kBlock, true>(out, a, b, n, stride, K, z, stream);
    case 9: return launch_split_hashes<2>(out, a, b, n, stride, K, stream);
    case 10: return launch_split_hashes<4>(out, a, b, n, stride, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
