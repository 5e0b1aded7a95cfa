// The single-pass segmented scan of seg_scan.cuh taken apart, for the
// probes path (zkpos_tpu_torch/probes/probe_segscan.py).  Not on a main
// path.  A source of its own, so that nvcc builds it beside probes.cu and
// seg_scan.cu.  Every kernel runs seg_scan.cu's tile mapping (a warp a
// chunk of whole tiles of 32 lanes x K = 64 elements from the global
// counter, 4 warps a block, the same shared memory a warp) unless said:
//
//   * copy: the byte floor of that mapping.  A warp counts its chunk's
//     heads as seg_chunk's first step does and stores the count in its
//     count word (no look-back), then streams each tile through shared
//     memory and back, element j of every lane at a time, 16 bytes a
//     thread with neighbouring lanes on neighbouring addresses (cp.async,
//     two stages), with no add: TPU stage 1 on this card.  Bound: the
//     stream's points read and written and its heads read, at the memory
//     rate;
//   * structure: seg_scan itself (every position) with WrapAdd, a
//     limb-wise wrapping add, in place of the complete add wherever one
//     runs: the lanes' serial pass, their Hillis-Steele scan, the carries,
//     the look-back's fold and the fix-up.  What is left is the scan's
//     structure without curve arithmetic: TPU stages 2-4 on this card, and
//     the share of seg_scan's time that its adds do not explain;
//   * lookback_k32: the segment sums at 32 elements a lane where
//     seg_scan.cu takes 64.
#include <cuda_runtime.h>

#include "probes.cuh"
#include "seg_scan.cuh"

using namespace scan;

namespace {

const int kK = 64;        // elements a lane, as seg_scan.cu
const int kK32 = 32;
const int kWarps = 4;

// seg_chunk's streaming without its adds: one chunk a warp.  It takes
// seg_sums's shared memory (WarpSmem<E, kSums>) and uses its two stages,
// so that shared memory holds as many of its warps an SM as of seg_sums's.
template <class E>
__device__ __forceinline__ void copy_chunk(const Args& a, uint32_t* smem) {
  typedef WarpSmem<E, kSums> S;
  const long long tile = kLanes * kK;
  const int lane = threadIdx.x & (kLanes - 1);
  const long long n = a.n;
  const long long chunks = ((n + tile - 1) / tile + a.tpc - 1) / a.tpc;
  const Scratch lay(n, tile, Words<E>::W, false);
  uint32_t* counter = reinterpret_cast<uint32_t*>(a.scratch);
  uint64_t* cnt = reinterpret_cast<uint64_t*>(a.scratch + lay.cnt);
  long long c = 0;
  if (lane == 0) c = atomicAdd(counter, 1u);
  c = __shfl_sync(kFull, c, 0);
  if (c >= chunks) return;
  const long long c0 = c * a.tpc * tile;
  const long long c1 = c0 + a.tpc * tile < n ? c0 + a.tpc * tile : n;
  uint32_t own = 0;
  for (long long i = c0 + lane; i < c1; i += kLanes)
    own += (i == 0 || a.heads[i]) ? 1u : 0u;
  own = __reduce_add_sync(kFull, own);
  if (lane == 0) cnt[c] = own;
  for (long long t0 = c0; t0 < c1; t0 += tile) {
    stage_in<E, kK>(smem, a.in, t0, 0, n, kFull, lane);
    cp_commit();
    for (int j = 0; j < kK; ++j) {
      if (j + 1 < kK)
        stage_in<E, kK>(smem + ((j + 1) & 1) * S::stage, a.in, t0, j + 1, n,
                        kFull, lane);
      cp_commit();
      cp_wait<1>();
      __syncwarp();
      stage_out<E, kK>(a.out, smem + (j & 1) * S::stage, t0, j, n, kFull,
                       lane);
      __syncwarp();
    }
    cp_wait<0>();
  }
}

template <class E>
__device__ __forceinline__ void copy_body(const Args& a) {
  extern __shared__ uint4 seg_smem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(seg_smem) +
                   (threadIdx.x / kLanes) * WarpSmem<E, kSums>::words;
  copy_chunk<E>(a, smem);
}

// launch bounds as seg_scan.cu's and seg_scan_g2.cu's kernels
__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_copy_g1(Args a) { copy_body<Fp1>(a); }
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_copy_g2(Args a) { copy_body<Fp2>(a); }
__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_structure_g1(Args a) {
  seg_kernel_body<Fp1, kScan, kK, probe::WrapAdd, probe::WrapAdd>(a);
}
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_structure_g2(Args a) {
  seg_kernel_body<Fp2, kScan, kK, probe::WrapAdd, probe::WrapAdd>(a);
}
__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_lookback_k32_g1(Args a) { seg_kernel_body<Fp1, kSums, kK32>(a); }
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_lookback_k32_g2(Args a) { seg_kernel_body<Fp2, kSums, kK32>(a); }

Args args(const void* in, const void* heads, void* out, void* scratch,
          long long n) {
  return Args{(const uint32_t*)in, (const uint8_t*)heads, (uint32_t*)out, n,
              (uint8_t*)scratch};
}

}  // namespace

extern "C" {

// Bytes of the scratch a stage needs over n points: stage 0 copy (the
// chunk counter, then a count word a chunk from byte 16), 1 structure,
// 2 lookback_k32; na = 3 (G1) or 6 (G2).
long long zk_probe_scan_bytes(int stage, int na, long long n) {
  const bool scan = stage == 1;
  const int K = stage == 2 ? kK32 : kK;
  return na == 3 ? scratch_bytes<Fp1>(n, K, scan)
                 : scratch_bytes<Fp2>(n, K, scan);
}

// The tiles a chunk that zk_probe_scan_copy gives its warps over n points.
long long zk_probe_scan_tpc(int na, long long n) {
  const long long tiles = (n + kLanes * kK - 1) / (kLanes * kK);
  if (tiles == 0) return 1;
  return na == 3 ? tiles_per_chunk<Fp1, kSums, kWarps>(k_copy_g1, tiles)
                 : tiles_per_chunk<Fp2, kSums, kWarps>(k_copy_g2, tiles);
}

// out = in (n points), and chunk c's head count in the 64-bit word at byte
// 16 + 8 c of scratch (zk_probe_scan_bytes(0, na, n) bytes); chunks of
// zk_probe_scan_tpc(na, n) tiles
int zk_probe_scan_copy(int na, const void* in, const void* heads, void* out,
                       void* scratch, long long n, void* stream) {
  const Args a = args(in, heads, out, scratch, n);
  if (na == 3) return launch<Fp1, kSums, kK, kWarps>(k_copy_g1, a, stream);
  return launch<Fp2, kSums, kK, kWarps>(k_copy_g2, a, stream);
}

// as zk_seg_scan, under the wrapping add; scratch:
// zk_probe_scan_bytes(1, na, n) bytes
int zk_probe_scan_structure(int na, const void* in, const void* heads,
                            void* out, void* scratch, long long n,
                            void* stream) {
  const Args a = args(in, heads, out, scratch, n);
  if (na == 3)
    return launch<Fp1, kScan, kK, kWarps>(k_structure_g1, a, stream);
  return launch<Fp2, kScan, kK, kWarps>(k_structure_g2, a, stream);
}

// as zk_seg_sums; scratch: zk_probe_scan_bytes(2, na, n) bytes
int zk_probe_lookback(int na, const void* in, const void* heads, void* out,
                      void* scratch, long long n, void* stream) {
  const Args a = args(in, heads, out, scratch, n);
  if (na == 3)
    return launch<Fp1, kSums, kK32, kWarps>(k_lookback_k32_g1, a, stream);
  return launch<Fp2, kSums, kK32, kWarps>(k_lookback_k32_g2, a, stream);
}

}  // extern "C"
