// Inclusive segmented EC-sum scan over a flat point stream, G1 and G2, in
// one kernel launch a call, with two outputs:
//   zk_seg_scan: out[i] = sum of in[h..i], h the last head at or before i;
//   zk_seg_sums: out[s] = the sum of segment s (the scan at its last
//                element), in stream order;
// the stream start counts as a head either way.
//
// Replaces zkpos_tpu/ops/ec_pallas.py:_seg_scan_kernel (seg_scan_pallas),
// which the TPU MSM uses for bucket accumulation and for the bucket fold.
// The TPU kernel carries the running point from one tile to the next in
// VMEM scratch across a sequential grid.  H100 blocks run in no order, so
// each warp carries it across a chunk of tiles and a decoupled look-back
// carries it from chunk to chunk (seg_scan.cuh).
//
// Bound on the H100: one complete add for each element that is not a head
// -- 3,696 (G1) or 11,088 (G2) 32-bit multiplies against 96 or 192 bytes
// read -- so the scan is bounded by integer multiply throughput.  The work
// beyond that: five Hillis-Steele rounds a tile of 32 x 64 elements and at
// most two adds a lane for its carry; seg_scan adds its carry to each
// element before the lane's first head (the full scan's inherent second
// add).  Points move through shared memory in 16-byte pieces, neighbouring
// threads on neighbouring addresses, and seg_sums writes only segment ends.
// 32 elements a lane (the probes path's lookback_k32) is slower (PERF.md).
// A first form, one tile a warp that waited for the tile before when it
// had no head, chained through every tile of the witness streams' long
// digit-0 segments: hence chunks of many tiles a warp.
#include <cuda_runtime.h>

#include "seg_scan.cuh"

using namespace scan;

namespace {

const int kK = 64;        // elements a lane
const int kWarps = 4;     // warps (chunks) a block

__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_seg_scan_g1(Args a) { seg_kernel_body<Fp1, kScan, kK>(a); }
__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_seg_sums_g1(Args a) { seg_kernel_body<Fp1, kSums, kK>(a); }

}  // namespace

// The G2 kernels, in seg_scan_g2.cu so that nvcc builds them beside these.
int seg_launch_g2(int sums, Args a, void* stream);

extern "C" {

// Bytes of the scratch buffer a call over n points needs (na = 3 | 6;
// sums = 1 for zk_seg_sums, 0 for zk_seg_scan).
long long zk_seg_scratch_bytes(int na, int sums, long long n) {
  return na == 3 ? scratch_bytes<Fp1>(n, kK, !sums)
                 : scratch_bytes<Fp2>(n, kK, !sums);
}

// in: n points (N, na, 8) int32, 16-byte aligned; heads: n bytes; out: n
// points; scratch: zk_seg_scratch_bytes(na, 0, n) bytes.
int zk_seg_scan(int na, const void* in, const void* heads, void* out,
                void* scratch, long long n, void* stream) {
  Args a{(const uint32_t*)in, (const uint8_t*)heads, (uint32_t*)out, n,
         (uint8_t*)scratch};
  if (na == 3) return launch<Fp1, kScan, kK, kWarps>(k_seg_scan_g1, a, stream);
  return seg_launch_g2(0, a, stream);
}

// As zk_seg_scan, but out holds one point a segment: as many as the heads,
// position 0 counted as one; scratch: zk_seg_scratch_bytes(na, 1, n).
int zk_seg_sums(int na, const void* in, const void* heads, void* out,
                void* scratch, long long n, void* stream) {
  Args a{(const uint32_t*)in, (const uint8_t*)heads, (uint32_t*)out, n,
         (uint8_t*)scratch};
  if (na == 3) return launch<Fp1, kSums, kK, kWarps>(k_seg_sums_g1, a, stream);
  return seg_launch_g2(1, a, stream);
}

}  // extern "C"
