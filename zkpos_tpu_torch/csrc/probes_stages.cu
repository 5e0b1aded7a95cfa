// seg_scan's own body cut into the stages of the TPU probe's main6.kern
// (scripts/probe_segscan.py:101, stages 6-8), for the probes path
// (zkpos_tpu_torch/probes/probe_segscan.py).  Not on a main path.  Each
// stage is seg_kernel_body<E, kScan, 64> (csrc/seg_scan.cuh) with its
// production adds (the pass's inlined add, padd_cold everywhere else),
// the mapping, launch bounds and shared memory of seg_scan.cu's kernels,
// cut off by the compile-time phase:
//
//   * local (TPU stage 6): the lanes' serial passes alone, each lane's
//     first element taken as a head: one add for each element that is
//     neither a head nor a lane's first;
//   * local_agg (TPU stage 7): that and the count look-back, the lanes'
//     Hillis-Steele scan, each lane's carry, the chunk's running prefix,
//     the point look-back and each waiting carry joined with the prefix
//     before its chunk: everything but adding the carries to the elements
//     before each lane's first head.  Each such lane's carry-in stays in
//     its scratch slot, the stage's second output;
//   * full (TPU stage 8) is seg_scan itself (k_seg_scan_g1 / g2, timed
//     through ops/ec.seg_scan): no copy of it is made.
//
// full's time less local_agg's is the fix-up's: its second read and write
// of every element before a lane's first head and its adds through the
// out-of-line padd_cold.  Bound: the stage's complete adds at the INT32
// rate (probe_segscan.stage_adds).  The G2 kernels are in
// probes_stages_g2.cu, so that nvcc builds them beside these.
#include <cuda_runtime.h>

#include "seg_scan.cuh"

using namespace scan;

namespace {

const int kK = 64;        // elements a lane, as seg_scan.cu
const int kWarps = 4;

__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_local_g1(Args a) {
  seg_kernel_body<Fp1, kScan, kK, InlineAdd, ColdAdd, kPhaseLocal>(a);
}
__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_local_agg_g1(Args a) {
  seg_kernel_body<Fp1, kScan, kK, InlineAdd, ColdAdd, kPhaseAgg>(a);
}

}  // namespace

int stage_launch_g2(int phase, Args a, void* stream);
long long stage_tpc_g2(int phase, long long tiles);

extern "C" {

// Bytes of the scratch a stage needs over n points (as zk_seg_scan's), and
// the byte offset of its carry slots: lane l of tile t at
// (t 32 + l) na 32 bytes from there.
long long zk_probe_stage_bytes(int na, long long n) {
  return na == 3 ? scratch_bytes<Fp1>(n, kK, true)
                 : scratch_bytes<Fp2>(n, kK, true);
}
long long zk_probe_stage_carries(int na, long long n) {
  return Scratch(n, kLanes * kK, 8 * na, true).carry;
}

// The tiles a chunk that a stage's kernel gives its warps over n points.
long long zk_probe_stage_tpc(int phase, int na, long long n) {
  const long long tiles = (n + kLanes * kK - 1) / (kLanes * kK);
  if (tiles == 0) return 1;
  if (na == 6) return stage_tpc_g2(phase, tiles);
  return tiles_per_chunk<Fp1, kScan, kWarps>(
      phase == kPhaseLocal ? k_local_g1 : k_local_agg_g1, tiles);
}

// phase 0 local, 1 local_agg: out (n points) the lanes' passes; scratch
// zk_probe_stage_bytes(na, n) bytes, local_agg's carries in it
int zk_probe_scan_stage(int phase, int na, const void* in, const void* heads,
                        void* out, void* scratch, long long n,
                        void* stream) {
  if (phase != kPhaseLocal && phase != kPhaseAgg)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint32_t*)in, (const uint8_t*)heads, (uint32_t*)out,
               n, (uint8_t*)scratch};
  if (na == 6) return stage_launch_g2(phase, a, stream);
  return launch<Fp1, kScan, kK, kWarps>(
      phase == kPhaseLocal ? k_local_g1 : k_local_agg_g1, a, stream);
}

}  // extern "C"
