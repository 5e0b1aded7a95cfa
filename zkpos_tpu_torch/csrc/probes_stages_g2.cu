// The G2 kernels of probes_stages.cu (its notes hold for them), in a
// source of their own so that nvcc builds them beside the G1 kernels.
#include <cuda_runtime.h>

#include "seg_scan.cuh"

using namespace scan;

namespace {

const int kK = 64;
const int kWarps = 4;

// launch bounds as seg_scan_g2.cu's: the pass inlines a G2 add
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_local_g2(Args a) {
  seg_kernel_body<Fp2, kScan, kK, InlineAdd, ColdAdd, kPhaseLocal>(a);
}
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_local_agg_g2(Args a) {
  seg_kernel_body<Fp2, kScan, kK, InlineAdd, ColdAdd, kPhaseAgg>(a);
}

}  // namespace

int stage_launch_g2(int phase, Args a, void* stream) {
  return launch<Fp2, kScan, kK, kWarps>(
      phase == kPhaseLocal ? k_local_g2 : k_local_agg_g2, a, stream);
}

long long stage_tpc_g2(int phase, long long tiles) {
  return tiles_per_chunk<Fp2, kScan, kWarps>(
      phase == kPhaseLocal ? k_local_g2 : k_local_agg_g2, tiles);
}
