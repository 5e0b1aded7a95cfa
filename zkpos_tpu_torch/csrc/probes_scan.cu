// The single-pass segmented sum of seg_scan.cuh at another tile shape, for
// the probes path (zkpos_tpu_torch/probes/probe_segscan.py, stage
// lookback_k32): 32 elements a lane where csrc/seg_scan.cu takes 64, the
// rest of the design as it is.  Not on a main path.  A source of its own,
// so that nvcc builds it beside probes.cu and seg_scan.cu.
#include <cuda_runtime.h>

#include "seg_scan.cuh"

using namespace scan;

namespace {

const int kK = 32;
const int kWarps = 4;

__global__ void __launch_bounds__(kWarps * kLanes, 4)
k_lookback_k32_g1(Args a) { seg_kernel_body<Fp1, kSums, kK>(a); }
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_lookback_k32_g2(Args a) { seg_kernel_body<Fp2, kSums, kK>(a); }

}  // namespace

extern "C" {

long long zk_probe_lookback_bytes(int na, long long n) {
  return na == 3 ? scratch_bytes<Fp1>(n, kK, false)
                 : scratch_bytes<Fp2>(n, kK, false);
}

// as zk_seg_sums
int zk_probe_lookback(int na, const void* in, const void* heads, void* out,
                      void* scratch, long long n, void* stream) {
  Args a{(const uint32_t*)in, (const uint8_t*)heads, (uint32_t*)out, n,
         (uint8_t*)scratch};
  if (na == 3)
    return launch<Fp1, kSums, kK, kWarps>(k_lookback_k32_g1, a, stream);
  return launch<Fp2, kSums, kK, kWarps>(k_lookback_k32_g2, a, stream);
}

}  // extern "C"
