// The G2 kernels of seg_scan.cu (its notes hold for them), in a source of
// their own so that nvcc builds them beside the G1 kernels: a G2 add's code
// is three times a G1 add's.
#include <cuda_runtime.h>

#include "seg_scan.cuh"

using namespace scan;

namespace {

const int kK = 64;        // elements a lane, as seg_scan.cu
const int kWarps = 4;

// up to 255 registers: the pass inlines a G2 add, which takes 238 on its
// own (ec_add.cu)
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_seg_scan_g2(Args a) { seg_kernel_body<Fp2, kScan, kK>(a); }
__global__ void __launch_bounds__(kWarps * kLanes, 2)
k_seg_sums_g2(Args a) { seg_kernel_body<Fp2, kSums, kK>(a); }

}  // namespace

int seg_launch_g2(int sums, Args a, void* stream) {
  if (sums) return launch<Fp2, kSums, kK, kWarps>(k_seg_sums_g2, a, stream);
  return launch<Fp2, kScan, kK, kWarps>(k_seg_scan_g2, a, stream);
}
