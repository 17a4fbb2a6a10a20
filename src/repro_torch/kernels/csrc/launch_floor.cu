// An empty kernel: its time under a timer is the floor a launch of any
// kernel pays on the card (launch and completion, no work).  Used by
// chip_smoke.py and kernel_ab.py to write the floor beside kernels whose
// bound lies below it; no path of the port launches it.
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" {

// One launch of `blocks` CTAs of one warp each on `stream`; returns the
// cudaError_t of the launch.
int dcom_empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
