// Error text for the codes the kernels' C entry points return, and an empty
// launch: the floor under the device time of any launch-bound kernel, which
// chip_smoke.py times beside the kernels.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* hrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block of one warp that does nothing, on `stream`.
extern "C" int hrt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
