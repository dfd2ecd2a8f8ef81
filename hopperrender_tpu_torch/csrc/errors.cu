// Error text for the codes the kernels' C entry points return, an empty
// launch: the floor under the device time of any launch-bound kernel, which
// chip_smoke.py times beside the kernels, and the launches that take that
// floor apart for a one-block kernel such as P3's and P4's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void empty_kernel() {}

// Every thread loads src[0] and stores it: one L2 round trip.
__global__ void one_load_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out) {
  out[threadIdx.x] = src[0];
}

// Every thread loads src[0], then src[64 + (src[0] & 63)], another 128-byte
// line: two dependent L2 round trips, as P3's index and element or P4's
// offsets and window.
__global__ void two_loads_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out) {
  out[threadIdx.x] = src[64 + (src[0] & 63)];
}

}  // namespace

extern "C" const char* hrt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One block of one warp that does nothing, on `stream`.
extern "C" int hrt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// One block of `threads` threads (at most 1,024) that does nothing (kind 0),
// makes one L2 round trip (kind 1) or two dependent ones (kind 2); kind 3
// launches nothing, so that a caller can time its own call without the
// launch. src holds at least 128 int32, out at least `threads`.
extern "C" int hrt_floor_launch(int kind, int threads, const void* src, void* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in = static_cast<const int32_t*>(src);
  int32_t* o = static_cast<int32_t*>(out);
  switch (kind) {
    case 0: empty_kernel<<<1, threads, 0, s>>>(); break;
    case 1: one_load_kernel<<<1, threads, 0, s>>>(in, o); break;
    case 2: two_loads_kernel<<<1, threads, 0, s>>>(in, o); break;
    case 3: return static_cast<int>(cudaSuccess);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
