// Error text for the codes the kernels' C entry points return, an empty
// launch (of one block, or of a kernel's grid): the floor under the device
// time of any launch-bound kernel, which
// chip_smoke.py times beside the kernels, the launches that take that floor
// apart for a one-block kernel such as P3's and P4's, and a stream of reads
// from an L2-resident buffer: the card's L2 read rate, which bounds P1 and P2.
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

constexpr int kL2Threads = 1024, kL2InFlight = 8;

// Every block sums the whole buffer of n16 16-byte words (a multiple of
// kL2Threads * kL2InFlight), `passes` times, all blocks in step: they read
// the same lines together, as the probes' identical blocks do. Each thread
// keeps kL2InFlight 16-byte loads in flight. The loads are .cg (cached in
// the L2 only): no L1 hit inflates the rate. out[block, thread] = the
// thread's sum of the words it read, so no load is dead.
__global__ void __launch_bounds__(kL2Threads) l2_read_kernel(const uint4* __restrict__ src,
                                                             int n16, int passes,
                                                             uint32_t* __restrict__ out) {
  uint32_t acc = 0;
  for (int p = 0; p < passes; ++p) {
    for (int k = threadIdx.x; k < n16; k += kL2Threads * kL2InFlight) {
      uint4 v[kL2InFlight];
#pragma unroll
      for (int u = 0; u < kL2InFlight; ++u) v[u] = __ldcg(src + k + u * kL2Threads);
#pragma unroll
      for (int u = 0; u < kL2InFlight; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  }
  out[blockIdx.x * kL2Threads + threadIdx.x] = acc;
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

// A grid of grid_x x grid_y blocks of block_x x block_y threads that do
// nothing, on `stream`: the floor under a kernel launched on that grid.
extern "C" int hrt_empty_grid(int grid_x, int grid_y, int block_x, int block_y, void* stream) {
  if (grid_x < 1 || grid_y < 1 || block_x < 1 || block_y < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  empty_kernel<<<dim3(grid_x, grid_y), dim3(block_x, block_y), 0,
                 static_cast<cudaStream_t>(stream)>>>();
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

// `blocks` blocks of 1,024 threads, each reading all of src (n16 16-byte
// words, a multiple of 8,192; 16-byte aligned) `passes` times, in step:
// blocks * passes * n16 * 16 bytes from the L2 once src is resident. out
// holds blocks * 1,024 uint32: each thread's sum of the words it read.
extern "C" int hrt_l2_read(int passes, int n16, const void* src, void* out, int blocks,
                           void* stream) {
  if (passes < 0 || blocks < 1 || n16 < kL2Threads * kL2InFlight ||
      n16 % (kL2Threads * kL2InFlight) != 0 || (reinterpret_cast<uintptr_t>(src) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  l2_read_kernel<<<blocks, kL2Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), n16, passes, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
