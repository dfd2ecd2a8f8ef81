// K1 — 8x8 box blur of the two int16 flow planes.
//
// Replaces the TPU kernel hopperrender_tpu/ops/pallas_kernels.py::blur_flow_pallas
// (kernel body _make_blur_kernel). For each cell of (2, low_h, low_w):
//   acc = int32 sum of the 8x8 window [-4, 4) x [-4, 4) around the cell, with
//         borders mirrored symmetrically (numpy "symmetric": pos < 0 -> -pos-1,
//         pos >= dim -> 2*dim-pos-1, repeating with period 2*dim);
//   out = sign(acc) * (|acc| / 64).
// C's `/` truncates toward zero, which is exactly sign(acc) * (|acc| // 64).
//
// What bounds it on an H100: launch latency. At 4K the planes are 2x270x480
// int16, 518 KB in and 518 KB out; the 64 neighbourhood reads per output are
// L1/L2 hits (the input fits the 50 MB L2 many times over), so the arithmetic
// and the traffic take microseconds and the launch dominates. The design
// therefore stays simple: one thread per output element, reads straight from
// the unpadded planes with the mirror computed inline (no padded copy, unlike
// the TPU kernel's XLA-side pad), and no shared-memory tile, which would not
// shorten a launch-bound run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;  // window [-4, 4), KERNEL_RADIUS of the reference

__device__ __forceinline__ int mirror_symmetric(int pos, int dim) {
  const int period = 2 * dim;
  int m = pos % period;
  if (m < 0) m += period;
  return m < dim ? m : period - 1 - m;
}

__global__ void __launch_bounds__(256) blur_flow_kernel(
    const int16_t* __restrict__ in, int16_t* __restrict__ out, int low_h,
    int low_w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= low_w || y >= low_h) return;
  const size_t plane = static_cast<size_t>(low_h) * low_w;
  const int16_t* src = in + blockIdx.z * plane;
  int cols[2 * kRadius];
#pragma unroll
  for (int k = 0; k < 2 * kRadius; ++k) cols[k] = mirror_symmetric(x + k - kRadius, low_w);
  int acc = 0;
#pragma unroll
  for (int ky = 0; ky < 2 * kRadius; ++ky) {
    const int16_t* row = src + static_cast<size_t>(mirror_symmetric(y + ky - kRadius, low_h)) * low_w;
#pragma unroll
    for (int kx = 0; kx < 2 * kRadius; ++kx) acc += row[cols[kx]];
  }
  out[blockIdx.z * plane + static_cast<size_t>(y) * low_w + x] = static_cast<int16_t>(acc / 64);
}

}  // namespace

// in/out: (2, low_h, low_w) int16, contiguous, on the current device.
extern "C" int hrt_blur_flow(const void* in, void* out, int low_h, int low_w,
                             void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((low_w + block.x - 1) / block.x, (low_h + block.y - 1) / block.y, 2);
  blur_flow_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), low_h, low_w);
  return static_cast<int>(cudaGetLastError());
}
