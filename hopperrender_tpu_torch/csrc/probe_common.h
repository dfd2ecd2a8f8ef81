// What the probe kernels share: the window rule of the TPU kernels' dynamic
// slices, P1/P2's table and band, and P3/P4's shared-memory opt-in.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hrt_probe {

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device. The attribute holds per device, so it is set at the first launch on
// each device (one bit of `ready` per device) and not on every launch.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel* kernel, int bytes, std::atomic<uint64_t>& ready) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;   // past 64: every launch
  if (bit != 0 && (ready.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// pl.ds(start, size) over a dimension of `dim`, as the JAX kernels resolve it
// in interpret mode: a negative start counts from the end once (start + dim),
// then the start is clamped to [0, dim - size] so that the window fits. On the
// TPU a window past the array is undefined; the port follows interpret mode.
__device__ __forceinline__ int window_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  return min(max(start, 0), dim - size);
}

constexpr int kT = 512;                   // P1/P2: table entries
constexpr int kRows = 512, kW32 = 1024;   // P1/P2: the band, 2 MB of uint32
constexpr int kTile = 8 * 128;            // one (8, 128) tile, one thread per element

__device__ __forceinline__ uint32_t band_word(const uint32_t* __restrict__ band, int row,
                                              int lane) {
  return band[row * kW32 + lane];
}

}  // namespace hrt_probe
