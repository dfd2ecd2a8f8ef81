// What the probe kernels share: the window rule of the TPU kernels' dynamic
// slices, and P1/P2's table and band.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace hrt_probe {

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
