// P3 — the per-lane gather probe: three (8, 128) gathers from a (64, 256)
// int32 operand.
//
// Replaces the TPU kernels of scripts/gather_probe.py::probe_mosaic_vector_ops
// (pallas_call at its line 40, bodies k_take_sublane, k_take_lane and
// k_vec_index), which asked whether Mosaic lowers a per-lane dynamic gather.
// Element (i, l) of the output, with k = idx[i, l]:
//   take_along_sublane  jnp.take_along_axis(x[:, :128], idx, axis=0): x[k, l];
//   take_along_lane     jnp.take_along_axis(x[:8, :], idx + 7, axis=1): x[i, k + 7];
//   vector_index        x[:, :128][idx, lane iota]: x[k, l].
// Out-of-range indices follow JAX as run in interpret mode: a negative index
// counts from the end once (k + size); take_along_axis then fills what is
// still outside [0, size) with INT32_MIN (its default "fill" mode), and
// NumPy-style indexing clamps it into [0, size).
//
// Design: one block of 1,024 threads, one per output element. The block stages
// x (64 KB) into dynamic shared memory, the counterpart of the TPU kernel's
// VMEM operand, and each thread gathers its element from there. What bounds
// it on an H100: the launch. It moves 64 KB in and 4 KB out, microseconds of
// work against a launch of a few microseconds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.h"

namespace {

constexpr int kXRows = 64, kXCols = 256;
constexpr int kTile = 8 * 128;
constexpr int kSmemBytes = kXRows * kXCols * 4;
constexpr int32_t kFill = INT32_MIN;

enum Variant : int { kTakeAlongSublane, kTakeAlongLane, kVectorIndex, kNumVariants };

template <int V>
__global__ void __launch_bounds__(kTile) gather_probe_kernel(const int32_t* __restrict__ x,
                                                             const int32_t* __restrict__ idx,
                                                             int32_t* __restrict__ out) {
  extern __shared__ int32_t xs[];
  for (int k = threadIdx.x; k < kXRows * kXCols; k += blockDim.x) xs[k] = x[k];
  __syncthreads();
  const int i = threadIdx.x >> 7;
  const int l = threadIdx.x & 127;
  int32_t v;
  if constexpr (V == kTakeAlongSublane || V == kVectorIndex) {
    int64_t k = idx[threadIdx.x];
    if (k < 0) k += kXRows;
    if constexpr (V == kVectorIndex) {
      k = min(max(k, int64_t{0}), int64_t{kXRows - 1});
      v = xs[k * kXCols + l];
    } else {
      v = k >= 0 && k < kXRows ? xs[k * kXCols + l] : kFill;
    }
  } else {   // int64: idx + 7 does not overflow
    int64_t k = static_cast<int64_t>(idx[threadIdx.x]) + 7;
    if (k < 0) k += kXCols;
    v = k >= 0 && k < kXCols ? xs[i * kXCols + k] : kFill;
  }
  out[threadIdx.x] = v;
}

template <int V>
cudaError_t launch(const int32_t* x, const int32_t* idx, int32_t* out, cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  const cudaError_t attr =
      hrt_probe::allow_dynamic_smem(gather_probe_kernel<V>, kSmemBytes, ready);
  if (attr != cudaSuccess) return attr;
  gather_probe_kernel<V><<<1, kTile, kSmemBytes, stream>>>(x, idx, out);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const int32_t*, const int32_t*, int32_t*, cudaStream_t);
// In the order of Variant (and of probes/gather_probe.py::VARIANTS).
const Launcher kLaunchers[kNumVariants] = {launch<kTakeAlongSublane>, launch<kTakeAlongLane>,
                                           launch<kVectorIndex>};

}  // namespace

// x: (64, 256) int32; idx: (8, 128) int32; out: (8, 128) int32. All
// contiguous, on the current device. variant: the index of
// probes/gather_probe.py::VARIANTS.
extern "C" int hrt_gather_probe(int variant, const void* x, const void* idx, void* out,
                                void* stream) {
  if (variant < 0 || variant >= kNumVariants) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunchers[variant](
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), static_cast<cudaStream_t>(stream)));
}
