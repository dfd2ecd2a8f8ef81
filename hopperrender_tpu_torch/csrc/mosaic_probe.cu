// P4 — the dynamic-slice probe: seven (8, 256) windows and rolls of a
// (128, 256) int32 operand at runtime offsets.
//
// Replaces the TPU kernels of scripts/mosaic_probe.py::run (pallas_call at its
// line 14, bodies k_dyn_*), which asked which dynamic slices Mosaic lowers.
// idx is a (2,) int32 device input, read by every thread (never a constant):
// r0 = idx[0], la = idx[1] & ~127, ra = r0 & ~7. Element (i, l):
//   dyn_sublane          x[w(r0, 8) + i, l];
//   dyn_sublane_aligned  x[w(ra, 8) + i, l];
//   dyn_lane_aligned     x[i, w256(la, 256) + l]: a 256-wide window of a
//                        256-wide operand, whose start always clamps to 0;
//   dyn_both             x[w(r0, 8) + i, w256(la, 256) + l];
//   dyn_roll_lane        pltpu.roll(x[:8], r0, axis=1): x[i, (l - r0) mod 256];
//   dyn_roll_sublane     pltpu.roll(x[:16], r0, axis=0)[:8]: x[(i - r0) mod 16, l];
//   dyn_sublane_16       the 16-row window at ra rolled up by r0 - ra rows:
//                        x[w(ra, 16) + ((i + r0 - ra) mod 16), l];
// with w(start, size) the window start as interpret mode resolves
// pl.ds(start, size) over the 128 rows: start + 128 if start < 0, then
// clamped to [0, 128 - size] (dyn_sublane clamps r0 to 120 when r0 > 120).
//
// Design: one block of 1,024 threads, two output elements each (lanes l and
// l + 128 of row i). The block stages x (128 KB) into dynamic shared memory,
// the counterpart of the TPU kernel's VMEM operand. What bounds it on an H100:
// the launch (128 KB in, 8 KB out).
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.h"

namespace {

using hrt_probe::window_start;

constexpr int kXRows = 128, kXCols = 256;
constexpr int kOutRows = 8;
constexpr int kThreads = 1024;
constexpr int kSmemBytes = kXRows * kXCols * 4;

enum Variant : int {
  kDynSublane, kDynSublaneAligned, kDynLaneAligned, kDynBoth, kDynRollLane, kDynRollSublane,
  kDynSublane16, kNumVariants
};

template <int V>
__global__ void __launch_bounds__(kThreads) mosaic_probe_kernel(const int32_t* __restrict__ idx,
                                                                const int32_t* __restrict__ x,
                                                                int32_t* __restrict__ out) {
  extern __shared__ int32_t xs[];
  for (int k = threadIdx.x; k < kXRows * kXCols; k += blockDim.x) xs[k] = x[k];
  __syncthreads();
  const int r0 = idx[0];
  const int la = idx[1] & ~127;
  const int ra = r0 & ~7;
  for (int e = threadIdx.x; e < kOutRows * kXCols; e += kThreads) {
    const int i = e / kXCols;
    const int l = e % kXCols;
    int row = i, col = l;
    if constexpr (V == kDynSublane) {
      row = window_start(r0, kXRows, 8) + i;
    } else if constexpr (V == kDynSublaneAligned) {
      row = window_start(ra, kXRows, 8) + i;
    } else if constexpr (V == kDynLaneAligned) {
      col = window_start(la, kXCols, 256) + l;
    } else if constexpr (V == kDynBoth) {
      row = window_start(r0, kXRows, 8) + i;
      col = window_start(la, kXCols, 256) + l;
    } else if constexpr (V == kDynRollLane) {   // unsigned: a floor mod for any r0
      col = static_cast<int>((static_cast<uint32_t>(l) - static_cast<uint32_t>(r0)) & 255u);
    } else if constexpr (V == kDynRollSublane) {
      row = static_cast<int>((static_cast<uint32_t>(i) - static_cast<uint32_t>(r0)) & 15u);
    } else {   // kDynSublane16
      row = window_start(ra, kXRows, 16) + ((i + r0 - ra) & 15);
    }
    out[e] = xs[row * kXCols + col];
  }
}

template <int V>
cudaError_t launch(const int32_t* idx, const int32_t* x, int32_t* out, cudaStream_t stream) {
  static std::atomic<uint64_t> ready{0};
  const cudaError_t attr =
      hrt_probe::allow_dynamic_smem(mosaic_probe_kernel<V>, kSmemBytes, ready);
  if (attr != cudaSuccess) return attr;
  mosaic_probe_kernel<V><<<1, kThreads, kSmemBytes, stream>>>(idx, x, out);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const int32_t*, const int32_t*, int32_t*, cudaStream_t);
// In the order of Variant (and of probes/mosaic_probe.py::VARIANTS).
const Launcher kLaunchers[kNumVariants] = {
    launch<kDynSublane>,     launch<kDynSublaneAligned>, launch<kDynLaneAligned>,
    launch<kDynBoth>,        launch<kDynRollLane>,       launch<kDynRollSublane>,
    launch<kDynSublane16>};

}  // namespace

// idx: (2,) int32; x: (128, 256) int32; out: (8, 256) int32. All contiguous,
// on the current device. variant: the index of probes/mosaic_probe.py::VARIANTS.
extern "C" int hrt_mosaic_probe(int variant, const void* idx, const void* x, void* out,
                                void* stream) {
  if (variant < 0 || variant >= kNumVariants) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunchers[variant](
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(x),
      static_cast<int32_t*>(out), static_cast<cudaStream_t>(stream)));
}
