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
// What bounds it on an H100: the launch. It reads idx and 8 KB of x and
// writes 8 KB; an empty launch alone takes 0.8-1.0 us there. So the design
// reads only the window, from L2 with nothing staged in shared memory, and
// keeps the chain to the offsets and then the window: one block of 512
// threads, each owning 16 bytes (4 lanes) of one output row. Each thread
// loads idx as one 8-byte int2 (every thread the same address: one broadcast),
// computes its source row, and moves its 16 bytes with one aligned 16-byte
// load and one 16-byte store: every variant but dyn_roll_lane copies whole
// rows of x (the lane window of dyn_lane_aligned and dyn_both starts at 0).
// dyn_roll_lane rotates each row by r0 mod 256 lanes, 16-byte aligned only
// when r0 % 4 == 0; each thread loads the two aligned 16-byte chunks that
// hold its four source lanes and funnel-shifts them, as K2 does: a warp's
// two loads touch 8 L1 wavefronts where four 4-byte loads at a 16-byte
// stride touch 16, and the shift is one select on a value every thread
// shares. Pointers that are not 16-byte aligned (a view into a larger
// tensor) take a scalar instantiation. On an H100 a variant takes 1.2-1.4 us
// graph-timed: a block of more than 64 threads costs 1.0 us empty, and each
// dependent L2 round trip 0.12-0.15 us more (chip_smoke.py --kernel-times).
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.h"

namespace {

using hrt_probe::window_start;

constexpr int kXRows = 128, kXCols = 256;
constexpr int kOutRows = 8;
constexpr int kLanesPerThread = 4;                                 // 16 bytes
constexpr int kThreads = kOutRows * kXCols / kLanesPerThread;      // 512
constexpr int kThreadsPerRow = kXCols / kLanesPerThread;           // 64

enum Variant : int {
  kDynSublane, kDynSublaneAligned, kDynLaneAligned, kDynBoth, kDynRollLane, kDynRollSublane,
  kDynSublane16, kNumVariants
};

// Four consecutive int32 at p: one 16-byte access when kVec (p 16-byte aligned).
template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p) {
  if constexpr (kVec) return *reinterpret_cast<const int4*>(p);
  return make_int4(p[0], p[1], p[2], p[3]);
}

template <bool kVec>
__device__ __forceinline__ void store4(int32_t* __restrict__ p, int4 v) {
  if constexpr (kVec) {
    *reinterpret_cast<int4*>(p) = v;
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads) mosaic_probe_kernel(const int32_t* __restrict__ idx,
                                                                const int32_t* __restrict__ x,
                                                                int32_t* __restrict__ out) {
  int r0, lane;
  if constexpr (kVec) {
    const int2 o = *reinterpret_cast<const int2*>(idx);
    r0 = o.x;
    lane = o.y;
  } else {
    r0 = idx[0];
    lane = idx[1];
  }
  const int la = lane & ~127;
  const int ra = r0 & ~7;
  const int i = threadIdx.x / kThreadsPerRow;                      // output row
  const int l = (threadIdx.x % kThreadsPerRow) * kLanesPerThread;  // its first lane
  int4 v;
  if constexpr (V == kDynRollLane) {
    // Lanes l..l + 3 come from lanes (l - r0) mod 256 onwards (unsigned: a
    // floor mod for any r0): the aligned chunk holding the first and the next
    // one, funnel-shifted by (-r0) mod 4, the same shift in every thread.
    const int32_t* row = x + i * kXCols;
    const uint32_t first = (static_cast<uint32_t>(l) - static_cast<uint32_t>(r0)) & 255u;
    const uint32_t c0 = first & ~3u;
    const int4 a = load4<kVec>(row + c0), b = load4<kVec>(row + ((c0 + 4u) & 255u));
    switch (first & 3u) {
      case 0: v = a; break;
      case 1: v = make_int4(a.y, a.z, a.w, b.x); break;
      case 2: v = make_int4(a.z, a.w, b.x, b.y); break;
      default: v = make_int4(a.w, b.x, b.y, b.z); break;
    }
  } else {
    int row = i, col = 0;
    if constexpr (V == kDynSublane) {
      row = window_start(r0, kXRows, 8) + i;
    } else if constexpr (V == kDynSublaneAligned) {
      row = window_start(ra, kXRows, 8) + i;
    } else if constexpr (V == kDynLaneAligned) {
      col = window_start(la, kXCols, 256);   // always 0
    } else if constexpr (V == kDynBoth) {
      row = window_start(r0, kXRows, 8) + i;
      col = window_start(la, kXCols, 256);
    } else if constexpr (V == kDynRollSublane) {
      row = static_cast<int>((static_cast<uint32_t>(i) - static_cast<uint32_t>(r0)) & 15u);
    } else {   // kDynSublane16; r0 - ra is r0 & 7
      row = window_start(ra, kXRows, 16) + ((i + (r0 & 7)) & 15);
    }
    v = load4<kVec>(x + row * kXCols + col + l);
  }
  store4<kVec>(out + i * kXCols + l, v);
}

using Kernel = void (*)(const int32_t*, const int32_t*, int32_t*);
#define HRT_MOSAIC_KERNELS(VEC)                                                          \
  {mosaic_probe_kernel<kDynSublane, VEC>,     mosaic_probe_kernel<kDynSublaneAligned, VEC>, \
   mosaic_probe_kernel<kDynLaneAligned, VEC>, mosaic_probe_kernel<kDynBoth, VEC>,           \
   mosaic_probe_kernel<kDynRollLane, VEC>,    mosaic_probe_kernel<kDynRollSublane, VEC>,    \
   mosaic_probe_kernel<kDynSublane16, VEC>}
// [vec][variant], variants in the order of Variant (and of
// probes/mosaic_probe.py::VARIANTS); [1] the 16-byte instantiations.
const Kernel kKernels[2][kNumVariants] = {HRT_MOSAIC_KERNELS(false), HRT_MOSAIC_KERNELS(true)};
#undef HRT_MOSAIC_KERNELS

}  // namespace

// idx: (2,) int32; x: (128, 256) int32; out: (8, 256) int32. All contiguous,
// on the current device. variant: the index of probes/mosaic_probe.py::VARIANTS.
extern "C" int hrt_mosaic_probe(int variant, const void* idx, const void* x, void* out,
                                void* stream) {
  if (variant < 0 || variant >= kNumVariants) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(idx) % 8 == 0) &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  kKernels[vec][variant]<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(x),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
