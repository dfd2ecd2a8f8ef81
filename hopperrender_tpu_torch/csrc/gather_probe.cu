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
// What bounds it on an H100: the launch. It reads 4 KB of indices and at most
// 4 KB of the 64 KB operand (which stays in L2) and writes 4 KB. So the
// design is one launch and two dependent L2 round trips, the index and then
// the element, with nothing staged: one block of 256 threads, each owning four
// neighbouring outputs of one row (16 bytes). A thread loads its four indices
// as one 16-byte int4, issues its four gathers from global memory together,
// and stores the four results as one int4. 256 threads of 16 bytes cover the
// 4 KB tile in one pass with the fewest instructions that keep every access
// 16 bytes wide; a thread per element would issue four times the index loads
// and stores for the same two round trips. Pointers that are not 16-byte
// aligned (a view into a larger tensor) take a scalar instantiation. On an
// H100 a variant takes 1.4-1.5 us graph-timed, against 1.25 us for a block
// that makes two dependent L2 round trips and nothing else
// (chip_smoke.py --kernel-times).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kXRows = 64, kXCols = 256;
constexpr int kTileCols = 128, kTile = 8 * kTileCols;
constexpr int kPerThread = 4;                     // 16 bytes
constexpr int kThreads = kTile / kPerThread;      // 256
constexpr int32_t kFill = INT32_MIN;

enum Variant : int { kTakeAlongSublane, kTakeAlongLane, kVectorIndex, kNumVariants };

// Output (i, l) from its index k, read from x in global memory. int64: idx + 7
// does not overflow.
template <int V>
__device__ __forceinline__ int32_t gather(const int32_t* __restrict__ x, int32_t k32, int i,
                                          int l) {
  if constexpr (V == kTakeAlongLane) {
    int64_t k = static_cast<int64_t>(k32) + 7;
    if (k < 0) k += kXCols;
    return k >= 0 && k < kXCols ? x[i * kXCols + k] : kFill;
  } else {
    int64_t k = k32;
    if (k < 0) k += kXRows;
    if constexpr (V == kVectorIndex) {
      k = min(max(k, int64_t{0}), int64_t{kXRows - 1});
      return x[k * kXCols + l];
    } else {
      return k >= 0 && k < kXRows ? x[k * kXCols + l] : kFill;
    }
  }
}

template <int V, bool kVec>
__global__ void __launch_bounds__(kThreads) gather_probe_kernel(const int32_t* __restrict__ x,
                                                                const int32_t* __restrict__ idx,
                                                                int32_t* __restrict__ out) {
  const int e = threadIdx.x * kPerThread;   // its first element of the row-major tile
  const int i = e / kTileCols;
  const int l = e % kTileCols;
  int4 k;
  if constexpr (kVec) {
    k = *reinterpret_cast<const int4*>(idx + e);
  } else {
    k = make_int4(idx[e], idx[e + 1], idx[e + 2], idx[e + 3]);
  }
  const int4 v = make_int4(gather<V>(x, k.x, i, l), gather<V>(x, k.y, i, l + 1),
                           gather<V>(x, k.z, i, l + 2), gather<V>(x, k.w, i, l + 3));
  if constexpr (kVec) {
    *reinterpret_cast<int4*>(out + e) = v;
  } else {
    out[e] = v.x; out[e + 1] = v.y; out[e + 2] = v.z; out[e + 3] = v.w;
  }
}

using Kernel = void (*)(const int32_t*, const int32_t*, int32_t*);
// [vec][variant], variants in the order of Variant (and of
// probes/gather_probe.py::VARIANTS); [1] the 16-byte instantiations.
const Kernel kKernels[2][kNumVariants] = {
    {gather_probe_kernel<kTakeAlongSublane, false>, gather_probe_kernel<kTakeAlongLane, false>,
     gather_probe_kernel<kVectorIndex, false>},
    {gather_probe_kernel<kTakeAlongSublane, true>, gather_probe_kernel<kTakeAlongLane, true>,
     gather_probe_kernel<kVectorIndex, true>}};

}  // namespace

// x: (64, 256) int32; idx: (8, 128) int32; out: (8, 128) int32. All
// contiguous, on the current device. variant: the index of
// probes/gather_probe.py::VARIANTS.
extern "C" int hrt_gather_probe(int variant, const void* x, const void* idx, void* out,
                                void* stream) {
  if (variant < 0 || variant >= kNumVariants) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  kKernels[vec][variant]<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
