// P2 — the residual-select probe: P1's loop with per-lane row selects, static
// lane slices and dynamic gathers, 10 variants.
//
// Replaces the TPU kernel scripts/chain_probe2.py::run (pallas_call, body
// make_kernel). Iteration i reads entry j = i & 511 of the (3, 512) int32
// table: r0 = tab[0, j], c = tab[1, j], c32 = c >> 2, la = min(c32 & ~127,
// 768), ra = r0 & ~7. res is an (8, 128) int32 tile of residuals dy, 0..16 in
// the script. Element (s, l) then reads, per variant:
//   slice_static       row ra + s, lane la + 37 + l, XORed into acc;
//   slice_static_x17   the XOR of lanes la + 8 + k + l, k = 0..16, into acc;
//   vsel_x17           row ra + 8 (dy mod 3) + s, lane la + l, replacing acc
//                      (exactly one of the 17 selects matches dy in 0..16;
//                      none keeps acc);
//   fastpath_tile      p = l + dy; the row group comes from dy at column
//                      p mod 128 (the TPU kernel's mask is dy == k
//                      concatenated twice along the lanes): row
//                      ra + 8 (dy[s, p mod 128] mod 3) + s, lane la + p,
//                      replacing acc (0 where that dy is out of 0..16);
//   cond_branch        row ra + 8 (r0 & 1) + s, lane la + l, XORed;
//   dyngather_ax0_R    row w + ((s + l + r0) mod R), lane la + l, XORed;
//   dyngather_ax1_R    row w + s, lane la + ((s + l + r0) mod 128), XORed;
// with w the start of the R-row window at ra & ~31. transpose8 has no kernel:
// the JAX kernel XORs an (8, 128) value with an (8, 8) one and does not trace,
// and the wrapper refuses it the same way.
//
// Windows: every dynamic slice start is normalised and clamped as interpret
// mode does (probe_common.h, window_start). For R = 256 the script's
// own table runs the window past the band (ra & ~31 reaches 448); interpret
// mode clamps the start to 256, and so does this kernel.
//
// Where the data lives and what bounds it: as P1. The table (6 KB) and the
// residual tile (4 KB, read at other lanes by fastpath_tile) are staged in
// shared memory; the band (2 MB) stays in device memory, L2-resident. As in
// P1 an iteration waits for its L2 loads (slice_static_x17 makes 17 per
// element, the rest one); a gather whose lanes hit many rows
// (dyngather_ax0_32, _256) costs more L2 transactions per load. One block of
// 1,024 threads per (8, 128) tile; `blocks` identical blocks for the card's
// throughput; one template instantiation per variant.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.h"

namespace {

using namespace hrt_probe;

constexpr int kResidualOptions = 17;   // KV = KH = 17 of the TPU kernel

enum Variant : int {
  kSliceStatic, kSliceStaticX17, kVselX17, kFastpathTile, kCondBranch, kDyngatherAx0_8,
  kDyngatherAx0_32, kDyngatherAx0_256, kDyngatherAx1_8, kDyngatherAx1_32, kNumVariants
};

__device__ __forceinline__ bool is_option(int dy) { return dy >= 0 && dy < kResidualOptions; }

template <int V>
__global__ void __launch_bounds__(kTile) chain_probe2_kernel(
    int n, const int32_t* __restrict__ tab, const uint32_t* __restrict__ band,
    const int32_t* __restrict__ res, uint32_t* __restrict__ out) {
  __shared__ int32_t st[3 * kT];
  __shared__ int32_t dys[kTile];
  for (int k = threadIdx.x; k < 3 * kT; k += blockDim.x) st[k] = tab[k];
  dys[threadIdx.x] = res[threadIdx.x];
  __syncthreads();
  const int s = threadIdx.x >> 7;
  const int l = threadIdx.x & 127;
  const int dy = dys[threadIdx.x];
  // fastpath_tile: the lane p and the residual at its column, loop-invariant.
  const int p = l + dy;
  const int dy_p = is_option(dy) ? dys[s * 128 + (p & 127)] : 0;
  uint32_t acc = 0;
  for (int i = 0; i < n; ++i) {
    const int j = i & (kT - 1);
    const int r0 = st[j];
    const int c = st[kT + j];
    const int c32 = c >> 2;
    const int la = min(c32 & ~127, kW32 - 256);
    const int ra = r0 & ~7;
    if constexpr (V == kSliceStatic) {
      acc ^= band_word(band, window_start(ra, kRows, 8) + s, window_start(la, kW32, 256) + 37 + l);
    } else if constexpr (V == kSliceStaticX17) {
      const int row = window_start(ra, kRows, 8) + s;
      const int l0 = window_start(la, kW32, 256) + 8 + l;
#pragma unroll
      for (int k = 0; k < kResidualOptions; ++k) acc ^= band_word(band, row, l0 + k);
    } else if constexpr (V == kVselX17) {
      if (is_option(dy)) {
        acc = band_word(band, window_start(ra + 8 * (dy % 3), kRows, 8) + s,
                   window_start(la, kW32, 128) + l);
      }
    } else if constexpr (V == kFastpathTile) {
      if (is_option(dy)) {
        acc = is_option(dy_p) ? band_word(band, window_start(ra + 8 * (dy_p % 3), kRows, 8) + s,
                                     window_start(la, kW32, 256) + p)
                              : 0u;
      }
    } else if constexpr (V == kCondBranch) {
      acc ^= band_word(band, window_start(ra + ((r0 & 1) ? 8 : 0), kRows, 8) + s,
                  window_start(la, kW32, 128) + l);
    } else {   // the dynamic gathers: an R-row window at ra & ~31
      constexpr int R = V == kDyngatherAx0_8 || V == kDyngatherAx1_8 ? 8
                        : V == kDyngatherAx0_256                    ? 256
                                                                    : 32;
      constexpr bool kAxis0 = V == kDyngatherAx0_8 || V == kDyngatherAx0_32 ||
                              V == kDyngatherAx0_256;
      const int w0 = window_start(ra & ~31, kRows, R);
      const int l0 = window_start(la, kW32, 128);
      if constexpr (kAxis0) {
        acc ^= band_word(band, w0 + ((s + l + r0) & (R - 1)), l0 + l);
      } else {
        acc ^= band_word(band, w0 + s, l0 + ((s + l + r0) & 127));
      }
    }
  }
  out[blockIdx.x * kTile + threadIdx.x] = acc;
}

template <int V>
cudaError_t launch(int n, const int32_t* tab, const uint32_t* band, const int32_t* res,
                   uint32_t* out, int blocks, cudaStream_t stream) {
  chain_probe2_kernel<V><<<blocks, kTile, 0, stream>>>(n, tab, band, res, out);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(int, const int32_t*, const uint32_t*, const int32_t*,
                                 uint32_t*, int, cudaStream_t);
// In the order of Variant (and of probes/chain_probe2.py::KERNEL_VARIANTS).
const Launcher kLaunchers[kNumVariants] = {
    launch<kSliceStatic>,      launch<kSliceStaticX17>,   launch<kVselX17>,
    launch<kFastpathTile>,     launch<kCondBranch>,       launch<kDyngatherAx0_8>,
    launch<kDyngatherAx0_32>,  launch<kDyngatherAx0_256>, launch<kDyngatherAx1_8>,
    launch<kDyngatherAx1_32>};

}  // namespace

// tab: (3, 512) int32; band: (512, 1024) uint32; res: (8, 128) int32; out:
// (blocks, 8, 128) uint32. All contiguous, on the current device. variant: the
// index of probes/chain_probe2.py::KERNEL_VARIANTS; n >= 0 iterations.
extern "C" int hrt_chain_probe2(int variant, int n, const void* tab, const void* band,
                                const void* res, void* out, int blocks, void* stream) {
  if (variant < 0 || variant >= kNumVariants || n < 0 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(kLaunchers[variant](
      n, static_cast<const int32_t*>(tab), static_cast<const uint32_t*>(band),
      static_cast<const int32_t*>(res), static_cast<uint32_t*>(out), blocks,
      static_cast<cudaStream_t>(stream)));
}
