// P1 — the per-chain cost probe: n iterations of a table-driven fetch into an
// (8, 128) uint32 accumulator, 12 variants.
//
// Replaces the TPU kernel scripts/chain_probe.py::run (pallas_call, body
// make_kernel). Iteration i reads entry j = i & 511 of the (3, 512) int32
// table: r0 = tab[0, j], c = tab[1, j], t_sub = tab[2, j] & 7, c32 = c >> 2,
// sub = c & 3, la = min(c32 & ~127, 768), ra = r0 & ~7. Element (s, l) of the
// tile then reads the band word the variant names (the closed forms below).
//
// Windows. Each of the TPU kernel's dynamic slices is a window whose start
// follows interpret mode (probe_common.h, window_start), so a table outside
// the script's ranges reads what interpret mode reads. Within the script's
// ranges no start is clamped.
//
// The TPU's realign machinery (pltpu.roll over a (16, 256) window, the
// shift-or pair of the `full` chain, the lane mask) is not carried over: each
// thread computes the address of the word its element needs and loads that
// word, which gives the JAX kernel's result bit for bit. load8x256 and
// load16x256 equal load8x128 (JAX loads a wider window than it uses); here
// they load the same one word per element too, and differ from load8x128
// only in their window's clamp.
//
// Where the data lives. The block stages the table (6 KB) into shared memory,
// the counterpart of the TPU kernel's SMEM. The band (512 x 1024 uint32,
// 2 MB) cannot fit a block's 227 KB of shared memory, so it stays in device
// memory and is L2-resident after the first iterations (the L2 holds 50 MB):
// every load of the loop is an L2 (or L1) hit.
//
// What bounds it on an H100: not bytes (2 MB read once) but the latency of
// the loop. Per iteration a few shared-memory loads, ~10 integer operations
// for the fields and the address, and one L2 load. The table, not the
// accumulator, names the address, yet the loop is not unrolled and a warp
// stalls on its load before the XOR, so each warp holds one load in flight:
// measured, an iteration costs one L2 round trip, alike on 1 and 132 blocks.
// That is the probe's answer, so the loop is left as the TPU kernel wrote it.
// One block of 1,024 threads (one per element of the tile) is the TPU's one
// core on one SM; `blocks` identical blocks, each writing its own (8, 128)
// slot, put one on every SM (132) for the card's throughput. The variant is a
// template parameter: no switch runs inside the timed loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.h"

namespace {

using namespace hrt_probe;

enum Variant : int {
  kEmpty, kSmemOnly, kLoad8x128, kLoad8x256, kLoad16x256, kRoll0, kRoll0Static, kRoll1,
  kRoll1Static, kRoll1_128, kFull, kFullAlignedRows, kNumVariants
};

template <int V>
__global__ void __launch_bounds__(kTile) chain_probe_kernel(int n, const int32_t* __restrict__ tab,
                                                            const uint32_t* __restrict__ band,
                                                            uint32_t* __restrict__ out) {
  __shared__ int32_t st[3 * kT];
  for (int k = threadIdx.x; k < 3 * kT; k += blockDim.x) st[k] = tab[k];
  __syncthreads();
  const int s = threadIdx.x >> 7;    // sublane (row of the tile)
  const int l = threadIdx.x & 127;   // lane
  uint32_t acc = 0;
  for (int i = 0; i < n; ++i) {
    const int j = i & (kT - 1);
    const int r0 = st[j];
    const int c = st[kT + j];
    const int t_sub = st[2 * kT + j] & 7;
    const int c32 = c >> 2;
    const int sub = c & 3;
    const int la = min(c32 & ~127, kW32 - 256);
    const int ra = r0 & ~7;
    if constexpr (V == kEmpty) {
      acc += static_cast<uint32_t>(r0);
    } else if constexpr (V == kSmemOnly) {
      acc += static_cast<uint32_t>(r0) + static_cast<uint32_t>(c) + static_cast<uint32_t>(t_sub);
    } else if constexpr (V == kLoad8x128) {
      acc ^= band_word(band, window_start(ra, kRows, 8) + s, window_start(la, kW32, 128) + l);
    } else if constexpr (V == kLoad8x256) {
      acc ^= band_word(band, window_start(ra, kRows, 8) + s, window_start(la, kW32, 256) + l);
    } else if constexpr (V == kLoad16x256) {
      acc ^= band_word(band, window_start(ra, kRows, 16) + s, window_start(la, kW32, 256) + l);
    } else if constexpr (V == kRoll0) {   // the (16, 256) window rolled up by r0 - ra rows
      acc ^= band_word(band, window_start(ra, kRows, 16) + ((s + r0 - ra) & 15),
                  window_start(la, kW32, 256) + l);
    } else if constexpr (V == kRoll0Static) {   // rolled down by 5 rows
      acc ^= band_word(band, window_start(ra, kRows, 16) + ((s - 5) & 15),
                  window_start(la, kW32, 256) + l);
    } else if constexpr (V == kRoll1) {   // the (8, 256) window rolled left by c32 - la lanes
      acc ^= band_word(band, window_start(ra, kRows, 8) + s,
                  window_start(la, kW32, 256) + ((l + c32 - la) & 255));
    } else if constexpr (V == kRoll1Static) {   // rolled right by 37 lanes
      acc ^= band_word(band, window_start(ra, kRows, 8) + s,
                  window_start(la, kW32, 256) + ((l - 37) & 255));
    } else if constexpr (V == kRoll1_128) {
      acc ^= band_word(band, window_start(ra, kRows, 8) + s,
                  window_start(la, kW32, 128) + ((l + c32 - la) & 127));
    } else {   // kFull, kFullAlignedRows: the byte-realigned word, into lanes [t_sub, t_sub + 16)
      const int row = V == kFull ? window_start(ra, kRows, 16) + ((s + r0 - ra) & 15)
                                 : window_start(ra, kRows, 8) + s;
      const int l0 = window_start(la, kW32, 256);
      const uint32_t w = band_word(band, row, l0 + ((l + c32 - la) & 255));
      uint32_t v = w;
      if (sub != 0) {   // a shift by 32 is undefined in C++: sub == 0 keeps w
        const uint32_t w1 = band_word(band, row, l0 + ((l + 1 + c32 - la) & 255));
        const int sh = 8 * sub;
        v = (w >> sh) | (w1 << (32 - sh));
      }
      if (l >= t_sub && l < t_sub + 16) acc = v;
    }
  }
  out[blockIdx.x * kTile + threadIdx.x] = acc;
}

template <int V>
cudaError_t launch(int n, const int32_t* tab, const uint32_t* band, uint32_t* out, int blocks,
                   cudaStream_t stream) {
  chain_probe_kernel<V><<<blocks, kTile, 0, stream>>>(n, tab, band, out);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(int, const int32_t*, const uint32_t*, uint32_t*, int,
                                 cudaStream_t);
// In the order of Variant (and of probes/chain_probe.py::VARIANTS).
const Launcher kLaunchers[kNumVariants] = {
    launch<kEmpty>, launch<kSmemOnly>, launch<kLoad8x128>, launch<kLoad8x256>,
    launch<kLoad16x256>, launch<kRoll0>, launch<kRoll0Static>, launch<kRoll1>,
    launch<kRoll1Static>, launch<kRoll1_128>, launch<kFull>, launch<kFullAlignedRows>};

}  // namespace

// tab: (3, 512) int32; band: (512, 1024) uint32; out: (blocks, 8, 128) uint32.
// All contiguous, on the current device. variant: the index of
// probes/chain_probe.py::VARIANTS; n >= 0 iterations.
extern "C" int hrt_chain_probe(int variant, int n, const void* tab, const void* band, void* out,
                               int blocks, void* stream) {
  if (variant < 0 || variant >= kNumVariants || n < 0 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(kLaunchers[variant](
      n, static_cast<const int32_t*>(tab), static_cast<const uint32_t*>(band),
      static_cast<uint32_t*>(out), blocks, static_cast<cudaStream_t>(stream)));
}
