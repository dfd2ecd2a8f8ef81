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
// What bounds it on an H100. The iterations are independent: every address
// comes from the table, and the accumulator only folds the loaded words
// together (an add, an XOR, or a replacement in which the last iteration
// wins). The band (512 x 1024 uint32, 2 MB) cannot fit a block's shared
// memory; it stays in device memory, L2-resident after the first iterations.
// So the least time is the L2 traffic: per iteration and block, the distinct
// 32-byte sectors the tile reads (128 for an aligned (8, 128) window), over
// the card's L2 read rate, and on one block the rate one SM can draw from the
// L2. The design keeps that traffic moving:
//   - the loads of U = 8 iterations are issued before any of them is folded
//     in, and the next 8 iterations' loads are issued before those are: a
//     warp holds 8 to 16 loads in flight, not one;
//   - the table is staged once per block as a per-entry descriptor (the
//     window's first word, the row roll folded in, and the variant's lane
//     shift), made in the preamble: an iteration reads U descriptors as
//     16-byte vectors and adds the thread's offset, with no per-iteration
//     field arithmetic;
//   - `full`'s second word w1 is the next lane's word, taken by a shuffle;
//     the byte realign is one funnel shift. Only lanes 0 .. 22 can be
//     written (the mask [t_sub, t_sub + 16) with t_sub < 8), so lane 31
//     needs no second word, and only the first warp of each row folds the
//     words in; the others load theirs, as the TPU kernel loads its whole
//     window, and keep them alive (keep_alive). Warp w takes row w mod 8 and
//     lanes 32 (w / 8) ..: the eight folding warps are warps 0 .. 7, spread
//     over the SM's four schedulers (warp w issues on scheduler w mod 4).
// Every iteration's loads are issued: once the loop is unrolled, the compilers
// could drop the loads of a replaced accumulator, and the probe's answer is
// the time per iteration, which must grow with n (probe_common.h, load_band
// and keep_alive). empty and smem_only read the raw table with `asm
// volatile` shared loads, so that their sum of table words stays a sum of
// loads.
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

__host__ __device__ constexpr bool is_table_only(int v) {
  return v == kEmpty || v == kSmemOnly;
}
__host__ __device__ constexpr bool is_full(int v) {
  return v == kFull || v == kFullAlignedRows;
}

// The descriptor of one table entry: `base`, the flat index of the first word
// row s = 0 reads (the window's, plus roll0's and full's row roll r0 - ra:
// s + r0 - ra < 16, so the roll never wraps its 16-row window); `aux`, the
// variant's lane shift. roll1, roll1_128: c32 - la, masked to the window;
// full: that (bits 0-7), the realign shift 8 (c & 3) (bits 8-12) and t_sub
// (bits 13-15).
template <int V>
__device__ __forceinline__ void describe(int r0, int c, int t, int& base, int& aux) {
  const int c32 = c >> 2;
  const int la = min(c32 & ~127, kW32 - 256);
  const int ra = r0 & ~7;
  const int rows = window_start(ra, kRows, V == kLoad16x256 || V == kRoll0 ||
                                               V == kRoll0Static || V == kFull ? 16 : 8);
  const int lanes = window_start(la, kW32, V == kLoad8x128 || V == kRoll1_128 ? 128 : 256);
  const int roll = V == kRoll0 || V == kFull ? r0 - ra : 0;
  base = (rows + roll) * kW32 + lanes;
  aux = 0;
  if constexpr (V == kRoll1) aux = (c32 - la) & 255;
  if constexpr (V == kRoll1_128) aux = (c32 - la) & 127;
  if constexpr (is_full(V)) aux = ((c32 - la) & 255) | ((8 * (c & 3)) << 8) | ((t & 7) << 13);
}

// The flat band index element (s, l) reads, from its iteration's descriptor.
template <int V>
__device__ __forceinline__ int word(int base, int aux, int s, int l) {
  if constexpr (V == kRoll0Static) return base + ((s - 5) & 15) * kW32 + l;   // down by 5 rows
  if constexpr (V == kRoll1) return base + s * kW32 + ((l + aux) & 255);
  if constexpr (V == kRoll1Static) return base + s * kW32 + ((l - 37) & 255);  // right by 37
  if constexpr (V == kRoll1_128) return base + s * kW32 + ((l + aux) & 127);
  if constexpr (is_full(V)) return base + s * kW32 + ((l + (aux & 255)) & 255);
  return base + s * kW32 + l;   // the load variants and roll0
}

// Whether a variant's words depend on its descriptor's lane shift aux.
__host__ __device__ constexpr bool has_aux(int v) {
  return v == kRoll1 || v == kRoll1_128 || is_full(v);
}

// Folds U issued iterations into acc, in iteration order. `sink` takes the
// words no element keeps (full's lanes past 31).
template <int V, int U>
__device__ __forceinline__ void fold(uint32_t& acc, uint32_t& sink, const Group<U>& g, int l) {
  if constexpr (is_full(V)) {
    if (l < 32) {   // the warp whose lanes a mask can cover (warp-uniform)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // w1: the next lane's word (lane 31's own w, never written)
        const uint32_t w1 = __shfl_down_sync(0xffffffffu, g.w[u], 1);
        // (w1:w) >> 8 (c & 3): the word at byte offset c; w itself where c & 3 == 0
        const uint32_t v = __funnelshift_r(g.w[u], w1, (g.aux[u] >> 8) & 31);
        if (static_cast<unsigned>(l - (g.aux[u] >> 13)) < 16u) acc = v;
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) sink ^= g.w[u];
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) acc ^= g.w[u];
  }
}

// empty and smem_only: U iterations' table words, read as 16-byte vectors.
template <int V, int U>
__device__ __forceinline__ void fold_table(uint32_t& acc, int j0, const int32_t* st) {
  int r0[U], c[U], t[U];
  read_entries_volatile<U>(st, j0, r0);
  if constexpr (V == kSmemOnly) {
    read_entries_volatile<U>(st + kT, j0, c);
    read_entries_volatile<U>(st + 2 * kT, j0, t);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    acc += static_cast<uint32_t>(r0[u]);
    if constexpr (V == kSmemOnly) {
      acc += static_cast<uint32_t>(c[u]) + static_cast<uint32_t>(t[u] & 7);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kTile) chain_probe_kernel(int n, const int32_t* __restrict__ tab,
                                                            const uint32_t* __restrict__ band,
                                                            uint32_t* __restrict__ out) {
  // The raw table (empty, smem_only) or one descriptor per entry.
  __shared__ __align__(16) int32_t st[3 * kT];
  int32_t* sbase = st;
  int32_t* saux = st + kT;
  if constexpr (is_table_only(V)) {
    for (int k = threadIdx.x; k < 3 * kT; k += blockDim.x) st[k] = tab[k];
  } else {
    for (int j = threadIdx.x; j < kT; j += blockDim.x) {
      describe<V>(tab[j], tab[kT + j], tab[2 * kT + j], sbase[j], saux[j]);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int s = warp & 7;                           // sublane (row of the tile)
  const int l = 32 * (warp >> 3) + (threadIdx.x & 31);   // lane
  uint32_t acc = 0, sink = 0;
  int i = 0;
  if constexpr (is_table_only(V)) {
    // Groups of kU start at multiples of kU, which divides the table: a
    // group never wraps; the last n mod kU iterations go one by one.
    for (; i + kU <= n; i += kU) fold_table<V, kU>(acc, i & (kT - 1), st);
    for (; i < n; ++i) fold_table<V, 1>(acc, i & (kT - 1), st);
  } else {
    // Two groups of kU in turn: one group's loads are in flight while the
    // other is folded in. A group starts at a multiple of kU (it never wraps
    // the table); the last n mod kU iterations go one by one.
    const auto at = [=](int base, int aux) { return word<V>(base, aux, s, l); };
    if (n >= kU) {
      Group<kU> a, b;
      issue_group<has_aux(V)>(a, 0, sbase, saux, band, at);
      for (i = kU; i + 2 * kU <= n; i += 2 * kU) {
        issue_group<has_aux(V)>(b, i & (kT - 1), sbase, saux, band, at);
        fold<V>(acc, sink, a, l);
        issue_group<has_aux(V)>(a, (i + kU) & (kT - 1), sbase, saux, band, at);
        fold<V>(acc, sink, b, l);
      }
      if (i + kU <= n) {
        issue_group<has_aux(V)>(b, i & (kT - 1), sbase, saux, band, at);
        fold<V>(acc, sink, a, l);
        fold<V>(acc, sink, b, l);
        i += kU;
      } else {
        fold<V>(acc, sink, a, l);
      }
    }
    for (; i < n; ++i) {
      Group<1> g;
      issue_group<has_aux(V)>(g, i & (kT - 1), sbase, saux, band, at);
      fold<V>(acc, sink, g, l);
    }
  }
  out[blockIdx.x * kTile + s * 128 + l] = acc;
  keep_alive(sink, n, out + blockIdx.x * kTile + s * 128 + l);
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
