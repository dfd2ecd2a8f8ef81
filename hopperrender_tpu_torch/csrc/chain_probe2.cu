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
// What bounds it: as P1, the L2 traffic of independent iterations: the
// distinct 32-byte band sectors each iteration reads, over the L2 read rate;
// and where a warp's load touches many 128-byte lines, the count of those
// line requests. The design is P1's (8 iterations' loads in flight before
// any is folded in, the table staged as per-entry descriptors, no
// iteration's load dropped, the replacing variants included: probe_common.h,
// keep_alive), and each variant reads no more than its iteration needs:
//   - slice_static_x17 reads its row's 144 words once: a warp per row, four
//     lanes per thread as one 16-byte load, the tail of 16 words loaded by
//     the first four threads; the 16 words after a thread's own come from
//     the next four threads by shuffles, and the 17-word window is XORed in
//     registers: 18 sectors per row, where 17 loads per element read 17 x 4.
//     A tile then takes 256 threads, so four groups of them fold alternate
//     groups of iterations (XOR is associative) and their tiles are XORed
//     in shared memory at the end: 32 warps hide the shuffles' latency;
//   - the axis-0 gathers read a different row in every lane. Element (s, l)
//     reads row (s + l + r0) mod R, the same for the eight elements of an
//     anti-diagonal s + l = d, whose lanes d - 7 .. d are one or two
//     sectors. A warp takes four anti-diagonals (d mod 128) of 8 sublanes:
//     about five line requests a load, where a warp of 32 lanes of one
//     sublane made 32;
//   - vsel_x17 and fastpath_tile hoist what no iteration changes: the row
//     group (dy mod 3), fastpath_tile's lane p and the residual at column
//     p mod 128. Each thread reads the descriptor of its row group: three
//     per entry, made in the preamble. fastpath_tile's threads are sorted by
//     the line and row group they read (the residuals do not change).
// Every element's load is issued, also where its value is not taken (dy out
// of 0..16), as the TPU kernel loads its whole window. One block of 1,024
// threads per (8, 128) tile; `blocks` identical blocks for the card's
// throughput; one template instantiation per variant.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.h"

namespace {

using namespace hrt_probe;

constexpr int kResidualOptions = 17;   // KV = KH = 17 of the TPU kernel
constexpr int kGroupStride = kT + 4;   // the three row groups' descriptors, on other banks

enum Variant : int {
  kSliceStatic, kSliceStaticX17, kVselX17, kFastpathTile, kCondBranch, kDyngatherAx0_8,
  kDyngatherAx0_32, kDyngatherAx0_256, kDyngatherAx1_8, kDyngatherAx1_32, kNumVariants
};

__host__ __device__ constexpr bool is_axis0(int v) {
  return v == kDyngatherAx0_8 || v == kDyngatherAx0_32 || v == kDyngatherAx0_256;
}
__host__ __device__ constexpr bool is_gather(int v) {
  return is_axis0(v) || v == kDyngatherAx1_8 || v == kDyngatherAx1_32;
}
__host__ __device__ constexpr bool has_groups(int v) {
  return v == kVselX17 || v == kFastpathTile;
}
__host__ __device__ constexpr int gather_rows(int v) {
  return v == kDyngatherAx0_8 || v == kDyngatherAx1_8 ? 8 : v == kDyngatherAx0_256 ? 256 : 32;
}
// slice_static_x17: iterations per group in flight, and the groups of 256
// threads (one tile) that share the block.
constexpr int kX17U = 4, kX17Groups = 4;

__device__ __forceinline__ bool is_option(int dy) { return dy >= 0 && dy < kResidualOptions; }

// fastpath_tile's element (s, l): its lane p = l + dy (dy clamped to
// 0..16), the row group from the residual at column p mod 128, and whether
// that residual is out of 0..16 (the value is then 0).
struct FastLane {
  int p, group;
  bool zero;
};
constexpr int kFastKeys = 15;   // (p / 32) * 3 + group, p < 144

__device__ __forceinline__ FastLane fastpath_lane(const int32_t* dys, int s, int l) {
  const int p = l + min(max(dys[s * 128 + l], 0), kResidualOptions - 1);
  const int dy_p = dys[s * 128 + (p & 127)];
  return {p, max(dy_p, 0) % 3, !is_option(dy_p)};
}

// The descriptors of one table entry: base[g], the flat index of the
// window's first word (g: the row group 0, 8 or 16 of vsel_x17 and
// fastpath_tile; else g = 0 only); aux, the gathers' roll r0 mod R.
template <int V>
__device__ __forceinline__ void describe(int r0, int c, int32_t* base, int& aux) {
  const int c32 = c >> 2;
  const int la = min(c32 & ~127, kW32 - 256);
  const int ra = r0 & ~7;
  const int lanes128 = window_start(la, kW32, 128), lanes256 = window_start(la, kW32, 256);
  aux = 0;
  if constexpr (V == kSliceStatic) {
    base[0] = window_start(ra, kRows, 8) * kW32 + lanes256 + 37;
  } else if constexpr (V == kSliceStaticX17) {
    base[0] = window_start(ra, kRows, 8) * kW32 + lanes256 + 8;
  } else if constexpr (has_groups(V)) {
    const int lanes = V == kVselX17 ? lanes128 : lanes256;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      base[g * kGroupStride] = window_start(ra + 8 * g, kRows, 8) * kW32 + lanes;
    }
  } else if constexpr (V == kCondBranch) {
    base[0] = window_start(ra + ((r0 & 1) ? 8 : 0), kRows, 8) * kW32 + lanes128;
  } else {   // the dynamic gathers: an R-row window at ra & ~31
    constexpr int R = gather_rows(V);
    base[0] = window_start(ra & ~31, kRows, R) * kW32 + lanes128;
    aux = is_axis0(V) ? r0 & (R - 1) : r0 & 127;
  }
}

// The flat band index element (s, l) reads; p is fastpath_tile's lane.
template <int V>
__device__ __forceinline__ int word(int base, int aux, int s, int l, int p) {
  if constexpr (is_axis0(V)) return base + ((s + l + aux) & (gather_rows(V) - 1)) * kW32 + l;
  if constexpr (is_gather(V)) return base + s * kW32 + ((s + l + aux) & 127);
  if constexpr (V == kFastpathTile) return base + s * kW32 + p;
  return base + s * kW32 + l;
}

// Folds U issued iterations into acc, in iteration order: `keep` whether the
// replacing variants take the value, `zero` whether fastpath_tile's value is
// 0; `sink` takes the replacing variants' words, most of which a later
// iteration replaces.
template <int V, int U>
__device__ __forceinline__ void fold(uint32_t& acc, uint32_t& sink, const Group<U>& g, bool keep,
                                     bool zero) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if constexpr (has_groups(V)) {
      sink ^= g.w[u];
      if (keep) acc = zero ? 0u : g.w[u];
    } else {
      acc ^= g.w[u];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kTile) chain_probe2_kernel(
    int n, const int32_t* __restrict__ tab, const uint32_t* __restrict__ band,
    const int32_t* __restrict__ res, uint32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t sbase[3 * kGroupStride];
  __shared__ __align__(16) int32_t saux[kT];
  __shared__ int32_t dys[kTile];
  for (int j = threadIdx.x; j < kT; j += blockDim.x) {
    describe<V>(tab[j], tab[kT + j], sbase + j, saux[j]);
  }
  for (int k = threadIdx.x; k < kTile; k += blockDim.x) dys[k] = res[k];
  __syncthreads();
  int s, l;
  if constexpr (is_axis0(V)) {   // a warp: 4 anti-diagonals (mod 128) of 8 sublanes
    const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
    s = k & 7;
    l = (4 * warp + (k >> 3) - s) & 127;
  } else if constexpr (V == kFastpathTile) {
    // Each row's threads in the order of the 32-lane line and the row group
    // their element reads, both loop-invariant: a counting sort of the row's
    // 128 elements by key, so that a warp's loads touch about three lines,
    // where 32 lanes l read lanes l + dy of three row groups, about six.
    __shared__ int counts[8][kFastKeys];
    __shared__ int order[kTile];
    const int es = threadIdx.x >> 7, el = threadIdx.x & 127;
    const FastLane e = fastpath_lane(dys, es, el);
    const int key = (e.p >> 5) * 3 + e.group;
    for (int k = threadIdx.x; k < 8 * kFastKeys; k += blockDim.x) {
      counts[k / kFastKeys][k % kFastKeys] = 0;
    }
    __syncthreads();
    const int rank = atomicAdd(&counts[es][key], 1);
    __syncthreads();
    if (threadIdx.x < 8) {   // each row's counts into the start of each key
      int start = 0;
      for (int k = 0; k < kFastKeys; ++k) {
        const int count = counts[threadIdx.x][k];
        counts[threadIdx.x][k] = start;
        start += count;
      }
    }
    __syncthreads();
    order[es * 128 + counts[es][key] + rank] = threadIdx.x;
    __syncthreads();
    s = order[threadIdx.x] >> 7;
    l = order[threadIdx.x] & 127;
  } else {
    s = threadIdx.x >> 7;
    l = threadIdx.x & 127;
  }
  // Loop-invariant: the row group, fastpath_tile's lane p and the residual
  // at its column (the plain version's clamps, for residuals outside 0..16).
  const int dy = dys[s * 128 + l];
  const bool keep = is_option(dy);
  int group = 0, p = l;
  bool zero = false;
  if constexpr (V == kFastpathTile) {
    const FastLane e = fastpath_lane(dys, s, l);
    p = e.p, group = e.group, zero = e.zero;
  } else if constexpr (V == kVselX17) {
    group = max(dy, 0) % 3;
  }
  // The thread's descriptors are its row group's; the gathers' aux is their roll.
  const int32_t* mine = sbase + group * kGroupStride;
  const auto at = [=](int base, int aux) { return word<V>(base, aux, s, l, p); };
  uint32_t acc = 0, sink = 0;
  int i = 0;
  // Groups of kU start at multiples of kU, which divides the table: a group
  // never wraps; the last n mod kU iterations go one by one. (P1's two
  // groups in turn were slower here.)
  for (; i + kU <= n; i += kU) {
    Group<kU> g;
    issue_group<is_gather(V)>(g, i & (kT - 1), mine, saux, band, at);
    fold<V>(acc, sink, g, keep, zero);
  }
  for (; i < n; ++i) {
    Group<1> g;
    issue_group<is_gather(V)>(g, i & (kT - 1), mine, saux, band, at);
    fold<V>(acc, sink, g, keep, zero);
  }
  out[blockIdx.x * kTile + s * 128 + l] = acc;
  keep_alive(sink, n, out + blockIdx.x * kTile + s * 128 + l);
}

// slice_static_x17: a warp per row s, thread k of it owning lanes 4k .. 4k + 3
// of the tile. Row word m of the iteration is band[base + s * kW32 + m]; the
// element at lane 4k + e is the XOR of words 4k + e .. 4k + e + 16, so thread
// k needs words 4k .. 4k + 19: its own four, and four from each of threads
// k + 1 .. k + 4 (for k + m >= 32: the tail words 128 .. 143, held by threads
// 0 .. 3). kAligned: the band is 16-byte aligned (one vector load).
template <int U, bool kAligned>
__device__ __forceinline__ void fold_x17(uint32_t (&acc)[4], int j0, const int32_t* sbase,
                                         const uint32_t* band, int s, int k) {
  int base[U];
  read_entries<U>(sbase, j0, base);
  uint4 own[U], tail[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint32_t* row = band + base[u] + s * kW32;
    own[u] = load_band4_if<kAligned>(true, row + 4 * k);
    tail[u] = load_band4_if<kAligned>(k < 4, row + 128 + 4 * k);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    uint32_t x[20];
    x[0] = own[u].x, x[1] = own[u].y, x[2] = own[u].z, x[3] = own[u].w;
#pragma unroll
    for (int m = 1; m <= 4; ++m) {   // thread j sends to thread j - m: its tail if j < m
      const uint4 send = k < m ? tail[u] : own[u];
      const int from = (k + m) & 31;
      x[4 * m] = __shfl_sync(0xffffffffu, send.x, from);
      x[4 * m + 1] = __shfl_sync(0xffffffffu, send.y, from);
      x[4 * m + 2] = __shfl_sync(0xffffffffu, send.z, from);
      x[4 * m + 3] = __shfl_sync(0xffffffffu, send.w, from);
    }
    uint32_t mid = 0;   // words 3 .. 16, in every window
#pragma unroll
    for (int q = 3; q <= 16; ++q) mid ^= x[q];
    const uint32_t a = x[1] ^ x[2], b = x[17] ^ x[18];
    acc[0] ^= mid ^ x[0] ^ a;
    acc[1] ^= mid ^ a ^ x[17];
    acc[2] ^= mid ^ x[2] ^ b;
    acc[3] ^= mid ^ b ^ x[19];
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kTile) slice_x17_kernel(int n, const int32_t* __restrict__ tab,
                                                          const uint32_t* __restrict__ band,
                                                          uint32_t* __restrict__ out) {
  constexpr int kThreads = kTile / 4;   // one tile: a warp per row, four lanes a thread
  __shared__ __align__(16) int32_t sbase[kT];
  __shared__ uint4 part[kX17Groups - 1][kThreads];
  for (int j = threadIdx.x; j < kT; j += blockDim.x) {
    int aux;
    describe<kSliceStaticX17>(tab[j], tab[kT + j], sbase + j, aux);
  }
  __syncthreads();
  const int group = threadIdx.x / kThreads, t = threadIdx.x % kThreads;
  const int s = t >> 5, k = t & 31;
  uint32_t acc[4] = {0, 0, 0, 0};
  // Group g folds the runs b = g, g + 4, ... of kX17U iterations (a run starts
  // at a multiple of kX17U: it never wraps the table); the last n mod kX17U
  // iterations go one by one to the group next in turn.
  const int runs = n / kX17U;
  for (int b = group; b < runs; b += kX17Groups) {
    fold_x17<kX17U, kAligned>(acc, (b * kX17U) & (kT - 1), sbase, band, s, k);
  }
  if (group == runs % kX17Groups) {
    for (int i = runs * kX17U; i < n; ++i) {
      fold_x17<1, kAligned>(acc, i & (kT - 1), sbase, band, s, k);
    }
  }
  if (group > 0) part[group - 1][t] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (group > 0) return;
#pragma unroll
  for (int g = 0; g < kX17Groups - 1; ++g) {
    const uint4 q = part[g][t];
    acc[0] ^= q.x, acc[1] ^= q.y, acc[2] ^= q.z, acc[3] ^= q.w;
  }
  uint32_t* o = out + blockIdx.x * kTile + s * 128 + 4 * k;
  if constexpr (kAligned) {
    *reinterpret_cast<uint4*>(o) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    o[0] = acc[0], o[1] = acc[1], o[2] = acc[2], o[3] = acc[3];
  }
}

template <int V>
cudaError_t launch(int n, const int32_t* tab, const uint32_t* band, const int32_t* res,
                   uint32_t* out, int blocks, cudaStream_t stream) {
  if constexpr (V == kSliceStaticX17) {
    // The vector loads and stores need 16-byte alignment of band and out
    // (a tensor view may start anywhere on a word).
    if (((reinterpret_cast<uintptr_t>(band) | reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
      slice_x17_kernel<true><<<blocks, kTile, 0, stream>>>(n, tab, band, out);
    } else {
      slice_x17_kernel<false><<<blocks, kTile, 0, stream>>>(n, tab, band, out);
    }
  } else {
    chain_probe2_kernel<V><<<blocks, kTile, 0, stream>>>(n, tab, band, res, out);
  }
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
