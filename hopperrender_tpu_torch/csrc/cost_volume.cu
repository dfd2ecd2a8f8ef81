// K3 — the cost volume of one pyramid step, as compact window sums; K4 — the
// per-window argmin over the layers and the commit of the winning offset;
// and the pyramid step that launches one after the other.
//
// What they replace. Neither replaces a pallas_call: the JAX package computes
// both in XLA (hopperrender_tpu/ops/flow.py:63 delta_window_sums, :178-201
// lowest_layer and adjust_offsets). They are the reference's calcDeltaSums
// and determineLowestLayer + adjustOffsetArray (calcDeltaSumsKernelSDR.h,
// determineLowestLayerKernelSDR.h, adjustOffsetArrayKernelSDR.h).
//
// K3. For each flow cell (cx, cy) of (low_h, low_w) and each candidate layer
// l of [0, num_layers), global layer g = layer_offset + l < radius:
//   rel   = signed_square(g % radius - radius / 2), as int16;
//   off   = int16(ideal + rel) on the step's axis (x in step 0, y in step 1);
//   delta = |f1(mirror(scaled + off)) - f2(clamp(scaled))| over Y, U and V
//           (HDR samples >> 8), << delta_scalar, and 0 where the scaled cell
//           lies outside the frame;
//   total = delta + |off| (+ the four neighbours' sum |n - off| at +-2 window,
//           edge-clamped, << neighbor_scalar, from FIRST_NEIGHBOR_ITERATION);
//   sums[l, cy / window, cx / window] += total, in uint32 (wraps).
// Every term is an add or a left shift by at most 31, so uint32 sums in any
// order equal the plain version's int64 sum mod 2**32: atomics do not make
// the result depend on the order.
//
// What bounds K3 on an H100: the operations per candidate (two gathered
// loads of frame 1 and ~40 integer operations), not the bytes; at radius 5
// in step 1 the distinct sectors of frame 1's rows come close. At res_scalar
// 3 (a 4K frame at the default MaxCalcRes, 270) a step reads every 8th row of
// frame 1 near the cells, which stays in the 50 MB L2; at res_scalar 0 (the
// flow at the frame's own resolution) it reads frame 1 densely, 64x the
// cells, and a 4K HDR pair's planes (50 MB) no longer fit beside the rest.
// Timed in variants (hrt_delta_sums_probe), a first, simpler
// kernel lost its time to a fill launch before every call, to its
// reduction (five shuffles and a shared-memory atomic per layer and warp)
// and to issuing each layer's loads only after the last were used; pointing
// every gather at the cell's own pixel saved almost nothing, so frame 1's
// rows are not staged in shared memory. The design:
//   - a thread owns a cell and loops over its layers in chunks of 8: every
//     index of a chunk is valid (a thread past the grid reads its edge cell
//     and adds 0), so all of a chunk's loads issue before any is used;
//     frame 2's samples, the fixed axis's mirrored position, the offsets and
//     the four neighbours load once a cell; the layers' candidate offsets
//     come in the kernel's parameters (`Rel`), computed once on the host;
//   - U and V sit side by side at an even index: one 32-bit (HDR) or 16-bit
//     (SDR) load reads both (the wrappers refuse an odd or short UV row and
//     a misaligned UV plane); indices are 32-bit (planes below 2**31);
//   - a block is a tile of 8 rows x 32 cells, a warp a row, 4 blocks an SM,
//     so a 4K flow's 510 blocks at res_scalar 3 fit one wave on 132 SMs
//     (at res_scalar 0, 32,400 blocks: 62 waves); windows are powers
//     of two aligned to the tile. A warp reduces its layers over a window's
//     lanes by halving exchange (each shuffle carries one of the layers a
//     lane still holds: 15 shuffles for 16 layers where a tree a layer takes
//     80), specialised per window width; then neighbouring lanes read a
//     window's rows from shared memory and shuffle-sum them;
//   - a window of at most 8 cells a side lies in one block, which stores its
//     sums; a larger window takes one atomic per (layer, window, block) into
//     sums that arrive zeroed (at res_scalar 0 the first windows are 2048
//     cells a side: every block of the grid adds into the same 4 windows
//     a layer). On the pyramid path (hrt_flow_step) the step
//     before clears them in its K4 and layers past the radius are never
//     written (K4 does not read them); hrt_delta_sums keeps a fill launch,
//     which also writes 0xFFFFFFFF past the radius.
//
// K4. For each window, the first strict minimum (unsigned) of its sums over
// layers [0, min(radius, num_layers)); then every cell of the window commits
// out[step & 1] = int16(in[step & 1] + signed_square(winner - radius / 2));
// where out is not in, the other plane is copied. At 4K and res_scalar 3 it
// moves 0.5 MB of offsets (33 MB at res_scalar 0), so its bound (0.26 us)
// lies below a launch's floor (~1 us): its time there is the launch, the
// dispatch of its blocks and a chain of memory latencies (the offsets'
// read-modify-write; the scan, then the barrier, then the store). A thread a cell scanning its window's layers one load after
// another would add a round trip a layer. Here a block is a tile of 8 x 128
// cells (136 blocks at 4K and res_scalar 3, about one an SM; 8,100 at
// res_scalar 0): every thread loads its four cells' offsets, then the
// tile's windows are scanned a thread a window with the scan unrolled to 16
// layers and predicated, so all of its loads are in flight with the offsets'; the winners' adjustments meet the cells through
// shared memory. On the pyramid path K4 also clears the next step's sums
// (when that step adds with atomics) and, at iteration 0 step 0, writes the
// raw frame delta (window (0, 0) of layer radius / 2 - 1, as Python indexes
// it) into a 0-dim int64.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileX = 32, kTileY = 8;          // cells a block: a warp a row
constexpr int kThreads = kTileX * kTileY;
constexpr int kBlocksPerSM = 4;                 // a 4K flow's 510 tiles in one wave (rs 3)
constexpr int kMaxLayers = 16;                  // MAX_SEARCH_RADIUS
constexpr int kFillThreads = 256;
constexpr uint32_t kFull = 0xFFFFFFFFu;

// Each layer's candidate offset on the searched axis, int16-wrapped.
struct Rel {
  int v[kMaxLayers];
};

__device__ __host__ __forceinline__ int signed_square(int r) { return r > 0 ? r * r : -(r * r); }

// Single-branch mirror, then the clamp (ref: calcDeltaSumsKernelSDR.h:86-95).
__device__ __forceinline__ int mirror_clamp(int p, int dim) {
  const int m = p >= dim ? 2 * dim - 1 - p : (p < 0 ? -p - 1 : p);
  return min(max(m, 0), dim - 1);
}

// A plane's sample, and the (U, V) pair that one load reads.
template <typename T> struct Pair;
template <> struct Pair<uint8_t> { using type = uint16_t; };
template <> struct Pair<uint16_t> { using type = uint32_t; };

template <typename T>
__device__ __forceinline__ void split_pair(uint32_t w, int& u, int& v) {
  constexpr int kShift = sizeof(T) == 2 ? 8 : 0;    // HDR samples compare as >> 8
  u = (w >> kShift) & 0xFF;
  v = w >> (8 * sizeof(T) + kShift);
}

__global__ void fill_sums_kernel(uint32_t* __restrict__ sums, int per_layer, int active,
                                 int total) {
  const int i = blockIdx.x * kFillThreads + threadIdx.x;
  if (i < total) sums[i] = i < active * per_layer ? 0u : kFull;
}

// Halving exchange over the lane bits kBit, kBit - 1, ..., 0 of a warp: the
// lane whose bit is set keeps the upper half of the kHeld layers it holds and
// receives its partner's upper half, the other the lower half, so each
// shuffle carries one layer and each stage halves the layers a lane holds;
// once a lane holds one layer, the bits left are summed by plain shuffles.
template <int kHeld, int kBit, int N>
__device__ __forceinline__ void halve(uint32_t (&v)[N], int lane) {
  if constexpr (kBit >= 0) {
    if constexpr (kHeld > 1) {
      const bool upper = lane & (1 << kBit);
#pragma unroll
      for (int i = 0; i < kHeld / 2; ++i) {
        const uint32_t send = upper ? v[i] : v[i + kHeld / 2];
        const uint32_t keep = upper ? v[i + kHeld / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, 1 << kBit);
      }
      halve<kHeld / 2, kBit - 1>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], 1 << kBit);
      halve<1, kBit - 1>(v, lane);
    }
  }
}

constexpr int kPartStride = kTileY + 1;   // `part`'s words a slot: a row each, padded

// A window's share of a warp's row is an aligned group of 2**kLog2Group
// lanes (32 at most). After the exchange over the group's bits a lane holds
// `held` layers of its window, summed over the group; the lanes that hold
// them first write them to part[(layer * windows across + window) *
// kPartStride + row].
template <int kLayers, int kLog2Group>
__device__ __forceinline__ void reduce_row(uint32_t (&v)[kLayers], uint32_t* part, int lane,
                                           int row) {
  constexpr int kLog2Layers = kLayers == 16 ? 4 : 3;
  constexpr int kStages = kLog2Group < kLog2Layers ? kLog2Group : kLog2Layers;
  constexpr int kRest = kLog2Group - kStages;     // bits summed by plain shuffles
  constexpr int kHeld = kLayers >> kStages;
  constexpr int kWindows = kTileX >> kLog2Group;  // windows across the tile
  halve<kLayers, kLog2Group - 1>(v, lane);
  if ((lane & ((1 << kRest) - 1)) == 0) {
    const int first = ((lane >> kRest) & ((1 << kStages) - 1)) * kHeld;
    const int window = lane >> kLog2Group;
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      part[((first + j) * kWindows + window) * kPartStride + row] = v[j];
    }
  }
}

// T: uint8_t (SDR) or uint16_t (HDR). kStepY: the step searches y (step 1).
// kNeighbors: the neighbour term is on (iteration >= FIRST_NEIGHBOR_ITERATION).
// kLayers: 8 or 16, at least n_active. kProbe: 0 as on the path; for timing
// only, 1 points every gather at the cell's own pixel, 2 stores one word a
// thread into probe_out in place of the reduction, 3 returns at once (the
// floor of a launch of K3's grid).
template <typename T, bool kStepY, bool kNeighbors, int kLayers, int kProbe>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) delta_sums_kernel(
    const T* __restrict__ f1y, const typename Pair<T>::type* __restrict__ f1uv,
    const T* __restrict__ f2y, const typename Pair<T>::type* __restrict__ f2uv,
    const int16_t* __restrict__ offsets, uint32_t* __restrict__ sums,
    uint32_t* __restrict__ probe_out, int dim_y, int dim_x, int uv_h, int uv_pairs, int low_h,
    int low_w, int n_win_y, int n_win_x, int delta_scalar, int neighbor_scalar,
    int log2_window, int res_scalar, int n_active, Rel rel) {
  if (kProbe == 3) return;
  constexpr int kShift = sizeof(T) == 2 ? 8 : 0;
  __shared__ uint32_t part[kMaxLayers * kTileX * kPartStride];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int cx = blockIdx.x * kTileX + lane, cy = blockIdx.y * kTileY + row;
  const bool in_grid = cx < low_w && cy < low_h;
  // A thread past the grid reads its edge cell's data and adds 0, so that no
  // load waits behind a branch.
  const int gx = min(cx, low_w - 1), gy = min(cy, low_h - 1), cell = gy * low_w + gx;
  const int plane = low_h * low_w;
  const int scx = cx << res_scalar, scy = cy << res_scalar;
  const uint32_t frame_mask = in_grid && scx < dim_x && scy < dim_y ? kFull : 0u;
  const int sx = min(scx, dim_x - 1), sy = min(scy, dim_y - 1);
  const int ox = offsets[cell], oy = offsets[plane + cell];
  const int ideal = kStepY ? oy : ox;
  // The fixed axis: step 0 searches x on row `fixed`, step 1 y in column `fixed`.
  const int fixed = kStepY ? mirror_clamp(scx + ox, dim_x) : mirror_clamp(scy + oy, dim_y);
  const int y_base = kStepY ? fixed : fixed * dim_x;
  const int uv_base = kStepY ? fixed >> 1 : min(fixed >> 1, uv_h - 1) * uv_pairs;
  const int y2 = f2y[sy * dim_x + sx] >> kShift;
  int u2, v2;
  split_pair<T>(f2uv[min(sy >> 1, uv_h - 1) * uv_pairs + (sx >> 1)], u2, v2);
  int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
  if (kNeighbors) {
    // down, right, left, up at +-2 window, edge-clamped, from the searched
    // axis's plane (ref: calcDeltaSumsKernelSDR.h:112-131).
    const int16_t* p = offsets + (kStepY ? plane : 0);
    const int d = 2 << log2_window;
    n0 = p[min(gy + d, low_h - 1) * low_w + gx];
    n1 = p[gy * low_w + min(gx + d, low_w - 1)];
    n2 = p[gy * low_w + max(gx - d, 0)];
    n3 = p[max(gy - d, 0) * low_w + gx];
  }

  // Chunks of 8 layers: every gather of a chunk is issued before any is used.
  constexpr int kChunk = 8;
  uint32_t total[kLayers];
#pragma unroll
  for (int c = 0; c < kLayers; c += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) total[c + j] = 0;
    if (c >= n_active) continue;
    int ys[kChunk];
    uint32_t pairs[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int off = static_cast<int16_t>(ideal + rel.v[c + j]);
      int yi, pi;
      if (kStepY) {
        int my = mirror_clamp(scy + off, dim_y);
        if (kProbe == 1) my = sy + (static_cast<unsigned>(my) >> 30);
        yi = my * dim_x + y_base;
        pi = min(my >> 1, uv_h - 1) * uv_pairs + uv_base;
      } else {
        int mx = mirror_clamp(scx + off, dim_x);
        if (kProbe == 1) mx = sx + (static_cast<unsigned>(mx) >> 30);
        yi = y_base + mx;
        pi = uv_base + (mx >> 1);
      }
      ys[j] = f1y[yi];
      pairs[j] = f1uv[pi];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int off = static_cast<int16_t>(ideal + rel.v[c + j]);
      int u1, v1;
      split_pair<T>(pairs[j], u1, v1);
      const uint32_t delta = abs((ys[j] >> kShift) - y2) + abs(u1 - u2) + abs(v1 - v2);
      uint32_t t = static_cast<uint32_t>(abs(off)) + ((delta << delta_scalar) & frame_mask);
      if (kNeighbors) {
        const uint32_t nb = abs(n0 - off) + abs(n1 - off) + abs(n2 - off) + abs(n3 - off);
        t += nb << neighbor_scalar;
      }
      total[c + j] = in_grid && c + j < n_active ? t : 0u;
    }
  }
  if (kProbe == 2) {
    uint32_t all = 0;
#pragma unroll
    for (int l = 0; l < kLayers; ++l) all += total[l];
    if (in_grid) probe_out[cy * low_w + cx] = all;
    return;
  }

  // Each warp sums its row's share of each window, then the rows of a window
  // add up: `rows` neighbouring lanes read a (layer, window)'s rows and one
  // shuffle-sums them. A block-owned window is stored, a larger one added.
  switch (min(log2_window, 5)) {
    case 0: reduce_row<kLayers, 0>(total, part, lane, row); break;
    case 1: reduce_row<kLayers, 1>(total, part, lane, row); break;
    case 2: reduce_row<kLayers, 2>(total, part, lane, row); break;
    case 3: reduce_row<kLayers, 3>(total, part, lane, row); break;
    case 4: reduce_row<kLayers, 4>(total, part, lane, row); break;
    default: reduce_row<kLayers, 5>(total, part, lane, row); break;
  }
  __syncthreads();
  const int log2_rows = min(log2_window, 3);          // a window's rows in the tile
  const int log2_wy = 3 - log2_rows, log2_wx = 5 - min(log2_window, 5);
  const int n_pairs = n_active << (3 + log2_wx);      // (layer, window, row of it)
  const int wx0 = (blockIdx.x * kTileX) >> log2_window;
  const int wy0 = (blockIdx.y * kTileY) >> log2_window;
  const int layer_stride = n_win_y * n_win_x;
  for (int base = 0; base < n_pairs; base += kThreads) {
    const int i = base + row * kTileX + lane;
    const int r = i & ((1 << log2_rows) - 1), o = i >> log2_rows;
    const int wx = o & ((1 << log2_wx) - 1), wy = (o >> log2_wx) & ((1 << log2_wy) - 1);
    const int l = o >> (log2_wx + log2_wy);
    uint32_t s = i < n_pairs ? part[((l << log2_wx) + wx) * kPartStride + (wy << log2_rows) + r]
                             : 0u;
    for (int m = 1; m < 1 << log2_rows; m <<= 1) s += __shfl_xor_sync(kFull, s, m);
    if (r == 0 && i < n_pairs && wy0 + wy < n_win_y && wx0 + wx < n_win_x) {
      uint32_t* dst = sums + l * layer_stride + (wy0 + wy) * n_win_x + wx0 + wx;
      if (log2_window <= 3) {
        *dst = s;
      } else if (s) {
        atomicAdd(dst, s);
      }
    }
  }
}

int log2_of(int window) {
  int lw = 0;
  while ((1 << lw) < window) ++lw;
  return lw;
}

Rel layer_offsets(int radius, int layer_offset, int n_active) {
  Rel rel{};
  for (int l = 0; l < n_active; ++l) {
    rel.v[l] = static_cast<int16_t>(signed_square((layer_offset + l) % radius - radius / 2));
  }
  return rel;
}

struct Step {
  const void *f1y, *f1uv, *f2y, *f2uv;
  const int16_t* offsets;
  uint32_t* sums;
  int dim_y, dim_x, uv_h, uv_w, low_h, low_w, radius, delta_scalar, neighbor_scalar;
  int log2_window, res_scalar, neighbors, step, is_hdr;
  int n_win_y() const { return (low_h + (1 << log2_window) - 1) >> log2_window; }
  int n_win_x() const { return (low_w + (1 << log2_window) - 1) >> log2_window; }
};

template <typename T, int kProbe>
void launch_delta_sums(const Step& a, int layer_offset, int n_active, uint32_t* probe_out,
                       cudaStream_t s) {
  using P = typename Pair<T>::type;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((a.low_w + kTileX - 1) / kTileX, (a.low_h + kTileY - 1) / kTileY);
  auto pick = [&](auto layers) {
    constexpr int L = decltype(layers)::value;
    return a.step ? (a.neighbors ? delta_sums_kernel<T, true, true, L, kProbe>
                                 : delta_sums_kernel<T, true, false, L, kProbe>)
                  : (a.neighbors ? delta_sums_kernel<T, false, true, L, kProbe>
                                 : delta_sums_kernel<T, false, false, L, kProbe>);
  };
  auto kernel = n_active <= 8 ? pick(std::integral_constant<int, 8>{})
                              : pick(std::integral_constant<int, kMaxLayers>{});
  kernel<<<grid, block, 0, s>>>(
      static_cast<const T*>(a.f1y), static_cast<const P*>(a.f1uv), static_cast<const T*>(a.f2y),
      static_cast<const P*>(a.f2uv), a.offsets, a.sums, probe_out, a.dim_y, a.dim_x, a.uv_h,
      a.uv_w / 2, a.low_h, a.low_w, a.n_win_y(), a.n_win_x(), a.delta_scalar,
      a.neighbor_scalar, a.log2_window, a.res_scalar, n_active,
      layer_offsets(a.radius, layer_offset, n_active));
}

void launch_k3(const Step& a, int layer_offset, int n_active, cudaStream_t s) {
  if (a.is_hdr) {
    launch_delta_sums<uint16_t, 0>(a, layer_offset, n_active, nullptr, s);
  } else {
    launch_delta_sums<uint8_t, 0>(a, layer_offset, n_active, nullptr, s);
  }
}

// K4's block: a tile of 8 rows x 128 cells, a thread four cells of a row
// (32 apart, so that each of its loads and stores is a warp's contiguous run).
constexpr int kCommitX = 4 * kTileX, kCommitCells = kCommitX / kTileX;
constexpr int kMaxTileWindows = kCommitX * kTileY;   // at window 1

// Phase 1: every thread loads its cells' offsets, and the tile's windows are
// scanned, a thread a window, all of its layers' loads in flight; phase 2:
// after the barrier, every cell adds its window's adjustment. kProbe, for
// timing only: 1 scans a layer's load after the other; 2 returns at once
// (the floor of a launch of K4's grid); 3 scans nothing (the adjustments are
// 0); 4 reads no offsets (each cell stores its adjustment).
template <int kProbe>
__global__ void __launch_bounds__(kThreads) commit_winners_kernel(
    const int16_t* in, int16_t* out, const uint32_t* __restrict__ sums, int low_h, int low_w,
    int n_win_y, int n_win_x, int n_scan, int radius, int log2_window, int plane_index,
    uint4* __restrict__ clear, int clear_n4, long long* __restrict__ delta_out,
    int delta_layer) {
  if (kProbe == 2) return;
  __shared__ int adj[kMaxTileWindows];
  const int lane = threadIdx.x, tid = threadIdx.y * kTileX + lane;
  const int n_threads = gridDim.x * gridDim.y * kThreads;
  for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * kThreads + tid; i < clear_n4;
       i += n_threads) {
    clear[i] = make_uint4(0, 0, 0, 0);
  }
  const int n = low_h * low_w;
  const int x0 = blockIdx.x * kCommitX, cy = blockIdx.y * kTileY + threadIdx.y;
  int cur[kCommitCells];
#pragma unroll
  for (int k = 0; k < kCommitCells; ++k) {
    const int cx = x0 + lane + k * kTileX;
    cur[k] = kProbe != 4 && cy < low_h && cx < low_w ? in[plane_index * n + cy * low_w + cx]
                                                      : 0;
  }
  const int log2_wx = max(7 - log2_window, 0), log2_wy = max(3 - log2_window, 0);
  const int wx0 = x0 >> log2_window, wy0 = (blockIdx.y * kTileY) >> log2_window;
  const int layer_stride = n_win_y * n_win_x;
  for (int w = tid; w < 1 << (log2_wx + log2_wy); w += kThreads) {
    const int wx = wx0 + (w & ((1 << log2_wx) - 1)), wy = wy0 + (w >> log2_wx);
    if (wx >= n_win_x || wy >= n_win_y) continue;
    if (kProbe == 3) {
      adj[w] = 0;
      continue;
    }
    const uint32_t* s = sums + wy * n_win_x + wx;
    uint32_t best = s[0];
    int winner = 0;
    if (kProbe == 1) {
      for (int l = 1; l < n_scan; ++l) {
        const uint32_t v = s[l * layer_stride];
        if (v < best) {
          best = v;
          winner = l;
        }
      }
    } else {
      uint32_t v[kMaxLayers];
#pragma unroll
      for (int l = 1; l < kMaxLayers; ++l) v[l] = l < n_scan ? s[l * layer_stride] : kFull;
#pragma unroll
      for (int l = 1; l < kMaxLayers; ++l) {
        if (v[l] < best) {   // strict: the first minimum wins (kFull never does)
          best = v[l];
          winner = l;
        }
      }
    }
    adj[w] = signed_square(winner - radius / 2);
    if (delta_out != nullptr && wx == 0 && wy == 0) {
      *delta_out = delta_layer < n_scan ? s[delta_layer * layer_stride] : kFull;
    }
  }
  __syncthreads();
  if (cy >= low_h) return;
#pragma unroll
  for (int k = 0; k < kCommitCells; ++k) {
    const int cx = x0 + lane + k * kTileX;
    if (cx >= low_w) break;
    const int w = (((cy >> log2_window) - wy0) << log2_wx) + (cx >> log2_window) - wx0;
    const int i = cy * low_w + cx;
    if (in != out) out[(1 - plane_index) * n + i] = in[(1 - plane_index) * n + i];
    out[plane_index * n + i] = static_cast<int16_t>(cur[k] + adj[w]);
  }
}

template <int kProbe>
void launch_k4(const int16_t* in, int16_t* out, const uint32_t* sums, int low_h, int low_w,
               int num_layers, int radius, int log2_window, int step, uint32_t* clear,
               int clear_words, long long* delta_out, cudaStream_t s) {
  const int n_win_y = (low_h + (1 << log2_window) - 1) >> log2_window;
  const int n_win_x = (low_w + (1 << log2_window) - 1) >> log2_window;
  int delta_layer = radius / 2 - 1;                 // Python's sums[radius // 2 - 1]
  if (delta_layer < 0) delta_layer += num_layers;
  const dim3 grid((low_w + kCommitX - 1) / kCommitX, (low_h + kTileY - 1) / kTileY);
  commit_winners_kernel<kProbe><<<grid, dim3(kTileX, kTileY), 0, s>>>(
      in, out, sums, low_h, low_w, n_win_y, n_win_x, min(radius, num_layers), radius,
      log2_window, step, reinterpret_cast<uint4*>(clear), (clear_words + 3) / 4, delta_out,
      delta_layer);
}

bool bad_step(int radius, int window_size, int step, int delta_scalar, int neighbor_scalar) {
  return radius < 1 || window_size < 1 || (window_size & (window_size - 1)) != 0 ||
         (step != 0 && step != 1) || delta_scalar < 0 || delta_scalar > 31 ||
         neighbor_scalar < 0 || neighbor_scalar > 31;
}

}  // namespace

// f1y, f2y: (dim_y, dim_x), f1uv, f2uv: (uv_h, uv_w), uint8 or (is_hdr)
// uint16, uv_w even and >= dim_x, the UV planes aligned to a (U, V) pair;
// offsets: (2, low_h, low_w) int16; sums: (num_layers, n_win_y, n_win_x)
// uint32, written whole. window_size: a power of two; num_layers <= 16; 0 <=
// the scalars <= 31; step 0 or 1; neighbors: the neighbour term is on. Two
// launches: the fill (0, and 0xFFFFFFFF past the radius), then the sums.
extern "C" int hrt_delta_sums(const void* f1y, const void* f1uv, const void* f2y,
                              const void* f2uv, const void* offsets, void* sums, int dim_y,
                              int dim_x, int uv_h, int uv_w, int low_h, int low_w, int n_win_y,
                              int n_win_x, int radius, int delta_scalar, int neighbor_scalar,
                              int window_size, int res_scalar, int neighbors, int step,
                              int layer_offset, int num_layers, int is_hdr, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || layer_offset < 0 || (uv_w & 1) ||
      bad_step(radius, window_size, step, delta_scalar, neighbor_scalar)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_layer = n_win_y * n_win_x;
  const int active = max(0, min(num_layers, radius - layer_offset));
  const int total = num_layers * per_layer;
  if (total == 0) return static_cast<int>(cudaSuccess);   // an empty flow grid
  uint32_t* out = static_cast<uint32_t*>(sums);
  fill_sums_kernel<<<(total + kFillThreads - 1) / kFillThreads, kFillThreads, 0, s>>>(
      out, per_layer, active, total);
  if (active > 0) {
    const Step a{f1y, f1uv, f2y, f2uv, static_cast<const int16_t*>(offsets), out, dim_y, dim_x,
                 uv_h, uv_w, low_h, low_w, radius, delta_scalar, neighbor_scalar,
                 log2_of(window_size), res_scalar, neighbors, step, is_hdr};
    launch_k3(a, layer_offset, active, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// in, out: (2, low_h, low_w) int16 (out may be in: then only plane
// step & 1 is written); sums: (num_layers, n_win_y, n_win_x) uint32, the
// first min(radius, num_layers) layers scanned. window_size: a power of two.
extern "C" int hrt_commit_winners(const void* in, void* out, const void* sums, int low_h,
                                  int low_w, int n_win_y, int n_win_x, int num_layers,
                                  int radius, int window_size, int step, void* stream) {
  if (num_layers < 1 || bad_step(radius, window_size, step, 0, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (low_h * low_w == 0) return static_cast<int>(cudaSuccess);
  launch_k4<0>(static_cast<const int16_t*>(in), static_cast<int16_t*>(out),
                   static_cast<const uint32_t*>(sums), low_h, low_w, num_layers, radius,
                   log2_of(window_size), step, nullptr, 0, nullptr,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// One pyramid step: K3 adds layers [0, min(radius, num_layers)) of the step
// into `sums` (zeroed when window_size > 8, the atomic path; else stored
// whole), then K4 commits into `offsets` in place, clears the words of
// `next_sums` that the next step (window next_window, 0 if none) adds into
// when it takes the atomic path, and, when delta_out is not null, writes the
// raw frame delta there as int64. Stream order is the only barrier. sums and
// next_sums hold 16-byte aligned buffers of num_layers * n_win_y * n_win_x
// words for the step's finest window, rounded up to a multiple of 4.
extern "C" int hrt_flow_step(const void* f1y, const void* f1uv, const void* f2y,
                             const void* f2uv, void* offsets, void* sums, void* next_sums,
                             void* delta_out, int dim_y, int dim_x, int uv_h, int uv_w,
                             int low_h, int low_w, int radius, int delta_scalar,
                             int neighbor_scalar, int window_size, int next_window,
                             int res_scalar, int neighbors, int step, int num_layers, int is_hdr,
                             void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || radius > num_layers || (uv_w & 1) ||
      next_window < 0 || bad_step(radius, window_size, step, delta_scalar, neighbor_scalar)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (low_h * low_w == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int16_t* off = static_cast<int16_t*>(offsets);
  uint32_t* cur = static_cast<uint32_t*>(sums);
  const Step a{f1y, f1uv, f2y, f2uv, off, cur, dim_y, dim_x, uv_h, uv_w, low_h, low_w, radius,
               delta_scalar, neighbor_scalar, log2_of(window_size), res_scalar, neighbors,
               step, is_hdr};
  launch_k3(a, 0, radius, s);
  int clear_words = 0;
  if (next_window > kTileY) {
    const int lw = log2_of(next_window);
    clear_words = radius * (((low_h + next_window - 1) >> lw) * ((low_w + next_window - 1) >> lw));
  }
  launch_k4<0>(off, off, cur, low_h, low_w, num_layers, radius, a.log2_window, step,
               static_cast<uint32_t*>(next_sums), clear_words,
               static_cast<long long*>(delta_out), s);
  return static_cast<int>(cudaGetLastError());
}

// Timing variants of K3 alone (no fill; layer_offset 0; HDR): 0 as on the
// path, 1 every candidate's gathers at the cell's own pixel, 2 the reduction
// replaced by one store a thread into probe_out (low_h * low_w words), 3 an
// empty launch of K3's grid.
extern "C" int hrt_delta_sums_probe(int variant, const void* f1y, const void* f1uv,
                                    const void* f2y, const void* f2uv, const void* offsets,
                                    void* sums, void* probe_out, int dim_y, int dim_x, int uv_h,
                                    int uv_w, int low_h, int low_w, int radius,
                                    int delta_scalar, int neighbor_scalar,
                                    int window_size, int res_scalar, int neighbors, int step,
                                    int num_layers, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || variant < 0 || variant > 3 ||
      bad_step(radius, window_size, step, delta_scalar, neighbor_scalar)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Step a{f1y, f1uv, f2y, f2uv, static_cast<const int16_t*>(offsets),
               static_cast<uint32_t*>(sums), dim_y, dim_x, uv_h, uv_w, low_h, low_w, radius,
               delta_scalar, neighbor_scalar, log2_of(window_size), res_scalar, neighbors,
               step, 1};
  const int active = min(num_layers, radius);
  uint32_t* po = static_cast<uint32_t*>(probe_out);
  if (variant == 0) launch_delta_sums<uint16_t, 0>(a, 0, active, po, s);
  if (variant == 1) launch_delta_sums<uint16_t, 1>(a, 0, active, po, s);
  if (variant == 2) launch_delta_sums<uint16_t, 2>(a, 0, active, po, s);
  if (variant == 3) launch_delta_sums<uint16_t, 3>(a, 0, active, po, s);
  return static_cast<int>(cudaGetLastError());
}

// Timing variants of K4: 0 as on the path (the scan unrolled to 16 layers
// with predication), 1 a serial scan, 2 an empty launch of K4's grid, 3 no
// scan, 4 no offsets read.
extern "C" int hrt_commit_winners_probe(int variant, const void* in, void* out, const void* sums,
                                        int low_h, int low_w, int num_layers, int radius,
                                        int window_size, int step, void* stream) {
  if (num_layers < 1 || variant < 0 || variant > 4 || bad_step(radius, window_size, step, 0, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = variant == 1 ? launch_k4<1> : variant == 2 ? launch_k4<2>
              : variant == 3 ? launch_k4<3> : variant == 4 ? launch_k4<4> : launch_k4<0>;
  launch(static_cast<const int16_t*>(in), static_cast<int16_t*>(out),
         static_cast<const uint32_t*>(sums), low_h, low_w, num_layers, radius,
         log2_of(window_size), step, nullptr, 0, nullptr, s);
  return static_cast<int>(cudaGetLastError());
}
