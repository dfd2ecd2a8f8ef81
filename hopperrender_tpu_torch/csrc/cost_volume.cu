// K3 — the cost volume of one pyramid step, as compact window sums; K4 — the
// per-window argmin over the layers and the commit of the winning offset.
//
// Neither replaces a pallas_call: the JAX package computes both in XLA
// (hopperrender_tpu/ops/flow.py:63 delta_window_sums, :178-201 lowest_layer
// and adjust_offsets). They are the reference's calcDeltaSums and
// determineLowestLayer + adjustOffsetArray (calcDeltaSumsKernelSDR.h,
// determineLowestLayerKernelSDR.h, adjustOffsetArrayKernelSDR.h), which the
// port ran as ~150 eager PyTorch operations a pyramid step.
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
// Layers whose global index is >= radius are 0xFFFFFFFF and cost no work.
// Every term is an add or a left shift by at most 31, so uint32 sums in any
// order equal the plain version's int64 sum mod 2**32: atomics do not make
// the result depend on the order.
//
// What bounds it on an H100: the work per candidate (three gathered samples
// of frame 1 and ~35 integer operations), not the bytes. At res_scalar 3 a
// step reads every 8th row of frame 1 near the cells (~4 MB at 4K HDR), which
// stays in the 50 MB L2. The design:
//   - a thread owns a cell and loops over its layers, so frame 2's samples,
//     the fixed axis's mirrored position, the offsets and the four neighbours
//     load once a cell, not once a candidate; the loop is unrolled over the
//     16 layers at most, so a thread's loads of every layer are in flight
//     together;
//   - a block is a tile of 8 rows x 32 cells, a warp per row; windows are
//     powers of two aligned to the tile, so a window's part of a row is an
//     aligned group of lanes: shuffles sum it, one lane adds it to the
//     block's per-(layer, window) sum in shared memory, and after the tile
//     one atomic per (layer, window) goes to the device's sums;
//   - a first launch fills the sums with 0 (real layers) or 0xFFFFFFFF.
//
// K4. One thread per flow cell: the first strict minimum (unsigned) of its
// window's sums over layers [0, min(radius, num_layers)), then
// out[step & 1] = int16(in[step & 1] + signed_square(winner % radius -
// radius / 2)); where out is not in, the other plane is copied. Bound by the
// launch: at 4K it reads and writes 518 KB of offsets.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32, kTileY = 8;          // cells a block: a warp a row
constexpr int kThreads = kTileX * kTileY;
constexpr int kMaxLayers = 16;                  // MAX_SEARCH_RADIUS
constexpr int kFillThreads = 256, kCommitThreads = 256;

__device__ __forceinline__ int signed_square(int r) { return r > 0 ? r * r : -(r * r); }

// Single-branch mirror, then the clamp (ref: calcDeltaSumsKernelSDR.h:86-95).
__device__ __forceinline__ int mirror_clamp(int p, int dim) {
  const int m = p >= dim ? dim - (p - dim + 1) : (p < 0 ? -p - 1 : p);
  return min(max(m, 0), dim - 1);
}

__global__ void fill_sums_kernel(uint32_t* __restrict__ sums, int per_layer, int active,
                                 int total) {
  const int i = blockIdx.x * kFillThreads + threadIdx.x;
  if (i < total) sums[i] = i < active * per_layer ? 0u : 0xFFFFFFFFu;
}

// T: uint8_t (SDR) or uint16_t (HDR). kStepY: the step searches y (step 1).
// kNeighbors: the neighbour term is on (iteration >= FIRST_NEIGHBOR_ITERATION).
template <typename T, bool kStepY, bool kNeighbors>
__global__ void __launch_bounds__(kThreads) delta_sums_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1uv, const T* __restrict__ f2y,
    const T* __restrict__ f2uv, const int16_t* __restrict__ offsets,
    uint32_t* __restrict__ sums, int dim_y, int dim_x, int uv_h, int uv_w, int low_h,
    int low_w, int n_win_y, int n_win_x, int radius, int delta_scalar, int neighbor_scalar,
    int log2_window, int res_scalar, int layer_offset, int n_active) {
  __shared__ uint32_t acc[kMaxLayers * kThreads];   // (layer, window of the tile)
  constexpr int kShift = sizeof(T) == 2 ? 8 : 0;
  const int lane = threadIdx.x, tid = threadIdx.y * kTileX + lane;
  const int cx0 = blockIdx.x * kTileX, cy0 = blockIdx.y * kTileY;
  const int cx = cx0 + lane, cy = cy0 + threadIdx.y;
  const int window = 1 << log2_window;
  const int tile_wx = window >= kTileX ? 1 : kTileX >> log2_window;
  const int tile_wy = window >= kTileY ? 1 : kTileY >> log2_window;
  const int tile_windows = tile_wx * tile_wy;
  for (int i = tid; i < n_active * tile_windows; i += kThreads) acc[i] = 0;

  const bool in_grid = cx < low_w && cy < low_h;
  const size_t plane = static_cast<size_t>(low_h) * low_w;
  const int scx = cx << res_scalar, scy = cy << res_scalar;
  const bool in_frame = in_grid && scx < dim_x && scy < dim_y;
  int ideal = 0;                  // the offset on the searched axis
  int fixed = 0, fu = 0, fv = 0;  // the other axis: Y position, UV row or U/V columns
  int y2 = 0, u2 = 0, v2 = 0;     // frame 2's samples (the source pixel grid)
  int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
  if (in_grid) {
    const size_t cell = static_cast<size_t>(cy) * low_w + cx;
    const int ox = offsets[cell], oy = offsets[plane + cell];
    ideal = kStepY ? oy : ox;
    if (kStepY) {
      fixed = mirror_clamp(scx + ox, dim_x);
      fu = min(fixed & ~1, uv_w - 1);
      fv = min((fixed & ~1) + 1, uv_w - 1);
    } else {
      fixed = mirror_clamp(scy + oy, dim_y);
      fu = min(fixed >> 1, uv_h - 1);
    }
    const int sx = min(scx, dim_x - 1), sy = min(scy, dim_y - 1);
    const size_t uv_row = static_cast<size_t>(min(sy >> 1, uv_h - 1)) * uv_w;
    y2 = f2y[static_cast<size_t>(sy) * dim_x + sx] >> kShift;
    u2 = f2uv[uv_row + min(sx & ~1, uv_w - 1)] >> kShift;
    v2 = f2uv[uv_row + min((sx & ~1) + 1, uv_w - 1)] >> kShift;
    if (kNeighbors) {
      // down, right, left, up at +-2 window, edge-clamped, from the searched
      // axis's plane (ref: calcDeltaSumsKernelSDR.h:112-131).
      const int16_t* p = offsets + (kStepY ? plane : 0);
      const int d = 2 * window;
      n0 = p[static_cast<size_t>(min(cy + d, low_h - 1)) * low_w + cx];
      n1 = p[static_cast<size_t>(cy) * low_w + min(cx + d, low_w - 1)];
      n2 = p[static_cast<size_t>(cy) * low_w + max(cx - d, 0)];
      n3 = p[static_cast<size_t>(max(cy - d, 0)) * low_w + cx];
    }
  }

  uint32_t total[kMaxLayers];
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    total[l] = 0;
    if (l >= n_active || !in_grid) continue;
    const int g = layer_offset + l;   // < radius: g % radius == g
    const int off = static_cast<int16_t>(
        ideal + static_cast<int16_t>(signed_square(g % radius - radius / 2)));
    uint32_t t = static_cast<uint32_t>(abs(off));
    if (in_frame) {
      int y1, u1, v1;
      if (kStepY) {
        const int my = mirror_clamp(scy + off, dim_y);
        const size_t uv_row = static_cast<size_t>(min(my >> 1, uv_h - 1)) * uv_w;
        y1 = f1y[static_cast<size_t>(my) * dim_x + fixed];
        u1 = f1uv[uv_row + fu];
        v1 = f1uv[uv_row + fv];
      } else {
        const int mx = mirror_clamp(scx + off, dim_x);
        const size_t uv_row = static_cast<size_t>(fu) * uv_w;
        y1 = f1y[static_cast<size_t>(fixed) * dim_x + mx];
        u1 = f1uv[uv_row + min(mx & ~1, uv_w - 1)];
        v1 = f1uv[uv_row + min((mx & ~1) + 1, uv_w - 1)];
      }
      const uint32_t delta = abs((y1 >> kShift) - y2) + abs((u1 >> kShift) - u2) +
                             abs((v1 >> kShift) - v2);
      t += delta << delta_scalar;
    }
    if (kNeighbors) {
      const uint32_t nb = abs(n0 - off) + abs(n1 - off) + abs(n2 - off) + abs(n3 - off);
      t += nb << neighbor_scalar;
    }
    total[l] = t;
  }
  __syncthreads();   // acc is zeroed

  // A window's share of this row is an aligned group of `group` lanes.
  const int group = min(window, kTileX);
  const int slot = ((cy >> log2_window) - (cy0 >> log2_window)) * tile_wx +
                   (cx >> log2_window) - (cx0 >> log2_window);
#pragma unroll
  for (int l = 0; l < kMaxLayers; ++l) {
    if (l >= n_active) break;
    uint32_t t = total[l];
    for (int o = 1; o < group; o <<= 1) t += __shfl_xor_sync(0xFFFFFFFFu, t, o);
    if ((lane & (group - 1)) == 0 && t) atomicAdd(&acc[l * tile_windows + slot], t);
  }
  __syncthreads();

  const size_t layer_stride = static_cast<size_t>(n_win_y) * n_win_x;
  for (int i = tid; i < n_active * tile_windows; i += kThreads) {
    const uint32_t s = acc[i];
    if (!s) continue;
    const int l = i / tile_windows, w = i - l * tile_windows;
    const int wy = (cy0 >> log2_window) + w / tile_wx;
    const int wx = (cx0 >> log2_window) + w % tile_wx;
    if (wy < n_win_y && wx < n_win_x) {
      atomicAdd(&sums[l * layer_stride + static_cast<size_t>(wy) * n_win_x + wx], s);
    }
  }
}

template <typename T>
void launch_delta_sums(const void* f1y, const void* f1uv, const void* f2y, const void* f2uv,
                       const int16_t* offsets, uint32_t* sums, int dim_y, int dim_x, int uv_h,
                       int uv_w, int low_h, int low_w, int n_win_y, int n_win_x, int radius,
                       int delta_scalar, int neighbor_scalar, int log2_window, int res_scalar,
                       bool neighbors, int step, int layer_offset, int n_active,
                       cudaStream_t s) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((low_w + kTileX - 1) / kTileX, (low_h + kTileY - 1) / kTileY);
  auto kernel = step ? (neighbors ? delta_sums_kernel<T, true, true>
                                  : delta_sums_kernel<T, true, false>)
                     : (neighbors ? delta_sums_kernel<T, false, true>
                                  : delta_sums_kernel<T, false, false>);
  kernel<<<grid, block, 0, s>>>(
      static_cast<const T*>(f1y), static_cast<const T*>(f1uv), static_cast<const T*>(f2y),
      static_cast<const T*>(f2uv), offsets, sums, dim_y, dim_x, uv_h, uv_w, low_h, low_w,
      n_win_y, n_win_x, radius, delta_scalar, neighbor_scalar, log2_window, res_scalar,
      layer_offset, n_active);
}

__global__ void __launch_bounds__(kCommitThreads) commit_winners_kernel(
    const int16_t* in, int16_t* out, const uint32_t* __restrict__ sums,
    int low_h, int low_w, int n_win_y, int n_win_x, int n_scan, int radius, int log2_window,
    int plane_index) {
  const int i = blockIdx.x * kCommitThreads + threadIdx.x;
  const int n = low_h * low_w;
  if (i >= n) return;
  const int cy = i / low_w, cx = i - cy * low_w;
  const size_t layer_stride = static_cast<size_t>(n_win_y) * n_win_x;
  const uint32_t* s = sums + static_cast<size_t>(cy >> log2_window) * n_win_x +
                      (cx >> log2_window);
  uint32_t best = s[0];
  int winner = 0;
  for (int l = 1; l < n_scan; ++l) {
    const uint32_t v = s[l * layer_stride];
    if (v < best) {   // strict: the first minimum wins
      best = v;
      winner = l;
    }
  }
  const int adj = static_cast<int16_t>(signed_square(winner % radius - radius / 2));
  const size_t at = static_cast<size_t>(plane_index) * n + i;
  const int16_t value = static_cast<int16_t>(in[at] + adj);
  if (in != out) {
    const size_t other = static_cast<size_t>(1 - plane_index) * n + i;
    out[other] = in[other];
  }
  out[at] = value;
}

int log2_of(int window) {
  int lw = 0;
  while ((1 << lw) < window) ++lw;
  return lw;
}

}  // namespace

// f1y, f2y: (dim_y, dim_x), f1uv, f2uv: (uv_h, uv_w), uint8 or (is_hdr)
// uint16; offsets: (2, low_h, low_w) int16; sums: (num_layers, n_win_y,
// n_win_x) uint32, written whole. window_size: a power of two; num_layers
// <= 16; 0 <= the scalars <= 31; step 0 or 1; neighbors: the neighbour term
// is on. Two launches: the fill, then (when some layer is below radius) the
// sums.
extern "C" int hrt_delta_sums(const void* f1y, const void* f1uv, const void* f2y,
                              const void* f2uv, const void* offsets, void* sums, int dim_y,
                              int dim_x, int uv_h, int uv_w, int low_h, int low_w, int n_win_y,
                              int n_win_x, int radius, int delta_scalar, int neighbor_scalar,
                              int window_size, int res_scalar, int neighbors, int step,
                              int layer_offset, int num_layers, int is_hdr, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || radius < 1 || window_size < 1 ||
      (window_size & (window_size - 1)) != 0 || (step != 0 && step != 1) ||
      delta_scalar < 0 || delta_scalar > 31 || neighbor_scalar < 0 || neighbor_scalar > 31 ||
      layer_offset < 0) {
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
    const int16_t* off = static_cast<const int16_t*>(offsets);
    const int lw = log2_of(window_size);
    if (is_hdr) {
      launch_delta_sums<uint16_t>(f1y, f1uv, f2y, f2uv, off, out, dim_y, dim_x, uv_h, uv_w,
                                  low_h, low_w, n_win_y, n_win_x, radius, delta_scalar,
                                  neighbor_scalar, lw, res_scalar, neighbors != 0, step,
                                  layer_offset, active, s);
    } else {
      launch_delta_sums<uint8_t>(f1y, f1uv, f2y, f2uv, off, out, dim_y, dim_x, uv_h, uv_w,
                                 low_h, low_w, n_win_y, n_win_x, radius, delta_scalar,
                                 neighbor_scalar, lw, res_scalar, neighbors != 0, step,
                                 layer_offset, active, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// in, out: (2, low_h, low_w) int16 (out may be in: then only plane
// step & 1 is written); sums: (num_layers, n_win_y, n_win_x) uint32, the
// first min(radius, num_layers) layers scanned. window_size: a power of two.
extern "C" int hrt_commit_winners(const void* in, void* out, const void* sums, int low_h,
                                  int low_w, int n_win_y, int n_win_x, int num_layers,
                                  int radius, int window_size, int step, void* stream) {
  if (num_layers < 1 || radius < 1 || window_size < 1 ||
      (window_size & (window_size - 1)) != 0 || (step != 0 && step != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = low_h * low_w;
  if (n == 0) return static_cast<int>(cudaSuccess);
  commit_winners_kernel<<<(n + kCommitThreads - 1) / kCommitThreads, kCommitThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out),
      static_cast<const uint32_t*>(sums), low_h, low_w, n_win_y, n_win_x,
      min(radius, num_layers), radius, log2_of(window_size), step);
  return static_cast<int>(cudaGetLastError());
}
