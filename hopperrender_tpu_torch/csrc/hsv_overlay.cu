// K5 — mode 3's HSV flow overlay: the colour of each pixel's flow cell over
// K2's raw mode-2 blend, then the black/white levels, for the Y plane and the
// interleaved UV plane of a (T, rows, W) batch.
//
// Replaces no pallas_call: the JAX package computes the overlay as one jitted
// XLA program, hopperrender_tpu/ops/warp_viz.py::hsv_flow_overlay, after the
// TPU kernel's raw_blend variant. Semantics are those of the port's plain
// version, hopperrender_tpu_torch/ops/hsv_kernel.py::hsv_flow_overlay_reference,
// per output element (cx, cy) of a plane, cy = row0 + its row in the batch,
// and per t:
//   * the flow cell: (cx >> rs, cy >> rs) on Y, ((cx >> rs) & ~1,
//     (cy >> rs) << 1) on UV, clamped to the flow grid (ops/warp.flow_cells).
//     Rows past the plane (a mesh band's padding) take the clamped cell, as
//     if the flow grid went on;
//   * the colour of the cell's negated flow, narrowed to int16 (so -(-32768)
//     stays -32768): ops/warp._visualize_flow, channel 0 on Y and 1 + (cx & 1)
//     on UV;
//   * Y adds the raw sample's half: (y << 7) + (raw >> 1) in HDR, (y >> 1) +
//     (raw >> 1) in SDR. U and V are u << 8 and v << 8 in HDR (u and v in
//     SDR): the colour replaces the raw UV, so K5 never reads it;
//   * the levels of the plane (ops/warp._apply_levels_y, _apply_levels_uv).
//
// Served mode 3 does not run it: K2's mode 3 (csrc/warp_frame.cu) warps,
// blends, colours and levels in one launch. K5 is the kernel behind
// ops/warp_viz.hsv_flow_overlay, the counterpart of the JAX function of
// that name, on any raw blend it is given.
//
// Float rules: the colour and the levels are csrc/hsv_colour.h's device
// functions, shared with K2's mode 3 (csrc/warp_frame.cu), where every float
// operation rounds where the plain version's does.
//
// What bounds it on an H100: device-memory bytes. A 4K HDR call at T = 1
// reads the raw Y plane (16.6 MB) and writes both planes (24.9 MB): 12.4 us at
// 3.35 TB/s. The colour takes some 80 float operations a flow cell (two
// divisions and the polynomial of atan2, the hue, the products), made once a
// run of 8 or 16 samples; each Y sample then takes 9 (its shift and add, and
// the levels with their division): a few us of the card's float rate.
//
// The design (K2's, csrc/warp_frame.cu). One thread takes a RUN: up to 16
// bytes of consecutive outputs of one row (8 HDR or 16 SDR samples), never
// wider than a flow cell (1 << rs columns on Y, 2 << rs on UV) and starting
// at a multiple of its width, so every element of a run shares one flow cell
// and one colour. The thread computes the colour once, then every t of the
// batch: on Y it loads the run's raw samples with one aligned load of the
// run's width, adds each sample's half to the colour and applies the levels;
// on UV the run's outputs (U on even columns, V on odd ones) are the same for
// every t, so it levels U and V once and stores the run T times. Runs of 8
// samples, and SDR runs of 16, are compiled for that width; narrower runs (a
// flow cell under 8 columns: small res_scalar) take a generic instance, and
// the ragged tail of a row goes sample by sample.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hsv_colour.h"

namespace {

__device__ __forceinline__ int clamp_hi(int v, int lo, int hi) {
  // min(max(v, lo), hi): the torch.clamp order when lo > hi.
  return min(max(v, lo), hi);
}

// The n samples of a run at p, each widened to 32 bits: one load of the
// run's width where the run is whole and p is aligned to it, else sample by
// sample.
template <typename T, int kMax>
__device__ __forceinline__ void load_run(const T* p, uint32_t (&s)[kMax], int n, int run) {
  const int nbytes = run * static_cast<int>(sizeof(T));
  if (n == run && nbytes >= 4 && (reinterpret_cast<uintptr_t>(p) & (nbytes - 1)) == 0) {
    uint32_t w[4] = {0, 0, 0, 0};
    if (nbytes == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if (nbytes == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    }
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      s[k] = sizeof(T) == 2 ? (w[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu
                            : (w[k >> 2] >> ((k & 3) * 8)) & 0xFFu;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kMax; ++k) s[k] = k < n ? static_cast<uint32_t>(p[k]) : 0u;
}

// The low bytes of the n values v[k] to the run at p: one store of the run's
// width where the run is whole and p is aligned to it, else sample by sample.
template <typename T, int kMax>
__device__ __forceinline__ void store_run(T* p, const uint32_t (&v)[kMax], int n, int run) {
  const int nbytes = run * static_cast<int>(sizeof(T));
  if (n == run && nbytes >= 4 && (reinterpret_cast<uintptr_t>(p) & (nbytes - 1)) == 0) {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      if (sizeof(T) == 2) {
        w[k >> 1] |= (v[k] & 0xFFFFu) << ((k & 1) * 16);
      } else {
        w[k >> 2] |= (v[k] & 0xFFu) << ((k & 3) * 8);
      }
    }
    if (nbytes == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if (nbytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k < n) p[k] = static_cast<T>(v[k]);
  }
}

// One thread per run of one row of the plane (see the note above), every t.
// kRun > 0: runs of kRun samples, compiled for that width; kRun 0: runs of
// 1 << run_shift samples, any width up to 16 bytes. kUV: the UV plane, whose
// runs are even and start at even columns (U then V).
template <typename T, bool kUV, int kRun>
__global__ void __launch_bounds__(256) hsv_overlay_kernel(
    const T* __restrict__ raw, const int16_t* __restrict__ flow, T* __restrict__ out, int n_t,
    int rows, int dim_x, int row0, int low_h, int low_w, int rs, int run_shift, float black,
    float white) {
  constexpr bool kHdr = sizeof(T) == 2;
  constexpr int kMax = kRun > 0 ? kRun : 16 / static_cast<int>(sizeof(T));
  constexpr float kPeak = kHdr ? 65535.0f : 255.0f;
  constexpr float kMid = kHdr ? 32768.0f : 128.0f;
  const int run = kRun > 0 ? kRun : 1 << run_shift;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * run;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;   // row within the batch's planes
  if (x0 >= dim_x || r >= rows) return;
  const int n = min(run, dim_x - x0);    // the ragged tail of a row has fewer
  const int cy = row0 + r;               // row of the plane

  // The run's flow cell and its colour.
  int scx = x0 >> rs;
  int scy = cy >> rs;
  if (kUV) {
    scx &= ~1;
    scy <<= 1;
  }
  scx = clamp_hi(scx, 0, low_w - 1);
  scy = clamp_hi(scy, 0, low_h - 1);
  const size_t cell = static_cast<size_t>(scy) * low_w + scx;
  const int ox = negate16(flow[cell]);
  const int oy = negate16(flow[static_cast<size_t>(low_h) * low_w + cell]);
  const Rgb c = flow_rgb(ox, oy, rs <= 2 ? 4.0f : 1.0f);

  const size_t plane = static_cast<size_t>(rows) * dim_x;
  const size_t at = static_cast<size_t>(r) * dim_x + x0;
  uint32_t v[kMax];
  if (kUV) {   // the same U, V pairs for every t
    const uint32_t lu = level_uv(kHdr ? chroma_u(c) << 8 : chroma_u(c), white, kPeak, kMid);
    const uint32_t lv = level_uv(kHdr ? chroma_v(c) << 8 : chroma_v(c), white, kPeak, kMid);
#pragma unroll
    for (int k = 0; k < kMax; ++k) v[k] = (k & 1) ? lv : lu;
    for (int t = 0; t < n_t; ++t) store_run<T, kMax>(out + t * plane + at, v, n, run);
    return;
  }
  const int y_val = luma(c);
  const int base = kHdr ? y_val << 7 : y_val >> 1;
  const float range = __fsub_rn(white, black);
  for (int t = 0; t < n_t; ++t) {
    uint32_t s[kMax];
    load_run<T, kMax>(raw + t * plane + at, s, n, run);
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      v[k] = level_y(base + static_cast<int>(s[k] >> 1), black, range, kPeak);
    }
    store_run<T, kMax>(out + t * plane + at, v, n, run);
  }
}

// One plane: runs of 1 << shift samples, compiled for 8 samples (HDR) or 8
// and 16 (SDR), generic otherwise; a warp takes 32 neighbouring runs of one
// row.
template <typename T, bool kUV>
cudaError_t launch_plane(const void* raw, const int16_t* flow, void* out, int n_t, int rows,
                         int dim_x, int row0, int low_h, int low_w, int rs, int shift,
                         float black, float white, cudaStream_t stream) {
  const dim3 block(32, 8);
  const int runs = (dim_x + (1 << shift) - 1) >> shift;
  const dim3 grid((runs + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  const auto go = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(static_cast<const T*>(raw), flow, static_cast<T*>(out),
                                       n_t, rows, dim_x, row0, low_h, low_w, rs, shift, black,
                                       white);
    return cudaGetLastError();
  };
  if (shift == 3) return go(hsv_overlay_kernel<T, kUV, 8>);
  if constexpr (sizeof(T) == 1) {
    if (shift == 4) return go(hsv_overlay_kernel<T, kUV, 16>);
  }
  return go(hsv_overlay_kernel<T, kUV, 0>);
}

template <typename T>
cudaError_t launch_type(const void* raw_y, const int16_t* flow, void* out_y, void* out_uv,
                        int n_t, int rows_y, int rows_uv, int dim_x, int row0_y, int row0_uv,
                        int low_h, int low_w, int rs, float black, float white,
                        cudaStream_t stream) {
  // A run is at most 16 bytes and at most a flow cell wide (1 << rs columns
  // on Y, 2 << rs on UV: at least 2, so UV runs are even).
  constexpr int kMaxShift = sizeof(T) == 2 ? 3 : 4;
  const int shift_y = rs < kMaxShift ? rs : kMaxShift;
  const int shift_uv = rs + 1 < kMaxShift ? rs + 1 : kMaxShift;
  const cudaError_t err = launch_plane<T, false>(raw_y, flow, out_y, n_t, rows_y, dim_x, row0_y,
                                                 low_h, low_w, rs, shift_y, black, white, stream);
  if (err != cudaSuccess) return err;
  return launch_plane<T, true>(nullptr, flow, out_uv, n_t, rows_uv, dim_x, row0_uv, low_h,
                               low_w, rs, shift_uv, black, white, stream);
}

}  // namespace

// raw_y: (n_t, rows_y, dim_x), K2's raw mode-2 blend of plane rows [row0_y,
// row0_y + rows_y) of Y, uint8 (SDR) or uint16 (HDR); flow: (2, low_h, low_w)
// int16. Outputs: out_y (n_t, rows_y, dim_x) and out_uv (n_t, rows_uv,
// dim_x), the latter plane rows [row0_uv, row0_uv + rows_uv) of the
// interleaved UV plane, of the same type. The raw UV blend is not an input:
// the colour replaces it. All contiguous, on the current device. black/white
// are the levels in sample units (HDR pre-scaled x256).
extern "C" int hrt_hsv_overlay(const void* raw_y, const void* flow, void* out_y, void* out_uv,
                               int n_t, int rows_y, int rows_uv, int dim_x, int row0_y,
                               int row0_uv, int low_h, int low_w, int res_scalar, int is_hdr,
                               float black, float white, void* stream) {
  if (n_t < 1 || rows_y < 1 || rows_uv < 1 || dim_x < 1 || row0_y < 0 || row0_uv < 0 ||
      low_h < 1 || low_w < 1 || res_scalar < 0 || res_scalar > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* f = static_cast<const int16_t*>(flow);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_hdr ? launch_type<uint16_t>(raw_y, f, out_y, out_uv, n_t, rows_y, rows_uv, dim_x,
                                     row0_y, row0_uv, low_h, low_w, res_scalar, black, white, s)
             : launch_type<uint8_t>(raw_y, f, out_y, out_uv, n_t, rows_y, rows_uv, dim_x,
                                    row0_y, row0_uv, low_h, low_w, res_scalar, black, white, s);
  return static_cast<int>(err);
}
