// K2 — bidirectional warp + blend + levels (warpFrameKernel modes 0/1/2),
// batched over T blending scalars, for the Y plane and the interleaved UV plane.
//
// Replaces the TPU kernel hopperrender_tpu/ops/warp_band.py::warp_frame_band
// (pallas_call in _band_call, body _merge_cells_kernel), modes 0/1/2 with a
// (T,) blending-scalar vector. Semantics are those of
// hopperrender_tpu/ops/warp.py::warp_frame_plane, per output element (cx, cy)
// of a plane and per blending scalar t:
//   * flow12 at the output's low-res cell, flow21 at the back-projected cell
//     (cell - flow12 >> rs), both clamped to the flow grid; UV looks flow up at
//     ((cx >> rs) & ~1, (cy >> rs) << 1);
//   * positions pos + round_c(flow12 * t) and pos - round_c(flow21 * (1 - t)),
//     y offsets halved on UV, each through the remapping mirror clamped to
//     [1, dim - 2]; UV keeps the output's chroma parity: (new_cx & ~1) + (cx & 1);
//   * mode 0 takes the 1->2 sample, mode 1 the 2->1 sample, mode 2 blends
//     trunc(v12 * (1 - t) + v21 * t) and applies the black/white levels;
//   * kRaw (mode 2 only) stores the blend without levels: the TPU kernel's
//     raw_blend variant (warp_band.py, "Mode-3 feeder"), which the HSV
//     overlay of mode 3 colours. Identity levels would not give the blend
//     back: the level arithmetic is not exact in float32;
//   * a row band (row0, rows) per plane is the TPU kernel's mesh-sharded
//     variant (warp_frame_band with num_shards > 1, which slices its band
//     tables and packed sources per shard): shard s of n computes rows
//     [s * r, (s + 1) * r) of each plane, r = ceil(plane_h / n) apart for Y
//     and UV, into a band-local (T, r, W) output. Sources and flow stay
//     whole; the mirror and the flow lookup use the whole plane. Rows past
//     the plane are not written.
//
// Float rules. The JAX package is the reference, so every float operation is
// pinned to the rounding the JAX package's compiled code performs:
//   * XLA contracts two multiply-adds into FMAs, and the golden fixtures carry
//     that rounding: the blend is fma(v12, 1 - t, v21 * t) and the UV levels
//     are fma(q, peak, mid) — written here as __fmaf_rn;
//   * every other product and sum rounds on its own (__fmul_rn / __fadd_rn /
//     __fsub_rn), since nvcc would otherwise contract a*b+c where it likes —
//     round_c's `x*t + 0.5` among them;
//   * 1 - t is formed in float32, as the JAX package forms it;
//   * __fdiv_rn (IEEE division) in the levels; float -> int truncates.
//
// What bounds it on an H100: device-memory bytes. Each output element reads
// one (modes 0/1) or two (mode 2, raw or not) source samples and writes one. At
// 4K HDR a T=3 call must read both sources once (49.8 MB) and write 74.6 MB:
// some 37 us at 3.35 TB/s. The flow planes
// (518 KB) stay in L2. The TPU kernel's machinery (u32 lane packing, band DMAs
// with aprons, select chains, padded warp contexts built per source frame)
// existed because the TPU has no fast per-lane gather; Hopper gathers
// natively, so this kernel is one thread per output element reading the
// UNPADDED source planes with the mirror computed inline. Neighbouring threads
// take neighbouring x, and smooth flow keeps their gathers on neighbouring
// addresses, so the loads coalesce on real content. All T outputs run in one
// launch per plane (grid z = t), and the sources stay L2-resident across them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clamp_hi(int v, int lo, int hi) {
  // min(max(v, lo), hi): the jnp.clip / torch.clamp order when lo > hi.
  return min(max(v, lo), hi);
}

// Remapping mirror of warpFrameKernel (ops/warp.py::_mirror_warp).
__device__ __forceinline__ int mirror_warp(int p, int dim) {
  const int r = p >= dim - 1 ? p - (p - (dim - 2)) * 2 : (p < 1 ? -p + 1 : p);
  return clamp_hi(r, 1, dim - 2);
}

// C round(): half away from zero, in float32 (ops/warp.py::_round_c).
__device__ __forceinline__ int round_c(float x) {
  return static_cast<int>(x >= 0.0f ? floorf(__fadd_rn(x, 0.5f))
                                    : ceilf(__fsub_rn(x, 0.5f)));
}

template <typename T, int kMode, bool kUV, bool kRaw>
__global__ void __launch_bounds__(256) warp_plane_kernel(
    const T* __restrict__ src12, const T* __restrict__ src21,
    const int16_t* __restrict__ flow, const float* __restrict__ ts,
    T* __restrict__ out, int plane_h, int row0, int rows, int dim_x, int low_h, int low_w,
    int rs, float black, float white, float peak, float mid) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int band_y = blockIdx.y * blockDim.y + threadIdx.y;  // row within the band
  const int cy = row0 + band_y;                               // row of the plane
  if (cx >= dim_x || band_y >= rows || cy >= plane_h) return;
  const float fs12 = ts[blockIdx.z];
  const float fs21 = __fsub_rn(1.0f, fs12);

  int scx = cx >> rs;
  int scy = cy >> rs;
  if (kUV) {
    scx &= ~1;
    scy <<= 1;
  }
  scx = clamp_hi(scx, 0, low_w - 1);
  scy = clamp_hi(scy, 0, low_h - 1);
  const int16_t* flow_x = flow;
  const int16_t* flow_y = flow + static_cast<size_t>(low_h) * low_w;
  const int ox12 = flow_x[scy * low_w + scx];
  const int oy12 = flow_y[scy * low_w + scx];
  const int bcy = clamp_hi(scy - (oy12 >> rs), 0, low_h - 1);
  const int bcx = clamp_hi(scx - (ox12 >> rs), 0, low_w - 1);
  const int ox21 = flow_x[bcy * low_w + bcx];
  const int oy21 = flow_y[bcy * low_w + bcx];

  // y offset products in the reference's left-to-right order: (off * t) * 0.5.
  const float y_scale = kUV ? 0.5f : 1.0f;
  int v12 = 0, v21 = 0;
  if (kMode != 1) {
    const int x = mirror_warp(cx + round_c(__fmul_rn(static_cast<float>(ox12), fs12)), dim_x);
    const int y = mirror_warp(
        cy + round_c(__fmul_rn(__fmul_rn(static_cast<float>(oy12), fs12), y_scale)), plane_h);
    const int col = kUV ? (x & ~1) + (cx & 1) : x;
    v12 = src12[static_cast<size_t>(y) * dim_x + col];
  }
  if (kMode != 0) {
    const int x = mirror_warp(cx - round_c(__fmul_rn(static_cast<float>(ox21), fs21)), dim_x);
    const int y = mirror_warp(
        cy - round_c(__fmul_rn(__fmul_rn(static_cast<float>(oy21), fs21), y_scale)), plane_h);
    const int col = kUV ? (x & ~1) + (cx & 1) : x;
    v21 = src21[static_cast<size_t>(y) * dim_x + col];
  }

  int res;
  if (kMode == 0) {
    res = v12;
  } else if (kMode == 1) {
    res = v21;
  } else {
    const float blended = truncf(__fmaf_rn(static_cast<float>(v12), fs21,
                                           __fmul_rn(static_cast<float>(v21), fs12)));
    if (kRaw) {
      res = static_cast<int>(blended);  // in [0, peak]: a blend of two samples
    } else {
      float v;
      if (kUV) {  // ops/warp.py::_apply_levels_uv: fma((v - mid) / white, peak, mid)
        v = __fmaf_rn(__fdiv_rn(__fsub_rn(blended, mid), white), peak, mid);
      } else {    // ops/warp.py::_apply_levels_y: (v - black) / (white - black) * peak
        v = __fmul_rn(__fdiv_rn(__fsub_rn(blended, black), __fsub_rn(white, black)), peak);
      }
      res = static_cast<int>(fminf(fmaxf(v, 0.0f), peak));  // clip, then truncate
    }
  }
  out[(static_cast<size_t>(blockIdx.z) * rows + band_y) * dim_x + cx] = static_cast<T>(res);
}

// The output rows of one call: rows [row0, row0 + rows) of each plane, clipped
// to the plane. The whole frame is row0 0 and rows dim_y (Y), dim_y / 2 (UV).
struct Band {
  int row0_y, rows_y, row0_uv, rows_uv;
};

template <typename T, int kMode, bool kRaw>
cudaError_t launch_mode(const void* s12y, const void* s12uv, const void* s21y,
                        const void* s21uv, const int16_t* flow, const float* ts,
                        int n_t, void* out_y, void* out_uv, int dim_y, int dim_x,
                        const Band& band, int low_h, int low_w, int rs, float black,
                        float white, float peak, float mid, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid_y((dim_x + block.x - 1) / block.x, (band.rows_y + block.y - 1) / block.y,
                    n_t);
  warp_plane_kernel<T, kMode, false, kRaw><<<grid_y, block, 0, stream>>>(
      static_cast<const T*>(s12y), static_cast<const T*>(s21y), flow, ts,
      static_cast<T*>(out_y), dim_y, band.row0_y, band.rows_y, dim_x, low_h, low_w, rs, black,
      white, peak, mid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_uv((dim_x + block.x - 1) / block.x, (band.rows_uv + block.y - 1) / block.y,
                     n_t);
  warp_plane_kernel<T, kMode, true, kRaw><<<grid_uv, block, 0, stream>>>(
      static_cast<const T*>(s12uv), static_cast<const T*>(s21uv), flow, ts,
      static_cast<T*>(out_uv), dim_y / 2, band.row0_uv, band.rows_uv, dim_x, low_h, low_w, rs,
      black, white, peak, mid);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(int mode, bool raw, const void* s12y, const void* s12uv,
                        const void* s21y, const void* s21uv, const int16_t* flow,
                        const float* ts, int n_t, void* out_y, void* out_uv,
                        int dim_y, int dim_x, const Band& band, int low_h, int low_w, int rs,
                        float black, float white, float peak, float mid,
                        cudaStream_t stream) {
  if (raw) {  // the raw_blend variant exists for mode 2 only
    if (mode != 2) return cudaErrorInvalidValue;
    return launch_mode<T, 2, true>(s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y, out_uv,
                                   dim_y, dim_x, band, low_h, low_w, rs, black, white, peak,
                                   mid, stream);
  }
  switch (mode) {
    case 0:
      return launch_mode<T, 0, false>(s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y,
                                      out_uv, dim_y, dim_x, band, low_h, low_w, rs, black,
                                      white, peak, mid, stream);
    case 1:
      return launch_mode<T, 1, false>(s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y,
                                      out_uv, dim_y, dim_x, band, low_h, low_w, rs, black,
                                      white, peak, mid, stream);
    case 2:
      return launch_mode<T, 2, false>(s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y,
                                      out_uv, dim_y, dim_x, band, low_h, low_w, rs, black,
                                      white, peak, mid, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Sources: (dim_y, dim_x) Y and (dim_y/2, dim_x) interleaved UV, uint8 (SDR) or
// uint16 (HDR); flow: (2, low_h, low_w) int16; ts: (n_t,) float32. Outputs: rows
// [row0_y, row0_y + rows_y) of the Y plane as (n_t, rows_y, dim_x) and rows
// [row0_uv, row0_uv + rows_uv) of the UV plane as (n_t, rows_uv, dim_x); rows past
// the plane are not written. The whole frame is row0 0, rows dim_y and dim_y/2;
// a shard of the row-band split (K2's mesh-sharded variant) passes its band.
// All contiguous, on the current device. black/white are the levels in sample
// units (HDR pre-scaled x256). raw_blend != 0 (mode 2 only) stores the blend
// without levels.
extern "C" int hrt_warp_frames(const void* src12_y, const void* src12_uv,
                               const void* src21_y, const void* src21_uv,
                               const void* flow, const void* ts, int n_t,
                               void* out_y, void* out_uv, int dim_y, int dim_x,
                               int row0_y, int rows_y, int row0_uv, int rows_uv,
                               int low_h, int low_w, int res_scalar, int mode,
                               int raw_blend, int is_hdr, float black, float white,
                               void* stream) {
  const auto* f = static_cast<const int16_t*>(flow);
  const auto* t = static_cast<const float*>(ts);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool raw = raw_blend != 0;
  const Band band{row0_y, rows_y, row0_uv, rows_uv};
  if (row0_y < 0 || rows_y < 1 || row0_uv < 0 || rows_uv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      is_hdr ? launch_type<uint16_t>(mode, raw, src12_y, src12_uv, src21_y, src21_uv, f, t, n_t,
                                     out_y, out_uv, dim_y, dim_x, band, low_h, low_w,
                                     res_scalar, black, white, 65535.0f, 32768.0f, s)
             : launch_type<uint8_t>(mode, raw, src12_y, src12_uv, src21_y, src21_uv, f, t, n_t,
                                    out_y, out_uv, dim_y, dim_x, band, low_h, low_w,
                                    res_scalar, black, white, 255.0f, 128.0f, s);
  return static_cast<int>(err);
}
