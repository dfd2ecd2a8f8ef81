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
// some 37 us at 3.35 TB/s. The flow planes (518 KB) stay in L2. The TPU
// kernel's machinery (u32 lane packing, band DMAs with aprons, select chains,
// padded warp contexts built per source frame) existed because the TPU has no
// fast per-lane gather; Hopper gathers natively, so this kernel reads the
// UNPADDED source planes with the mirror computed inline.
//
// The design. One thread per element (the first port) ran a dependent chain of
// two flow loads and then the sample loads for every element and every t, and
// redid for each what a whole flow cell shares. Here one thread takes a RUN:
// up to 16 bytes of consecutive outputs of one row (8 HDR or 16 SDR samples),
// never wider than a flow cell (1 << rs columns on Y, 2 << rs on UV, whose
// lookup column is (cx >> rs) & ~1), and starting at a multiple of its width,
// so every element of a run shares its flow cell. It computes every t of the
// (T,) vector in an inner loop:
//   * the flow lookup, the back-projection and the clamps: once per run;
//   * each rounded offset and each mirrored source row: once per run and t;
//   * the T reads of one source row land near each other and hit L1.
// Fast path (both warped column spans inside [1, dim_x - 2], where the mirror
// is the identity, and a whole run): each source read is one span of the row,
// read as the aligned 16-byte chunks that hold it (issue_span) and shifted
// into place (extract); both sources' chunks are requested before either is
// used. On UV, (x & ~1) + (cx & 1) keeps a pair (U, V) whole for an even
// shift dx; for an odd one U comes from cx + dx - 1 and V from cx + dx + 1,
// two spans whose even and odd samples are taken. The run is stored with one
// store of its width where the address is aligned to it. Slow path (runs
// that cross a mirror edge, the ragged tail of a row): per element, with the
// same arithmetic. Both paths compute the same positions, so the choice only
// picks between two exact implementations.
// Runs of 8 samples, and SDR runs of 16, are compiled for that width, so the
// per-sample loops of their whole runs carry no guards; narrower runs (a
// flow cell under 8 columns: small res_scalar) take a generic instance.
// The blend converts samples to float and back by byte permutes and adds
// (sample_float, and x + 2^23 rounded toward zero for t in [0, 1]) instead
// of conversion instructions, which run at a quarter of the rate.
// Measured (chip_smoke.py phase 6, PERF.md): a whole 4K HDR T = 3 call
// moves its bytes at about half the rate of a copy of the same bytes; with
// zero flow and one source (mode 0) it moves them at the copy's rate. The
// difference is the second source and the blend's arithmetic, and on random
// flow the scatter: each run reads its 16 bytes from its own row for every
// t, so the T reads share no L1 lines.
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

// C round(): half away from zero, in float32 (ops/warp.py::_round_c):
// floor(x + 0.5) for x >= 0 and ceil(x - 0.5) below, each the truncation of
// the same rounded sum x + copysign(0.5, x).
__device__ __forceinline__ int round_c(float x) {
  return static_cast<int>(__fadd_rn(x, copysignf(0.5f, x)));
}

// 16 bytes as four little-endian words.
struct Words {
  uint32_t w[4];
};

// The aligned 16-byte chunks that hold the nbytes (1..16) bytes at p, of
// any alignment: issued first (issue_span), shifted into place later
// (extract), so that the loads of both sources are in flight together. Only
// the chunks that hold a byte of the span are read, so nothing past the
// chunk of the span's last byte.
struct Span {
  uint4 lo, hi;
  int off;   // p's offset into lo
};

__device__ __forceinline__ Span issue_span(const void* p, int nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  Span s;
  s.off = static_cast<int>(a & 15);
  const uint4* q = reinterpret_cast<const uint4*>(a - s.off);
  s.lo = __ldg(q);
  s.hi = make_uint4(0, 0, 0, 0);
  if (s.off + nbytes > 16) s.hi = __ldg(q + 1);
  return s;
}

// The span's bytes as the first bytes of a Words: words ws .. ws + 4 of
// lo:hi, by selects (a dynamic index would spill the eight words to local
// memory), shifted right by the byte remainder.
__device__ __forceinline__ Words extract(const Span& s) {
  const uint4 lo = s.lo, hi = s.hi;
  const int ws = s.off >> 2;
  const int bits = (s.off & 3) * 8;
  const uint32_t s0 = ws == 0 ? lo.x : ws == 1 ? lo.y : ws == 2 ? lo.z : lo.w;
  const uint32_t s1 = ws == 0 ? lo.y : ws == 1 ? lo.z : ws == 2 ? lo.w : hi.x;
  const uint32_t s2 = ws == 0 ? lo.z : ws == 1 ? lo.w : ws == 2 ? hi.x : hi.y;
  const uint32_t s3 = ws == 0 ? lo.w : ws == 1 ? hi.x : ws == 2 ? hi.y : hi.z;
  const uint32_t s4 = ws == 0 ? hi.x : ws == 1 ? hi.y : ws == 2 ? hi.z : hi.w;
  return Words{{__funnelshift_r(s0, s1, bits), __funnelshift_r(s1, s2, bits),
                __funnelshift_r(s2, s3, bits), __funnelshift_r(s3, s4, bits)}};
}

// A float in [2^23, 2^24) is an integer whose low 23 bits are the integer
// less 2^23. Converting through it takes a byte permute or an add, where a
// conversion instruction runs at a quarter of the rate of an add.
constexpr float kTwo23 = 8388608.0f;
constexpr uint32_t kTwo23Bits = 0x4B000000u;

// Sample k of a Words of samples of type T, as an int (k a compile-time
// constant after unrolling, so the words stay in registers).
template <typename T>
__device__ __forceinline__ int sample(const Words& v, int k) {
  if (sizeof(T) == 2) return static_cast<int>((v.w[k >> 1] >> ((k & 1) * 16)) & 0xFFFFu);
  return static_cast<int>((v.w[k >> 2] >> ((k & 3) * 8)) & 0xFFu);
}

// Sample k of v as a float, exactly: a byte permute builds the bits of
// 2^23 + sample, an add takes 2^23 away.
template <typename T>
__device__ __forceinline__ float sample_float(const Words& v, int k) {
  const uint32_t word = sizeof(T) == 2 ? v.w[k >> 1] : v.w[k >> 2];
  const uint32_t sel = sizeof(T) == 2 ? ((k & 1) ? 0x7632u : 0x7610u) : 0x7650u | (k & 3);
  return __fsub_rn(__uint_as_float(__byte_perm(word, kTwo23Bits, sel)), kTwo23);
}

// The Words whose sample k is static_cast<T>(r[k]): the low bytes of each
// r[k] (so a blend outside [0, peak], from a t outside [0, 1], wraps as the
// cast does), by byte permutes.
template <typename T, int kMax>
__device__ __forceinline__ Words pack(const uint32_t (&r)[kMax]) {
  Words v{{0, 0, 0, 0}};
  if (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < kMax / 2; ++i) v.w[i] = __byte_perm(r[2 * i], r[2 * i + 1], 0x5410);
  } else {
#pragma unroll
    for (int i = 0; i < kMax / 4; ++i) {
      v.w[i] = __byte_perm(__byte_perm(r[4 * i], r[4 * i + 1], 0x0040),
                           __byte_perm(r[4 * i + 2], r[4 * i + 3], 0x0040), 0x5410);
    }
  }
  return v;
}

// The n samples of v to dst: one store of the run's width where the run is
// whole and dst is aligned to it, else sample by sample.
template <typename T, int kMax>
__device__ __forceinline__ void store_run(T* dst, const Words& v, int n, int run) {
  const int nbytes = run * static_cast<int>(sizeof(T));
  if (n == run && (reinterpret_cast<uintptr_t>(dst) & (nbytes - 1)) == 0) {
    switch (nbytes) {
      case 16:
        *reinterpret_cast<uint4*>(dst) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
        return;
      case 8:
        *reinterpret_cast<uint2*>(dst) = make_uint2(v.w[0], v.w[1]);
        return;
      case 4:
        *reinterpret_cast<uint32_t*>(dst) = v.w[0];
        return;
      default:
        break;
    }
  }
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (k < n) dst[k] = static_cast<T>(sample<T>(v, k));
  }
}

// One source's read for a whole run whose warped columns lie inside
// [1, dim_x - 2] (the mirror is then the identity): one span of the row. On
// UV, (x & ~1) + (cx & 1) keeps each (U, V) pair whole for an even shift dx;
// for an odd one U (even samples) comes from cx + dx - 1 and V from
// cx + dx + 1, two spans.
struct RunRead {
  Span a, b;
};

template <typename T, bool kUV>
__device__ __forceinline__ RunRead issue_run(const T* row, int x0, int dx, int nbytes) {
  RunRead r;
  const bool odd = kUV && (dx & 1);
  r.a = issue_span(row + x0 + dx - odd, nbytes);
  if (odd) r.b = issue_span(row + x0 + dx + 1, nbytes);
  return r;
}

template <typename T, bool kUV>
__device__ __forceinline__ Words extract_run(const RunRead& r, int dx) {
  const Words a = extract(r.a);
  if (!kUV || (dx & 1) == 0) return a;
  const Words b = extract(r.b);
  constexpr uint32_t kEven = sizeof(T) == 2 ? 0x0000FFFFu : 0x00FF00FFu;
  Words v;
#pragma unroll
  for (int i = 0; i < 4; ++i) v.w[i] = (a.w[i] & kEven) | (b.w[i] & ~kEven);
  return v;
}

// One source's samples element by element, through the mirror: runs that
// cross a mirror edge and the ragged tail of a row (n < the run's width).
template <typename T, bool kUV, int kMax>
__device__ __forceinline__ Words gather_slow(const T* row, int x0, int n, int dx, int dim_x) {
  uint32_t r[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    r[k] = 0;
    if (k < n) {
      const int cx = x0 + k;
      const int x = mirror_warp(cx + dx, dim_x);
      r[k] = row[kUV ? (x & ~1) + (cx & 1) : x];
    }
  }
  return pack<T, kMax>(r);
}

// The n outputs of one run and t from the samples g12, g21: mode 0 or 1 takes
// one, mode 2 blends (and, unless kRaw, applies the levels). kUnit: t in
// [0, 1], so every blend lies in [0, 2^24) and truncates by an add rounded
// toward zero (x + 2^23 -> 2^23 + trunc(x)); else by conversion instructions.
// Both give the same bits.
template <typename T, int kMode, bool kUV, bool kRaw, bool kUnit, int kMax>
__device__ __forceinline__ Words finish_run(const Words& g12, const Words& g21, int n,
                                            float fs12, float fs21, float black, float white,
                                            float peak, float mid) {
  if (kMode == 0) return g12;
  if (kMode == 1) return g21;
  uint32_t r[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    r[k] = 0;
    if (k >= n) continue;
    const float x = __fmaf_rn(sample_float<T>(g12, k), fs21,
                              __fmul_rn(sample_float<T>(g21, k), fs12));
    float blended;   // truncf(x)
    if (kUnit) {
      const float s = __fadd_rz(x, kTwo23);
      r[k] = __float_as_uint(s);
      blended = __fsub_rn(s, kTwo23);
    } else {
      blended = truncf(x);
      r[k] = static_cast<uint32_t>(static_cast<int>(blended));
    }
    if (!kRaw) {  // the raw_blend variant stores the blend as it is
      float v;
      if (kUV) {  // ops/warp.py::_apply_levels_uv: fma((v - mid) / white, peak, mid)
        v = __fmaf_rn(__fdiv_rn(__fsub_rn(blended, mid), white), peak, mid);
      } else {    // ops/warp.py::_apply_levels_y: (v - black) / (white - black) * peak
        v = __fmul_rn(__fdiv_rn(__fsub_rn(blended, black), __fsub_rn(white, black)), peak);
      }
      // clip (NaN to 0) into [0, peak], then truncate
      r[k] = __float_as_uint(__fadd_rz(fminf(fmaxf(v, 0.0f), peak), kTwo23));
    }
  }
  return pack<T, kMax>(r);
}

// Every t of ts for one run: n outputs (the run's `run`, or fewer at the
// ragged tail of a row) at columns [x0, x0 + n) of plane row cy, written from
// dst on, t after t.
template <typename T, int kMode, bool kUV, bool kRaw, int kMax>
__device__ __forceinline__ void warp_run(const T* __restrict__ src12,
                                         const T* __restrict__ src21,
                                         const float* __restrict__ ts, int n_t, T* dst,
                                         size_t t_stride, int cy, int plane_h, int x0, int n,
                                         int run, int dim_x, int ox12, int oy12, int ox21,
                                         int oy21, float black, float white, float peak,
                                         float mid) {
  const int nbytes = run * static_cast<int>(sizeof(T));
  for (int i = 0; i < n_t; ++i, dst += t_stride) {
    const float fs12 = ts[i];
    const float fs21 = __fsub_rn(1.0f, fs12);
    // Each source's column shift and mirrored row. y offset products in the
    // reference's left-to-right order: (off * t) * 0.5 on UV (* 1 on Y is
    // the identity).
    int dx12 = 0, dx21 = 0;
    const T* row12 = src12;
    const T* row21 = src21;
    if (kMode != 1) {
      dx12 = round_c(__fmul_rn(static_cast<float>(ox12), fs12));
      const float dy = __fmul_rn(static_cast<float>(oy12), fs12);
      const int y = mirror_warp(cy + round_c(kUV ? __fmul_rn(dy, 0.5f) : dy), plane_h);
      row12 += static_cast<size_t>(y) * dim_x;
    }
    if (kMode != 0) {
      dx21 = -round_c(__fmul_rn(static_cast<float>(ox21), fs21));
      const float dy = __fmul_rn(static_cast<float>(oy21), fs21);
      const int y = mirror_warp(cy - round_c(kUV ? __fmul_rn(dy, 0.5f) : dy), plane_h);
      row21 += static_cast<size_t>(y) * dim_x;
    }
    // Both sources' loads go out before either is used.
    const bool whole = n == run;
    const bool fast12 = kMode != 1 && whole && x0 + dx12 >= 1 && x0 + run - 1 + dx12 <= dim_x - 2;
    const bool fast21 = kMode != 0 && whole && x0 + dx21 >= 1 && x0 + run - 1 + dx21 <= dim_x - 2;
    RunRead r12, r21;
    if (fast12) r12 = issue_run<T, kUV>(row12, x0, dx12, nbytes);
    if (fast21) r21 = issue_run<T, kUV>(row21, x0, dx21, nbytes);
    Words g12{{0, 0, 0, 0}}, g21{{0, 0, 0, 0}};
    if (kMode != 1) {
      g12 = fast12 ? extract_run<T, kUV>(r12, dx12)
                   : gather_slow<T, kUV, kMax>(row12, x0, n, dx12, dim_x);
    }
    if (kMode != 0) {
      g21 = fast21 ? extract_run<T, kUV>(r21, dx21)
                   : gather_slow<T, kUV, kMax>(row21, x0, n, dx21, dim_x);
    }
    const Words res = fs12 >= 0.0f && fs12 <= 1.0f
        ? finish_run<T, kMode, kUV, kRaw, true, kMax>(g12, g21, n, fs12, fs21, black, white,
                                                      peak, mid)
        : finish_run<T, kMode, kUV, kRaw, false, kMax>(g12, g21, n, fs12, fs21, black, white,
                                                       peak, mid);
    store_run<T, kMax>(dst, res, n, run);
  }
}

// One thread per run of outputs of one row (see the note above), every t of
// ts. kRun > 0: runs of kRun samples, whose whole runs are compiled for that
// width (no per-sample guards); kRun 0: runs of 1 << run_shift samples, any
// width up to 16 bytes.
template <typename T, int kMode, bool kUV, bool kRaw, int kRun>
__global__ void __launch_bounds__(256) warp_plane_kernel(
    const T* __restrict__ src12, const T* __restrict__ src21,
    const int16_t* __restrict__ flow, const float* __restrict__ ts, int n_t,
    T* __restrict__ out, int plane_h, int row0, int rows, int dim_x, int low_h, int low_w,
    int rs, int run_shift, float black, float white, float peak, float mid) {
  constexpr int kMax = kRun > 0 ? kRun : 16 / static_cast<int>(sizeof(T));
  const int run = kRun > 0 ? kRun : 1 << run_shift;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * run;
  const int band_y = blockIdx.y * blockDim.y + threadIdx.y;  // row within the band
  const int cy = row0 + band_y;                               // row of the plane
  if (x0 >= dim_x || band_y >= rows || cy >= plane_h) return;
  const int n = min(run, dim_x - x0);   // the ragged tail of a row has fewer

  // The run's flow cell, flow12 there and flow21 at the back-projected cell.
  int scx = x0 >> rs;
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

  T* dst = out + static_cast<size_t>(band_y) * dim_x + x0;
  const size_t t_stride = static_cast<size_t>(rows) * dim_x;
  if (kRun > 0 && n == kRun) {   // a whole run: n and run are compile-time
    warp_run<T, kMode, kUV, kRaw, kMax>(src12, src21, ts, n_t, dst, t_stride, cy, plane_h, x0,
                                        kMax, kMax, dim_x, ox12, oy12, ox21, oy21, black,
                                        white, peak, mid);
  } else {
    warp_run<T, kMode, kUV, kRaw, kMax>(src12, src21, ts, n_t, dst, t_stride, cy, plane_h, x0,
                                        n, run, dim_x, ox12, oy12, ox21, oy21, black, white,
                                        peak, mid);
  }
}

// The output rows of one call: rows [row0, row0 + rows) of each plane, clipped
// to the plane. The whole frame is row0 0 and rows dim_y (Y), dim_y / 2 (UV).
struct Band {
  int row0_y, rows_y, row0_uv, rows_uv;
};

// One plane: runs of 1 << shift samples, compiled for 8 samples (HDR) or 8
// and 16 (SDR), generic otherwise; a warp takes 32 neighbouring runs of one
// row.
template <typename T, int kMode, bool kUV, bool kRaw>
cudaError_t launch_plane(const void* s12, const void* s21, const int16_t* flow,
                         const float* ts, int n_t, void* out, int plane_h, int row0, int rows,
                         int dim_x, int low_h, int low_w, int rs, int shift, float black,
                         float white, float peak, float mid, cudaStream_t stream) {
  const dim3 block(32, 8);
  const int runs = (dim_x + (1 << shift) - 1) >> shift;
  const dim3 grid((runs + block.x - 1) / block.x, (rows + block.y - 1) / block.y);
  const auto go = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(static_cast<const T*>(s12), static_cast<const T*>(s21),
                                       flow, ts, n_t, static_cast<T*>(out), plane_h, row0, rows,
                                       dim_x, low_h, low_w, rs, shift, black, white, peak, mid);
    return cudaGetLastError();
  };
  if (shift == 3) return go(warp_plane_kernel<T, kMode, kUV, kRaw, 8>);
  if constexpr (sizeof(T) == 1) {
    if (shift == 4) return go(warp_plane_kernel<T, kMode, kUV, kRaw, 16>);
  }
  return go(warp_plane_kernel<T, kMode, kUV, kRaw, 0>);
}

template <typename T, int kMode, bool kRaw>
cudaError_t launch_mode(const void* s12y, const void* s12uv, const void* s21y,
                        const void* s21uv, const int16_t* flow, const float* ts,
                        int n_t, void* out_y, void* out_uv, int dim_y, int dim_x,
                        const Band& band, int low_h, int low_w, int rs, float black,
                        float white, float peak, float mid, cudaStream_t stream) {
  // A run is at most 16 bytes and at most a flow cell wide (1 << rs columns
  // on Y, 2 << rs on UV).
  constexpr int kMaxShift = sizeof(T) == 2 ? 3 : 4;
  const int shift_y = rs < kMaxShift ? rs : kMaxShift;
  const int shift_uv = rs + 1 < kMaxShift ? rs + 1 : kMaxShift;
  const cudaError_t err = launch_plane<T, kMode, false, kRaw>(
      s12y, s21y, flow, ts, n_t, out_y, dim_y, band.row0_y, band.rows_y, dim_x, low_h, low_w,
      rs, shift_y, black, white, peak, mid, stream);
  if (err != cudaSuccess) return err;
  return launch_plane<T, kMode, true, kRaw>(
      s12uv, s21uv, flow, ts, n_t, out_uv, dim_y / 2, band.row0_uv, band.rows_uv, dim_x, low_h,
      low_w, rs, shift_uv, black, white, peak, mid, stream);
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
