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
// Float rules. The plain colour is pinned to jitted JAX (tests/test_torch_viz.py
// and the comment above ops/warp._visualize_flow), so every float operation
// here rounds where the plain version's does:
//   * atan2 is fdlibm's atan2f/atanf (glibc's, which XLA calls), ported from
//     ops/warp._atan2f/_atanf step by step; CUDA's atan2f would differ;
//   * every product, sum, difference and quotient rounds on its own
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn): nvcc would otherwise
//     contract a*b+c where it likes;
//   * __fmaf_rn exactly where the plain version calls _fma_f32: the three YUV
//     sums, in its order, and the UV levels fma(q, peak, mid);
//   * float -> int truncates toward zero (__float2int_rz), after the clamp;
//   * the constants are float32 bit patterns, each the float32 of the plain
//     version's decimal (tests/test_torch_hsv_kernel.py holds this table to
//     ops/warp.py's), and 180/pi is the float32 quotient of 180 and pi.
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

namespace {

// float32 constants by bit pattern; beside each, the plain version's decimal.
// fdlibm s_atanf.c / e_atan2f.c (ops/warp._ATAN_HI, _ATAN_LO, _AT, _PI*):
constexpr uint32_t kAtanHi0 = 0x3EED6338u;  // 4.6364760399e-01
constexpr uint32_t kAtanHi1 = 0x3F490FDAu;  // 7.8539812565e-01
constexpr uint32_t kAtanHi2 = 0x3F7B985Eu;  // 9.8279368877e-01
constexpr uint32_t kAtanHi3 = 0x3FC90FDAu;  // 1.5707962513e+00
constexpr uint32_t kAtanLo0 = 0x31AC3769u;  // 5.0121582440e-09
constexpr uint32_t kAtanLo1 = 0x33222168u;  // 3.7748947079e-08
constexpr uint32_t kAtanLo2 = 0x33140FB4u;  // 3.4473217170e-08
constexpr uint32_t kAtanLo3 = 0x33A22168u;  // 7.5497894159e-08
constexpr uint32_t kAt0 = 0x3EAAAAABu;      // 3.3333334327e-01
constexpr uint32_t kAt1 = 0xBE4CCCCDu;      // -2.0000000298e-01
constexpr uint32_t kAt2 = 0x3E124925u;      // 1.4285714924e-01
constexpr uint32_t kAt3 = 0xBDE38E38u;      // -1.1111110449e-01
constexpr uint32_t kAt4 = 0x3DBA2E6Eu;      // 9.0908870101e-02
constexpr uint32_t kAt5 = 0xBD9D8795u;      // -7.6918758452e-02
constexpr uint32_t kAt6 = 0x3D886B35u;      // 6.6610731184e-02
constexpr uint32_t kAt7 = 0xBD6EF16Bu;      // -5.8335702866e-02
constexpr uint32_t kAt8 = 0x3D4BDA59u;      // 4.9768779427e-02
constexpr uint32_t kAt9 = 0xBD15A221u;      // -3.6531571299e-02
constexpr uint32_t kAt10 = 0x3C8569D7u;     // 1.6285819933e-02
constexpr uint32_t kPi = 0x40490FDBu;       // 3.1415927410e+00 (and 3.14159274101257324)
constexpr uint32_t kPiLo = 0xB3BBBD2Eu;     // -8.7422776573e-08
constexpr uint32_t kPiO2 = 0x3FC90FDBu;     // 1.5707963705e+00
// XLA's folds (ops/warp._INV60, _INV255):
constexpr uint32_t kInv60 = 0x3C888889u;    // float32(1/60)
constexpr uint32_t kInv255 = 0x3B808081u;   // float32(1/255)
// The YUV sums' weights (ops/warp._visualize_flow):
constexpr uint32_t kYr = 0x3E991687u;       // 0.299
constexpr uint32_t kYg = 0x3F1645A2u;       // 0.587
constexpr uint32_t kYb = 0x3DE978D5u;       // 0.114
constexpr uint32_t kUr = 0xBE2CC921u;       // -0.168736
constexpr uint32_t kUg = 0xBEA99B6Fu;       // -0.331264
constexpr uint32_t kVg = 0xBED65E46u;       // -0.418688
constexpr uint32_t kVb = 0xBDA686E8u;       // -0.081312

__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

__device__ __forceinline__ int clamp_hi(int v, int lo, int hi) {
  // min(max(v, lo), hi): the torch.clamp order when lo > hi.
  return min(max(v, lo), hi);
}

// fdlibm atanf for finite x (ops/warp._atanf).
__device__ float fdlibm_atanf(float x) {
  const int hx = __float_as_int(x);
  const int ix = hx & 0x7FFFFFFF;
  if (ix >= 0x4C000000) {   // |x| >= 2**26
    const float inf_hi = __fadd_rn(f32(kAtanHi3), f32(kAtanLo3));
    return hx > 0 ? inf_hi : -inf_hi;
  }
  // Argument reduction: id -1 (|x| < 7/16), 0 (< 11/16), 1 (< 19/16),
  // 2 (< 39/16), 3 (otherwise).
  const float ax = fabsf(x);
  int id;
  float xr;
  if (ix < 0x3EE00000) {
    id = -1;
    xr = x;
  } else if (ix < 0x3F300000) {
    id = 0;
    xr = __fdiv_rn(__fsub_rn(__fmul_rn(2.0f, ax), 1.0f), __fadd_rn(2.0f, ax));
  } else if (ix < 0x3F980000) {
    id = 1;
    xr = __fdiv_rn(__fsub_rn(ax, 1.0f), __fadd_rn(ax, 1.0f));
  } else if (ix < 0x401C0000) {
    id = 2;
    xr = __fdiv_rn(__fsub_rn(ax, 1.5f), __fadd_rn(1.0f, __fmul_rn(1.5f, ax)));
  } else {
    id = 3;
    xr = __fdiv_rn(-1.0f, ax);
  }
  const float z = __fmul_rn(xr, xr);
  const float w = __fmul_rn(z, z);
  // s1 = z * (a0 + w * (a2 + w * (a4 + w * (a6 + w * (a8 + w * a10)))))
  float p = __fadd_rn(f32(kAt8), __fmul_rn(w, f32(kAt10)));
  p = __fadd_rn(f32(kAt6), __fmul_rn(w, p));
  p = __fadd_rn(f32(kAt4), __fmul_rn(w, p));
  p = __fadd_rn(f32(kAt2), __fmul_rn(w, p));
  p = __fadd_rn(f32(kAt0), __fmul_rn(w, p));
  const float s1 = __fmul_rn(z, p);
  // s2 = w * (a1 + w * (a3 + w * (a5 + w * (a7 + w * a9))))
  float q = __fadd_rn(f32(kAt7), __fmul_rn(w, f32(kAt9)));
  q = __fadd_rn(f32(kAt5), __fmul_rn(w, q));
  q = __fadd_rn(f32(kAt3), __fmul_rn(w, q));
  q = __fadd_rn(f32(kAt1), __fmul_rn(w, q));
  const float s2 = __fmul_rn(w, q);
  const float xs = __fmul_rn(xr, __fadd_rn(s1, s2));
  if (id < 0) return __fsub_rn(xr, xs);
  const float hi = f32(id == 0 ? kAtanHi0 : id == 1 ? kAtanHi1 : id == 2 ? kAtanHi2 : kAtanHi3);
  const float lo = f32(id == 0 ? kAtanLo0 : id == 1 ? kAtanLo1 : id == 2 ? kAtanLo2 : kAtanLo3);
  const float big = __fsub_rn(hi, __fsub_rn(__fsub_rn(xs, lo), xr));
  return hx < 0 ? -big : big;
}

// fdlibm atan2f for finite y, x (ops/warp._atan2f), its cases in the plain
// version's order of precedence: x == 1, then y == 0, then x == 0.
__device__ float fdlibm_atan2f(float y, float x) {
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
  const float pi = f32(kPi), pi_lo = f32(kPiLo), pi_o_2 = f32(kPiO2);
  if (hx == 0x3F800000) return fdlibm_atanf(y);      // x == 1
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);  // 2 * sign(x) + sign(y)
  if (iy == 0) return m <= 1 ? y : (m == 2 ? pi : -pi);
  if (ix == 0) return hy < 0 ? -pi_o_2 : pi_o_2;
  const int e = (iy - ix) >> 23;                      // exponent difference
  float z;
  if (e > 60) {
    z = __fadd_rn(pi_o_2, __fmul_rn(0.5f, pi_lo));
  } else if (hx < 0 && e < -60) {
    z = 0.0f;
  } else {
    z = fdlibm_atanf(fabsf(__fdiv_rn(y, x)));
  }
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(pi, __fsub_rn(z, pi_lo));
    default: return __fsub_rn(__fsub_rn(z, pi_lo), pi);
  }
}

// trunc(clamp(v, 0, hi)) as an int (ops/warp.py's sat and the levels' clip;
// NaN goes to 0).
__device__ __forceinline__ int clip_trunc(float v, float hi) {
  return __float2int_rz(fminf(fmaxf(v, 0.0f), hi));
}

// The flow colour's r, g and b of the negated flow (ox, oy) of a cell, as
// floats of their ints; 0 where there is no flow (ops/warp._visualize_flow).
struct Rgb {
  float r, g, b;
};

__device__ Rgb flow_rgb(int ox, int oy, float impact) {
  if (ox == 0 && oy == 0) return Rgb{0.0f, 0.0f, 0.0f};
  float angle = __fmul_rn(fdlibm_atan2f(static_cast<float>(oy), static_cast<float>(ox)),
                          __fdiv_rn(180.0f, f32(kPi)));
  // fmod(angle, 360) of an angle in (-180, 180], in the plain version's order
  if (angle < 0.0f) angle = __fadd_rn(angle, 360.0f);
  if (angle >= 360.0f) angle = __fsub_rn(angle, 360.0f);
  if (angle < 0.0f) angle = __fadd_rn(angle, 360.0f);
  const float hue6 = __fmul_rn(angle, f32(kInv60));
  const int h_i = __float2int_rz(hue6);
  const float f = __fsub_rn(hue6, static_cast<float>(h_i));
  const int f255 = __float2int_rz(__fmul_rn(f, 255.0f));
  const int q255 = __float2int_rz(__fmul_rn(__fsub_rn(1.0f, f), 255.0f));
  int pr, pg, pb;
  switch (h_i % 6) {   // hue6 can round to 6.0
    case 0: pr = 255; pg = f255; pb = 0; break;
    case 1: pr = q255; pg = 255; pb = 0; break;
    case 2: pr = 0; pg = 255; pb = f255; break;
    case 3: pr = 0; pg = q255; pb = 255; break;
    case 4: pr = f255; pg = 0; pb = 255; break;
    default: pr = 255; pg = 0; pb = q255; break;
  }
  const float inv255 = f32(kInv255);
  const float mag = static_cast<float>(abs(ox) + abs(oy));
  // left to right: pick * (1/255) * mag * impact; g: pick * (1/255) * |oy| * 2 * impact
  const int r = clip_trunc(
      __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(pr), inv255), mag), impact), 255.0f);
  const int g = clip_trunc(
      __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(pg), inv255),
                                    static_cast<float>(abs(oy))), 2.0f), impact), 255.0f);
  const int b = clip_trunc(
      __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(pb), inv255), mag), impact), 255.0f);
  return Rgb{static_cast<float>(r), static_cast<float>(g), static_cast<float>(b)};
}

// The YUV sums with XLA's contraction: Y = fma(b, .114, fma(g, .587, r * .299)),
// U = fma(b, .5, fma(g, -.331264, r * -.168736)) + 128,
// V = fma(b, -.081312, fma(r, .5, g * -.418688)) + 128.
__device__ __forceinline__ int luma(const Rgb& c) {
  return clip_trunc(__fmaf_rn(c.b, f32(kYb), __fmaf_rn(c.g, f32(kYg), __fmul_rn(c.r, f32(kYr)))),
                    255.0f);
}

__device__ __forceinline__ int chroma_u(const Rgb& c) {
  return clip_trunc(__fadd_rn(__fmaf_rn(c.b, 0.5f, __fmaf_rn(c.g, f32(kUg),
                                                             __fmul_rn(c.r, f32(kUr)))),
                              128.0f), 255.0f);
}

__device__ __forceinline__ int chroma_v(const Rgb& c) {
  return clip_trunc(__fadd_rn(__fmaf_rn(c.b, f32(kVb), __fmaf_rn(c.r, 0.5f,
                                                                 __fmul_rn(c.g, f32(kVg)))),
                              128.0f), 255.0f);
}

// -(flow), narrowed to int16: -(-32768) stays -32768.
__device__ __forceinline__ int negate16(int16_t v) {
  return v == -32768 ? -32768 : -static_cast<int>(v);
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

// ops/warp._apply_levels_y: trunc(clip((v - black) / (white - black) * peak)).
__device__ __forceinline__ uint32_t level_y(int value, float black, float range, float peak) {
  const float v = __fmul_rn(__fdiv_rn(__fsub_rn(static_cast<float>(value), black), range), peak);
  return static_cast<uint32_t>(clip_trunc(v, peak));
}

// ops/warp._apply_levels_uv: trunc(clip(fma((v - mid) / white, peak, mid))).
__device__ __forceinline__ uint32_t level_uv(int value, float white, float peak, float mid) {
  const float v = __fmaf_rn(__fdiv_rn(__fsub_rn(static_cast<float>(value), mid), white), peak,
                            mid);
  return static_cast<uint32_t>(clip_trunc(v, peak));
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
