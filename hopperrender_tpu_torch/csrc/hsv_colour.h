// Mode 3's HSV flow colour and the levels, as device functions: the one
// definition that K5 (csrc/hsv_overlay.cu, the overlay on K2's raw blend) and
// K2's mode 3 (csrc/warp_frame.cu, the overlay in K2's epilogue) share.
//
// Semantics are those of hopperrender_tpu_torch/ops/warp.py::_visualize_flow
// and its levels (_apply_levels_y, _apply_levels_uv). The plain colour is
// pinned to jitted JAX (tests/test_torch_viz.py and the comment above
// ops/warp._visualize_flow), so every float operation here rounds where the
// plain version's does:
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
// The build hashes csrc/*.cu and csrc/*.h, so an edit here rebuilds both.
#pragma once

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

}  // namespace
