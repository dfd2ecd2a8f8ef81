// K2 — bidirectional warp + blend + levels (warpFrameKernel, every output
// mode 0-6), batched over T blending scalars, for the Y plane and the
// interleaved UV plane.
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
//     raw_blend variant (warp_band.py, "Mode-3 feeder"), which K5
//     (csrc/hsv_overlay.cu) colours. Identity levels would not give the
//     blend back: the level arithmetic is not exact in float32;
//   * mode 3 (the HSV flow overlay, ops/warp.py::warp_frame_plane with mode
//     3) colours in K2's epilogue: Y blends as mode 2 does, adds the colour
//     of the output's cell (the negated flow12 that the back-projection
//     loads) as (y << 7) + (raw >> 1) in HDR, (y >> 1) + (raw >> 1) in SDR,
//     and applies the Y levels; UV reads no source sample: its outputs are
//     the cell's levelled U (even columns) and V (odd ones), the same for
//     every t. See "Mode 3" below;
//   * modes 4, 5 and 6 (the grey flow and the two side-by-side views,
//     ops/warp.py::warp_frame_plane in those modes, which the JAX package
//     composes in XLA outside any kernel: ops/warp_viz.py, warp_strip.py's
//     grey_flow_frame, engine/flow_engine.py's _run_warp) are K2's too, one
//     launch each. See "Modes 4, 5 and 6" below;
//   * a row band (row0, rows) per plane is the TPU kernel's mesh-sharded
//     variant (warp_frame_band with num_shards > 1, which slices its band
//     tables and packed sources per shard): shard s of n computes rows
//     [s * r, (s + 1) * r) of each plane, r = ceil(plane_h / n) apart for Y
//     and UV, into a band-local (T, r, W) output. Sources and flow stay
//     whole; the mirror and the flow lookup use the whole plane. Rows past
//     the plane are not written (the wrapper zeroes them; in mode 3 too,
//     where K5 on the raw_blend band coloured them from a raw 0: no output
//     shows them, the mesh crops them).
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
//
// Mode 3. One grid for both planes: blocks [0, n_y) take the Y plane's
// tiles, the rest the UV plane's, so a call is one launch (modes 0/1/2 keep
// one launch a plane). Y runs are mode 2's (the fast path, both sources'
// loads issued together, the slow path at mirror edges and ragged tails);
// finish_run adds the colour's luma to the raw blend and applies the Y
// levels, with mode 2's float rules. UV runs load no source and no flow21:
// the cell's flow12, its colour, U and V levelled once, the run stored T
// times. The colour (fdlibm's atan2f and the hue: some 250-300 divergent
// instructions, csrc/hsv_colour.h) is made once per distinct flow cell of a
// block, not once a run: the first run of each cell in the block (its
// leader, in x and in y) colours it into shared memory from the flow12 it
// loaded, and after one __syncthreads every run reads its cell's entry. A
// block of 32 x 8 runs spans at most 32 x 8 cells, one entry each. At rs 3
// that is 8x (Y) and 16x (UV) fewer colours than one a run. The kernel is
// held to 64 registers (4 blocks an SM), the colour's code spilling a few
// bytes: left to itself it takes 78-82 and runs about 1.6x slower. What
// bounds it: the bytes of both sources' Y planes, the flow and both output
// planes (at 4K HDR T = 1, 58.6 MB: 17.5 us at 3.35 TB/s). Timed without
// the colour (hrt_warp_mode3_probe, PERF.md), what keeps it above that is
// K2's own Y gather (three quarters of its time) and the barrier's wait for
// the colour; a colour made a run, without the barrier, was slower.
//
// Modes 4, 5 and 6. One grid for both planes, as mode 3: blocks [0, n_y)
// take the Y plane's tiles, the rest the UV plane's. A thread takes a run of
// up to 16 bytes of one row and stores it for every t.
//   * Mode 4 reads no source: Y is min((|ox12| + |oy12|) << (10 HDR, 2 SDR),
//     peak) of the run's flow cell (flow loaded once a run), UV is mid
//     (32768 or 128, written here: no byte fill makes 0x8000), no levels.
//     UV runs are 16 bytes whatever the flow grid.
//   * Mode 5: columns below dim_x / 2 copy source 1 (a 16-byte span a run,
//     no levels), the rest are mode 2's runs (warp_run, fast path and all);
//     a run across the half takes its first outputs from the copy.
//   * Mode 6: rows outside the centred band [vo, vo + (dim_y >> (1 + cz))),
//     vo = (dim_y >> 2) >> cz, are filled (0 on Y, mid on UV). In the band
//     the left half reads source 1 at (2 (cy - vo), 2 cx (+ cx & 1 on UV)),
//     16-byte runs read as two spans, no levels; the right half is mode 2
//     at the adjusted position (2 (cx - dim_x / 2), 2 (cy - vo)): the flow
//     lookup, the back-projection, the mirror over the whole plane, UV's
//     halved y offsets and the levels, but UV's sample column keeps the
//     OUTPUT column's parity, which no mode-2 output has. Adjacent right-half
//     outputs are two adjusted columns apart, so its runs are half as wide
//     (a run stays inside one flow cell) and read sample by sample. A row
//     is n_left 16-byte runs of the left half, then the right half's.
//     Mode 6 computes only the quarter of the warp it shows.
// A row band needs nothing outside it: sources and flow are whole.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hsv_colour.h"

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

// The first n_front samples of front, then those of rest.
template <typename T, int kMax>
__device__ __forceinline__ Words merge_front(const Words& front, const Words& rest,
                                             int n_front) {
  uint32_t r[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) r[k] = k < n_front ? sample<T>(front, k) : sample<T>(rest, k);
  return pack<T, kMax>(r);
}

// The n outputs of one run and t from the samples g12, g21: mode 0 or 1 takes
// one, mode 2 blends (and, unless kRaw, applies the levels). kUnit: t in
// [0, 1], so every blend lies in [0, 2^24) and truncates by an add rounded
// toward zero (x + 2^23 -> 2^23 + trunc(x)); else by conversion instructions.
// Both give the same bits.
// Mode 3 (Y only) adds `base`, its cell's colour, to half the raw blend and
// applies the Y levels.
template <typename T, int kMode, bool kUV, bool kRaw, bool kUnit, int kMax>
__device__ __forceinline__ Words finish_run(const Words& g12, const Words& g21, int n,
                                            float fs12, float fs21, float black, float white,
                                            float peak, float mid, int base) {
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
    if (kMode == 3) {  // ops/warp.hsv_colour over the blend, then _apply_levels_y
      const int raw = kUnit ? static_cast<int>(r[k] - kTwo23Bits) : static_cast<int>(r[k]);
      const float v = __fmul_rn(__fdiv_rn(__fsub_rn(static_cast<float>(base + (raw >> 1)),
                                                    black), __fsub_rn(white, black)), peak);
      r[k] = __float_as_uint(__fadd_rz(fminf(fmaxf(v, 0.0f), peak), kTwo23));
    } else if (!kRaw) {  // the raw_blend variant stores the blend as it is
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
                                         float mid, int base = 0, Words front = Words{},
                                         int n_front = 0) {
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
                                                      peak, mid, base)
        : finish_run<T, kMode, kUV, kRaw, false, kMax>(g12, g21, n, fs12, fs21, black, white,
                                                       peak, mid, base);
    // Mode 5: the run's first n_front outputs are source 1's.
    store_run<T, kMax>(dst, n_front > 0 ? merge_front<T, kMax>(front, res, n_front) : res, n,
                       run);
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

// Mode 3's block: 32 runs of 8 rows, as launch_plane's; one colour entry per
// flow cell it can span.
constexpr int kBlockX = 32, kBlockY = 8;

// Mode 3 (see "Mode 3" above): blocks [0, n_y_blocks) take the Y plane's
// tiles of kBlockX runs x kBlockY rows, row-major over blocks_x_y tiles a row;
// the rest take the UV plane's, blocks_x_uv tiles a row. Y runs are
// 1 << shift_y samples (kRunY > 0: compiled for kRunY), UV runs 1 << shift_uv.
// __launch_bounds__ asks for 4 blocks of 256 threads an SM, which caps the
// registers at 64 a thread, as K2's mode 2 uses; left uncapped the colour's
// code takes 78 and more, and an SM holds 2 or 3 blocks, too few loads in
// flight (timed, PERF.md). kColour false (a timing variant,
// hrt_warp_mode3_probe) makes no colour and waits at no barrier: the warp
// and the bytes alone.
template <typename T, int kRunY, bool kColour = true>
__global__ void __launch_bounds__(kBlockX * kBlockY, 4) warp_mode3_kernel(
    const T* __restrict__ src12, const T* __restrict__ src21,
    const int16_t* __restrict__ flow, const float* __restrict__ ts, int n_t,
    T* __restrict__ out_y, T* __restrict__ out_uv, int dim_y, int dim_x, Band band, int low_h,
    int low_w, int rs, int shift_y, int shift_uv, int n_y_blocks, int blocks_x_y,
    int blocks_x_uv, float black, float white) {
  constexpr bool kHdr = sizeof(T) == 2;
  constexpr int kMaxY = kRunY > 0 ? kRunY : 16 / static_cast<int>(sizeof(T));
  constexpr int kMaxUV = 16 / static_cast<int>(sizeof(T));
  constexpr float kPeak = kHdr ? 65535.0f : 255.0f;
  constexpr float kMid = kHdr ? 32768.0f : 128.0f;
  // Y: the cell's colour base; UV: the cell's levelled (U, V) pairs, as the
  // word a run of them repeats.
  __shared__ uint32_t colour[kBlockX * kBlockY];

  const bool uv = blockIdx.x >= static_cast<unsigned>(n_y_blocks);   // uniform in a block
  const int b = uv ? blockIdx.x - n_y_blocks : blockIdx.x;
  const int tiles_x = uv ? blocks_x_uv : blocks_x_y;
  const int bx = b % tiles_x, by = b / tiles_x;
  const int shift = uv ? shift_uv : shift_y;
  const int run = !uv && kRunY > 0 ? kRunY : 1 << shift;
  const int plane_h = uv ? dim_y / 2 : dim_y;
  const int row0 = uv ? band.row0_uv : band.row0_y;
  const int rows = uv ? band.rows_uv : band.rows_y;
  const int x0 = (bx * kBlockX + threadIdx.x) * run;
  const int band_y = by * kBlockY + threadIdx.y;   // row within the band
  const int cy = row0 + band_y;                    // row of the plane
  const bool active = x0 < dim_x && band_y < rows && cy < plane_h;

  // The run's flow cell: column (x0 >> rs) on Y, ((x0 >> rs) & ~1) on UV,
  // counted in cells of its plane (cell_x), and row cy >> rs.
  const auto cell_of = [&](int x) { return uv ? (x >> rs) >> 1 : x >> rs; };
  const int cell_x = cell_of(x0), cell_y = cy >> rs;
  const int entry = (cell_y - ((row0 + by * kBlockY) >> rs)) * kBlockX
                    + cell_x - cell_of(bx * kBlockX * run);
  const bool leader = (threadIdx.x == 0 || cell_of(x0 - run) != cell_x)
                      && (threadIdx.y == 0 || ((cy - 1) >> rs) != cell_y);
  int ox12 = 0, oy12 = 0, ox21 = 0, oy21 = 0;
  if (active) {
    const int scx = clamp_hi(uv ? cell_x << 1 : cell_x, 0, low_w - 1);
    const int scy = clamp_hi(uv ? cell_y << 1 : cell_y, 0, low_h - 1);
    const int16_t* flow_x = flow;
    const int16_t* flow_y = flow + static_cast<size_t>(low_h) * low_w;
    ox12 = flow_x[scy * low_w + scx];
    oy12 = flow_y[scy * low_w + scx];
    if (!uv) {   // flow21 at the back-projected cell, as K2's other modes
      const int bcy = clamp_hi(scy - (oy12 >> rs), 0, low_h - 1);
      const int bcx = clamp_hi(scx - (ox12 >> rs), 0, low_w - 1);
      ox21 = flow_x[bcy * low_w + bcx];
      oy21 = flow_y[bcy * low_w + bcx];
    }
    // the colour of the cell's negated flow12, once a block (by its leader)
    if (kColour && leader) {
      const Rgb c = flow_rgb(negate16(static_cast<int16_t>(ox12)),
                             negate16(static_cast<int16_t>(oy12)), rs <= 2 ? 4.0f : 1.0f);
      if (uv) {
        const uint32_t lu = level_uv(kHdr ? chroma_u(c) << 8 : chroma_u(c), white, kPeak, kMid);
        const uint32_t lv = level_uv(kHdr ? chroma_v(c) << 8 : chroma_v(c), white, kPeak, kMid);
        colour[entry] = kHdr ? lu | lv << 16 : (lu | lv << 8) * 0x00010001u;
      } else {
        colour[entry] = static_cast<uint32_t>(kHdr ? luma(c) << 7 : luma(c) >> 1);
      }
    }
  }
  if (kColour) __syncthreads();
  if (!active) return;
  const uint32_t word = kColour ? colour[entry] : 0u;
  const int n = min(run, dim_x - x0);   // the ragged tail of a row has fewer
  const size_t t_stride = static_cast<size_t>(rows) * dim_x;
  const size_t at = static_cast<size_t>(band_y) * dim_x + x0;
  if (uv) {   // U on even columns, V on odd ones (x0 is even), every t the same
    const Words v{{word, word, word, word}};
    for (int i = 0; i < n_t; ++i) store_run<T, kMaxUV>(out_uv + at + i * t_stride, v, n, run);
    return;
  }
  const int base = static_cast<int>(word);
  if (kRunY > 0 && n == kRunY) {   // a whole run: n and run are compile-time
    warp_run<T, 3, false, false, kMaxY>(src12, src21, ts, n_t, out_y + at, t_stride, cy,
                                        plane_h, x0, kMaxY, kMaxY, dim_x, ox12, oy12, ox21,
                                        oy21, black, white, kPeak, kMid, base);
  } else {
    warp_run<T, 3, false, false, kMaxY>(src12, src21, ts, n_t, out_y + at, t_stride, cy,
                                        plane_h, x0, n, run, dim_x, ox12, oy12, ox21, oy21,
                                        black, white, kPeak, kMid, base);
  }
}

// Mode 3's one launch: the Y tiles, then the UV tiles, in one grid.
template <typename T, bool kColour = true>
cudaError_t launch_mode3(const void* s12y, const void* s21y, const int16_t* flow,
                         const float* ts, int n_t, void* out_y, void* out_uv, int dim_y,
                         int dim_x, const Band& band, int low_h, int low_w, int rs, float black,
                         float white, cudaStream_t stream) {
  constexpr int kMaxShift = sizeof(T) == 2 ? 3 : 4;
  const int shift_y = rs < kMaxShift ? rs : kMaxShift;
  const int shift_uv = rs + 1 < kMaxShift ? rs + 1 : kMaxShift;
  const auto tiles_x = [&](int shift) {
    const int runs = (dim_x + (1 << shift) - 1) >> shift;
    return (runs + kBlockX - 1) / kBlockX;
  };
  const int blocks_x_y = tiles_x(shift_y), blocks_x_uv = tiles_x(shift_uv);
  const int n_y_blocks = blocks_x_y * ((band.rows_y + kBlockY - 1) / kBlockY);
  const int n_blocks = n_y_blocks + blocks_x_uv * ((band.rows_uv + kBlockY - 1) / kBlockY);
  const auto go = [&](auto kernel) {
    kernel<<<n_blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
        static_cast<const T*>(s12y), static_cast<const T*>(s21y), flow, ts, n_t,
        static_cast<T*>(out_y), static_cast<T*>(out_uv), dim_y, dim_x, band, low_h, low_w, rs,
        shift_y, shift_uv, n_y_blocks, blocks_x_y, blocks_x_uv, black, white);
    return cudaGetLastError();
  };
  if (shift_y == 3) return go(warp_mode3_kernel<T, 8, kColour>);
  if constexpr (sizeof(T) == 1) {
    if (shift_y == 4) return go(warp_mode3_kernel<T, 16, kColour>);
  }
  return go(warp_mode3_kernel<T, 0, kColour>);
}

// -- Modes 4, 5 and 6 (see "Modes 4, 5 and 6" above) -----------------------------

// How the runs of modes 4, 5 and 6 tile one row of a plane.
struct VizPlane {
  int shift;     // modes 4 and 5: log2 of a run's width
  int shift_r;   // mode 6: log2 of the right half's runs, from column dim_x / 2
  int n_left;    // mode 6: 16-byte runs of the left half
  int tiles_x;   // blocks of kBlockX runs across a row
};

// v in every sample of a Words.
template <typename T>
__device__ __forceinline__ Words splat(uint32_t v) {
  const uint32_t w = sizeof(T) == 2 ? v * 0x00010001u : v * 0x01010101u;
  return Words{{w, w, w, w}};
}

// The n samples at p (any alignment): the aligned chunks that hold them where
// the run is whole, else one by one.
template <typename T, int kMax>
__device__ __forceinline__ Words load_run(const T* p, int n, int run) {
  if (n == run) return extract(issue_span(p, run * static_cast<int>(sizeof(T))));
  uint32_t r[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) r[k] = k < n ? p[k] : 0u;
  return pack<T, kMax>(r);
}

// The same n outputs for every t.
template <typename T, int kMax>
__device__ __forceinline__ void store_every_t(T* dst, size_t t_stride, int n_t, const Words& v,
                                              int n, int run) {
  for (int i = 0; i < n_t; ++i) store_run<T, kMax>(dst + i * t_stride, v, n, run);
}

// Mode 6's left half: output column c shows sample 2c (Y) or 2c + (c & 1)
// (UV: U from even source pairs, V from odd ones) of source row `row`. A
// whole run (x0 even) reads its 2 kMax samples as two 16-byte spans.
template <typename T, bool kUV, int kMax>
__device__ __forceinline__ Words side_left(const T* row, int x0, int n, int dim_x) {
  uint32_t r[kMax];
  if (n == kMax) {
    const Words a = extract(issue_span(row + 2 * x0, 16));
    const Words b = extract(issue_span(row + 2 * x0 + kMax, 16));
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      const int i = 2 * k + (kUV ? (k & 1) : 0);
      r[k] = i < kMax ? sample<T>(a, i) : sample<T>(b, i - kMax);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      const int c = x0 + k;
      r[k] = k < n ? row[min(2 * c + (kUV ? (c & 1) : 0), dim_x - 1)] : 0u;
    }
  }
  return pack<T, kMax>(r);
}

// Mode 6's right half: n outputs at columns [x0, x0 + n) of a band row, each
// mode 2 at the adjusted position (ax0 + 2k, ay) with its levels; UV's
// sample column keeps the OUTPUT column's parity, (x & ~1) + ((x0 + k) & 1).
// Adjacent outputs are two adjusted columns apart, so the samples are read
// one by one. The run lies inside one flow cell (ox12 .. oy21).
template <typename T, bool kUV, int kMax>
__device__ __forceinline__ void warp_run_side(const T* __restrict__ src12,
                                              const T* __restrict__ src21,
                                              const float* __restrict__ ts, int n_t, T* dst,
                                              size_t t_stride, int ay, int plane_h, int ax0,
                                              int x0, int n, int run, int dim_x, int ox12,
                                              int oy12, int ox21, int oy21, float black,
                                              float white, float peak, float mid) {
  for (int i = 0; i < n_t; ++i, dst += t_stride) {
    const float fs12 = ts[i];
    const float fs21 = __fsub_rn(1.0f, fs12);
    const int dx12 = round_c(__fmul_rn(static_cast<float>(ox12), fs12));
    const int dx21 = -round_c(__fmul_rn(static_cast<float>(ox21), fs21));
    const float dy12 = __fmul_rn(static_cast<float>(oy12), fs12);
    const float dy21 = __fmul_rn(static_cast<float>(oy21), fs21);
    const T* row12 = src12 + static_cast<size_t>(mirror_warp(
        ay + round_c(kUV ? __fmul_rn(dy12, 0.5f) : dy12), plane_h)) * dim_x;
    const T* row21 = src21 + static_cast<size_t>(mirror_warp(
        ay - round_c(kUV ? __fmul_rn(dy21, 0.5f) : dy21), plane_h)) * dim_x;
    uint32_t r12[kMax], r21[kMax];
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      r12[k] = r21[k] = 0;
      if (k < n) {
        int x12 = mirror_warp(ax0 + 2 * k + dx12, dim_x);
        int x21 = mirror_warp(ax0 + 2 * k + dx21, dim_x);
        if (kUV) {
          x12 = (x12 & ~1) + ((x0 + k) & 1);
          x21 = (x21 & ~1) + ((x0 + k) & 1);
        }
        r12[k] = row12[x12];
        r21[k] = row21[x21];
      }
    }
    const Words g12 = pack<T, kMax>(r12), g21 = pack<T, kMax>(r21);
    const Words res = fs12 >= 0.0f && fs12 <= 1.0f
        ? finish_run<T, 2, kUV, false, true, kMax>(g12, g21, n, fs12, fs21, black, white, peak,
                                                   mid, 0)
        : finish_run<T, 2, kUV, false, false, kMax>(g12, g21, n, fs12, fs21, black, white, peak,
                                                    mid, 0);
    store_run<T, kMax>(dst, res, n, run);
  }
}

// flow12 at flow cell (scx, scy) of plane coordinates, clamped, and flow21 at
// the back-projected cell: (ox12, oy12, ox21, oy21).
struct CellFlow {
  int ox12, oy12, ox21, oy21;
};

template <bool kUV>
__device__ __forceinline__ CellFlow cell_flow(const int16_t* __restrict__ flow, int x, int y,
                                              int low_h, int low_w, int rs) {
  int scx = x >> rs, scy = y >> rs;
  if (kUV) {
    scx &= ~1;
    scy <<= 1;
  }
  scx = clamp_hi(scx, 0, low_w - 1);
  scy = clamp_hi(scy, 0, low_h - 1);
  const int16_t* flow_x = flow;
  const int16_t* flow_y = flow + static_cast<size_t>(low_h) * low_w;
  CellFlow f;
  f.ox12 = flow_x[scy * low_w + scx];
  f.oy12 = flow_y[scy * low_w + scx];
  const int bcy = clamp_hi(scy - (f.oy12 >> rs), 0, low_h - 1);
  const int bcx = clamp_hi(scx - (f.ox12 >> rs), 0, low_w - 1);
  f.ox21 = flow_x[bcy * low_w + bcx];
  f.oy21 = flow_y[bcy * low_w + bcx];
  return f;
}

// Mode 6's run j of plane row cy (see viz_run, which calls it).
template <typename T, bool kUV, int kMax>
__device__ __forceinline__ void viz_run_side(const T* __restrict__ src12,
                                             const T* __restrict__ src21,
                                             const int16_t* __restrict__ flow,
                                             const float* __restrict__ ts, int n_t, T* row_out,
                                             size_t t_stride, int dim_y, int dim_x, int plane_h,
                                             int cy, int j, const VizPlane& g, int low_h,
                                             int low_w, int rs, float black, float white) {
  constexpr bool kHdr = sizeof(T) == 2;
  constexpr uint32_t kMidSample = kHdr ? 32768u : 128u;
  const int half = dim_x >> 1;
  const bool left = j < g.n_left;
  const int run = left ? kMax : 1 << g.shift_r;
  const int x0 = left ? j * kMax : half + ((j - g.n_left) << g.shift_r);
  const int end = left ? half : dim_x;
  if (x0 >= end) return;
  const int n = min(run, end - x0);
  const int vo = (dim_y >> 2) >> (kUV ? 1 : 0);
  if (cy < vo || cy >= vo + (dim_y >> (kUV ? 2 : 1))) {
    store_every_t<T, kMax>(row_out + x0, t_stride, n_t, splat<T>(kUV ? kMidSample : 0u), n, run);
    return;
  }
  const int ay = (cy - vo) << 1;   // the adjusted (source) row
  if (left) {
    const T* row = src12 + static_cast<size_t>(min(ay, plane_h - 1)) * dim_x;
    store_every_t<T, kMax>(row_out + x0, t_stride, n_t, side_left<T, kUV, kMax>(row, x0, n, dim_x),
                           n, run);
    return;
  }
  const int ax0 = (x0 - half) << 1;
  const CellFlow f = cell_flow<kUV>(flow, ax0, ay, low_h, low_w, rs);
  warp_run_side<T, kUV, kMax>(src12, src21, ts, n_t, row_out + x0, t_stride, ay, plane_h, ax0,
                              x0, n, run, dim_x, f.ox12, f.oy12, f.ox21, f.oy21, black, white,
                              kHdr ? 65535.0f : 255.0f, kHdr ? 32768.0f : 128.0f);
}

// Run j of plane row cy (band row band_y) in mode 4, 5 or 6, every t. kRun >
// 0: mode 5's whole runs are compiled for that width.
template <typename T, int kMode, bool kUV, int kRun>
__device__ __forceinline__ void viz_run(const T* __restrict__ src12, const T* __restrict__ src21,
                                        const int16_t* __restrict__ flow,
                                        const float* __restrict__ ts, int n_t, T* out,
                                        size_t t_stride, int dim_y, int dim_x, int plane_h,
                                        int cy, int band_y, int j, const VizPlane& g, int low_h,
                                        int low_w, int rs, float black, float white) {
  constexpr bool kHdr = sizeof(T) == 2;
  constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  constexpr int kPeak = kHdr ? 65535 : 255;
  T* const row_out = out + static_cast<size_t>(band_y) * dim_x;

  if constexpr (kMode == 4) {   // the grey of the run's flow cell on Y; mid on UV
    const int run = 1 << g.shift;
    const int x0 = j << g.shift;
    if (x0 >= dim_x) return;
    uint32_t v = kHdr ? 32768u : 128u;
    if (!kUV) {
      const int16_t* flow_y = flow + static_cast<size_t>(low_h) * low_w;
      const int at = clamp_hi(cy >> rs, 0, low_h - 1) * low_w + clamp_hi(x0 >> rs, 0, low_w - 1);
      const int mag = abs(static_cast<int>(flow[at])) + abs(static_cast<int>(flow_y[at]));
      v = static_cast<uint32_t>(min(mag << (kHdr ? 10 : 2), kPeak));
    }
    store_every_t<T, kMax>(row_out + x0, t_stride, n_t, splat<T>(v), min(run, dim_x - x0), run);
  } else if constexpr (kMode == 5) {   // source 1 left of the half, mode 2 from it on
    const int run = kRun > 0 ? kRun : 1 << g.shift;
    const int x0 = j * run;
    if (x0 >= dim_x) return;
    const int n = min(run, dim_x - x0);
    const int n_front = clamp_hi((dim_x >> 1) - x0, 0, n);
    const T* src_row = src12 + static_cast<size_t>(cy) * dim_x + x0;
    const Words front = n_front > 0 ? load_run<T, kMax>(src_row, n, run) : Words{{0, 0, 0, 0}};
    if (n_front == n) {
      store_every_t<T, kMax>(row_out + x0, t_stride, n_t, front, n, run);
      return;
    }
    const CellFlow f = cell_flow<kUV>(flow, x0, cy, low_h, low_w, rs);
    constexpr int kWhole = kRun > 0 ? kRun : kMax;
    if (kRun > 0 && n == kRun) {   // a whole run: n and run are compile-time
      warp_run<T, 2, kUV, false, kWhole>(src12, src21, ts, n_t, row_out + x0, t_stride, cy,
                                         plane_h, x0, kWhole, kWhole, dim_x, f.ox12, f.oy12,
                                         f.ox21, f.oy21, black, white, kPeak,
                                         kHdr ? 32768.0f : 128.0f, 0, front, n_front);
    } else {
      warp_run<T, 2, kUV, false, kMax>(src12, src21, ts, n_t, row_out + x0, t_stride, cy,
                                       plane_h, x0, n, run, dim_x, f.ox12, f.oy12, f.ox21,
                                       f.oy21, black, white, kPeak, kHdr ? 32768.0f : 128.0f, 0,
                                       front, n_front);
    }
  } else {
    // Mode 6: a centred band of rows [vo, vo + (dim_y >> (1 + cz))) shows
    // source 1 (left) and mode 2 (right), 2x down; 0 (Y) and mid (UV) around it.
    viz_run_side<T, kUV, kMax>(src12, src21, flow, ts, n_t, row_out, t_stride, dim_y, dim_x,
                               plane_h, cy, j, g, low_h, low_w, rs, black, white);
  }
}

// Modes 4, 5 and 6 in one grid: blocks [0, n_y_blocks) take the Y plane's
// tiles of kBlockX runs x kBlockY rows (geo_y.tiles_x tiles a row), the rest
// the UV plane's. kRunY > 0: mode 5's whole Y runs are compiled for it.
// __launch_bounds__ asks for 4 blocks an SM (64 registers a thread), as mode
// 3: left to itself mode 5 takes 99-116 registers and mode 6 73-80, and
// both ran 8-16% slower, though held to 64 they spill (PERF.md, run DH).
template <typename T, int kMode, int kRunY>
__global__ void __launch_bounds__(kBlockX * kBlockY, 4) warp_viz_kernel(
    const T* __restrict__ s12y, const T* __restrict__ s12uv, const T* __restrict__ s21y,
    const T* __restrict__ s21uv, const int16_t* __restrict__ flow, const float* __restrict__ ts,
    int n_t, T* __restrict__ out_y, T* __restrict__ out_uv, int dim_y, int dim_x, Band band,
    int low_h, int low_w, int rs, VizPlane geo_y, VizPlane geo_uv, int n_y_blocks, float black,
    float white) {
  const bool uv = blockIdx.x >= static_cast<unsigned>(n_y_blocks);   // uniform in a block
  const VizPlane g = uv ? geo_uv : geo_y;
  const int b = uv ? blockIdx.x - n_y_blocks : blockIdx.x;
  const int j = (b % g.tiles_x) * kBlockX + threadIdx.x;        // the run's index in its row
  const int band_y = (b / g.tiles_x) * kBlockY + threadIdx.y;   // row within the band
  const int plane_h = uv ? dim_y / 2 : dim_y;
  const int rows = uv ? band.rows_uv : band.rows_y;
  const int cy = (uv ? band.row0_uv : band.row0_y) + band_y;    // row of the plane
  if (band_y >= rows || cy >= plane_h) return;
  const size_t t_stride = static_cast<size_t>(rows) * dim_x;
  if (uv) {
    viz_run<T, kMode, true, 0>(s12uv, s21uv, flow, ts, n_t, out_uv, t_stride, dim_y, dim_x,
                               plane_h, cy, band_y, j, g, low_h, low_w, rs, black, white);
  } else {
    viz_run<T, kMode, false, kRunY>(s12y, s21y, flow, ts, n_t, out_y, t_stride, dim_y, dim_x,
                                    plane_h, cy, band_y, j, g, low_h, low_w, rs, black, white);
  }
}

// Modes 4, 5 and 6's one launch. A run is at most 16 bytes; where it warps
// (mode 5, mode 6's right half) it lies inside one flow cell: 1 << rs
// columns on Y and 2 << rs on UV, and on mode 6's right half half as many
// output columns, two adjusted columns apart. Mode 4's UV and mode 6's left
// half take whole 16-byte runs.
template <typename T, int kMode>
cudaError_t launch_viz(const void* s12y, const void* s12uv, const void* s21y, const void* s21uv,
                       const int16_t* flow, const float* ts, int n_t, void* out_y, void* out_uv,
                       int dim_y, int dim_x, const Band& band, int low_h, int low_w, int rs,
                       float black, float white, cudaStream_t stream) {
  constexpr int kMaxShift = sizeof(T) == 2 ? 3 : 4;
  const auto cap = [&](int shift) { return shift < kMaxShift ? shift : kMaxShift; };
  const auto runs = [](int width, int shift) { return (width + (1 << shift) - 1) >> shift; };
  const auto plane = [&](bool uv) {
    VizPlane g{0, 0, 0, 0};
    int n_runs;
    if (kMode == 6) {
      const int half = dim_x >> 1;
      g.shift_r = uv ? cap(rs) : (rs > 0 ? cap(rs - 1) : 0);
      g.n_left = runs(half, kMaxShift);
      n_runs = g.n_left + runs(dim_x - half, g.shift_r);
    } else {
      g.shift = kMode == 4 && uv ? kMaxShift : cap(uv ? rs + 1 : rs);
      n_runs = runs(dim_x, g.shift);
    }
    g.tiles_x = (n_runs + kBlockX - 1) / kBlockX;
    return g;
  };
  const VizPlane geo_y = plane(false), geo_uv = plane(true);
  const int n_y_blocks = geo_y.tiles_x * ((band.rows_y + kBlockY - 1) / kBlockY);
  const int n_blocks = n_y_blocks + geo_uv.tiles_x * ((band.rows_uv + kBlockY - 1) / kBlockY);
  const auto go = [&](auto kernel) {
    kernel<<<n_blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
        static_cast<const T*>(s12y), static_cast<const T*>(s12uv), static_cast<const T*>(s21y),
        static_cast<const T*>(s21uv), flow, ts, n_t, static_cast<T*>(out_y),
        static_cast<T*>(out_uv), dim_y, dim_x, band, low_h, low_w, rs, geo_y, geo_uv, n_y_blocks,
        black, white);
    return cudaGetLastError();
  };
  if constexpr (kMode == 5) {
    if (geo_y.shift == 3) return go(warp_viz_kernel<T, 5, 8>);
    if constexpr (sizeof(T) == 1) {
      if (geo_y.shift == 4) return go(warp_viz_kernel<T, 5, 16>);
    }
  }
  return go(warp_viz_kernel<T, kMode, 0>);
}

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
    case 3:   // the HSV flow overlay: one launch for both planes; reads no UV source
      return launch_mode3<T>(s12y, s21y, flow, ts, n_t, out_y, out_uv, dim_y, dim_x, band,
                             low_h, low_w, rs, black, white, stream);
    case 4:   // grey flow: one launch for both planes; reads no source
      return launch_viz<T, 4>(s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y, out_uv, dim_y,
                              dim_x, band, low_h, low_w, rs, black, white, stream);
    case 5:   // side by side: one launch for both planes
      return launch_viz<T, 5>(s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y, out_uv, dim_y,
                              dim_x, band, low_h, low_w, rs, black, white, stream);
    case 6:   // side by side, 2x down: one launch for both planes
      return launch_viz<T, 6>(s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y, out_uv, dim_y,
                              dim_x, band, low_h, low_w, rs, black, white, stream);
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
// units (HDR pre-scaled x256). mode 0-6 (3: the HSV flow overlay, one
// launch, the UV sources not read; 4: the grey flow, one launch, no source
// read; 5 and 6: side by side, one launch each). raw_blend != 0 (mode 2
// only) stores the blend without levels.
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

// A timing variant of K2's mode 3, HDR, the whole frame, res_scalar >= 3
// (runs of 8): 0 as on the path; 1 no colour. The arguments are
// hrt_warp_frames' without the band, mode and raw_blend.
extern "C" int hrt_warp_mode3_probe(int variant, const void* src12_y, const void* src21_y,
                                    const void* flow, const void* ts, int n_t, void* out_y,
                                    void* out_uv, int dim_y, int dim_x, int low_h, int low_w,
                                    int res_scalar, float black, float white, void* stream) {
  if (variant < 0 || variant > 1 || res_scalar < 3) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = variant == 0 ? launch_mode3<uint16_t, true>
                                    : launch_mode3<uint16_t, false>;
  const Band band{0, dim_y, 0, dim_y / 2};
  return static_cast<int>(launch(src12_y, src21_y, static_cast<const int16_t*>(flow),
                                 static_cast<const float*>(ts), n_t, out_y, out_uv, dim_y, dim_x,
                                 band, low_h, low_w, res_scalar, black, white,
                                 static_cast<cudaStream_t>(stream)));
}
