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
// Modes 4, 5 and 6. One launch of one grid for both planes an output.
//   * Mode 4 (grey_flow_kernel) reads no source: Y is min((|ox12| + |oy12|)
//     << (10 HDR, 2 SDR), peak) of each run's flow cell, UV mid (32768 or 128,
//     written here: no byte fill makes 0x8000); blocks [0, n_y) take the Y
//     plane's tiles, the rest the UV plane's (16-byte runs).
//   * Modes 5 and 6 (warp_viz_kernel): tiles of two kinds, one kind a block
//     (VizGrid, viz_grid). Stream tiles move bytes only, four 16-byte runs a
//     thread, all loaded before any is stored, every t: fill (mode 6 outside
//     its centred band [vo, vo + (dim_y >> (1 + cz))), vo = (dim_y >> 2) >>
//     cz: 0 on Y, mid on UV), copy (mode 5 left of the half: source 1) and
//     halve (mode 6's left half in its band: source 1 at (2 (cy - vo), 2 cx
//     (+ cx & 1 on UV)), two 16-byte loads and a byte permute a word). Warp
//     tiles look flow up, a run a thread: warp (mode 5's right half: mode 2,
//     runs of one flow cell of at most 8 samples from the half rounded down
//     to their width) and side (mode 6's right half in its band: mode 2 at
//     the adjusted position (2 (cx - dim_x / 2), 2 (cy - vo)), UV's sample
//     column keeping the OUTPUT column's parity; runs of 16 bytes, flow
//     cells of 4 outputs taken one after the other);
//   * a warp run reads each source's samples for a flow cell as one span of
//     the row, the aligned 16-byte chunks that hold it (at most two), both
//     sources' requested before either is used, and takes them apart by byte
//     permutes (pick_cell): mode 5's UV under an odd shift takes V from the
//     next pair (one span of run + 2 samples, not two); mode 6 takes every
//     other sample, on UV 2k + (k & 1). Mirror edges gather sample by sample,
//     four at a time (gather_cell); ragged tails, mode 5's run across an odd
//     half, mode 6's UV at an odd half and widths not compiled (small
//     res_scalar) go element by element in a function that is not inlined
//     (warp_elements); compiled widths: 4 and 8 samples.
// The kinds split so that a copy tile carries no warp state and a warp tile
// no copy state. The 4K HDR path's instances (rs >= 3) are held to 64
// registers (__launch_bounds__(256, 4), 4 blocks an SM) without spilling;
// the others take no cap, so that none spills. The stream tiles are spread
// evenly among the warp tiles (their bytes move while the warp tiles wait on
// their gathers). Both were chosen by graph-timed turns at 4K HDR
// (PERF.md): 64 registers beat 80 and no cap by 5-13%, spreading the
// stream tiles saved 5-9% in mode 6. On an H100 at 700 W, 4K HDR, one
// output takes 0.0355 ms in mode 5 and 0.0345 in mode 6, 1.9x and 2.3x the
// bytes' bound; what keeps the warp tiles above it is latency, a thread
// waiting on its flow cell, then on its sources (mode 6: then on its
// second cell).
// A row band needs nothing outside it: sources and flow are whole.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

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
                                         float mid, int base = 0) {
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

// v in every sample of a Words.
template <typename T>
__device__ __forceinline__ Words splat(uint32_t v) {
  const uint32_t w = sizeof(T) == 2 ? v * 0x00010001u : v * 0x01010101u;
  return Words{{w, w, w, w}};
}

// 16 bytes at p, aligned to 16.
__device__ __forceinline__ Words load16(const void* p) {
  const uint4 v = __ldg(static_cast<const uint4*>(p));
  return Words{{v.x, v.y, v.z, v.w}};
}

// The same n outputs for every t.
template <typename T, int kMax>
__device__ __forceinline__ void store_every_t(T* dst, int t_stride, int n_t, const Words& v,
                                              int n, int run) {
  for (int i = 0; i < n_t; ++i) {
    store_run<T, kMax>(dst + static_cast<size_t>(i) * t_stride, v, n, run);
  }
}

// A stream run element by element, every t: n outputs from column x0 of
// fill (kStep 0), of source row `row` (kStep 1: mode 5's left half) or of its
// sample 2c (Y) or 2c + (c & 1) (UV) at output column c (kStep 2: mode 6's
// left half). Ragged ends and rows off 16 bytes; not inlined, as
// warp_elements.
template <typename T, bool kUV, int kStep>
__device__ __noinline__ void stream_elements(const T* row, uint32_t fill, int x0, int n,
                                             int dim_x, T* dst, int t_stride, int n_t) {
  for (int k = 0; k < n; ++k) {
    const int c = x0 + k;
    const T v = kStep == 0 ? static_cast<T>(fill)
                : kStep == 1 ? row[c] : row[min(2 * c + (kUV ? (c & 1) : 0), dim_x - 1)];
    for (int i = 0; i < n_t; ++i) dst[static_cast<size_t>(i) * t_stride + k] = v;
  }
}

// flow12 at flow cell (scx, scy) of plane coordinates, clamped, and flow21 at
// the back-projected cell: (ox12, oy12, ox21, oy21), as floats (exact), the
// form the positions use: the ints need not stay live beside them.
struct CellFlow {
  float ox12, oy12, ox21, oy21;
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
  const int ox12 = flow_x[scy * low_w + scx];
  const int oy12 = flow_y[scy * low_w + scx];
  const int bcy = clamp_hi(scy - (oy12 >> rs), 0, low_h - 1);
  const int bcx = clamp_hi(scx - (ox12 >> rs), 0, low_w - 1);
  return CellFlow{static_cast<float>(ox12), static_cast<float>(oy12),
                  static_cast<float>(flow_x[bcy * low_w + bcx]),
                  static_cast<float>(flow_y[bcy * low_w + bcx])};
}

// One source's samples for the kSub outputs of one flow cell of a warp run
// whose warped columns lie inside [1, dim_x - 2] (the mirror is then the
// identity): output k at adjusted column ax + kStep k, shifted by dx. They lie
// in one span of the row, read as the aligned 16-byte chunks that hold it
// (issue_cell: at most two for the widths launch_viz compiles), which
// pick_cell takes apart later, so that both sources' loads are in flight
// together:
//   * Y: output k is span sample kStep k, the span from ax + dx;
//   * UV (the cell's first output column even, so output k's parity is
//     k & 1): the span starts at the even column ax + (dx & ~1); with kStep 1
//     output k is its sample k, or k + 2 for an odd k under an odd dx (V from
//     the next pair); with kStep 2 its sample 2k + (k & 1).
template <bool kUV, int kStep>
__device__ __forceinline__ constexpr int span_sample(int k) {   // under an even dx
  return !kUV ? kStep * k : kStep == 2 ? 2 * k + (k & 1) : k;
}

template <typename T, bool kUV, int kStep, int kSub>
struct CellSpan {
  // The span's most bytes, and the alignment of its start.
  static constexpr int kBytes =
      (kUV ? (kStep == 1 ? kSub + 2 : 2 * kSub) : kStep * (kSub - 1) + 1) *
      static_cast<int>(sizeof(T));
  static constexpr int kAlign = (kUV ? 2 : 1) * static_cast<int>(sizeof(T));
  static constexpr int kChunks = (16 - kAlign + kBytes + 15) / 16;
  uint4 c[kChunks];
  int off;   // the span's offset into c[0]
};

template <typename T, bool kUV, int kStep, int kSub>
__device__ __forceinline__ CellSpan<T, kUV, kStep, kSub> issue_cell(const T* row, int ax, int dx) {
  using S = CellSpan<T, kUV, kStep, kSub>;
  const int nbytes = kUV && kStep == 1 ? (kSub + ((dx & 1) << 1)) * static_cast<int>(sizeof(T))
                                       : S::kBytes;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + (kUV ? ax + (dx & ~1) : ax + dx));
  S s;
  s.off = static_cast<int>(a & 15);
  const uint4* q = reinterpret_cast<const uint4*>(a - s.off);
#pragma unroll
  for (int i = 0; i < S::kChunks; ++i) {
    s.c[i] = i == 0 || s.off + nbytes > 16 * i ? __ldg(q + i) : make_uint4(0, 0, 0, 0);
  }
  return s;
}

// Output word m of a cell: a byte permute of the two span words (word(i):
// the span's bytes 4i .. 4i + 3) that hold its samples.
template <typename T, bool kUV, int kStep, typename Word>
__device__ __forceinline__ uint32_t pick_word(int m, const Word& word) {
  constexpr int kSize = static_cast<int>(sizeof(T)), kPer = 4 / kSize;
  const int first = span_sample<kUV, kStep>(m * kPer) * kSize / 4;
  uint32_t sel = 0;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int byte = span_sample<kUV, kStep>(m * kPer + s) * kSize - 4 * first;
#pragma unroll
    for (int b = 0; b < kSize; ++b) {
      sel |= static_cast<uint32_t>(byte + b) << (4 * (s * kSize + b));
    }
  }
  return sel == 0x3210u ? word(first) : __byte_perm(word(first), word(first + 1), sel);
}

// Mode 6's left half, a whole run of 16 bytes from the 32 at p (aligned to
// 16): output k shows sample 2k (Y) or 2k + (k & 1) (UV, the run's first
// column even: U from even source pairs, V from odd ones), one byte permute
// an output word.
template <typename T, bool kUV>
__device__ __forceinline__ Words halve16(const T* p) {
  const Words a = load16(p), b = load16(p + 16 / static_cast<int>(sizeof(T)));
  const auto word = [&](int i) { return i < 4 ? a.w[i] : b.w[i - 4]; };
  Words v;
#pragma unroll
  for (int m = 0; m < 4; ++m) v.w[m] = pick_word<T, kUV, 2>(m, word);
  return v;
}

// The cell's kSub samples, packed as pack does: the span's words are the
// chunks' words from word off / 4 on, by selects (a dynamic index would put
// the chunks in local memory), shifted right by the byte remainder.
template <typename T, bool kUV, int kStep, int kSub>
__device__ __forceinline__ Words pick_cell(const CellSpan<T, kUV, kStep, kSub>& s, int dx) {
  using S = CellSpan<T, kUV, kStep, kSub>;
  constexpr int kN = 4 * S::kChunks;
  constexpr int kWords = kSub * static_cast<int>(sizeof(T)) / 4;
  uint32_t c[kN + 4];
#pragma unroll
  for (int i = 0; i < S::kChunks; ++i) {
    c[4 * i] = s.c[i].x;
    c[4 * i + 1] = s.c[i].y;
    c[4 * i + 2] = s.c[i].z;
    c[4 * i + 3] = s.c[i].w;
  }
#pragma unroll
  for (int i = kN; i < kN + 4; ++i) c[i] = 0;
  const int ws = s.off >> 2, bits = (s.off & 3) * 8;
  const auto word = [&](int i) {
    const uint32_t lo = ws == 0 ? c[i] : ws == 1 ? c[i + 1] : ws == 2 ? c[i + 2] : c[i + 3];
    if (S::kAlign % 4 == 0) return lo;   // the span starts on a word
    const uint32_t hi = ws == 0 ? c[i + 1] : ws == 1 ? c[i + 2] : ws == 2 ? c[i + 3] : c[i + 4];
    return __funnelshift_r(lo, hi, bits);
  };
  Words v{{0, 0, 0, 0}};
  if (kUV && kStep == 1) {   // V from the next pair under an odd dx: its selector at run time
    constexpr uint32_t kOddSel = sizeof(T) == 2 ? 0x7610u : 0x5230u;
    const uint32_t sel = (dx & 1) ? kOddSel : 0x3210u;
#pragma unroll
    for (int m = 0; m < kWords; ++m) v.w[m] = __byte_perm(word(m), word(m + 1), sel);
  } else {
#pragma unroll
    for (int m = 0; m < kWords; ++m) v.w[m] = pick_word<T, kUV, kStep>(m, word);
  }
  return v;
}

// The same samples one by one, through the mirror (a cell whose span crosses
// a mirror edge), four at a time: for a cell of eight a loop not unrolled, so
// that only four gathers are live at once (all eight, and the 4K HDR instance
// of mode 5 spills).
template <typename T, bool kUV, int kStep, int kSub>
__device__ __forceinline__ Words gather_cell(const T* row, int ax, int dx, int dim_x) {
  if constexpr (kSub <= 4) {
    uint32_t r[kSub];
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const int x = mirror_warp(ax + kStep * k + dx, dim_x);
      r[k] = row[kUV ? (x & ~1) + (k & 1) : x];
    }
    return pack<T, kSub>(r);
  }
  constexpr int kQuadWords = sizeof(T) == 2 ? 2 : 1;
  constexpr int kWords = kSub / 4 * kQuadWords;
  Words v{{0, 0, 0, 0}};
#pragma unroll 1
  for (int q = 0; q < kSub / 4; ++q) {
    uint32_t r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = mirror_warp(ax + kStep * (4 * q + k) + dx, dim_x);
      r[k] = row[kUV ? (x & ~1) + (k & 1) : x];
    }
    const Words w = pack<T, 4>(r);
#pragma unroll
    for (int m = 0; m < 4 - kQuadWords; ++m) v.w[m] = v.w[m + kQuadWords];
#pragma unroll
    for (int m = 0; m < kQuadWords; ++m) v.w[4 - kQuadWords + m] = w.w[m];
  }
#pragma unroll
  for (int m = 0; m < kWords; ++m) v.w[m] = v.w[4 - kWords + m];
  return v;
}

// One t of one flow cell of a whole warp run: kSub outputs, output k at
// adjusted column ax + kStep k of adjusted row ay, mode 2 there with its
// levels (finish_run): the column shifts and mirrored rows, both sources'
// chunks requested, then taken apart.
template <typename T, bool kUV, int kStep, int kSub>
__device__ __forceinline__ Words warp_cell(const T* __restrict__ src12,
                                           const T* __restrict__ src21, float fs12, float fs21,
                                           const CellFlow& f, int ax, int ay, int plane_h,
                                           int dim_x, float black, float white) {
  constexpr int kLast = kStep * (kSub - 1);
  // y offset products in the reference's left-to-right order, as warp_run.
  const int dx12 = round_c(__fmul_rn(f.ox12, fs12));
  const int dx21 = -round_c(__fmul_rn(f.ox21, fs21));
  const float dy12 = __fmul_rn(f.oy12, fs12);
  const float dy21 = __fmul_rn(f.oy21, fs21);
  const T* row12 = src12 + static_cast<size_t>(mirror_warp(
      ay + round_c(kUV ? __fmul_rn(dy12, 0.5f) : dy12), plane_h)) * dim_x;
  const T* row21 = src21 + static_cast<size_t>(mirror_warp(
      ay - round_c(kUV ? __fmul_rn(dy21, 0.5f) : dy21), plane_h)) * dim_x;
  const bool fast12 = ax + dx12 >= 1 && ax + kLast + dx12 <= dim_x - 2;
  const bool fast21 = ax + dx21 >= 1 && ax + kLast + dx21 <= dim_x - 2;
  CellSpan<T, kUV, kStep, kSub> r12, r21;
  if (fast12) r12 = issue_cell<T, kUV, kStep, kSub>(row12, ax, dx12);
  if (fast21) r21 = issue_cell<T, kUV, kStep, kSub>(row21, ax, dx21);
  const Words g12 = fast12 ? pick_cell(r12, dx12)
                           : gather_cell<T, kUV, kStep, kSub>(row12, ax, dx12, dim_x);
  const Words g21 = fast21 ? pick_cell(r21, dx21)
                           : gather_cell<T, kUV, kStep, kSub>(row21, ax, dx21, dim_x);
  // Blended and levelled four samples at a time (finish_run), so that only
  // four samples' arithmetic is live at once.
  constexpr float kPeak = sizeof(T) == 2 ? 65535.0f : 255.0f;
  constexpr float kMid = sizeof(T) == 2 ? 32768.0f : 128.0f;
  constexpr int kQuadWords = sizeof(T) == 2 ? 2 : 1;
  const bool unit = fs12 >= 0.0f && fs12 <= 1.0f;
  Words out{{0, 0, 0, 0}};
#pragma unroll
  for (int q = 0; q < kSub / 4; ++q) {
    Words a{{0, 0, 0, 0}}, b{{0, 0, 0, 0}};
#pragma unroll
    for (int m = 0; m < kQuadWords; ++m) {
      a.w[m] = g12.w[q * kQuadWords + m];
      b.w[m] = g21.w[q * kQuadWords + m];
    }
    const Words r = unit ? finish_run<T, 2, kUV, false, true, 4>(a, b, 4, fs12, fs21, black,
                                                                 white, kPeak, kMid, 0)
                         : finish_run<T, 2, kUV, false, false, 4>(a, b, 4, fs12, fs21, black,
                                                                  white, kPeak, kMid, 0);
#pragma unroll
    for (int m = 0; m < kQuadWords; ++m) out.w[q * kQuadWords + m] = r.w[m];
  }
  return out;
}

// A whole warp run of modes 5 and 6, every t, each t stored with one store of
// its width: kCells (mode 5: 1; mode 6: 2 or 4) flow cells of kSub outputs,
// cell c's output k at adjusted column ax0 + kStep (kSub c + k). The cells are
// taken one after the other (a loop not unrolled), so that one cell's state
// is live at a time.
template <typename T, bool kUV, int kStep, int kSub, int kCells>
__device__ __forceinline__ void warp_cells(const T* __restrict__ src12,
                                           const T* __restrict__ src21,
                                           const float* __restrict__ ts, int n_t, T* dst,
                                           int t_stride, int ax0, int ay, int plane_h,
                                           int dim_x, const CellFlow (&f)[kCells], float black,
                                           float white) {
  static_assert(kCells == 1 || kCells == 2 || kCells == 4, "a run is 1, 2 or 4 flow cells");
  constexpr int kRun = kSub * kCells;
  constexpr int kWordsACell = kSub * static_cast<int>(sizeof(T)) / 4;
  const auto one_t = [&](int i) {
    const float fs12 = ts[i];
    const float fs21 = __fsub_rn(1.0f, fs12);
    Words out{{0, 0, 0, 0}};
    const auto cell = [&](int c) {
      CellFlow fc = f[0];
#pragma unroll
      for (int k = 1; k < kCells; ++k) {
        if (c == k) fc = f[k];
      }
      const int ax = ax0 + kStep * kSub * c;
      const Words w = warp_cell<T, kUV, kStep, kSub>(src12, src21, fs12, fs21, fc, ax, ay,
                                                     plane_h, dim_x, black, white);
      // the cell's words on top, the earlier cell's below them
#pragma unroll
      for (int m = 0; m < 4 - kWordsACell; ++m) out.w[m] = out.w[m + kWordsACell];
#pragma unroll
      for (int m = 0; m < kWordsACell; ++m) out.w[4 - kWordsACell + m] = w.w[m];
    };
#pragma unroll 1
    for (int c = 0; c < kCells; ++c) cell(c);
    if (kRun * static_cast<int>(sizeof(T)) < 16) {   // the run's words sit on top
#pragma unroll
      for (int m = 0; m < kCells * kWordsACell; ++m) {
        out.w[m] = out.w[4 - kCells * kWordsACell + m];
      }
    }
    store_run<T, kRun>(dst + static_cast<size_t>(i) * t_stride, out, kRun, kRun);
  };
#pragma unroll 1
  for (int i = 0; i < n_t; ++i) one_t(i);
}

// The warp runs that take no fast path, element by element, every t: output k
// at column x0 + k, adjusted column ax0 + step k of adjusted row ay, its own
// flow lookup; columns below copy_end (mode 5's run across an odd half) copy
// source 1's row ay. Ragged tails, that run, mode 6's UV at an odd half, and
// every run of an instance without a width compiled (small res_scalar). Not
// inlined: its registers stay out of the fast runs' budget.
template <typename T, bool kUV>
__device__ __noinline__ void warp_elements(const T* __restrict__ src12,
                                           const T* __restrict__ src21,
                                           const int16_t* __restrict__ flow,
                                           const float* __restrict__ ts, int n_t, T* dst,
                                           int t_stride, int x0, int n, int copy_end, int ax0,
                                           int step, int ay, int plane_h, int dim_x, int low_h,
                                           int low_w, int rs, float black, float white) {
  constexpr int kOne = 4 / static_cast<int>(sizeof(T));   // finish_run's packing: a word
  for (int k = 0; k < n; ++k) {
    const int c = x0 + k;
    if (c < copy_end) {
      const T v = src12[static_cast<size_t>(ay) * dim_x + c];
      for (int i = 0; i < n_t; ++i) dst[static_cast<size_t>(i) * t_stride + k] = v;
      continue;
    }
    const int ax = ax0 + step * k;
    const CellFlow f = cell_flow<kUV>(flow, ax, ay, low_h, low_w, rs);
    for (int i = 0; i < n_t; ++i) {
      const float fs12 = ts[i];
      const float fs21 = __fsub_rn(1.0f, fs12);
      const float dy12 = __fmul_rn(f.oy12, fs12);
      const float dy21 = __fmul_rn(f.oy21, fs21);
      const int y12 = mirror_warp(ay + round_c(kUV ? __fmul_rn(dy12, 0.5f) : dy12), plane_h);
      const int y21 = mirror_warp(ay - round_c(kUV ? __fmul_rn(dy21, 0.5f) : dy21), plane_h);
      int x12 = mirror_warp(ax + round_c(__fmul_rn(f.ox12, fs12)), dim_x);
      int x21 = mirror_warp(ax - round_c(__fmul_rn(f.ox21, fs21)), dim_x);
      if (kUV) {   // the output column's chroma parity
        x12 = (x12 & ~1) + (c & 1);
        x21 = (x21 & ~1) + (c & 1);
      }
      const Words g12{{src12[static_cast<size_t>(y12) * dim_x + x12], 0, 0, 0}};
      const Words g21{{src21[static_cast<size_t>(y21) * dim_x + x21], 0, 0, 0}};
      dst[static_cast<size_t>(i) * t_stride + k] = static_cast<T>(sample<T>(
          finish_run<T, 2, kUV, false, false, kOne>(g12, g21, 1, fs12, fs21, black, white,
                                                    sizeof(T) == 2 ? 65535.0f : 255.0f,
                                                    sizeof(T) == 2 ? 32768.0f : 128.0f, 0), 0));
    }
  }
}

// What the threads of a tile do in modes 5 and 6; every tile of a block is of
// one kind. The stream kinds (fill, copy, halve) only move bytes; the warp
// kinds (warp, side) look flow up first.
enum VizKind : int {
  kVizFill,    // one value: mode 6 outside its band (0 on Y, mid on UV)
  kVizCopy,    // mode 5's left half: source 1
  kVizHalve,   // mode 6's left half: source 1, 2x down
  kVizWarp,    // mode 5's right half: mode 2 at the output's own position
  kVizSide,    // mode 6's right half: mode 2 at the adjusted position
};

// One kind of tile over columns [x_begin, x_end) and plane rows [row_begin,
// row_end) of one plane, in runs of 1 << shift samples: a tile is kBlockY rows
// of kBlockX threads, a thread of a stream kind takes kVizStreamRuns runs
// kBlockX apart, of a warp kind one. Its blocks are [first, first +
// tiles_x * tile rows) in the grid's order (VizGrid).
struct VizSeg {
  int first, kind, uv, shift, tiles_x, x_begin, x_end, row_begin, row_end;
};

// A call's tiles in mode 5 or 6: its segments in the grid's order, the
// warp kinds first (Y, then UV), then the stream kinds; n_blocks in all,
// n_stream of them stream blocks (see warp_viz_kernel).
constexpr int kVizSegs = 8;
struct VizGrid {
  VizSeg seg[kVizSegs];
  int n_blocks, n_stream;
};

// Runs a thread of a stream tile takes, and the segments a mode has (5: warp
// and copy a plane; 6: side, halve and two fills a plane).
constexpr int kVizStreamRuns = 4;
__host__ __device__ constexpr int viz_segs(int mode) { return mode == 5 ? 4 : kVizSegs; }

// A stream tile's runs of kMax samples, kR a thread kBlockX runs apart (a
// warp stores 32 neighbouring runs at once), each stored for every t: fill
// (kStep 0), source row `row` (kStep 1) or 2x down (kStep 2), as
// stream_elements. A whole run whose source and outputs are aligned to 16
// bytes is one 16-byte load (two for kStep 2) and a 16-byte store a t, all
// loads issued before any store; the others go element by element.
template <typename T, bool kUV, int kStep, int kR>
__device__ __forceinline__ void stream_runs(T* row_out, int t_stride, int n_t, int j,
                                            int x_begin, int x_end, const T* row, uint32_t fill,
                                            int dim_x) {
  constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  const bool t_aligned = ((t_stride * sizeof(T)) & 15) == 0;
  Words v[kR];
  bool whole[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int x0 = x_begin + (j + r * kBlockX) * kMax;
    const int n = min(kMax, x_end - x0);
    const T* p = row + kStep * x0;
    whole[r] = n == kMax && t_aligned && (reinterpret_cast<uintptr_t>(row_out + x0) & 15) == 0
               && (kStep == 0 || (reinterpret_cast<uintptr_t>(p) & 15) == 0);
    v[r] = Words{{0, 0, 0, 0}};
    if (whole[r]) {
      v[r] = kStep == 0 ? splat<T>(fill) : kStep == 1 ? load16(p) : halve16<T, kUV>(p);
    } else if (n > 0) {
      stream_elements<T, kUV, kStep>(row, fill, x0, n, dim_x, row_out + x0, t_stride, n_t);
    }
  }
  for (int i = 0; i < n_t; ++i) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (whole[r]) {
        T* dst = row_out + static_cast<size_t>(i) * t_stride + x_begin + (j + r * kBlockX) * kMax;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[r].w[0], v[r].w[1], v[r].w[2], v[r].w[3]);
      }
    }
  }
}

// A stream tile's runs (fill, copy, halve; see stream_runs) of plane row cy.
template <typename T, int kMode, bool kUV>
__device__ __forceinline__ void stream_tile(const VizSeg& s, const T* __restrict__ src12, int n_t,
                                            T* row_out, int t_stride, int cy, int j,
                                            int dim_y, int dim_x) {
  constexpr int kR = kVizStreamRuns;
  if (kMode == 6 && s.kind == kVizFill) {   // 0 on Y, mid on UV
    stream_runs<T, kUV, 0, kR>(row_out, t_stride, n_t, j, s.x_begin, s.x_end, src12,
                               kUV ? (sizeof(T) == 2 ? 32768u : 128u) : 0u, dim_x);
  } else if (kMode == 5) {   // source 1 left of the half
    stream_runs<T, kUV, 1, kR>(row_out, t_stride, n_t, j, s.x_begin, s.x_end,
                               src12 + static_cast<size_t>(cy) * dim_x, 0, dim_x);
  } else if (kMode == 6) {   // source 1, 2x down, left of the half in mode 6's band
    const int plane_h = kUV ? dim_y / 2 : dim_y;
    const int ay = (cy - ((dim_y >> 2) >> (kUV ? 1 : 0))) << 1;
    stream_runs<T, kUV, 2, kR>(row_out, t_stride, n_t, j, s.x_begin, s.x_end,
                               src12 + static_cast<size_t>(min(ay, plane_h - 1)) * dim_x, 0,
                               dim_x);
  }
}

// A warp tile's run j of plane row cy (warp, side). kFast > 0: the
// plane's whole warp runs are compiled for that width (mode 5: kFast samples,
// one flow cell; mode 6: 16 bytes of kFast-output cells); the others go
// element by element (warp_elements).
template <typename T, int kMode, bool kUV, int kFast>
__device__ __forceinline__ void warp_tile(const VizSeg& s, const T* __restrict__ src12,
                                          const T* __restrict__ src21,
                                          const int16_t* __restrict__ flow,
                                          const float* __restrict__ ts, int n_t, T* row_out,
                                          int t_stride, int cy, int j, int dim_y, int dim_x,
                                          int low_h, int low_w, int rs, float black,
                                          float white) {
  constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  const int plane_h = kUV ? dim_y / 2 : dim_y;
  const int half = dim_x >> 1;
  if constexpr (kMode == 5) {   // mode 2 from the half on
    const int run = kFast > 0 ? kFast : 1 << s.shift;
    const int x0 = s.x_begin + j * run;
    if (x0 >= s.x_end) return;
    const int n = min(run, dim_x - x0);
    if constexpr (kFast > 0) {
      if (n == kFast && x0 >= half) {
        const CellFlow f[1] = {cell_flow<kUV>(flow, x0, cy, low_h, low_w, rs)};
        warp_cells<T, kUV, 1, kFast, 1>(src12, src21, ts, n_t, row_out + x0, t_stride, x0, cy,
                                        plane_h, dim_x, f, black, white);
        return;
      }
    }
    warp_elements<T, kUV>(src12, src21, flow, ts, n_t, row_out + x0, t_stride, x0, n, half, x0,
                          1, cy, plane_h, dim_x, low_h, low_w, rs, black, white);
  } else {   // mode 6's right half: output x at adjusted (2 (x - half), 2 (cy - vo))
    const int ay = (cy - ((dim_y >> 2) >> (kUV ? 1 : 0))) << 1;
    const int x0 = half + j * kMax;
    if (x0 >= dim_x) return;
    const int n = min(kMax, dim_x - x0);
    const int ax0 = (x0 - half) << 1;
    if constexpr (kFast > 0) {
      if (n == kMax && (!kUV || (x0 & 1) == 0)) {
        constexpr int kCells = kMax / kFast;
        CellFlow f[kCells];
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          f[c] = cell_flow<kUV>(flow, ax0 + 2 * kFast * c, ay, low_h, low_w, rs);
        }
        warp_cells<T, kUV, 2, kFast, kCells>(src12, src21, ts, n_t, row_out + x0, t_stride, ax0,
                                             ay, plane_h, dim_x, f, black, white);
        return;
      }
    }
    warp_elements<T, kUV>(src12, src21, flow, ts, n_t, row_out + x0, t_stride, x0, n, 0, ax0, 2,
                          ay, plane_h, dim_x, low_h, low_w, rs, black, white);
  }
}

// Modes 5 and 6 in one grid of tiles of kBlockX x kBlockY threads, each
// block's tiles of one kind (VizGrid). The stream tiles are spread evenly
// through the grid: block b is stream block floor(b * n_stream / n_blocks)
// where that count steps at b, else a warp block, so that their bytes move
// while warp tiles wait on their gathers. kY, kUV: the planes' compiled warp
// widths (warp_tile's kFast). kMinBlocks: blocks an SM that
// __launch_bounds__ asks for, which caps the registers (4: 64 a thread, 1:
// none).
template <typename T, int kMode, int kY, int kUV, int kMinBlocks>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocks) warp_viz_kernel(
    const T* __restrict__ s12y, const T* __restrict__ s12uv, const T* __restrict__ s21y,
    const T* __restrict__ s21uv, const int16_t* __restrict__ flow, const float* __restrict__ ts,
    int n_t, T* __restrict__ out_y, T* __restrict__ out_uv, int dim_y, int dim_x, Band band,
    int low_h, int low_w, int rs, VizGrid grid, float black, float white) {
  const long long k = blockIdx.x;
  const int before = static_cast<int>(k * grid.n_stream / grid.n_blocks);
  const int after = static_cast<int>((k + 1) * grid.n_stream / grid.n_blocks);
  // the block's place in the grid's order
  const int v = after > before ? grid.n_blocks - grid.n_stream + before
                               : static_cast<int>(k) - before;
  VizSeg s = grid.seg[0];
#pragma unroll
  for (int i = 1; i < viz_segs(kMode); ++i) {
    if (v >= grid.seg[i].first) s = grid.seg[i];
  }
  const int b = v - s.first;
  const int by = b / s.tiles_x;
  const int cy = s.row_begin + by * kBlockY + threadIdx.y;   // row of the plane
  if (cy >= s.row_end) return;
  const bool stream = s.kind == kVizFill || s.kind == kVizCopy || s.kind == kVizHalve;
  const int j = (b - by * s.tiles_x) * kBlockX * (stream ? kVizStreamRuns : 1)
                + threadIdx.x;
  const int t_stride = (s.uv ? band.rows_uv : band.rows_y) * dim_x;
  T* const row_out = (s.uv ? out_uv : out_y)
                     + static_cast<size_t>(cy - (s.uv ? band.row0_uv : band.row0_y)) * dim_x;
  if (stream) {
    if (s.uv) {
      stream_tile<T, kMode, true>(s, s12uv, n_t, row_out, t_stride, cy, j, dim_y, dim_x);
    } else {
      stream_tile<T, kMode, false>(s, s12y, n_t, row_out, t_stride, cy, j, dim_y, dim_x);
    }
  } else if (s.uv) {
    warp_tile<T, kMode, true, kUV>(s, s12uv, s21uv, flow, ts, n_t, row_out, t_stride, cy, j,
                                   dim_y, dim_x, low_h, low_w, rs, black, white);
  } else {
    warp_tile<T, kMode, false, kY>(s, s12y, s21y, flow, ts, n_t, row_out, t_stride, cy, j, dim_y,
                                   dim_x, low_h, low_w, rs, black, white);
  }
}

// Mode 4, the grey flow (see "Modes 4, 5 and 6" above): blocks [0,
// n_y_blocks) take the Y plane's tiles of kBlockX
// runs of 1 << shift_y samples (one flow cell, at most 16 bytes) x kBlockY
// rows, tiles_y a row of tiles; the rest the UV plane's, of 16-byte runs.
// Y is min((|ox12| + |oy12|) << (10 HDR, 2 SDR), peak) of the run's flow
// cell, UV mid, for every t.
template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY, 4) grey_flow_kernel(
    const int16_t* __restrict__ flow, int n_t, T* __restrict__ out_y, T* __restrict__ out_uv,
    int dim_y, int dim_x, Band band, int low_h, int low_w, int rs, int shift_y, int tiles_y,
    int tiles_uv, int n_y_blocks) {
  constexpr bool kHdr = sizeof(T) == 2;
  constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  constexpr int kMaxShift = kHdr ? 3 : 4;
  const bool uv = blockIdx.x >= static_cast<unsigned>(n_y_blocks);   // uniform in a block
  const int b = uv ? blockIdx.x - n_y_blocks : blockIdx.x;
  const int tiles_x = uv ? tiles_uv : tiles_y;
  const int shift = uv ? kMaxShift : shift_y;
  const int x0 = ((b % tiles_x) * kBlockX + threadIdx.x) << shift;
  const int band_y = (b / tiles_x) * kBlockY + threadIdx.y;   // row within the band
  const int rows = uv ? band.rows_uv : band.rows_y;
  const int cy = (uv ? band.row0_uv : band.row0_y) + band_y;  // row of the plane
  if (band_y >= rows || cy >= (uv ? dim_y / 2 : dim_y) || x0 >= dim_x) return;
  uint32_t v = kHdr ? 32768u : 128u;
  if (!uv) {
    const int16_t* flow_y = flow + static_cast<size_t>(low_h) * low_w;
    const int at = clamp_hi(cy >> rs, 0, low_h - 1) * low_w + clamp_hi(x0 >> rs, 0, low_w - 1);
    const int mag = abs(static_cast<int>(flow[at])) + abs(static_cast<int>(flow_y[at]));
    v = static_cast<uint32_t>(min(mag << (kHdr ? 10 : 2), kHdr ? 65535 : 255));
  }
  const int run = 1 << shift;
  store_every_t<T, kMax>((uv ? out_uv : out_y) + static_cast<size_t>(band_y) * dim_x + x0,
                         rows * dim_x, n_t, splat<T>(v), min(run, dim_x - x0), run);
}

template <typename T>
cudaError_t launch_grey(const int16_t* flow, int n_t, void* out_y, void* out_uv, int dim_y,
                        int dim_x, const Band& band, int low_h, int low_w, int rs,
                        cudaStream_t stream) {
  constexpr int kMaxShift = sizeof(T) == 2 ? 3 : 4;
  const int shift_y = rs < kMaxShift ? rs : kMaxShift;
  const auto tiles = [&](int shift) {
    return (((dim_x + (1 << shift) - 1) >> shift) + kBlockX - 1) / kBlockX;
  };
  const int tiles_y = tiles(shift_y), tiles_uv = tiles(kMaxShift);
  const int n_y_blocks = tiles_y * ((band.rows_y + kBlockY - 1) / kBlockY);
  const int n_blocks = n_y_blocks + tiles_uv * ((band.rows_uv + kBlockY - 1) / kBlockY);
  grey_flow_kernel<T><<<n_blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
      flow, n_t, static_cast<T*>(out_y), static_cast<T*>(out_uv), dim_y, dim_x, band, low_h,
      low_w, rs, shift_y, tiles_y, tiles_uv, n_y_blocks);
  return cudaGetLastError();
}

// The register budget of the 4K HDR path's instances of modes 5 and 6
// (warp_viz_kernel's kMinBlocks: 64 registers a thread); chosen by
// graph-timed turns against 80 registers and no cap (PERF.md).
constexpr int kVizMinBlocks = 4;

// The tiles of one call in mode 5 or 6 (see warp_viz_kernel): per plane,
// rows [row0, row0 + rows) clipped to the plane,
//   * mode 5: copy columns [0, cb), warp from cb, cb the half rounded down to
//     the warp runs' width (one flow cell, at most 16 bytes), so that a run
//     across an odd half is a warp run;
//   * mode 6: fill outside the band, halve its left half, side its right
//     half in runs of 16 bytes.
// Stream runs are 16 bytes.
template <typename T>
VizGrid viz_grid(int mode, int dim_y, int dim_x, const Band& band, int rs) {
  constexpr int kMaxShift = sizeof(T) == 2 ? 3 : 4;
  VizSeg warp[2], stream[6];
  int n_warp = 0, n_stream = 0;
  const auto add = [&](bool is_warp, int kind, int uv, int shift, int x_begin, int x_end,
                       int row_begin, int row_end) {
    if (x_end <= x_begin || row_end <= row_begin) return;
    const int a_thread = is_warp ? 1 : kVizStreamRuns;
    const int runs = (x_end - x_begin + (1 << shift) - 1) >> shift;
    const VizSeg s{0, kind, uv, shift, (runs + kBlockX * a_thread - 1) / (kBlockX * a_thread),
                   x_begin, x_end, row_begin, row_end};
    if (is_warp) {
      warp[n_warp++] = s;
    } else {
      stream[n_stream++] = s;
    }
  };
  const int half = dim_x >> 1;
  for (int uv = 0; uv < 2; ++uv) {
    const int plane_h = uv ? dim_y / 2 : dim_y;
    const int r0 = uv ? band.row0_uv : band.row0_y;
    const int r1 = std::min(r0 + (uv ? band.rows_uv : band.rows_y), plane_h);
    if (mode == 5) {
      const int shift = std::min(rs + uv, 3);
      const int cb = (half >> shift) << shift;
      add(false, kVizCopy, uv, kMaxShift, 0, cb, r0, r1);
      add(true, kVizWarp, uv, shift, cb, dim_x, r0, r1);
    } else {
      const int vb = (dim_y >> 2) >> uv, ve = vb + (dim_y >> (1 + uv));
      const int b0 = std::max(r0, vb), b1 = std::min(r1, ve);
      add(false, kVizFill, uv, kMaxShift, 0, dim_x, r0, std::min(r1, vb));
      add(false, kVizFill, uv, kMaxShift, 0, dim_x, std::max(r0, ve), r1);
      add(false, kVizHalve, uv, kMaxShift, 0, half, b0, b1);
      add(true, kVizSide, uv, kMaxShift, half, dim_x, b0, b1);
    }
  }
  VizGrid g;
  int first = 0, i = 0;
  const auto place = [&](VizSeg s) {
    s.first = first;
    first += s.tiles_x * ((s.row_end - s.row_begin + kBlockY - 1) / kBlockY);
    g.seg[i++] = s;
  };
  for (int k = 0; k < n_warp; ++k) place(warp[k]);
  const int warp_blocks = first;
  for (int k = 0; k < n_stream; ++k) place(stream[k]);
  for (; i < kVizSegs; ++i) g.seg[i] = VizSeg{INT_MAX, kVizFill, 0, 0, 1, 0, 0, 0, 0};
  g.n_blocks = first;
  g.n_stream = first - warp_blocks;
  return g;
}

// One launch of warp_viz_kernel over grid g (none where the band lies past
// both planes: there is nothing to write).
template <typename T, int kMode, int kY, int kUV, int kMinBlocks>
cudaError_t go_viz(const VizGrid& g, const void* s12y, const void* s12uv, const void* s21y,
                   const void* s21uv, const int16_t* flow, const float* ts, int n_t, void* out_y,
                   void* out_uv, int dim_y, int dim_x, const Band& band, int low_h, int low_w,
                   int rs, float black, float white, cudaStream_t stream) {
  if (g.n_blocks == 0) return cudaSuccess;
  warp_viz_kernel<T, kMode, kY, kUV, kMinBlocks><<<g.n_blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
      static_cast<const T*>(s12y), static_cast<const T*>(s12uv), static_cast<const T*>(s21y),
      static_cast<const T*>(s21uv), flow, ts, n_t, static_cast<T*>(out_y),
      static_cast<T*>(out_uv), dim_y, dim_x, band, low_h, low_w, rs, g, black, white);
  return cudaGetLastError();
}

// Modes 5 and 6's instance for (kY, kUV), the planes' compiled warp widths
// (0: none, every run element by element): the pairs launch_viz makes. The
// 4K HDR path's (rs >= 3: (8, 8) in mode 5, (4, 4) in mode 6) is held to
// kVizMinBlocks; the others, off that path, take no cap, so that none spills.
template <typename T, int kMode, typename... Args>
cudaError_t go_viz_fast(int fy, int fuv, Args... args) {
  constexpr int kHdrPath = sizeof(T) == 2 ? kVizMinBlocks : 1;
  if (fy == 0 && fuv == 0) return go_viz<T, kMode, 0, 0, 1>(args...);
  if (fy == 0 && fuv == 4) return go_viz<T, kMode, 0, 4, 1>(args...);
  if constexpr (kMode == 5) {
    if (fy == 4 && fuv == 8) return go_viz<T, kMode, 4, 8, 1>(args...);
    if (fy == 8 && fuv == 8) return go_viz<T, kMode, 8, 8, kHdrPath>(args...);
  } else {
    if (fy == 4 && fuv == 4) return go_viz<T, kMode, 4, 4, kHdrPath>(args...);
  }
  return cudaErrorInvalidValue;
}

// Modes 5 and 6's one launch. The planes' compiled warp widths: mode 5's
// runs are one flow cell of at most 16 bytes (1 << rs columns on Y, 2 << rs
// on UV); mode 6's right half has 1 << (rs - 1) outputs a Y flow cell and
// 1 << rs a UV one (adjacent outputs two adjusted columns apart), read at
// most 8 bytes of outputs at a time (a span of at most two chunks), two or
// four to a run of 16 bytes. Widths under 4 are not compiled.
template <typename T, int kMode>
cudaError_t launch_viz(const void* s12y, const void* s12uv, const void* s21y, const void* s21uv,
                       const int16_t* flow, const float* ts, int n_t, void* out_y, void* out_uv,
                       int dim_y, int dim_x, const Band& band, int low_h, int low_w, int rs,
                       float black, float white, cudaStream_t stream) {
  const VizGrid g = viz_grid<T>(kMode, dim_y, dim_x, band, rs);
  constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  const auto fast = [&](int shift) {
    const int w = 1 << std::min(shift, 3);
    return w < 4 ? 0 : kMode == 5 ? std::min(w, kMax) : 4;
  };
  const int fy = fast(kMode == 5 ? rs : std::max(rs - 1, 0));
  const int fuv = fast(kMode == 5 ? rs + 1 : rs);
  return go_viz_fast<T, kMode>(fy, fuv, g, s12y, s12uv, s21y, s21uv, flow, ts, n_t, out_y, out_uv,
                               dim_y, dim_x, band, low_h, low_w, rs, black, white, stream);
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
      return launch_grey<T>(flow, n_t, out_y, out_uv, dim_y, dim_x, band, low_h, low_w, rs,
                            stream);
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
