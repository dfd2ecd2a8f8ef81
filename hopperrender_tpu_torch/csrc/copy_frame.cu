// K6 — the levelled passthrough (copyFrameKernel): both planes of one frame
// through the black/white levels, in one launch of one grid.
//
// Replaces no pallas_call: the JAX package computes the copy as one jitted
// XLA program (hopperrender_tpu/ops/warp.py::copy_frame, its levels
// _apply_levels_y and _apply_levels_uv), which XLA fuses into one pass. The
// plain version is ops/warp.py::copy_frame. Per sample v of dtype T (uint8
// SDR, uint16 HDR), in float32:
//   * Y:  (v - black) / (white - black) * peak;
//   * UV: fma((v - mid) / white, peak, mid), the one FMA that XLA makes of
//     (v - mid) / white * peak + mid, whose rounding the golden fixtures
//     carry;
//   * both planes: clipped into [0, peak] with NaN to 0, then truncated.
// peak is 255 or 65535 and mid 128 or 32768; black and white are in sample
// units (HDR pre-scaled x256). These are K2's levels (finish_run in
// warp_frame.cu), every step pinned with an _rn intrinsic as there: nvcc
// would otherwise contract where it likes.
//
// What bounds it on an H100: device-memory bytes. Each sample is read once
// and written once: 24.9 MB each way at 4K HDR, 0.0149 ms at 3.35 TB/s. The
// arithmetic, an IEEE division a sample (12.4 M a 4K frame), stays under
// that on 132 SMs; a sample goes to float and back through 2^23 + s (two
// full-rate adds, not the quarter-rate conversion unit).
//
// The design. Each plane is one flat contiguous array, and one grid covers
// both: its first blocks take Y, the rest UV. A thread takes kRuns runs of 16
// bytes (8 HDR or 16 SDR samples); in each of the kRuns rounds a block's
// threads take neighbouring runs, and a thread issues all its loads before it
// levels any. An SDR block first levels the 256 sample values of its plane
// into a table in shared memory, one a thread, and then looks its samples up:
// an SDR byte holds twice the samples of an HDR one, and a division a sample
// held 4K SDR at 2.4x its byte bound. A run that is not whole (the plane's
// ragged end, where its length is not a multiple of 16 bytes), and every run
// of a plane whose source or output is not 16-byte aligned, goes element by
// element in a function that is not inlined.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRuns = 4;                              // 16-byte runs a thread
constexpr long long kRunsPerBlock = static_cast<long long>(kThreads) * kRuns;
constexpr float kTwo23 = 8388608.0f;                  // 2^23
constexpr uint32_t kTwo23Bits = 0x4B000000u;          // its bits

struct Levels {
  float black, white, peak, mid;
};

// One plane: n samples from src to out.
struct Plane {
  const void* src;
  void* out;
  long long n;
  bool aligned;   // src and out on 16 bytes: whole runs load and store as int4
};

// A sample (below 2^23) as a float, exactly: the bits of 2^23 + s, less 2^23.
__device__ __forceinline__ float sample_float(uint32_t s) {
  return __fsub_rn(__uint_as_float(kTwo23Bits | s), kTwo23);
}

// The levelled sample in the low bits: ops/warp.py::_apply_levels_y or
// _apply_levels_uv, as finish_run computes them; clipped (NaN to 0) into
// [0, peak], then truncated by an add rounded toward zero (2^23 + trunc(v)).
template <bool kUV>
__device__ __forceinline__ uint32_t level(uint32_t s, const Levels& lv) {
  const float x = sample_float(s);
  float v;
  if (kUV) {  // fma((v - mid) / white, peak, mid)
    v = __fmaf_rn(__fdiv_rn(__fsub_rn(x, lv.mid), lv.white), lv.peak, lv.mid);
  } else {    // (v - black) / (white - black) * peak
    v = __fmul_rn(__fdiv_rn(__fsub_rn(x, lv.black), __fsub_rn(lv.white, lv.black)), lv.peak);
  }
  return __float_as_uint(__fadd_rz(fminf(fmaxf(v, 0.0f), lv.peak), kTwo23));
}

// The 8 HDR samples of one whole run, levelled.
template <bool kUV>
__device__ __forceinline__ uint4 level_run(const uint4& in, const Levels& lv) {
  uint32_t w[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (level<kUV>(w[i] & 0xFFFFu, lv) & 0xFFFFu) | (level<kUV>(w[i] >> 16, lv) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16 SDR samples of one whole run, each looked up in its plane's table.
__device__ __forceinline__ uint4 look_up_run(const uint4& in, const uint8_t* table) {
  uint32_t w[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = table[w[i] & 0xFFu] | table[(w[i] >> 8) & 0xFFu] << 8 |
           table[(w[i] >> 16) & 0xFFu] << 16 | static_cast<uint32_t>(table[w[i] >> 24]) << 24;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// n samples from i0 on, one at a time: a ragged end, or a plane off 16 bytes.
template <typename T, bool kUV>
__device__ __noinline__ void level_elements(const T* src, T* out, long long i0, int n,
                                            Levels lv) {
  for (int k = 0; k < n; ++k) out[i0 + k] = static_cast<T>(level<kUV>(src[i0 + k], lv));
}

template <typename T, bool kUV>
__device__ __forceinline__ void level_block(const Plane& p, long long block, const Levels& lv) {
  constexpr int kRun = 16 / static_cast<int>(sizeof(T));
  const T* src = static_cast<const T*>(p.src);
  T* out = static_cast<T*>(p.out);
  const long long first = block * kRunsPerBlock + threadIdx.x;
  const long long whole = p.aligned ? p.n / kRun : 0;
  uint4 v[kRuns];
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    const long long r = first + j * kThreads;
    if (r < whole) v[j] = __ldg(reinterpret_cast<const uint4*>(src) + r);
  }
  // SDR: the plane's 256 levelled values, one a thread, while the loads fly.
  __shared__ uint8_t table[sizeof(T) == 1 ? 256 : 1];
  if constexpr (sizeof(T) == 1) {
    static_assert(kThreads == 256, "one table entry a thread");
    table[threadIdx.x] = static_cast<uint8_t>(level<kUV>(threadIdx.x, lv));
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    const long long r = first + j * kThreads;
    if (r < whole) {
      if constexpr (sizeof(T) == 1) {
        reinterpret_cast<uint4*>(out)[r] = look_up_run(v[j], table);
      } else {
        reinterpret_cast<uint4*>(out)[r] = level_run<kUV>(v[j], lv);
      }
    } else if (r * kRun < p.n) {
      const long long left = p.n - r * kRun;
      level_elements<T, kUV>(src, out, r * kRun, left < kRun ? static_cast<int>(left) : kRun,
                             lv);
    }
  }
}

// Blocks [0, blocks_y) level Y, the rest UV.
template <typename T>
__global__ void __launch_bounds__(kThreads) copy_frame_kernel(Plane y, Plane uv,
                                                              unsigned blocks_y, Levels lv) {
  if (blockIdx.x < blocks_y) {
    level_block<T, false>(y, blockIdx.x, lv);
  } else {
    level_block<T, true>(uv, blockIdx.x - blocks_y, lv);
  }
}

long long plane_blocks(long long n, int sample_bytes) {
  const long long runs = (n * sample_bytes + 15) / 16;
  return (runs + kRunsPerBlock - 1) / kRunsPerBlock;
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15u) == 0;
}

}  // namespace

// Sources: (dim_y, dim_x) Y and (dim_y/2, dim_x) interleaved UV, uint8 (SDR)
// or uint16 (HDR), contiguous, on the current device; outputs of the same
// shapes and type. black/white are the levels in sample units (HDR pre-scaled
// x256). Grid: plane_blocks(Y) + plane_blocks(UV) blocks of kThreads threads
// (chip_smoke.copy_blocks mirrors it).
extern "C" int hrt_copy_frame(const void* src_y, const void* src_uv, void* out_y,
                              void* out_uv, int dim_y, int dim_x, int is_hdr, float black,
                              float white, void* stream) {
  if (dim_y < 2 || dim_y % 2 || dim_x < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = is_hdr ? 2 : 1;
  const long long n_y = static_cast<long long>(dim_y) * dim_x;
  const Plane y{src_y, out_y, n_y, aligned16(src_y, out_y)};
  const Plane uv{src_uv, out_uv, n_y / 2, aligned16(src_uv, out_uv)};
  const long long blocks_y = plane_blocks(y.n, bytes);
  const long long blocks = blocks_y + plane_blocks(uv.n, bytes);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_hdr) {
    copy_frame_kernel<uint16_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        y, uv, static_cast<unsigned>(blocks_y), Levels{black, white, 65535.0f, 32768.0f});
  } else {
    copy_frame_kernel<uint8_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        y, uv, static_cast<unsigned>(blocks_y), Levels{black, white, 255.0f, 128.0f});
  }
  return static_cast<int>(cudaGetLastError());
}
