// K1 — 8x8 box blur of the two int16 flow planes.
//
// Replaces the TPU kernel hopperrender_tpu/ops/pallas_kernels.py::blur_flow_pallas
// (kernel body _make_blur_kernel). For each cell of (2, low_h, low_w):
//   acc = int32 sum of the 8x8 window [-4, 4) x [-4, 4) around the cell, with
//         borders mirrored symmetrically (numpy "symmetric": pos < 0 -> -pos-1,
//         pos >= dim -> 2*dim-pos-1, repeating with period 2*dim);
//   out = sign(acc) * (|acc| / 64).
// C's `/` truncates toward zero, which is exactly sign(acc) * (|acc| // 64).
//
// What bounds it on an H100: the launch. At 4K and res_scalar 3 the planes
// are 2x270x480 int16, 518 KB in and 518 KB out (0.3 us at 3.35 TB/s), well
// under the time of one launch; at res_scalar 0, 2x2160x3840, 33 MB each way
// (20 us): there the bytes. The first port ran one thread per output with 16 mirror
// computations (each an integer %) and 64 loads, none shared with its
// neighbours. Here one block takes a kTileH x kTileW tile of one plane and:
//   1. mirrors the tile's kTileH + 7 rows and kTileW + 7 columns once each,
//      with the general rule (planes under 8 wide wrap more than once);
//   2. stages the tile and its 7-sample apron in shared memory, one coalesced
//      load per staged sample through those indices, all of a thread's
//      loads in flight together;
//   3. sums 8 columns along each staged row (int32), then 8 rows down each
//      column, as the TPU kernel's separable form did, and writes acc / 64.
// Each output costs 16 adds and no %. Tiles are 16 rows by 32 columns (540
// blocks at 4K and res_scalar 3): 32-row and 8-row tiles took longer on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;          // window [-4, 4), KERNEL_RADIUS of the reference
constexpr int kTaps = 2 * kRadius;
constexpr int kTileW = 32, kTileH = 16;
constexpr int kStageW = kTileW + kTaps - 1, kStageH = kTileH + kTaps - 1;
constexpr int kThreadsX = 32, kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

__device__ __forceinline__ int mirror_symmetric(int pos, int dim) {
  const int period = 2 * dim;
  int m = pos % period;
  if (m < 0) m += period;
  return m < dim ? m : period - 1 - m;
}

__global__ void __launch_bounds__(kThreads) blur_flow_kernel(
    const int16_t* __restrict__ in, int16_t* __restrict__ out, int low_h, int low_w) {
  __shared__ int row_at[kStageH];                // plane row of each staged row
  __shared__ int col_at[kStageW];                // plane column of each staged column
  __shared__ int16_t stage[kStageH][kStageW + 1];
  __shared__ int hsum[kStageH][kTileW];          // 8-column sums of each staged row
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(low_h) * low_w;
  const int16_t* src = in + blockIdx.z * plane;

  if (tid < kStageH) row_at[tid] = mirror_symmetric(y0 + tid - kRadius, low_h);
  if (tid >= 64 && tid < 64 + kStageW) {
    col_at[tid - 64] = mirror_symmetric(x0 + tid - 64 - kRadius, low_w);
  }
  __syncthreads();
  // Unrolled, so that a thread's loads are all in flight before its first
  // store to shared memory.
  constexpr int kStaged = kStageH * kStageW;
  int16_t staged[(kStaged + kThreads - 1) / kThreads];
#pragma unroll
  for (int j = 0; j * kThreads < kStaged; ++j) {
    const int i = tid + j * kThreads;
    if (i < kStaged) {
      const int r = i / kStageW, c = i - r * kStageW;
      staged[j] = src[static_cast<size_t>(row_at[r]) * low_w + col_at[c]];
    }
  }
#pragma unroll
  for (int j = 0; j * kThreads < kStaged; ++j) {
    const int i = tid + j * kThreads;
    if (i < kStaged) {
      const int r = i / kStageW, c = i - r * kStageW;
      stage[r][c] = staged[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < kStageH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i - r * kTileW;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc += stage[r][c + k];
    hsum[r][c] = acc;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= low_w) return;
  int16_t* dst = out + blockIdx.z * plane;
#pragma unroll
  for (int j = 0; j < kTileH / kThreadsY; ++j) {
    const int r = threadIdx.y + j * kThreadsY;
    const int y = y0 + r;
    if (y >= low_h) break;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc += hsum[r + k][threadIdx.x];
    dst[static_cast<size_t>(y) * low_w + x] = static_cast<int16_t>(acc / 64);
  }
}

}  // namespace

// in/out: (2, low_h, low_w) int16, contiguous, on the current device.
extern "C" int hrt_blur_flow(const void* in, void* out, int low_h, int low_w,
                             void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((low_w + kTileW - 1) / kTileW, (low_h + kTileH - 1) / kTileH, 2);
  blur_flow_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), low_h, low_w);
  return static_cast<int>(cudaGetLastError());
}
