// What the probe kernels share: the window rule of the TPU kernels' dynamic
// slices, and P1/P2's table, band, loads and iteration groups, whose loads
// issue_group issues the same way for both.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace hrt_probe {

// pl.ds(start, size) over a dimension of `dim`, as the JAX kernels resolve it
// in interpret mode: a negative start counts from the end once (start + dim),
// then the start is clamped to [0, dim - size] so that the window fits. On the
// TPU a window past the array is undefined; the port follows interpret mode.
__device__ __forceinline__ int window_start(int start, int dim, int size) {
  if (start < 0) start += dim;
  return min(max(start, 0), dim - size);
}

constexpr int kT = 512;                   // P1/P2: table entries
constexpr int kRows = 512, kW32 = 1024;   // P1/P2: the band, 2 MB of uint32
constexpr int kTile = 8 * 128;            // one (8, 128) tile
// P1/P2: iterations whose loads are issued before any is folded in. A
// divisor of kT, so that a group starting at a multiple of kU never wraps
// the table; and a multiple of 4, so that its entries load as 16-byte vectors.
constexpr int kU = 8;

// One band word. `asm volatile` keeps nvcc from dropping or reordering the
// loads of a group: they are issued, in order, before the group is folded in.
// ptxas sees a plain load, though, and drops one whose value is dead (a
// replaced accumulator's): keep_alive keeps those.
__device__ __forceinline__ uint32_t load_band(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// One band word where `pred` holds (a predicated load, no branch), else 0.
__device__ __forceinline__ uint32_t load_band_if(bool pred, const uint32_t* p) {
  uint32_t v = 0;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %2, 0;\n\t@q ld.global.nc.u32 %0, [%1];\n\t}"
      : "+r"(v)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// Four consecutive band words: one 16-byte load where p is 16-byte aligned
// (kAligned), else four word loads; only where `pred` holds, else zeros.
template <bool kAligned>
__device__ __forceinline__ uint4 load_band4_if(bool pred, const uint32_t* p) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if constexpr (kAligned) {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %5, 0;\n\t"
        "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
        : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
        : "l"(p), "r"(static_cast<int>(pred)));
  } else {
    v.x = load_band_if(pred, p);
    v.y = load_band_if(pred, p + 1);
    v.z = load_band_if(pred, p + 2);
    v.w = load_band_if(pred, p + 3);
  }
  return v;
}

// Stores `sink`, the XOR of loaded words whose values a variant drops, under
// a condition no launch meets (the entry points refuse n < 0): neither nvcc
// nor ptxas can prove those loads dead, so every iteration's loads are issued.
__device__ __forceinline__ void keep_alive(uint32_t sink, int n, uint32_t* out) {
  if (n < 0) *out = sink;
}

// Entries j0 .. j0 + U - 1 of a shared-memory array (16-byte aligned), as
// 16-byte vectors where U is a multiple of 4 (j0 then is too).
template <int U>
__device__ __forceinline__ void read_entries(const int32_t* a, int j0, int (&v)[U]) {
  if constexpr (U % 4 == 0) {
#pragma unroll
    for (int q = 0; q < U; q += 4) {
      const int4 e = *reinterpret_cast<const int4*>(a + j0 + q);
      v[q] = e.x, v[q + 1] = e.y, v[q + 2] = e.z, v[q + 3] = e.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = a[j0 + u];
  }
}

// As read_entries, with `asm volatile` loads: for the probes whose work is
// the table read itself. The "memory" clobber keeps them after the block's
// barrier that follows the table's staging.
template <int U>
__device__ __forceinline__ void read_entries_volatile(const int32_t* a, int j0, int (&v)[U]) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(a + j0));
  if constexpr (U % 4 == 0) {
#pragma unroll
    for (int q = 0; q < U; q += 4) {
      asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v[q]), "=r"(v[q + 1]), "=r"(v[q + 2]), "=r"(v[q + 3])
                   : "r"(addr + 4 * q)
                   : "memory");
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v[u]) : "r"(addr + 4 * u) : "memory");
    }
  }
}

// The loaded words of U iterations, and their `aux` descriptors.
template <int U>
struct Group {
  uint32_t w[U];
  int aux[U];
};

// Issues the loads of U iterations, from table entry j0 on: each reads its
// descriptor from sbase (and, where kAux, from saux; else aux is 0), then the
// band word at word(base, aux), the flat index the thread's element reads.
template <bool kAux, int U, class Word>
__device__ __forceinline__ void issue_group(Group<U>& g, int j0, const int32_t* sbase,
                                            const int32_t* saux, const uint32_t* band,
                                            Word word) {
  int base[U];
  read_entries<U>(sbase, j0, base);
  if constexpr (kAux) {
    read_entries<U>(saux, j0, g.aux);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) g.aux[u] = 0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) g.w[u] = load_band(band + word(base[u], g.aux[u]));
}

}  // namespace hrt_probe
