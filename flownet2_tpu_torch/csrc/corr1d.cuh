// Shared pieces of the 1-D (stereo) correlation kernels (csrc/correlation1d.cu,
// csrc/correlation1d_bwd.cu): staging a run of one NCHW row into shared
// memory, 4-element vector loads and stores, and the split of a block's
// threads over the staged rows.
#pragma once

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace corr1d {

constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may use

// elements of one 16-byte copy unit: 4 float32, 8 bfloat16
template <typename T>
constexpr int kUnit = 16 / static_cast<int>(sizeof(T));

// 4 neighbouring elements of shared memory as float32: one 16-byte load, or
// one 8-byte load of 4 bfloat16 widened. p is 4-element aligned.
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// 4 neighbouring outputs, one rounding each; p is 4-element aligned
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// 4 outputs at columns x .. x + 3 of a row of width w: one vector store
// where the row allows it (vec: w % 4 == 0, so p is aligned), else the
// columns inside the map one by one
template <typename T>
__device__ __forceinline__ void store_cols(T* p, const float (&v)[4], int x, int w, bool vec) {
  if (vec && x + 4 <= w) {
    store4(p, v);
  } else {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (x + a < w) p[a] = from_f32<T>(v[a]);
  }
}

// Where a 16-byte unit straddles the map's edge or its source is not
// aligned: float32 one 4-byte copy an element (zero-filled outside).
__device__ __forceinline__ void stage_partial(float* dst, const float* row, int x, int w) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int xx = x + e;
    const bool valid = xx >= 0 && xx < w;
    cp_async<4>(dst + e, valid ? row + xx : row, valid);
  }
}
// bfloat16 a pair of columns at a time: one 4-byte copy where the pair lies
// inside the map and its source is 4-byte aligned; else (an odd start, the
// map's edge) two plain loads and one shared store, since cp.async has no
// 2-byte copy. The stage is not read before the next barrier either way.
__device__ __forceinline__ void stage_partial(__nv_bfloat16* dst, const __nv_bfloat16* row, int x, int w) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const int xx = x + e;
    if (xx >= 0 && xx + 2 <= w && (reinterpret_cast<uintptr_t>(row + xx) & 3) == 0) {
      cp_async<4>(dst + e, row + xx, true);
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      __nv_bfloat162 pair;
      pair.x = xx >= 0 && xx < w ? row[xx] : zero;
      pair.y = xx + 1 >= 0 && xx + 1 < w ? row[xx + 1] : zero;
      *reinterpret_cast<__nv_bfloat162*>(dst + e) = pair;
    }
  }
}

// Copy columns x .. x + kUnit<T> - 1 of one map row (row: its column 0, any
// 2-byte alignment) into the 16-byte aligned dst, zero outside [0, w): one
// 16-byte cp.async where the unit lies inside the map and its source is
// 16-byte aligned, a zero fill where it lies wholly outside, else narrower.
template <typename T>
__device__ __forceinline__ void stage_unit(T* dst, const T* row, int x, int w) {
  constexpr int V = kUnit<T>;
  if (x >= 0 && x + V <= w && (reinterpret_cast<uintptr_t>(row + x) & 15) == 0) {
    cp_async<16>(dst, row + x, true);
  } else if (x + V <= 0 || x >= w) {
    cp_async<16>(dst, row, false);
  } else {
    stage_partial(dst, row, x, w);
  }
}

// A block's threads over `rows` staged rows of `units` 16-byte units each:
// thread tid copies units u0, u0 + ustep, .. of rows r0, r0 + rstep, ..;
// found once a block, so the staging loops divide nothing.
struct Split {
  int u0, ustep, r0, rstep;
  __device__ Split(int units, int tid, int nthreads) {
    if (nthreads >= units) {
      rstep = nthreads / units;
      u0 = tid % units;
      r0 = tid < rstep * units ? tid / units : 1 << 30;  // a thread past the last whole pass copies nothing
      ustep = units;
    } else {
      rstep = 1;
      r0 = 0;
      u0 = tid;
      ustep = nthreads;
    }
  }
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Blocks of `threads` threads and `smem` bytes resident on the whole card.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem) != cudaSuccess)
    return 0;
  return sms * occ;
}

}  // namespace corr1d
