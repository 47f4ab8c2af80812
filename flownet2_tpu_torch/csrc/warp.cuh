// What the flow warp's forward (csrc/warp.cu) and backward (csrc/warp_bwd.cu)
// share: the launch geometry, runs of four pixels loaded and stored as one
// vector, and the bilinear footprint of a sample.
//
// A thread owns kPx = 4 consecutive pixels of one row. A block is kTx x kTy
// threads, 64 x 16 pixels; blockIdx.x walks the columns, blockIdx.y the rows
// and blockIdx.z the batch (both of the last two loop when the grid's
// 65535 limit cuts them). Offsets of an image or a plane are taken in 64
// bits once per thread; inside a plane the index type Idx is int, so no
// per-pixel 64-bit arithmetic runs, unless a plane has 2^31 elements or
// more, where the host picks Idx = long long.
#pragma once

#include "common.cuh"

namespace warp {

constexpr int kPx = 4;  // pixels a thread owns, consecutive along x
constexpr int kTx = 16;
constexpr int kTy = 16;
constexpr int kThreads = kTx * kTy;

__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// Four consecutive elements: one 16-byte (float) or 8-byte (bfloat16) access.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  // a bfloat16 is the high half of the float32 with the same bits
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16), bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
}

// The run of kPx elements of a row from column x0 (x0 < w, x0 % kPx == 0):
// one vector access where `vec` (W % 4 == 0 and aligned base pointers) and
// the run is whole, else element by element; columns past the row's end
// read as 0 and are not written.
template <typename T>
__device__ __forceinline__ void load_run(const T* row, int x0, int w, bool vec, float v[kPx]) {
  const int left = w - x0;
  if (vec && left >= kPx) {
    load4(row + x0, v);
  } else {
#pragma unroll
    for (int i = 0; i < kPx; ++i) v[i] = i < left ? ldg(row + x0 + i) : 0.f;
  }
}
template <typename T>
__device__ __forceinline__ void store_run(T* row, int x0, int w, bool vec, const float v[kPx]) {
  const int left = w - x0;
  if (vec && left >= kPx) {
    store4(row + x0, v);
  } else {
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      if (i < left) row[x0 + i] = from_f32<T>(v[i]);
    }
  }
}

// The bilinear footprint of the sample (x + u, y + v): taps at t0, t0 + 1,
// t0 + w, t0 + w + 1 of a plane, fractions a and bt. Conventions as
// csrc/warp.cu's header states them. NaN and infinite coordinates clamp
// into the image (fmaxf returns its other operand for a NaN), so every
// footprint can be read, valid or not; so can a column past the row's end
// (u = 0 there), which is invalid since x2 >= W.
template <typename Idx>
struct Footprint {
  Idx t0;
  float a, bt;
  bool valid;
  bool u_live, v_live;  // the clip of x2 (y2) to [0, W-1] ([0, H-1]) does not saturate
};

template <typename Idx>
__device__ __forceinline__ Footprint<Idx> footprint(int x, int y, float u, float v, int w, int h) {
  const float x2 = __fadd_rn(static_cast<float>(x), u);
  const float y2 = __fadd_rn(static_cast<float>(y), v);
  Footprint<Idx> f;
  f.valid = x2 >= 0.f && y2 >= 0.f && x2 < static_cast<float>(w) && y2 < static_cast<float>(h);
  f.u_live = x2 <= static_cast<float>(w - 1);
  f.v_live = y2 <= static_cast<float>(h - 1);
  const float xs = fminf(fmaxf(x2, 0.f), static_cast<float>(w - 1));
  const float ys = fminf(fmaxf(y2, 0.f), static_cast<float>(h - 1));
  const int xb = min(static_cast<int>(floorf(xs)), w - 2);
  const int yb = min(static_cast<int>(floorf(ys)), h - 2);
  f.a = fminf(fmaxf(xs - static_cast<float>(xb), 0.f), 1.f);
  f.bt = fminf(fmaxf(ys - static_cast<float>(yb), 0.f), 1.f);
  f.t0 = static_cast<Idx>(yb) * w + xb;
  return f;
}

// The grid: columns in blockIdx.x, rows and the batch capped at 65535.
inline dim3 grid(int n, int h, int w) {
  const long long cols = (static_cast<long long>(w) + kTx * kPx - 1) / (kTx * kPx);
  const long long rows = (static_cast<long long>(h) + kTy - 1) / kTy;
  return dim3(static_cast<unsigned>(cols), static_cast<unsigned>(rows < 65535 ? rows : 65535),
              static_cast<unsigned>(n < 65535 ? n : 65535));
}

// A plane of 2^31 elements or more needs 64-bit tap indices.
inline bool wide(int h, int w) { return static_cast<long long>(h) * w > 0x7fffffffLL; }

template <typename T>
inline bool aligned4(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

}  // namespace warp
