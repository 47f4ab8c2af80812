// FlowWarp forward: out(x, y) = bilinear(image, x + u(x, y), y + v(x, y)).
//
// Replaces flownet2_tpu/ops/pallas/warp.py::flow_warp_pallas (the TPU's
// windowed triangular-weight matmul, which clamps footprints that leave a
// per-tile 127 px / 55 px window). Here the warp is an exact 4-tap gather
// for every pixel, with no window and no budget: the H100 has a cache
// hierarchy that serves scattered 4-byte loads, which the TPU has not.
//
// Conventions (flownet2_tpu/ops/warp.py:3-17,181-212):
//   valid iff 0 <= x2 < W and 0 <= y2 < H, else the fill value (0 or NaN);
//   base column min(floor(clip(x2, 0, W-1)), W-2), the same for rows;
//   fractional weights clipped to [0, 1].
// Coordinates and sums are float32. The lerps use __fmul_rn/__fadd_rn so
// that nvcc does not contract them into FMAs: the kernel then rounds exactly
// as the plain PyTorch version does, element for element.
//
// Layout: image (N, C, H, W), flow (N, 2, H, W), out (N, C, H, W), all
// contiguous.
//
// Bound on the H100: memory. At 8x3x320x448 f32 it moves about 37 MB
// (image and flow read, output written); the 4 taps of a pixel mostly hit
// L1/L2 because flows are locally smooth. What the design does about it
// (geometry in csrc/warp.cuh): a thread owns 4 pixels of a row, reads their
// u and v as one vector each, computes the 4 footprints, then issues all
// their tap loads (48 at C = 3, through the read-only path) before any
// arithmetic, so each thread keeps many loads in flight; each output plane
// is written as one vector. No index math per pixel is 64-bit, and no
// division runs at all. Rows whose width is not a multiple of 4, row tails
// and unaligned storage take the scalar path of the same kernel. C = 3,
// every call of the FlowNet cascade, is unrolled; other C loop.

#include "warp.cuh"

namespace {

using warp::Footprint;
using warp::kPx;

// One channel of one sample, rounded as flow_warp_plain rounds it.
__device__ __forceinline__ float bilinear(float p00, float p01, float p10, float p11, float a, float bt) {
  const float top = __fadd_rn(__fmul_rn(p00, 1.f - a), __fmul_rn(p01, a));
  const float bot = __fadd_rn(__fmul_rn(p10, 1.f - a), __fmul_rn(p11, a));
  return __fadd_rn(__fmul_rn(top, 1.f - bt), __fmul_rn(bot, bt));
}

// kC > 0: C fixed at compile time and unrolled; kC == 0: C = c_arg.
template <typename TI, typename TF, int kC, typename Idx>
__global__ void __launch_bounds__(warp::kThreads)
flow_warp_kernel(const TI* __restrict__ image, const TF* __restrict__ flow, TI* __restrict__ out, int n,
                 int c_arg, int h, int w, float fill, bool vec) {
  const int c = kC > 0 ? kC : c_arg;
  const unsigned xu = (blockIdx.x * warp::kTx + threadIdx.x) * kPx;
  if (xu >= static_cast<unsigned>(w)) return;
  const int x0 = static_cast<int>(xu);
  const long long hw = static_cast<long long>(h) * w;

  for (int b = blockIdx.z; b < n; b += gridDim.z) {
    const TF* fl = flow + static_cast<long long>(b) * 2 * hw;
    const TI* im = image + static_cast<long long>(b) * c * hw;
    TI* o = out + static_cast<long long>(b) * c * hw;
    for (long long yy = blockIdx.y * warp::kTy + threadIdx.y; yy < h; yy += gridDim.y * warp::kTy) {
      const int y = static_cast<int>(yy);
      const Idx row = static_cast<Idx>(y) * w;
      float u[kPx], v[kPx];
      warp::load_run(fl + row, x0, w, vec, u);
      warp::load_run(fl + hw + row, x0, w, vec, v);
      Footprint<Idx> f[kPx];
#pragma unroll
      for (int i = 0; i < kPx; ++i) f[i] = warp::footprint<Idx>(x0 + i, y, u[i], v[i], w, h);

      if constexpr (kC > 0) {
        // every tap of every channel first, then the arithmetic
        float p[kC][kPx][4];
#pragma unroll
        for (int ch = 0; ch < kC; ++ch) {
          const TI* plane = im + ch * hw;
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            p[ch][i][0] = warp::ldg(plane + f[i].t0);
            p[ch][i][1] = warp::ldg(plane + f[i].t0 + 1);
            p[ch][i][2] = warp::ldg(plane + f[i].t0 + w);
            p[ch][i][3] = warp::ldg(plane + f[i].t0 + w + 1);
          }
        }
#pragma unroll
        for (int ch = 0; ch < kC; ++ch) {
          float r[kPx];
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            r[i] = f[i].valid ? bilinear(p[ch][i][0], p[ch][i][1], p[ch][i][2], p[ch][i][3], f[i].a, f[i].bt)
                              : fill;
          }
          warp::store_run(o + ch * hw + row, x0, w, vec, r);
        }
      } else {
        for (int ch = 0; ch < c; ++ch) {
          const TI* plane = im + ch * hw;
          float p[kPx][4];
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            p[i][0] = warp::ldg(plane + f[i].t0);
            p[i][1] = warp::ldg(plane + f[i].t0 + 1);
            p[i][2] = warp::ldg(plane + f[i].t0 + w);
            p[i][3] = warp::ldg(plane + f[i].t0 + w + 1);
          }
          float r[kPx];
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            r[i] = f[i].valid ? bilinear(p[i][0], p[i][1], p[i][2], p[i][3], f[i].a, f[i].bt) : fill;
          }
          warp::store_run(o + ch * hw + row, x0, w, vec, r);
        }
      }
    }
  }
}

template <typename TI, typename TF>
void launch(const void* image, const void* flow, void* out, int n, int c, int h, int w, float fill,
            cudaStream_t stream) {
  const dim3 grid = warp::grid(n, h, w), block(warp::kTx, warp::kTy);
  const bool vec = w % kPx == 0 && warp::aligned4<TF>(flow) && warp::aligned4<TI>(out);
  const auto* im = static_cast<const TI*>(image);
  const auto* fl = static_cast<const TF*>(flow);
  auto* o = static_cast<TI*>(out);
  if (warp::wide(h, w)) {
    flow_warp_kernel<TI, TF, 0, long long><<<grid, block, 0, stream>>>(im, fl, o, n, c, h, w, fill, vec);
  } else if (c == 3) {
    flow_warp_kernel<TI, TF, 3, int><<<grid, block, 0, stream>>>(im, fl, o, n, c, h, w, fill, vec);
  } else {
    flow_warp_kernel<TI, TF, 0, int><<<grid, block, 0, stream>>>(im, fl, o, n, c, h, w, fill, vec);
  }
}

}  // namespace

extern "C" int fn2_flow_warp(const void* image, const void* flow, void* out, int n, int c,
                             int h, int w, int image_dtype, int flow_dtype, float fill,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (image_dtype == kFloat32 && flow_dtype == kFloat32) {
    launch<float, float>(image, flow, out, n, c, h, w, fill, s);
  } else if (image_dtype == kFloat32 && flow_dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(image, flow, out, n, c, h, w, fill, s);
  } else if (image_dtype == kBFloat16 && flow_dtype == kFloat32) {
    launch<__nv_bfloat16, float>(image, flow, out, n, c, h, w, fill, s);
  } else if (image_dtype == kBFloat16 && flow_dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(image, flow, out, n, c, h, w, fill, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
