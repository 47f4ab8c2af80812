// FlowWarp backward: the vector-Jacobian product of csrc/warp.cu.
//
// Replaces flownet2_tpu/ops/pallas/warp.py::flow_warp_pallas_bwd, which on
// the TPU recomputes the forward's windows and turns both gradients into
// one-hot matmuls (a TPU has no scatter unit). Here it is the gather
// formulation's own VJP, over all channels of each output pixel:
//
//   d_flow_u(x, y) = sum_c g_c * ((1-b) * (p01 - p00) + b * (p11 - p10))
//   d_flow_v(x, y) = sum_c g_c * (bot_c - top_c)
//   d_image[tap]  += g_c * (bilinear weight of the tap)
//
// The thread recomputes x2, y2, validity, the footprint base
// min(floor(clip(x2, 0, W-1)), W-2) and the clipped fractions exactly as the
// forward does. d_flow is written once per pixel, with no atomics. d_image
// takes four atomicAdds per channel into a zeroed float32 buffer (the
// wrapper casts it for bf16) and is computed only when asked for (a null
// pointer skips it: in the FlowNet2 cascade the image needs no gradient).
// Which of the two is computed is a template parameter.
//
// Invalid pixels (outside the image, or NaN or infinite flow) contribute
// nothing: d_flow is 0 there and no tap is touched, whatever g holds.
//
// Derivative convention: that of autodiff of the gather formulation
// (flownet2_tpu/ops/pallas/warp.py:263-267): taps at (xb, xb+1), so the
// last column differentiates as img[W-1] - img[W-2]. The clip of x2 to
// [0, W-1] passes the derivative on the closed interval, as torch.clamp's
// backward does, and stops it for x2 in (W-1, W), where the coordinate is
// saturated (rows the same). At the measure-zero ties x2 == 0 and
// x2 == W-1 this follows PyTorch (derivative 1); jnp.clip splits the
// gradient there differently, so tests against JAX keep clear of exact ties.
//
// Layout: image, g and d_image (N, C, H, W); flow and d_flow (N, 2, H, W);
// all contiguous. Accumulation in float32.
//
// Bound on the H100: memory and atomics. At 8x3x320x448 it reads image,
// flow and g (about 33 MB f32) and writes d_flow; with d_image it adds 12
// float atomics per pixel into an L2-resident 14 MB buffer. The design is
// the forward's (csrc/warp.cuh): 4 pixels a thread, u, v, g and d_flow as
// one vector per plane, every tap load of the run issued before the sums,
// 32-bit index math, C = 3 unrolled.

#include "warp.cuh"

namespace {

using warp::Footprint;
using warp::kPx;

template <typename TI, typename TF, int kC, bool kImage, bool kFlow, typename Idx>
__global__ void __launch_bounds__(warp::kThreads)
flow_warp_backward_kernel(const TI* __restrict__ image, const TF* __restrict__ flow, const TI* __restrict__ grad,
                          float* __restrict__ grad_image, TF* __restrict__ grad_flow, int n, int c_arg, int h,
                          int w, bool vec) {
  const int c = kC > 0 ? kC : c_arg;
  const unsigned xu = (blockIdx.x * warp::kTx + threadIdx.x) * kPx;
  if (xu >= static_cast<unsigned>(w)) return;
  const int x0 = static_cast<int>(xu);
  const long long hw = static_cast<long long>(h) * w;

  for (int b = blockIdx.z; b < n; b += gridDim.z) {
    const TF* fl = flow + static_cast<long long>(b) * 2 * hw;
    const TI* im = image + static_cast<long long>(b) * c * hw;
    const TI* gp = grad + static_cast<long long>(b) * c * hw;
    for (long long yy = blockIdx.y * warp::kTy + threadIdx.y; yy < h; yy += gridDim.y * warp::kTy) {
      const int y = static_cast<int>(yy);
      const Idx row = static_cast<Idx>(y) * w;
      float u[kPx], v[kPx];
      warp::load_run(fl + row, x0, w, vec, u);
      warp::load_run(fl + hw + row, x0, w, vec, v);
      Footprint<Idx> f[kPx];
#pragma unroll
      for (int i = 0; i < kPx; ++i) f[i] = warp::footprint<Idx>(x0 + i, y, u[i], v[i], w, h);

      float du[kPx] = {}, dv[kPx] = {};
#pragma unroll  // fully where C is a template constant, not at all otherwise
      for (int ch = 0; ch < c; ++ch) {
        const long long off = ch * hw;
        float g[kPx];
        warp::load_run(gp + off + row, x0, w, vec, g);
        if constexpr (kFlow) {
          const TI* plane = im + off;
          float p[kPx][4];
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            p[i][0] = warp::ldg(plane + f[i].t0);
            p[i][1] = warp::ldg(plane + f[i].t0 + 1);
            p[i][2] = warp::ldg(plane + f[i].t0 + w);
            p[i][3] = warp::ldg(plane + f[i].t0 + w + 1);
          }
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            const float a = f[i].a, bt = f[i].bt, a1 = 1.f - a, b1 = 1.f - bt;
            const float p00 = p[i][0], p01 = p[i][1], p10 = p[i][2], p11 = p[i][3];
            const float top = __fadd_rn(__fmul_rn(p00, a1), __fmul_rn(p01, a));
            const float bot = __fadd_rn(__fmul_rn(p10, a1), __fmul_rn(p11, a));
            du[i] += g[i] * (b1 * (p01 - p00) + bt * (p11 - p10));
            dv[i] += g[i] * (bot - top);
          }
        }
        if constexpr (kImage) {
          float* plane = grad_image + static_cast<long long>(b) * c * hw + off;
#pragma unroll
          for (int i = 0; i < kPx; ++i) {
            if (!f[i].valid) continue;
            const float a = f[i].a, bt = f[i].bt, a1 = 1.f - a, b1 = 1.f - bt;
            atomicAdd(plane + f[i].t0, g[i] * a1 * b1);
            atomicAdd(plane + f[i].t0 + 1, g[i] * a * b1);
            atomicAdd(plane + f[i].t0 + w, g[i] * a1 * bt);
            atomicAdd(plane + f[i].t0 + w + 1, g[i] * a * bt);
          }
        }
      }
      if constexpr (kFlow) {
        TF* gf = grad_flow + static_cast<long long>(b) * 2 * hw + row;
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          du[i] = f[i].valid && f[i].u_live ? du[i] : 0.f;
          dv[i] = f[i].valid && f[i].v_live ? dv[i] : 0.f;
        }
        warp::store_run(gf, x0, w, vec, du);
        warp::store_run(gf + hw, x0, w, vec, dv);
      }
    }
  }
}

template <typename TI, typename TF, int kC, typename Idx>
void launch_parts(const TI* image, const TF* flow, const TI* grad, float* grad_image, TF* grad_flow, int n,
                  int c, int h, int w, bool vec, cudaStream_t stream) {
  const dim3 grid = warp::grid(n, h, w), block(warp::kTx, warp::kTy);
  if (grad_image != nullptr && grad_flow != nullptr) {
    flow_warp_backward_kernel<TI, TF, kC, true, true, Idx>
        <<<grid, block, 0, stream>>>(image, flow, grad, grad_image, grad_flow, n, c, h, w, vec);
  } else if (grad_image != nullptr) {
    flow_warp_backward_kernel<TI, TF, kC, true, false, Idx>
        <<<grid, block, 0, stream>>>(image, flow, grad, grad_image, grad_flow, n, c, h, w, vec);
  } else if (grad_flow != nullptr) {
    flow_warp_backward_kernel<TI, TF, kC, false, true, Idx>
        <<<grid, block, 0, stream>>>(image, flow, grad, grad_image, grad_flow, n, c, h, w, vec);
  }
}

template <typename TI, typename TF>
void launch(const void* image, const void* flow, const void* grad, void* grad_image, void* grad_flow, int n,
            int c, int h, int w, cudaStream_t stream) {
  const bool vec = w % kPx == 0 && warp::aligned4<TF>(flow) && warp::aligned4<TI>(grad) &&
                   warp::aligned4<TF>(grad_flow);
  const auto* im = static_cast<const TI*>(image);
  const auto* fl = static_cast<const TF*>(flow);
  const auto* g = static_cast<const TI*>(grad);
  auto* gi = static_cast<float*>(grad_image);
  auto* gf = static_cast<TF*>(grad_flow);
  if (warp::wide(h, w)) {
    launch_parts<TI, TF, 0, long long>(im, fl, g, gi, gf, n, c, h, w, vec, stream);
  } else if (c == 3) {
    launch_parts<TI, TF, 3, int>(im, fl, g, gi, gf, n, c, h, w, vec, stream);
  } else {
    launch_parts<TI, TF, 0, int>(im, fl, g, gi, gf, n, c, h, w, vec, stream);
  }
}

}  // namespace

// grad_image: a zeroed float32 (N, C, H, W) buffer, or null to skip it.
// grad_flow: (N, 2, H, W) in the flow's dtype, or null to skip it.
extern "C" int fn2_flow_warp_backward(const void* image, const void* flow, const void* grad,
                                      void* grad_image, void* grad_flow, int n, int c, int h,
                                      int w, int image_dtype, int flow_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (image_dtype == kFloat32 && flow_dtype == kFloat32) {
    launch<float, float>(image, flow, grad, grad_image, grad_flow, n, c, h, w, s);
  } else if (image_dtype == kFloat32 && flow_dtype == kBFloat16) {
    launch<float, __nv_bfloat16>(image, flow, grad, grad_image, grad_flow, n, c, h, w, s);
  } else if (image_dtype == kBFloat16 && flow_dtype == kFloat32) {
    launch<__nv_bfloat16, float>(image, flow, grad, grad_image, grad_flow, n, c, h, w, s);
  } else if (image_dtype == kBFloat16 && flow_dtype == kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(image, flow, grad, grad_image, grad_flow, n, c, h, w,
                                         s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
