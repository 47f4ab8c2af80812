// FlowWarp backward: the vector-Jacobian product of csrc/warp.cu.
//
// Replaces flownet2_tpu/ops/pallas/warp.py::flow_warp_pallas_bwd, which on
// the TPU recomputes the forward's windows and turns both gradients into
// one-hot matmuls (a TPU has no scatter unit). Here it is the gather
// formulation's own VJP, one thread per output pixel over all channels:
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
// gradient there differently, so tests keep clear of exact ties.
//
// Layout: image, g and d_image (N, C, H, W); flow and d_flow (N, 2, H, W);
// all contiguous. Accumulation in float32.
//
// Bound on the H100: memory and atomics. At 8x3x320x448 it reads image,
// flow and g (about 33 MB f32) and writes d_flow; with d_image it adds 12
// float atomics per pixel into an L2-resident 14 MB buffer.

#include "common.cuh"

namespace {

template <typename TI, typename TF>
__global__ void flow_warp_backward_kernel(const TI* __restrict__ image,
                                          const TF* __restrict__ flow,
                                          const TI* __restrict__ grad,
                                          float* __restrict__ grad_image,
                                          TF* __restrict__ grad_flow, int n, int c, int h,
                                          int w) {
  const long long hw = static_cast<long long>(h) * w;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n * hw) return;
  const long long b = idx / hw;
  const long long p = idx - b * hw;
  const int y = static_cast<int>(p / w);
  const int x = static_cast<int>(p - static_cast<long long>(y) * w);

  const TF* fl = flow + b * 2 * hw;
  const float x2 = __fadd_rn(static_cast<float>(x), to_f32(fl[p]));
  const float y2 = __fadd_rn(static_cast<float>(y), to_f32(fl[hw + p]));
  const bool valid = x2 >= 0.f && y2 >= 0.f && x2 < static_cast<float>(w) &&
                     y2 < static_cast<float>(h);
  if (!valid) {
    if (grad_flow != nullptr) {
      grad_flow[b * 2 * hw + p] = from_f32<TF>(0.f);
      grad_flow[b * 2 * hw + hw + p] = from_f32<TF>(0.f);
    }
    return;
  }
  const float xs = fminf(fmaxf(x2, 0.f), static_cast<float>(w - 1));
  const float ys = fminf(fmaxf(y2, 0.f), static_cast<float>(h - 1));
  const int xb = min(static_cast<int>(floorf(xs)), w - 2);
  const int yb = min(static_cast<int>(floorf(ys)), h - 2);
  const float a = fminf(fmaxf(xs - static_cast<float>(xb), 0.f), 1.f);
  const float bt = fminf(fmaxf(ys - static_cast<float>(yb), 0.f), 1.f);
  const float a1 = 1.f - a;
  const float b1 = 1.f - bt;
  const long long t0 = static_cast<long long>(yb) * w + xb;
  const long long t1 = t0 + w;

  const TI* im = image + b * c * hw;
  const TI* gp = grad + b * c * hw;
  float* gi = grad_image == nullptr ? nullptr : grad_image + b * c * hw;
  float du = 0.f;
  float dv = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float g = to_f32(gp[ch * hw + p]);
    if (grad_flow != nullptr) {
      const TI* plane = im + ch * hw;
      const float p00 = to_f32(plane[t0]);
      const float p01 = to_f32(plane[t0 + 1]);
      const float p10 = to_f32(plane[t1]);
      const float p11 = to_f32(plane[t1 + 1]);
      const float top = __fadd_rn(__fmul_rn(p00, a1), __fmul_rn(p01, a));
      const float bot = __fadd_rn(__fmul_rn(p10, a1), __fmul_rn(p11, a));
      du += g * (b1 * (p01 - p00) + bt * (p11 - p10));
      dv += g * (bot - top);
    }
    if (gi != nullptr) {
      float* plane = gi + ch * hw;
      atomicAdd(plane + t0, g * a1 * b1);
      atomicAdd(plane + t0 + 1, g * a * b1);
      atomicAdd(plane + t1, g * a1 * bt);
      atomicAdd(plane + t1 + 1, g * a * bt);
    }
  }
  if (grad_flow != nullptr) {
    // the clip saturates for x2 in (W-1, W) and y2 in (H-1, H)
    const bool u_live = x2 <= static_cast<float>(w - 1);
    const bool v_live = y2 <= static_cast<float>(h - 1);
    grad_flow[b * 2 * hw + p] = from_f32<TF>(u_live ? du : 0.f);
    grad_flow[b * 2 * hw + hw + p] = from_f32<TF>(v_live ? dv : 0.f);
  }
}

template <typename TI, typename TF>
void launch(const void* image, const void* flow, const void* grad, void* grad_image,
            void* grad_flow, int n, int c, int h, int w, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * w;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  flow_warp_backward_kernel<TI, TF><<<blocks, threads, 0, stream>>>(
      static_cast<const TI*>(image), static_cast<const TF*>(flow),
      static_cast<const TI*>(grad), static_cast<float*>(grad_image),
      static_cast<TF*>(grad_flow), n, c, h, w);
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
