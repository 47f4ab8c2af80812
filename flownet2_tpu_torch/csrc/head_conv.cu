// Full-resolution head convolutions: a k x k conv (pad k/2, stride 1 or 2)
// and the k4/s2/p1 deconv, each with bias and an optional leaky ReLU
// (slope 0.1) fused into the epilogue.
//
// Replaces flownet2_tpu/ops/pallas/s2d_conv.py::matmul_conv_pallas, which
// the JAX package runs on the space-to-depth rewrite of these layers
// (flownet2_tpu/ops/s2d.py::_conv2d_s2d_routed and ::_deconv2d_s2d_routed)
// at full-resolution widths above 512. The s2d layout exists to feed the
// TPU's 128-lane matrix unit; here the same function is computed directly
// in the plain NCHW layout.
//
// Two routes behind the same entry points: float32 runs the CUDA-core
// kernels below; bfloat16 runs the tensor-core implicit GEMM of
// head_conv_tc.cu, which takes the weight packed by
// ops/head_conv.py::pack_head_weight.
//
// Float32 layouts (all contiguous): x (N, Cin, H, W); conv weight
// (Cout, Cin, k, k) (OIHW, nn.Conv2d); deconv weight (Cin, Cout, 4, 4)
// (nn.ConvTranspose2d); bias (Cout); out (N, Cout, Ho, Wo). Sums in float32.
//
// Design of the float32 route. One block of 256 threads computes an output tile for all Cout
// (<= 64) of one image. Per chunk of CK input channels, the input patch with
// its halo (zero outside the image: the conv's padding) and the chunk's
// weights are staged in shared memory, weights as
// [ci][tap][cout]. A warp covers 32 neighbouring output columns of one row
// and one group of output channels, so its weight loads are broadcasts and
// its input loads are consecutive addresses. Each thread keeps PX pixels
// (PX columns 32 apart) times CO output channels of sums in registers: per
// tap, PX input loads and CO/4 vector weight loads feed PX*CO FMAs.
// The deconv computes all four output phases (y%2, x%2) of a half-resolution
// tile; a warp holds one phase, whose 2x2 taps per channel are
// ky = 3 - py - 2a, kx = 3 - px - 2b over input (m - 1 + py + a, n - 1 + px + b)
// for output (2m + py, 2n + px) (the tap algebra of ops/s2d.py:211-232).
//
// Bound on the H100: float32 FMAs on the CUDA cores. At Sintel size
// (1024x448, batch 4) the twelve head layers of FlowNet2 do about 272 GFLOP
// and move about 4 GB, so the 67 TFLOP/s float32 peak, not the 3.35 TB/s of
// memory, sets the bound (about 4 ms). TF32 tensor cores stay unused: the
// port's float32 path is exact float32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 32;  // threads along a tile row: one warp

template <int CO>
__device__ __forceinline__ void load_weights(float (&wv)[CO], const float* p) {
  if constexpr (CO % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CO; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      wv[j] = v.x;
      wv[j + 1] = v.y;
      wv[j + 2] = v.z;
      wv[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CO; ++j) wv[j] = p[j];
  }
}

__device__ __forceinline__ float epilogue(float v, float bias, bool leaky) {
  v += bias;
  return (leaky && v < 0.f) ? v * 0.1f : v;
}

// COB output channels per block (Cout <= COB, the rest masked), in G groups
// of CO = COB / G per thread; TY = 256 / (32 G) output rows by 32 PX columns
// per tile; CK input channels per staged chunk.
template <int K, int S, int COB, int G, int PX, int CK>
struct ConvGeom {
  static constexpr int CO = COB / G;
  static constexpr int TY = kThreads / (kTX * G);
  static constexpr int TW = kTX * PX;
  static constexpr int IR = (TY - 1) * S + K;
  static constexpr int IC = (TW - 1) * S + K;
  static constexpr int W_FLOATS = CK * K * K * COB;
  static constexpr int X_FLOATS = CK * IR * IC;
  static constexpr size_t SMEM = (W_FLOATS + X_FLOATS) * sizeof(float);
};

template <int K, int S, int COB, int G, int PX, int CK>
__global__ void __launch_bounds__(kThreads)
head_conv_kernel(const float* __restrict__ x, const float* __restrict__ weight, const float* __restrict__ bias,
                 float* __restrict__ out, int cin, int h, int w, int cout, int ho, int wo, bool leaky) {
  using Geo = ConvGeom<K, S, COB, G, PX, CK>;
  constexpr int CO = Geo::CO, TY = Geo::TY, TW = Geo::TW, IR = Geo::IR, IC = Geo::IC;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [CK][K*K][COB]
  float* xs = ws + Geo::W_FLOATS;                // [CK][IR][IC]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = (tid / kTX) % TY;
  const int g = tid / (kTX * TY);
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TY;
  const int ox0 = blockIdx.x * TW;
  const int iy0 = oy0 * S - K / 2;
  const int ix0 = ox0 * S - K / 2;
  const long long hw = static_cast<long long>(h) * w;
  const float* xb = x + static_cast<long long>(b) * cin * hw;

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < Geo::X_FLOATS; i += kThreads) {
      const int ci = i / (IR * IC);
      const int r = (i / IC) % IR;
      const int c = i % IC;
      const int gy = iy0 + r, gx = ix0 + c;
      float v = 0.f;
      if (c0 + ci < cin && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = xb[(c0 + ci) * hw + static_cast<long long>(gy) * w + gx];
      xs[i] = v;
    }
    for (int i = tid; i < Geo::W_FLOATS; i += kThreads) {
      const int co = i % COB;
      const int tap = (i / COB) % (K * K);
      const int ci = i / (COB * K * K);
      float v = 0.f;
      if (co < cout && c0 + ci < cin)
        v = weight[(static_cast<long long>(co) * cin + c0 + ci) * (K * K) + tap];
      ws[i] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int ci = 0; ci < CK; ++ci) {
      const float* xr = xs + ci * IR * IC + ty * S * IC + tx * S;
      const float* wr = ws + ci * K * K * COB + g * CO;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float wv[CO];
          load_weights<CO>(wv, wr + (ky * K + kx) * COB);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float xv = xr[ky * IC + p * kTX * S + kx];
#pragma unroll
            for (int j = 0; j < CO; ++j) acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
          }
        }
      }
    }
  }

  const int oy = oy0 + ty;
  if (oy >= ho) return;
  const long long howo = static_cast<long long>(ho) * wo;
  float* ob = out + static_cast<long long>(b) * cout * howo + static_cast<long long>(oy) * wo;
#pragma unroll
  for (int j = 0; j < CO; ++j) {
    const int co = g * CO + j;
    if (co >= cout) continue;
    const float bv = bias[co];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int ox = ox0 + tx + p * kTX;
      if (ox < wo) ob[co * howo + ox] = epilogue(acc[p][j], bv, leaky);
    }
  }
}

// The k4/s2/p1 deconv: a tile of TY half-resolution rows by 32 PX columns,
// all four phases (one per group of TY warps), all COB output channels.
template <int COB, int PX, int CK>
struct DeconvGeom {
  static constexpr int TY = kThreads / (kTX * 4);
  static constexpr int TW = kTX * PX;
  static constexpr int IR = TY + 2;
  static constexpr int IC = TW + 2;
  static constexpr int W_FLOATS = CK * 16 * COB;
  static constexpr int X_FLOATS = CK * IR * IC;
  static constexpr size_t SMEM = (W_FLOATS + X_FLOATS) * sizeof(float);
};

template <int COB, int PX, int CK>
__global__ void __launch_bounds__(kThreads)
head_deconv_kernel(const float* __restrict__ x, const float* __restrict__ weight, const float* __restrict__ bias,
                   float* __restrict__ out, int cin, int h, int w, int cout, bool leaky) {
  using Geo = DeconvGeom<COB, PX, CK>;
  constexpr int TY = Geo::TY, TW = Geo::TW, IR = Geo::IR, IC = Geo::IC;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [CK][16][COB]
  float* xs = ws + Geo::W_FLOATS;                // [CK][IR][IC]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = (tid / kTX) % TY;
  const int phase = tid / (kTX * TY);
  const int py = phase >> 1, px = phase & 1;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * TY;
  const int n0 = blockIdx.x * TW;
  const long long hw = static_cast<long long>(h) * w;
  const float* xb = x + static_cast<long long>(b) * cin * hw;

  float acc[PX][COB];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[p][j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();
    for (int i = tid; i < Geo::X_FLOATS; i += kThreads) {
      const int ci = i / (IR * IC);
      const int r = (i / IC) % IR;
      const int c = i % IC;
      const int gy = m0 - 1 + r, gx = n0 - 1 + c;
      float v = 0.f;
      if (c0 + ci < cin && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = xb[(c0 + ci) * hw + static_cast<long long>(gy) * w + gx];
      xs[i] = v;
    }
    for (int i = tid; i < Geo::W_FLOATS; i += kThreads) {
      const int co = i % COB;
      const int tap = (i / COB) % 16;
      const int ci = i / (COB * 16);
      float v = 0.f;
      if (co < cout && c0 + ci < cin)
        v = weight[(static_cast<long long>(c0 + ci) * cout + co) * 16 + tap];
      ws[i] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int ci = 0; ci < CK; ++ci) {
      const float* xr = xs + ci * IR * IC + (ty + py) * IC + tx + px;
      const float* wr = ws + ci * 16 * COB;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          float wv[COB];
          load_weights<COB>(wv, wr + ((3 - py - 2 * a) * 4 + (3 - px - 2 * bb)) * COB);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            const float xv = xr[a * IC + p * kTX + bb];
#pragma unroll
            for (int j = 0; j < COB; ++j) acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
          }
        }
      }
    }
  }

  const int m = m0 + ty;
  if (m >= h) return;
  const int ho = 2 * h, wo = 2 * w;
  const long long howo = static_cast<long long>(ho) * wo;
  float* ob = out + static_cast<long long>(b) * cout * howo + static_cast<long long>(2 * m + py) * wo + px;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    if (j >= cout) continue;
    const float bv = bias[j];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int n = n0 + tx + p * kTX;
      if (n < w) ob[j * howo + 2 * n] = epilogue(acc[p][j], bv, leaky);
    }
  }
}

template <int K, int S, int COB, int G, int CK>
int launch_conv(const void* x, const void* weight, const void* bias, void* out, int n, int cin,
                int h, int w, int cout, int ho, int wo, bool leaky, cudaStream_t stream) {
  constexpr int PX = 4;
  using Geo = ConvGeom<K, S, COB, G, PX, CK>;
  auto kernel = head_conv_kernel<K, S, COB, G, PX, CK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Geo::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((wo + Geo::TW - 1) / Geo::TW, (ho + Geo::TY - 1) / Geo::TY, n);
  kernel<<<grid, kThreads, Geo::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(out), cin, h, w, cout, ho, wo, leaky);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int S>
int dispatch_cout(const void* x, const void* weight, const void* bias, void* out, int n, int cin,
                  int h, int w, int cout, int ho, int wo, bool leaky, cudaStream_t stream) {
  constexpr int CK = K == 7 ? 4 : 8;
  if (cout <= 2)
    return launch_conv<K, S, 2, 1, CK>(x, weight, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (cout <= 16)
    return launch_conv<K, S, 16, 1, CK>(x, weight, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  return launch_conv<K, S, 64, 4, CK>(x, weight, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
}

int dispatch_conv(const void* x, const void* weight, const void* bias, void* out, int n, int cin,
                  int h, int w, int cout, int k, int stride, bool leaky, cudaStream_t stream) {
  const int ho = (h + 2 * (k / 2) - k) / stride + 1;
  const int wo = (w + 2 * (k / 2) - k) / stride + 1;
  if (k == 3 && stride == 1)
    return dispatch_cout<3, 1>(x, weight, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (k == 3 && stride == 2)
    return dispatch_cout<3, 2>(x, weight, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (k == 7 && stride == 2)
    return dispatch_cout<7, 2>(x, weight, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int COB>
int launch_deconv(const void* x, const void* weight, const void* bias, void* out, int n, int cin,
                  int h, int w, int cout, bool leaky, cudaStream_t stream) {
  constexpr int PX = 4, CK = 8;
  using Geo = DeconvGeom<COB, PX, CK>;
  auto kernel = head_deconv_kernel<COB, PX, CK>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Geo::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + Geo::TW - 1) / Geo::TW, (h + Geo::TY - 1) / Geo::TY, n);
  kernel<<<grid, kThreads, Geo::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(out), cin, h, w, cout, leaky);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_deconv(const void* x, const void* weight, const void* bias, void* out, int n, int cin,
                    int h, int w, int cout, bool leaky, cudaStream_t stream) {
  if (cout <= 2) return launch_deconv<2>(x, weight, bias, out, n, cin, h, w, cout, leaky, stream);
  if (cout <= 16) return launch_deconv<16>(x, weight, bias, out, n, cin, h, w, cout, leaky, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The bfloat16 route (head_conv_tc.cu): packed weights, tensor cores.
int head_conv_mma(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                  int cout, int k, int stride, bool leaky, cudaStream_t stream);
int head_deconv_mma(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                    int cout, bool leaky, cudaStream_t stream);

// k x k conv, pad k/2: (k, stride) in {(3, 1), (3, 2), (7, 2)}, 1 <= Cout <= 64.
// float32: weight (Cout, Cin, k, k); bfloat16: weight packed as [k*k][cout_pad][cin_pad].
extern "C" int fn2_head_conv(const void* x, const void* weight, const void* bias, void* out, int n,
                             int cin, int h, int w, int cout, int k, int stride, int leaky,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout < 1 || cout > 64 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return dispatch_conv(x, weight, bias, out, n, cin, h, w, cout, k, stride, leaky != 0, s);
  if (dtype == kBFloat16)
    return head_conv_mma(x, weight, bias, out, n, cin, h, w, cout, k, stride, leaky != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// k4/s2/p1 deconv: (N, Cin, H, W) -> (N, Cout, 2H, 2W), 1 <= Cout <= 16.
// float32: weight (Cin, Cout, 4, 4); bfloat16: weight packed as [16][cout_pad][cin_pad].
extern "C" int fn2_head_deconv(const void* x, const void* weight, const void* bias, void* out, int n,
                               int cin, int h, int w, int cout, int leaky, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout < 1 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return dispatch_deconv(x, weight, bias, out, n, cin, h, w, cout, leaky != 0, s);
  if (dtype == kBFloat16)
    return head_deconv_mma(x, weight, bias, out, n, cin, h, w, cout, leaky != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
