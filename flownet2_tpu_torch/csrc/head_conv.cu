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
// head_conv_tc.cu. Each takes its weight packed by ops/head_conv.py
// (float32: pack_head_weight_f32; bfloat16: pack_head_weight), per call.
//
// Float32 layouts: x (N, Cin, H, W), out (N, Cout, Ho, Wo), bias (Cout),
// all contiguous; the weight packed as [cin][tap][cout_pad], cout_pad 4, 16
// or 64 (the kernel's channel block), zero in the padding. Conv taps are
// ky * k + kx; the deconv's 16 are phase * 4 + a * 2 + b for output phase
// (py, px), phase = 2 py + px, holding weight[ci, co, 3 - py - 2a,
// 3 - px - 2b]: output (2m + py, 2n + px) is then a 2x2 stride-1 conv over
// input (m - 1 + py + a, n - 1 + px + b) (the tap algebra of
// ops/s2d.py:211-232). Sums in float32: plain FMAs, no TF32, the meaning of
// cuDNN's float32 conv with TF32 off.
//
// Bound on the H100: float32 FMAs on the CUDA cores. At Sintel size
// (1024x448, batch 4) the twelve head layers of FlowNet2 do about 272 GFLOP
// and move about 4 GB, so the 67 TFLOP/s float32 peak, not the 3.35 TB/s of
// memory, sets the bound (about 4.1 ms). A warp scheduler issues one
// instruction a cycle and an FMA instruction fills the cores for one, so
// every other instruction in the inner loop (shared loads, addresses)
// costs FMA rate; so does any time a block waits on its loads.
//
// Design. A block of 8 warps computes a tile of output rows by columns for
// all cout_pad channels of one image, split into G channel groups of CO
// channels. A warp holds one group, so its weight loads are broadcasts; its
// lanes are 32 neighbouring output columns, so its input loads are
// neighbouring addresses. Each thread keeps RY rows x PX columns (32
// apart) x CO channels of float32 sums: per tap, RY PX input loads and CO/4
// 16-byte weight loads feed RY PX CO FMAs (64 at the 16- and 64-channel
// layers). The deconv's groups are its four output phases.
// Input channels run in chunks of CK through a ring of two shared-memory
// stages filled by cp.async: while the block computes one chunk, the next
// one's input patch (with its halo) and weights are in flight. The packed
// weights make a chunk's weights one contiguous run, copied 16 bytes at a
// time; the patch is copied 4 bytes at a time along NCHW rows (neighbouring
// threads on neighbouring columns), and the copy's zero fill (src-size 0)
// writes the conv's padding outside the image. At stride 2 a patch row is
// stored as its even and then its odd columns, so the 32 lanes, which read
// every second column, hit 32 distinct banks. CK is the largest power of
// two up to 16 whose stage fits 48 KB, so two 256-thread blocks (at most
// 128 registers a thread) share an SM. Staging divides only by
// compile-time constants.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTX = 32;  // output columns of a warp
constexpr int kStages = 2;
constexpr int kStageBytes = 48 * 1024;  // largest stage, so two blocks fit an SM

template <int CO>
__device__ __forceinline__ void load_weights(float (&wv)[CO], const float* p) {
#pragma unroll
  for (int j = 0; j < CO; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    wv[j] = v.x;
    wv[j + 1] = v.y;
    wv[j + 2] = v.z;
    wv[j + 3] = v.w;
  }
}

__device__ __forceinline__ float epilogue(float v, float bias, bool leaky) {
  v += bias;
  return (leaky && v < 0.f) ? v * 0.1f : v;
}

// DECONV false: a K x K conv at stride S over a tile of TY x TW outputs.
// DECONV true: the k4/s2 deconv, K = 2 taps a side per phase, S = 1, over
// TY x TW half-resolution positions in each of the four phases (G = 4).
// COB channels (the packed cout_pad) in G groups of CO; RY x PX outputs a
// thread.
template <int K, int S, bool DECONV, int COB, int G, int RY, int PX>
struct Geom {
  static constexpr int STRIDE = S;
  static constexpr int CO = DECONV ? COB : COB / G;  // a deconv phase has every channel
  static constexpr int WG = kWarps / G;               // warps per group
  static constexpr int TY = WG * RY;
  static constexpr int TW = kTX * PX;
  static constexpr int TAPS = DECONV ? 16 : K * K;  // packed taps per input channel
  static constexpr int IR = DECONV ? TY + 2 : (TY - 1) * S + K;
  static constexpr int IC = DECONV ? TW + 2 : (TW - 1) * S + K;
  static constexpr int ICP = (IC + S - 1) / S;  // columns of one plane (stride 2: even, then odd)
  static constexpr int ROW = S * ICP;           // floats from one patch row to the next
  static constexpr int X_CH = IR * ROW;
  static constexpr int W_CH = TAPS * COB;
  static constexpr int CH_BYTES = 4 * (X_CH + W_CH);
  static constexpr int CK = 16 * CH_BYTES <= kStageBytes ? 16
                            : 8 * CH_BYTES <= kStageBytes ? 8
                            : 4 * CH_BYTES <= kStageBytes ? 4
                            : 2 * CH_BYTES <= kStageBytes ? 2 : 1;
  static constexpr int W_FLOATS = CK * W_CH;
  static constexpr int STAGE = (W_FLOATS + CK * X_CH + 3) / 4 * 4;  // floats, 16-byte multiple
  static constexpr size_t SMEM = static_cast<size_t>(kStages) * STAGE * sizeof(float);
  static_assert(CO * (DECONV ? 1 : G) == COB && CO % 4 == 0 && kWarps % G == 0, "groups of whole float4s");
};

// Issue the cp.async copies of input channels c0 .. c0 + nc - 1 into one
// stage: the chunk's packed weights, then its patch.
template <class Geo>
__device__ __forceinline__ void stage_chunk(float* st, const float* __restrict__ xb, const float* __restrict__ wp,
                                            int c0, int nc, int iy0, int ix0, int h, int w, long long hw) {
  const int tid = threadIdx.x;
  const float* wsrc = wp + static_cast<long long>(c0) * Geo::W_CH;
  for (int i = tid; i < nc * Geo::W_CH / 4; i += kThreads) cp_async<16>(st + 4 * i, wsrc + 4 * i, true);
  float* xs = st + Geo::W_FLOATS;
  constexpr int PATCH = Geo::IR * Geo::IC;
  for (int i = tid; i < nc * PATCH; i += kThreads) {
    const int ci = i / PATCH;
    const int rc = i - ci * PATCH;
    const int r = rc / Geo::IC;
    const int c = rc - r * Geo::IC;
    const int gy = iy0 + r, gx = ix0 + c;
    const bool valid = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float* src = valid ? xb + (c0 + ci) * hw + static_cast<long long>(gy) * w + gx : xb;
    const int col = Geo::STRIDE == 2 ? (c & 1) * Geo::ICP + (c >> 1) : c;
    cp_async<4>(xs + ci * Geo::X_CH + r * Geo::ROW + col, src, valid);
  }
}

template <int K, int S, bool DECONV, int COB, int G, int RY, int PX>
__global__ void __launch_bounds__(kThreads, 2)
head_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wpacked, const float* __restrict__ bias,
                     float* __restrict__ out, int cin, int h, int w, int cout, int ho, int wo, bool leaky) {
  using Geo = Geom<K, S, DECONV, COB, G, RY, PX>;
  constexpr int CO = Geo::CO, CK = Geo::CK, ROW = Geo::ROW;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // kStages x ([CK][TAPS][COB] weights, [CK][IR][ROW] patch)

  const int tid = threadIdx.x;
  const int tx = tid & 31, warp = tid >> 5;
  const int g = warp / Geo::WG;           // channel group (deconv: output phase)
  const int wy = warp - g * Geo::WG;      // the warp's rows within the tile: wy * RY ..
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * Geo::TY;  // (half-resolution, for the deconv) output tile origin
  const int col0 = blockIdx.x * Geo::TW;
  const int iy0 = DECONV ? row0 - 1 : row0 * S - K / 2;  // patch origin in the input
  const int ix0 = DECONV ? col0 - 1 : col0 * S - K / 2;
  const long long hw = static_cast<long long>(h) * w;
  const float* xb = x + static_cast<long long>(b) * cin * hw;

  // the thread's patch offset at tap (0, 0) of its first output, and its
  // first packed tap and weight column
  const int py = DECONV ? g >> 1 : 0, px = DECONV ? g & 1 : 0;
  const int x_off = (DECONV ? wy * RY + py : wy * RY * S) * ROW + tx + px;
  const int w_off = (DECONV ? g * 4 * COB : g * CO);

  float acc[RY][PX][CO];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[r][p][j] = 0.f;

  const int nchunks = (cin + CK - 1) / CK;
  // prologue: the first kStages - 1 chunks in flight
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks)
      stage_chunk<Geo>(smem + s * Geo::STAGE, xb, wpacked, s * CK, min(CK, cin - s * CK), iy0, ix0, h, w, hw);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = 0; k < nchunks; ++k) {
    const int next = k + kStages - 1;  // into the stage chunk k - 1 used, read by now
    if (next < nchunks)
      stage_chunk<Geo>(smem + (next % kStages) * Geo::STAGE, xb, wpacked, next * CK, min(CK, cin - next * CK),
                       iy0, ix0, h, w, hw);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk k has landed (this thread's copies)
    __syncthreads();               // ... and every thread's

    const float* ws = smem + (k % kStages) * Geo::STAGE + w_off;
    const float* xs = smem + (k % kStages) * Geo::STAGE + Geo::W_FLOATS + x_off;
    const int nc = min(CK, cin - k * CK);
#pragma unroll 1
    for (int ci = 0; ci < nc; ++ci) {
      const float* xc = xs + ci * Geo::X_CH;
      const float* wc = ws + ci * Geo::W_CH;
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float wv[CO];
          load_weights<CO>(wv, wc + (ky * K + kx) * COB);
          // stride 2: tap column kx of output column c is patch column 2c + kx,
          // in plane kx & 1 at position c + kx / 2
          const int dcol = S == 2 ? (kx & 1) * Geo::ICP + (kx >> 1) : kx;
#pragma unroll
          for (int r = 0; r < RY; ++r) {
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              const float xv = xc[(r * S + ky) * ROW + dcol + p * kTX];
#pragma unroll
              for (int j = 0; j < CO; ++j) acc[r][p][j] = fmaf(xv, wv[j], acc[r][p][j]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is read; the next iteration refills it
  }

  const long long howo = static_cast<long long>(ho) * wo;
  float* ob = out + static_cast<long long>(b) * cout * howo;
#pragma unroll
  for (int j = 0; j < CO; ++j) {
    const int co = DECONV ? j : g * CO + j;
    if (co >= cout) continue;
    const float bv = bias[co];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int m = row0 + wy * RY + r;  // (half-resolution) output row
      const int oy = DECONV ? 2 * m + py : m;
      if (oy >= ho) continue;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int n = col0 + tx + p * kTX;
        const int ox = DECONV ? 2 * n + px : n;
        if (ox < wo) ob[co * howo + static_cast<long long>(oy) * wo + ox] = epilogue(acc[r][p][j], bv, leaky);
      }
    }
  }
}

template <int K, int S, bool DECONV, int COB, int G, int RY, int PX>
int launch_f32(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
               int cout, int ho, int wo, bool leaky, cudaStream_t stream) {
  using Geo = Geom<K, S, DECONV, COB, G, RY, PX>;
  auto kernel = head_conv_f32_kernel<K, S, DECONV, COB, G, RY, PX>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Geo::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  // the grid walks the (half-resolution, for the deconv) output in tiles
  const int rows = DECONV ? h : ho, cols = DECONV ? w : wo;
  const dim3 grid((cols + Geo::TW - 1) / Geo::TW, (rows + Geo::TY - 1) / Geo::TY, n);
  kernel<<<grid, kThreads, Geo::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wpacked), static_cast<const float*>(bias),
      static_cast<float*>(out), cin, h, w, cout, ho, wo, leaky);
  return static_cast<int>(cudaGetLastError());
}

// Channel block and thread tile per Cout: 64 channels in four groups of 16
// (2 rows x 2 columns a thread); 16 channels in one group (1 row x 4
// columns); 4 channels (2 rows x 4 columns). The packed cout_pad is the
// block.
template <int K, int S>
int dispatch_conv_cout(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h,
                       int w, int cout, int ho, int wo, bool leaky, cudaStream_t stream) {
  if (cout <= 4)
    return launch_f32<K, S, false, 4, 1, 2, 4>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (cout <= 16)
    return launch_f32<K, S, false, 16, 1, 1, 4>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  return launch_f32<K, S, false, 64, 4, 2, 2>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
}

int dispatch_conv(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                  int cout, int k, int stride, bool leaky, cudaStream_t stream) {
  const int ho = (h + 2 * (k / 2) - k) / stride + 1;
  const int wo = (w + 2 * (k / 2) - k) / stride + 1;
  if (k == 3 && stride == 1)
    return dispatch_conv_cout<3, 1>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (k == 3 && stride == 2)
    return dispatch_conv_cout<3, 2>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (k == 7 && stride == 2)
    return dispatch_conv_cout<7, 2>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The deconv's four phases are its groups: a phase's 16 (or 4) channels a
// warp, 2 half-resolution rows x 2 columns (or 2 x 4) a thread.
int dispatch_deconv(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                    int cout, bool leaky, cudaStream_t stream) {
  if (cout <= 4)
    return launch_f32<2, 1, true, 4, 4, 2, 4>(x, wpacked, bias, out, n, cin, h, w, cout, 2 * h, 2 * w, leaky,
                                              stream);
  if (cout <= 16)
    return launch_f32<2, 1, true, 16, 4, 2, 2>(x, wpacked, bias, out, n, cin, h, w, cout, 2 * h, 2 * w, leaky,
                                               stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The bfloat16 route (head_conv_tc.cu): packed weights, tensor cores.
int head_conv_mma(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                  int cout, int k, int stride, bool leaky, cudaStream_t stream);
int head_deconv_mma(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                    int cout, bool leaky, cudaStream_t stream);

// k x k conv, pad k/2: (k, stride) in {(3, 1), (3, 2), (7, 2)}, 1 <= Cout <= 64.
// float32: weight packed as [cin][k*k][cout_pad]; bfloat16: as [k*k][cout_pad][cin_pad].
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
// float32: weight packed as [cin][16][cout_pad]; bfloat16: as [16][cout_pad][cin_pad].
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
