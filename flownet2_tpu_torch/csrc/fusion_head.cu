// The fusion net's decoder head in one launch:
//
//   inter1  = conv3x3(concat1)                   162 -> 32  (inter_conv1)
//   flow1   = conv3x3(inter1)                     32 ->  2  (predict_flow1)
//   upfeat  = leaky(deconv4x2(concat1))          162 -> 16  (deconv0)
//   upflow  = deconv4x2(flow1)                     2 ->  2  (upsample_flow1to0)
//   inter0  = conv3x3([c0 | upfeat | upflow])     82 -> 16  (inter_conv0)
//   flow0   = conv3x3(inter0)                     16 ->  2  (predict_flow0)
//
// Replaces flownet2_tpu/ops/pallas/fusion_head.py::fusion_head_pallas (the
// TPU kernel works on the space-to-depth layout with lane-padded merged
// weights); here the same function in the plain NCHW layout.
//
// Layouts (contiguous): concat1 (N, 162, H2, W2), c0 (N, 64, H, W) with
// H = 2 H2, W = 2 W2; conv weights OIHW, deconv weights (Cin, Cout, 4, 4);
// flow0 (N, 2, H, W), flow1 (N, 2, H2, W2). float32 or bfloat16, one type
// for all; sums in float32. Each intermediate is rounded to that type once,
// after its bias (and leaky), as the layer-by-layer composition stores it.
//
// Design. One block of 512 threads owns a 16 x 32 tile of flow0 (and the
// 8 x 16 tile of flow1 under it) and recomputes the halo the chain needs:
// concat1 on a 16 x 24 half-resolution window, inter1 on 14 x 22, flow1 on
// 12 x 20, upfeat and upflow on 20 x 36 full-resolution pixels, inter0 on
// 18 x 34. Every intermediate stays in shared memory (137 KB in all):
// inter1's and inter0's sums share one buffer. Each intermediate is set to
// zero outside the image before the next stage reads it, because each layer
// of the composition zero-pads its own input (a chained kernel that read the
// previous stage's values past the border would be wrong there only). The
// two consumers of concat1 (inter_conv1 and deconv0) and the c0 part of
// inter_conv0 stream their inputs in chunks of 8 channels, with the chunk's
// weights staged as [ci][tap][cout]; a unit of work is one position and 8
// output channels, summed in registers across the chunk.
//
// Bound on the H100: float32 FMAs. At Sintel size (1024x448, batch 4) the
// head does about 92 GFLOP (1.4 ms at the 67 TFLOP/s float32 peak) and must
// move about 0.8 GB (0.23 ms at 3.35 TB/s); the halo recompute adds about
// 40% to the FLOPs.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int TH = 16, TW = 32;          // flow0 tile (full resolution)
constexpr int HT = TH / 2, WT = TW / 2;  // flow1 tile (half resolution)
constexpr int C1 = 162, CI1 = 32, CD = 16, C0 = 64, CI0 = 16, CAT0 = C0 + CD + 2;
constexpr int CK = 8;  // channels per streamed chunk

// regions: rows x cols, origin relative to the tile's (M0, N0) or (y0, x0)
constexpr int CAT_R = HT + 8, CAT_C = WT + 8;  // concat1, origin -4
constexpr int I1_R = HT + 6, I1_C = WT + 6;    // inter1, origin -3
constexpr int F1_R = HT + 4, F1_C = WT + 4;    // flow1, origin -2
constexpr int UP_R = TH + 4, UP_C = TW + 4;    // upfeat, upflow, c0 window, origin -2
constexpr int I0_R = TH + 2, I0_C = TW + 2;    // inter0, origin -1
constexpr int N_I1 = I1_R * I1_C, N_F1 = F1_R * F1_C, N_UP = UP_R * UP_C, N_I0 = I0_R * I0_C;

// shared memory, in floats
constexpr int SZ_ACC = (CI1 * N_I1 > CI0 * N_I0) ? CI1 * N_I1 : CI0 * N_I0;  // inter1, then inter0
constexpr int SZ_UP = (CD + 2) * N_UP;                                        // upfeat then upflow
constexpr int SZ_F1 = 2 * N_F1;
constexpr int SZ_X = (CK * CAT_R * CAT_C > CK * N_UP) ? CK * CAT_R * CAT_C : CK * N_UP;
constexpr int SZ_W = CK * 9 * CI1 + CK * 16 * CD;  // >= (CD + 2) * 9 * CI0 as well
constexpr int SZ_S = CI1 * 9 * 2 + 2 * 16 * 2 + CI0 * 9 * 2;  // predict_flow1, upsample, predict_flow0
constexpr int SMEM_FLOATS = SZ_ACC + SZ_UP + SZ_F1 + SZ_X + SZ_W + SZ_S;
static_assert(SZ_W >= (CD + 2) * 9 * CI0, "inter_conv0 tail weights must fit");
static_assert(SZ_ACC % 4 == 0 && SZ_UP % 4 == 0 && SZ_F1 % 4 == 0 && SZ_X % 4 == 0, "float4 alignment");

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ void load8(float (&wv)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
  wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
}

// floor division by 2 and parity, for coordinates that may be negative
__device__ __forceinline__ int half_floor(int v) { return (v - (v & 1)) / 2; }

struct Weights {
  const void *w_i1, *b_i1, *w_pf1, *b_pf1, *w_dc, *b_dc, *w_up, *b_up, *w_i0, *b_i0, *w_pf0, *b_pf0;
};

template <typename T>
__device__ __forceinline__ float ld(const void* p, long long i) {
  return to_f32(static_cast<const T*>(p)[i]);
}

// One 3x3 conv's sums over `nch` source channels into acc [CI0][N_I0]:
// src channel ci at src + ci * src_stride, rows of UP_C; weights [ci][tap][CI0].
__device__ __forceinline__ void accum_inter0(float* acc, const float* src, int src_stride, int nch,
                                             const float* w) {
  for (int u = threadIdx.x; u < 2 * N_I0; u += kThreads) {
    const int g = u / N_I0, pos = u % N_I0;
    const int r = pos / I0_C, c = pos % I0_C;
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = acc[(g * 8 + j) * N_I0 + pos];
    for (int ci = 0; ci < nch; ++ci) {
      const float* s = src + ci * src_stride + r * UP_C + c;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float wv[8];
          load8(wv, w + (ci * 9 + dy * 3 + dx) * CI0 + g * 8);
          const float xv = s[dy * UP_C + dx];
#pragma unroll
          for (int j = 0; j < 8; ++j) a[j] = fmaf(xv, wv[j], a[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[(g * 8 + j) * N_I0 + pos] = a[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fusion_head_kernel(const T* __restrict__ cat1, const T* __restrict__ c0, Weights wt,
                   T* __restrict__ flow0, T* __restrict__ flow1, int h2, int w2) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);  // inter1 [CI1][N_I1], later inter0 [CI0][N_I0]
  float* up = acc + SZ_ACC;                      // upfeat [CD][N_UP], then upflow [2][N_UP]
  float* upflow = up + CD * N_UP;
  float* f1 = up + SZ_UP;                        // flow1 [2][N_F1]
  float* xs = f1 + SZ_F1;                        // streamed input chunk
  float* ws = xs + SZ_X;                         // streamed weights
  float* w_pf1 = ws + SZ_W;                      // [32][9][2]
  float* w_up = w_pf1 + CI1 * 9 * 2;             // [2][16][2]
  float* w_pf0 = w_up + 2 * 16 * 2;              // [16][9][2]

  const int tid = threadIdx.x;
  const int h = 2 * h2, w = 2 * w2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int m0 = y0 / 2, n0 = x0 / 2;
  const long long hw2 = static_cast<long long>(h2) * w2, hw = static_cast<long long>(h) * w;
  const T* catb = cat1 + static_cast<long long>(b) * C1 * hw2;
  const T* c0b = c0 + static_cast<long long>(b) * C0 * hw;

  // --- stage A: inter1 sums on I1 and upfeat sums on UP, streaming concat1
  for (int i = tid; i < CI1 * N_I1; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < CD * N_UP; i += kThreads) up[i] = 0.f;
  float* w_i1s = ws;                 // [CK][9][CI1]
  float* w_dcs = ws + CK * 9 * CI1;  // [CK][16][CD]
  for (int cc = 0; cc < C1; cc += CK) {
    __syncthreads();
    for (int i = tid; i < CK * CAT_R * CAT_C; i += kThreads) {
      const int ci = i / (CAT_R * CAT_C), r = (i / CAT_C) % CAT_R, c = i % CAT_C;
      const int gy = m0 - 4 + r, gx = n0 - 4 + c;
      float v = 0.f;
      if (cc + ci < C1 && gy >= 0 && gy < h2 && gx >= 0 && gx < w2)
        v = to_f32(catb[(cc + ci) * hw2 + static_cast<long long>(gy) * w2 + gx]);
      xs[i] = v;
    }
    for (int i = tid; i < CK * 9 * CI1; i += kThreads) {
      const int co = i % CI1, tap = (i / CI1) % 9, ci = i / (9 * CI1);
      w_i1s[i] = cc + ci < C1 ? ld<T>(wt.w_i1, (co * C1 + cc + ci) * 9 + tap) : 0.f;
    }
    for (int i = tid; i < CK * 16 * CD; i += kThreads) {
      const int co = i % CD, tap = (i / CD) % 16, ci = i / (16 * CD);
      w_dcs[i] = cc + ci < C1 ? ld<T>(wt.w_dc, ((cc + ci) * CD + co) * 16 + tap) : 0.f;
    }
    __syncthreads();
    for (int u = tid; u < 4 * N_I1 + 2 * N_UP; u += kThreads) {
      float a[8];
      if (u < 4 * N_I1) {
        const int g = u / N_I1, pos = u % N_I1;
        const int r = pos / I1_C, c = pos % I1_C;
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = acc[(g * 8 + j) * N_I1 + pos];
        for (int ci = 0; ci < CK; ++ci) {
          const float* s = xs + ci * CAT_R * CAT_C + r * CAT_C + c;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              float wv[8];
              load8(wv, w_i1s + (ci * 9 + dy * 3 + dx) * CI1 + g * 8);
              const float xv = s[dy * CAT_C + dx];
#pragma unroll
              for (int j = 0; j < 8; ++j) a[j] = fmaf(xv, wv[j], a[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[(g * 8 + j) * N_I1 + pos] = a[j];
      } else {
        const int v = u - 4 * N_I1;
        const int g = v / N_UP, pos = v % N_UP;
        const int oy = y0 - 2 + pos / UP_C, ox = x0 - 2 + pos % UP_C;
        const int py = oy & 1, px = ox & 1;
        // input (m - 1 + py + a, n - 1 + px + b) in the window at origin (m0 - 4, n0 - 4)
        const int r = half_floor(oy) + py + 3 - m0, c = half_floor(ox) + px + 3 - n0;
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = up[(g * 8 + j) * N_UP + pos];
        for (int ci = 0; ci < CK; ++ci) {
          const float* s = xs + ci * CAT_R * CAT_C + r * CAT_C + c;
#pragma unroll
          for (int ta = 0; ta < 2; ++ta)
#pragma unroll
            for (int tb = 0; tb < 2; ++tb) {
              float wv[8];
              const int tap = (3 - py - 2 * ta) * 4 + (3 - px - 2 * tb);
              load8(wv, w_dcs + (ci * 16 + tap) * CD + g * 8);
              const float xv = s[ta * CAT_C + tb];
#pragma unroll
              for (int j = 0; j < 8; ++j) a[j] = fmaf(xv, wv[j], a[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) up[(g * 8 + j) * N_UP + pos] = a[j];
      }
    }
  }
  __syncthreads();

  // bias, leaky (upfeat), rounding, zero outside the image; the small weights
  for (int i = tid; i < CI1 * N_I1; i += kThreads) {
    const int co = i / N_I1, pos = i % N_I1;
    const int gy = m0 - 3 + pos / I1_C, gx = n0 - 3 + pos % I1_C;
    const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
    acc[i] = in ? round_to<T>(acc[i] + ld<T>(wt.b_i1, co)) : 0.f;
  }
  for (int i = tid; i < CD * N_UP; i += kThreads) {
    const int co = i / N_UP, pos = i % N_UP;
    const int gy = y0 - 2 + pos / UP_C, gx = x0 - 2 + pos % UP_C;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    float v = up[i] + ld<T>(wt.b_dc, co);
    v = v < 0.f ? v * 0.1f : v;
    up[i] = in ? round_to<T>(v) : 0.f;
  }
  for (int i = tid; i < CI1 * 9 * 2; i += kThreads) {
    const int co = i % 2, tap = (i / 2) % 9, ci = i / 18;
    w_pf1[i] = ld<T>(wt.w_pf1, (co * CI1 + ci) * 9 + tap);
  }
  for (int i = tid; i < 2 * 16 * 2; i += kThreads) {
    const int co = i % 2, tap = (i / 2) % 16, ci = i / 32;
    w_up[i] = ld<T>(wt.w_up, (ci * 2 + co) * 16 + tap);
  }
  for (int i = tid; i < CI0 * 9 * 2; i += kThreads) {
    const int co = i % 2, tap = (i / 2) % 9, ci = i / 18;
    w_pf0[i] = ld<T>(wt.w_pf0, (co * CI0 + ci) * 9 + tap);
  }
  __syncthreads();

  // --- stage B: flow1 on F1 (origin -2), from inter1 (origin -3)
  for (int pos = tid; pos < N_F1; pos += kThreads) {
    const int r = pos / F1_C, c = pos % F1_C;
    const int gy = m0 - 2 + r, gx = n0 - 2 + c;
    float s0 = 0.f, s1 = 0.f;
    for (int ci = 0; ci < CI1; ++ci) {
      const float* s = acc + ci * N_I1 + r * I1_C + c;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float xv = s[(t / 3) * I1_C + t % 3];
        s0 = fmaf(xv, w_pf1[(ci * 9 + t) * 2], s0);
        s1 = fmaf(xv, w_pf1[(ci * 9 + t) * 2 + 1], s1);
      }
    }
    const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
    const float v0 = in ? round_to<T>(s0 + ld<T>(wt.b_pf1, 0)) : 0.f;
    const float v1 = in ? round_to<T>(s1 + ld<T>(wt.b_pf1, 1)) : 0.f;
    f1[pos] = v0;
    f1[N_F1 + pos] = v1;
    if (in && r >= 2 && r < 2 + HT && c >= 2 && c < 2 + WT) {
      T* o = flow1 + static_cast<long long>(b) * 2 * hw2 + static_cast<long long>(gy) * w2 + gx;
      o[0] = from_f32<T>(v0);
      o[hw2] = from_f32<T>(v1);
    }
  }
  __syncthreads();

  // --- stage C: upflow on UP from flow1 (origin -2); inter0's sums start at 0
  for (int pos = tid; pos < N_UP; pos += kThreads) {
    const int oy = y0 - 2 + pos / UP_C, ox = x0 - 2 + pos % UP_C;
    const int py = oy & 1, px = ox & 1;
    const int r = half_floor(oy) + py + 1 - m0, c = half_floor(ox) + px + 1 - n0;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
#pragma unroll
      for (int ta = 0; ta < 2; ++ta)
#pragma unroll
        for (int tb = 0; tb < 2; ++tb) {
          const int tap = (3 - py - 2 * ta) * 4 + (3 - px - 2 * tb);
          const float xv = f1[ci * N_F1 + (r + ta) * F1_C + c + tb];
          s0 = fmaf(xv, w_up[(ci * 16 + tap) * 2], s0);
          s1 = fmaf(xv, w_up[(ci * 16 + tap) * 2 + 1], s1);
        }
    const bool in = oy >= 0 && oy < h && ox >= 0 && ox < w;
    upflow[pos] = in ? round_to<T>(s0 + ld<T>(wt.b_up, 0)) : 0.f;
    upflow[N_UP + pos] = in ? round_to<T>(s1 + ld<T>(wt.b_up, 1)) : 0.f;
  }
  for (int i = tid; i < CI0 * N_I0; i += kThreads) acc[i] = 0.f;

  // --- stage D: inter0 on I0 (origin -1) over [c0 | upfeat | upflow] (origin -2)
  for (int cc = 0; cc < C0; cc += CK) {
    __syncthreads();
    for (int i = tid; i < CK * N_UP; i += kThreads) {
      const int ci = i / N_UP, pos = i % N_UP;
      const int gy = y0 - 2 + pos / UP_C, gx = x0 - 2 + pos % UP_C;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = to_f32(c0b[(cc + ci) * hw + static_cast<long long>(gy) * w + gx]);
      xs[i] = v;
    }
    for (int i = tid; i < CK * 9 * CI0; i += kThreads) {
      const int co = i % CI0, tap = (i / CI0) % 9, ci = i / (9 * CI0);
      ws[i] = ld<T>(wt.w_i0, (co * CAT0 + cc + ci) * 9 + tap);
    }
    __syncthreads();
    accum_inter0(acc, xs, N_UP, CK, ws);
  }
  __syncthreads();
  for (int i = tid; i < (CD + 2) * 9 * CI0; i += kThreads) {
    const int co = i % CI0, tap = (i / CI0) % 9, ci = i / (9 * CI0);
    ws[i] = ld<T>(wt.w_i0, (co * CAT0 + C0 + ci) * 9 + tap);
  }
  __syncthreads();
  accum_inter0(acc, up, N_UP, CD + 2, ws);
  __syncthreads();
  for (int i = tid; i < CI0 * N_I0; i += kThreads) {
    const int co = i / N_I0, pos = i % N_I0;
    const int gy = y0 - 1 + pos / I0_C, gx = x0 - 1 + pos % I0_C;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    acc[i] = in ? round_to<T>(acc[i] + ld<T>(wt.b_i0, co)) : 0.f;
  }
  __syncthreads();

  // --- stage E: flow0 on the tile, from inter0 (origin -1)
  for (int pos = tid; pos < TH * TW; pos += kThreads) {
    const int r = pos / TW, c = pos % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float s0 = 0.f, s1 = 0.f;
    for (int ci = 0; ci < CI0; ++ci) {
      const float* s = acc + ci * N_I0 + r * I0_C + c;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float xv = s[(t / 3) * I0_C + t % 3];
        s0 = fmaf(xv, w_pf0[(ci * 9 + t) * 2], s0);
        s1 = fmaf(xv, w_pf0[(ci * 9 + t) * 2 + 1], s1);
      }
    }
    T* o = flow0 + static_cast<long long>(b) * 2 * hw + static_cast<long long>(gy) * w + gx;
    o[0] = from_f32<T>(s0 + ld<T>(wt.b_pf0, 0));
    o[hw] = from_f32<T>(s1 + ld<T>(wt.b_pf0, 1));
  }
}

template <typename T>
int launch(const void* cat1, const void* c0, const Weights& wt, void* flow0, void* flow1, int n, int h2,
           int w2, cudaStream_t stream) {
  constexpr size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fusion_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((2 * w2 + TW - 1) / TW, (2 * h2 + TH - 1) / TH, n);
  fusion_head_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(cat1), static_cast<const T*>(c0), wt, static_cast<T*>(flow0),
      static_cast<T*>(flow1), h2, w2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fn2_fusion_head(const void* cat1, const void* c0, const void* w_i1, const void* b_i1,
                               const void* w_pf1, const void* b_pf1, const void* w_dc, const void* b_dc,
                               const void* w_up, const void* b_up, const void* w_i0, const void* b_i0,
                               const void* w_pf0, const void* b_pf0, void* flow0, void* flow1, int n,
                               int h2, int w2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Weights wt{w_i1, b_i1, w_pf1, b_pf1, w_dc, b_dc, w_up, b_up, w_i0, b_i0, w_pf0, b_pf0};
  if (dtype == kFloat32) return launch<float>(cat1, c0, wt, flow0, flow1, n, h2, w2, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(cat1, c0, wt, flow0, flow1, n, h2, w2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
