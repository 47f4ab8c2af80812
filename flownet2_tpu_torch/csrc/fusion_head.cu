// The fusion net's decoder head (K4) in one launch:
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
// weights); here the same function in the plain NCHW layout. Two routes
// behind one entry point: float32 runs the CUDA-core kernel below, bfloat16
// the tensor-core kernel of fusion_head_tc.cu. Both take their weights
// packed per call by ops/fusion_head.py::pack_fusion_head_weights.
//
// Layouts (contiguous): concat1 (N, 162, H2, W2), c0 (N, 64, H, W) with
// H = 2 H2, W = 2 W2; flow0 (N, 2, H, W), flow1 (N, 2, H2, W2); biases
// (Cout). One type for all, sums in float32. Each intermediate is rounded
// to that type once, after its bias (and leaky), as the layer-by-layer
// composition stores it, and set to zero outside the image before the next
// stage reads it, because each layer of the composition zero-pads its own
// input.
//
// Work and bound on the H100, at Sintel size (concat1 4x162x224x512, c0
// 4x64x448x1024): 125.8 GFLOP of useful multiply-adds (inter_conv1 42.8,
// deconv0 38.0, inter_conv0 43.3, the 2-channel layers 1.7) and about 786 MB
// of float32 in and out (393 MB in bfloat16). Float32: 1.878 ms at the
// 67 TFLOP/s CUDA-core peak, against 0.235 ms for the bytes: operations
// bind. Bfloat16: 0.127 ms at the 989 TFLOP/s tensor-core peak, the bytes
// 0.117 ms at 3.35 TB/s.
//
// Design. The first version of this kernel (16 x 32 tiles, one position
// x 8 channels a unit of work on the CUDA cores in both types, 137 KB of
// shared memory) reached 13% of the float32 bound; what held it, and what
// this design does about each:
//
// 1. No tensor cores. The bfloat16 route (fusion_head_tc.cu) runs the five
//    convolutions as implicit GEMMs on mma.sync m16n8k16; float32 stays
//    exact on the CUDA cores (no TF32: the plain version's meaning).
// 2. Inner loops bound by shared-memory loads. Each float32 stage gives a
//    thread a register tile, so one broadcast weight vector feeds every
//    position and one input value 8-16 FMAs: inter_conv1 a 2 x 2 block of
//    positions x 8 channels, whose 4 x 4 inputs of a channel serve all
//    nine taps (26 loads for 288 FMAs); deconv0 3 positions x 16; inter_conv0
//    5 x 8. The weights come packed [cin][tap][cout_pad]
//    (ops/head_conv.py::pack_head_weight_f32), a chunk one 16-byte run.
//    Every work loop is one layer's, with warp-uniform channel groups and
//    deconv phases, and every stage keeps all 16 warps busy (84-95% of the
//    thread slots hold a position).
// 3. Loads not overlapped. concat1 and c0 come through a two-stage
//    cp.async ring (6, 8 and 4 channels a stage, weights with them;
//    inter_conv1's window 16 bytes a copy), so the next chunk's copies fly
//    while the block computes the current one; the bfloat16 route copies
//    its chunks raw the same way and transposes them to channels innermost
//    in shared memory.
// 4. Halo recompute. A 32 x 32 flow0 tile: inter1 is computed on 22 x 22
//    half-resolution positions for a 16 x 16 flow1 tile (1.89x), upfeat and
//    upflow on 36 x 36 (1.27x), inter0 on 34 x 34 (1.13x): 1.43x of the
//    useful operations in all, against 1.67x for 16 x 32 tiles (2.41x,
//    1.41x, 1.20x). Sintel b4 has 1,792 tiles, 13.6 for each of the 132 SMs.
//
// Resources (-Xptxas -v for sm_90a): float32 512 threads, 224,000 bytes of
// shared memory (inter1, later inter0, 74 KB; upfeat and upflow 93 KB; the
// ring 46 KB; flow1 and the 2-channel layers' weights), 127 registers, one
// block an SM; bfloat16 512 threads, 213,504 bytes, 128 registers, no
// spills, one block an SM.

#include "common.cuh"
#include "fusion_head.cuh"

namespace fusion_head {

int launch_tc(const void* cat1, const void* c0, const void* const* weights, void* flow0, void* flow1, int n,
              int h2, int w2, cudaStream_t stream);

namespace {

// float32 channels a ring stage holds per stage type, and the weight floats
// of one input channel there (packed [cin][tap][cout_pad])
constexpr int CK_I1 = 6, CK_DC = 8, CK_I0 = 4;
constexpr int WCH_I1 = 9 * CI1, WCH_DC = 16 * CD, WCH_I0 = 9 * CI0;
constexpr int ST_I1 = CK_I1 * (WCH_I1 + XA_R * XA_C), ST_DC = CK_DC * (WCH_DC + XB_R * XB_C),
              ST_I0 = CK_I0 * (WCH_I0 + N_UP);
constexpr int STAGE = ST_I0 > ST_I1 ? (ST_I0 > ST_DC ? ST_I0 : ST_DC) : (ST_I1 > ST_DC ? ST_I1 : ST_DC);
// shared memory, in floats
constexpr int SZ_I = CI1 * N_I1 > CI0 * N_I0 ? CI1 * N_I1 : CI0 * N_I0;  // inter1, then inter0
constexpr int SZ_U = (CD + 2) * N_UP;                                     // upfeat, upflow
constexpr int SZ_F1 = 2 * N_F1;
constexpr int SZ_PF1 = CI1 * 9 * 4, SZ_PF0 = CI0 * 9 * 4, SZ_UPW = 2 * 16 * 4;
constexpr int OFF_U = SZ_I, OFF_F1 = OFF_U + SZ_U, OFF_RING = OFF_F1 + SZ_F1, OFF_PF1 = OFF_RING + 2 * STAGE;
constexpr int OFF_PF0 = OFF_PF1 + SZ_PF1, OFF_UPW = OFF_PF0 + SZ_PF0;
constexpr int SMEM_F32 = (OFF_UPW + SZ_UPW) * 4;
static_assert(SMEM_F32 <= 232448, "one block's shared memory");
static_assert(SZ_I % 4 == 0 && SZ_U % 4 == 0 && SZ_F1 % 4 == 0 && STAGE % 4 == 0 && SZ_PF1 % 4 == 0 &&
                  SZ_PF0 % 4 == 0, "16-byte alignment");
static_assert(C0 % CK_I0 == 0, "no inter_conv0 chunk mixes c0 with upfeat");

struct F32Args {
  const float *cat1, *c0;
  const float *w_i1, *b_i1, *w_pf1, *b_pf1, *w_dc, *b_dc, *w_up, *b_up, *w_i0, *b_i0, *w_pf0, *b_pf0;
  float *flow0, *flow1;
  int h2, w2;
};

// cp.async of input channels c0 .. c0 + nc - 1 into one ring stage: their
// packed weights (WCH floats a channel), then, where `window`, their WR x
// WC window at (gy0, gx0), zero outside the image; 16 bytes at a time where
// `vec` (gx0, WC and the width multiples of 4), else 4.
template <int CK, int WR, int WC, int WCH>
__device__ __forceinline__ void stage_chunk(float* st, const float* __restrict__ img, long long hw, int h, int w,
                                            const float* __restrict__ wp, int c0, int nc, int gy0, int gx0,
                                            bool window, bool vec = false) {
  const int tid = threadIdx.x;
  const float* wsrc = wp + static_cast<long long>(c0) * WCH;
  for (int i = tid; i < nc * WCH / 4; i += kThreads) cp_async<16>(st + 4 * i, wsrc + 4 * i, true);
  if (!window) return;
  float* xs = st + CK * WCH;
  if (vec) {
    static_assert(WC % 4 == 0, "whole 16-byte groups");
    for (int i = tid; i < nc * WR * WC / 4; i += kThreads) {
      const int ci = i / (WR * WC / 4), rc = i % (WR * WC / 4);
      const int gy = gy0 + rc / (WC / 4), gx = gx0 + 4 * (rc % (WC / 4));
      const bool valid = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const float* src = valid ? img + (c0 + ci) * hw + static_cast<long long>(gy) * w + gx : img;
      cp_async<16>(xs + 4 * i, src, valid);
    }
    return;
  }
  for (int i = tid; i < nc * WR * WC; i += kThreads) {
    const int ci = i / (WR * WC), rc = i % (WR * WC);
    const int gy = gy0 + rc / WC, gx = gx0 + rc % WC;
    const bool valid = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float* src = valid ? img + (c0 + ci) * hw + static_cast<long long>(gy) * w + gx : img;
    cp_async<4>(xs + i, src, valid);
  }
}

// A two-stage cp.async ring over `nchunks` chunks: stage(dst, k) starts
// chunk k's copies, compute(src, k) reads it once it has landed.
template <class Stage, class Compute>
__device__ __forceinline__ void ring(float* buf, int nchunks, Stage stage, Compute compute) {
  stage(buf, 0);
  cp_async_commit();
#pragma unroll 1
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage(buf + ((k + 1) & 1) * STAGE, k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    compute(buf + (k & 1) * STAGE, k);
    __syncthreads();
  }
}

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

__global__ void __launch_bounds__(kThreads, 1) fusion_head_f32_kernel(F32Args args) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_i = smem;                // inter1 [CI1][N_I1], then inter0 [CI0][N_I0]
  float* s_u = smem + OFF_U;        // upfeat [CD][N_UP], then upflow [2][N_UP]
  float* s_f1 = smem + OFF_F1;      // flow1 [2][N_F1]
  float* s_ring = smem + OFF_RING;  // two stages
  float* s_pf1 = smem + OFF_PF1;    // [CI1][9][4]
  float* s_pf0 = smem + OFF_PF0;    // [CI0][9][4]
  float* s_upw = smem + OFF_UPW;    // [2][16][4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h2 = args.h2, w2 = args.w2, h = 2 * h2, w = 2 * w2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW, m0 = y0 / 2, n0 = x0 / 2;
  const long long hw2 = static_cast<long long>(h2) * w2, hw = static_cast<long long>(h) * w;
  const float* catb = args.cat1 + static_cast<long long>(b) * C1 * hw2;
  const float* c0b = args.c0 + static_cast<long long>(b) * C0 * hw;

  // the 2-channel layers' weights, once (in the ring's first group)
  for (int i = tid; i < SZ_PF1 / 4; i += kThreads) cp_async<16>(s_pf1 + 4 * i, args.w_pf1 + 4 * i, true);
  for (int i = tid; i < SZ_PF0 / 4; i += kThreads) cp_async<16>(s_pf0 + 4 * i, args.w_pf0 + 4 * i, true);
  for (int i = tid; i < SZ_UPW / 4; i += kThreads) cp_async<16>(s_upw + 4 * i, args.w_up + 4 * i, true);

  // --- inter1 on I1 (22 x 22, origin -3) over concat1 (window origin -4):
  // 4 channel groups of 8 x 4 warps; a 2 x 2 block of positions a thread,
  // whose 4 x 4 inputs of a channel serve all nine taps
  {
    constexpr int CO = 8, NB = (I1_R / 2) * (I1_C / 2);
    static_assert(I1_R % 2 == 0 && I1_C % 2 == 0 && XA_C % 2 == 0 && NB <= 128, "2 x 2 blocks, 128 a group");
    const int cg = warp >> 2, blk = (warp & 3) * 32 + lane;
    const bool active = blk < NB;
    const int r0 = active ? 2 * (blk / (I1_C / 2)) : 0, c0 = active ? 2 * (blk % (I1_C / 2)) : 0;
    float acc[4][CO] = {};
    ring(s_ring, (C1 + CK_I1 - 1) / CK_I1,
         [&](float* st, int k) {
           stage_chunk<CK_I1, XA_R, XA_C, WCH_I1>(st, catb, hw2, h2, w2, args.w_i1, k * CK_I1,
                                                  min(CK_I1, C1 - k * CK_I1), m0 - 4, n0 - 4, true, (w2 & 3) == 0);
         },
         [&](const float* st, int k) {
           const int nc = min(CK_I1, C1 - k * CK_I1);
#pragma unroll 2
           for (int ci = 0; ci < nc; ++ci) {
             const float* xc = st + CK_I1 * WCH_I1 + ci * XA_R * XA_C + r0 * XA_C + c0;
             const float* wc = st + ci * WCH_I1 + cg * CO;
             float xv[4][4];
#pragma unroll
             for (int rr = 0; rr < 4; ++rr) {
               const float2 a = *reinterpret_cast<const float2*>(xc + rr * XA_C);
               const float2 b = *reinterpret_cast<const float2*>(xc + rr * XA_C + 2);
               xv[rr][0] = a.x;
               xv[rr][1] = a.y;
               xv[rr][2] = b.x;
               xv[rr][3] = b.y;
             }
#pragma unroll
             for (int dy = 0; dy < 3; ++dy)
#pragma unroll
               for (int dx = 0; dx < 3; ++dx) {
                 float wv[CO];
                 load_weights<CO>(wv, wc + (dy * 3 + dx) * CI1);
#pragma unroll
                 for (int t = 0; t < 4; ++t)
#pragma unroll
                   for (int j = 0; j < CO; ++j) acc[t][j] = fmaf(xv[(t >> 1) + dy][(t & 1) + dx], wv[j], acc[t][j]);
               }
           }
         });
    if (active) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int p = (r0 + (t >> 1)) * I1_C + c0 + (t & 1);
        const int gy = m0 - 3 + r0 + (t >> 1), gx = n0 - 3 + c0 + (t & 1);
        const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
#pragma unroll
        for (int j = 0; j < CO; ++j) {
          const int co = cg * CO + j;
          s_i[co * N_I1 + p] = in ? acc[t][j] + args.b_i1[co] : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // --- flow1 on F1 (20 x 20, origin -2) from inter1 (origin -3)
  if (tid < N_F1) {
    const int r = tid / F1_C, c = tid % F1_C;
    const int gy = m0 - 2 + r, gx = n0 - 2 + c;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < CI1; ++ci) {
      const float* s = s_i + ci * N_I1 + r * I1_C + c;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float xv = s[(t / 3) * I1_C + t % 3];
        const float2 wv = *reinterpret_cast<const float2*>(s_pf1 + (ci * 9 + t) * 4);
        s0 = fmaf(xv, wv.x, s0);
        s1 = fmaf(xv, wv.y, s1);
      }
    }
    const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
    const float v0 = in ? s0 + args.b_pf1[0] : 0.f, v1 = in ? s1 + args.b_pf1[1] : 0.f;
    s_f1[tid] = v0;
    s_f1[N_F1 + tid] = v1;
    if (in && r >= 2 && r < 2 + HT && c >= 2 && c < 2 + WT) {
      float* o = args.flow1 + static_cast<long long>(b) * 2 * hw2 + static_cast<long long>(gy) * w2 + gx;
      o[0] = v0;
      o[hw2] = v1;
    }
  }

  // --- upfeat on UP (36 x 36, origin -2): deconv0's four phases over
  // concat1 (window origin -2); 4 warps a phase, 3 positions a thread
  {
    constexpr int P = 3, CO = CD;
    const int phase = warp >> 2, slot = warp & 3;
    const int py = phase >> 1, px = phase & 1;
    int pos[P], base[P];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      pos[t] = slot * 32 * P + t * 32 + lane;
      const int pc = pos[t] < N_PH ? pos[t] : 0;
      base[t] = (pc / PH_C + py) * XB_C + pc % PH_C + px;
    }
    float acc[P][CO] = {};
    ring(s_ring, (C1 + CK_DC - 1) / CK_DC,
         [&](float* st, int k) {
           stage_chunk<CK_DC, XB_R, XB_C, WCH_DC>(st, catb, hw2, h2, w2, args.w_dc, k * CK_DC,
                                                  min(CK_DC, C1 - k * CK_DC), m0 - 2, n0 - 2, true);
         },
         [&](const float* st, int k) {
           const int nc = min(CK_DC, C1 - k * CK_DC);
#pragma unroll 2
           for (int ci = 0; ci < nc; ++ci) {
             const float* xc = st + CK_DC * WCH_DC + ci * XB_R * XB_C;
             const float* wc = st + ci * WCH_DC + phase * 4 * CD;
#pragma unroll
             for (int ta = 0; ta < 2; ++ta)
#pragma unroll
               for (int tb = 0; tb < 2; ++tb) {
                 float wv[CO];
                 load_weights<CO>(wv, wc + (ta * 2 + tb) * CD);
#pragma unroll
                 for (int t = 0; t < P; ++t) {
                   const float xv = xc[base[t] + ta * XB_C + tb];
#pragma unroll
                   for (int j = 0; j < CO; ++j) acc[t][j] = fmaf(xv, wv[j], acc[t][j]);
                 }
               }
           }
         });
#pragma unroll
    for (int t = 0; t < P; ++t) {
      if (pos[t] >= N_PH) continue;
      const int rr = 2 * (pos[t] / PH_C) + py, cc = 2 * (pos[t] % PH_C) + px;
      const int gy = y0 - 2 + rr, gx = x0 - 2 + cc;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
      for (int j = 0; j < CO; ++j) {
        const float v = acc[t][j] + args.b_dc[j];
        s_u[j * N_UP + rr * UP_C + cc] = in ? (v < 0.f ? v * 0.1f : v) : 0.f;
      }
    }
  }

  // --- upflow on UP from flow1 (origin -2), as channels 16-17 of s_u
  for (int pos = tid; pos < N_UP; pos += kThreads) {
    const int rr = pos / UP_C, cc = pos % UP_C;
    const int gy = y0 - 2 + rr, gx = x0 - 2 + cc;
    const int py = rr & 1, px = cc & 1;
    const int fr = (rr >> 1) + py, fc = (cc >> 1) + px;  // flow1 at tap (0, 0)
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
#pragma unroll
      for (int ta = 0; ta < 2; ++ta)
#pragma unroll
        for (int tb = 0; tb < 2; ++tb) {
          const int tap = (py * 2 + px) * 4 + ta * 2 + tb;
          const float xv = s_f1[ci * N_F1 + (fr + ta) * F1_C + fc + tb];
          s0 = fmaf(xv, s_upw[(ci * 16 + tap) * 4], s0);
          s1 = fmaf(xv, s_upw[(ci * 16 + tap) * 4 + 1], s1);
        }
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s_u[CD * N_UP + pos] = in ? s0 + args.b_up[0] : 0.f;
    s_u[(CD + 1) * N_UP + pos] = in ? s1 + args.b_up[1] : 0.f;
  }
  __syncthreads();

  // --- inter0 on I0 (34 x 34, origin -1) over [c0 | upfeat | upflow]
  // (origin -2): c0 chunks through the ring, upfeat and upflow from s_u;
  // 2 channel groups of 8 x 8 warps, 5 positions a thread
  {
    constexpr int P = 5, CO = 8;
    constexpr int CIN = C0 + CD + 2;
    const int cg = warp >> 3, slot = warp & 7;
    int pos[P], base[P];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      pos[t] = slot * 32 * P + t * 32 + lane;
      const int pc = pos[t] < N_I0 ? pos[t] : 0;
      base[t] = (pc / I0_C) * UP_C + pc % I0_C;
    }
    float acc[P][CO] = {};
    ring(s_ring, (CIN + CK_I0 - 1) / CK_I0,
         [&](float* st, int k) {
           stage_chunk<CK_I0, UP_R, UP_C, WCH_I0>(st, c0b, hw, h, w, args.w_i0, k * CK_I0,
                                                  min(CK_I0, CIN - k * CK_I0), y0 - 2, x0 - 2, k * CK_I0 < C0);
         },
         [&](const float* st, int k) {
           const int nc = min(CK_I0, CIN - k * CK_I0);
           const float* xsrc = k * CK_I0 < C0 ? st + CK_I0 * WCH_I0 : s_u + (k * CK_I0 - C0) * N_UP;
#pragma unroll 2
           for (int ci = 0; ci < nc; ++ci) {
             const float* xc = xsrc + ci * N_UP;
             const float* wc = st + ci * WCH_I0 + cg * CO;
#pragma unroll
             for (int dy = 0; dy < 3; ++dy)
#pragma unroll
               for (int dx = 0; dx < 3; ++dx) {
                 float wv[CO];
                 load_weights<CO>(wv, wc + (dy * 3 + dx) * CI0);
#pragma unroll
                 for (int t = 0; t < P; ++t) {
                   const float xv = xc[base[t] + dy * UP_C + dx];
#pragma unroll
                   for (int j = 0; j < CO; ++j) acc[t][j] = fmaf(xv, wv[j], acc[t][j]);
                 }
               }
           }
         });
#pragma unroll
    for (int t = 0; t < P; ++t) {
      if (pos[t] >= N_I0) continue;
      const int gy = y0 - 1 + pos[t] / I0_C, gx = x0 - 1 + pos[t] % I0_C;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
      for (int j = 0; j < CO; ++j) {
        const int co = cg * CO + j;
        s_i[co * N_I0 + pos[t]] = in ? acc[t][j] + args.b_i0[co] : 0.f;
      }
    }
  }
  __syncthreads();

  // --- flow0 on the tile, from inter0 (origin -1): 2 positions a thread
#pragma unroll 1
  for (int pos = tid; pos < TH * TW; pos += kThreads) {
    const int r = pos / TW, c = pos % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
    for (int ci = 0; ci < CI0; ++ci) {
      const float* s = s_i + ci * N_I0 + r * I0_C + c;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float xv = s[(t / 3) * I0_C + t % 3];
        const float2 wv = *reinterpret_cast<const float2*>(s_pf0 + (ci * 9 + t) * 4);
        s0 = fmaf(xv, wv.x, s0);
        s1 = fmaf(xv, wv.y, s1);
      }
    }
    float* o = args.flow0 + static_cast<long long>(b) * 2 * hw + static_cast<long long>(gy) * w + gx;
    o[0] = s0 + args.b_pf0[0];
    o[hw] = s1 + args.b_pf0[1];
  }
}

int launch_f32(const void* cat1, const void* c0, const void* const* wt, void* flow0, void* flow1, int n, int h2,
               int w2, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(fusion_head_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F32);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto f = [&](int i) { return static_cast<const float*>(wt[i]); };
  const F32Args args{static_cast<const float*>(cat1), static_cast<const float*>(c0), f(0), f(1), f(2), f(3), f(4),
                     f(5), f(6), f(7), f(8), f(9), f(10), f(11), static_cast<float*>(flow0),
                     static_cast<float*>(flow1), h2, w2};
  const dim3 grid((2 * w2 + TW - 1) / TW, (2 * h2 + TH - 1) / TH, n);
  fusion_head_f32_kernel<<<grid, kThreads, SMEM_F32, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fusion_head

// weights: weight and bias of inter_conv1, predict_flow1, deconv0,
// upsample_flow1to0, inter_conv0, predict_flow0, the weights packed by
// ops/fusion_head.py::pack_fusion_head_weights for the call's dtype.
extern "C" int fn2_fusion_head(const void* cat1, const void* c0, const void* w_i1, const void* b_i1,
                               const void* w_pf1, const void* b_pf1, const void* w_dc, const void* b_dc,
                               const void* w_up, const void* b_up, const void* w_i0, const void* b_i0,
                               const void* w_pf0, const void* b_pf0, void* flow0, void* flow1, int n,
                               int h2, int w2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const void* const wt[12] = {w_i1, b_i1, w_pf1, b_pf1, w_dc, b_dc, w_up, b_up, w_i0, b_i0, w_pf0, b_pf0};
  if (dtype == kFloat32) return fusion_head::launch_f32(cat1, c0, wt, flow0, flow1, n, h2, w2, s);
  if (dtype == kBFloat16) return fusion_head::launch_tc(cat1, c0, wt, flow0, flow1, n, h2, w2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
