// The bfloat16 route of the fused fusion-net decoder head (K4) on the
// tensor cores. fusion_head.cu's entry point sends bfloat16 calls here; its
// CUDA-core kernel keeps the float32 route. Both routes share the tile and
// its halo (fusion_head.cuh) and compute, per block, the six layers
//
//   inter1  = conv3x3(concat1)                   162 -> 32  (inter_conv1)
//   flow1   = conv3x3(inter1)                     32 ->  2  (predict_flow1)
//   upfeat  = leaky(deconv4x2(concat1))          162 -> 16  (deconv0)
//   upflow  = deconv4x2(flow1)                     2 ->  2  (upsample_flow1to0)
//   inter0  = conv3x3([c0 | upfeat | upflow])     82 -> 16  (inter_conv0)
//   flow0   = conv3x3(inter0)                     16 ->  2  (predict_flow0)
//
// Each of the five convolutions is an implicit GEMM on mma.sync.m16n8k16
// (bf16 in, float32 sums), in the pattern of head_conv_tc.cu: M = the
// positions of the layer's region in the tile, flattened (ldmatrix takes a
// row address per lane, so the 16 rows of an m16 tile may be any 16
// pixels), N = its output channels (32, 16, or 2 padded to one n8 tile),
// K = taps x input channels in chunks of 16:
//
//   inter_conv1  M = 22 x 22 half-resolution positions, N = 32, K = 9 x 176
//   predict_flow1 M = 20 x 20, N = 8 (2 used), K = 9 x 32
//   deconv0      four phases, each a 2x2 stride-1 conv (the tap algebra of
//                head_conv_tc.cu): M = 18 x 18 positions a phase, N = 16,
//                K = 4 x 176
//   inter_conv0  M = 34 x 34 full-resolution pixels, N = 16, K = 9 x 96:
//                c0 in 4 chunks, upfeat in 1, upflow and 14 zero channels in 1
//   predict_flow0 M = 32 x 32, N = 8 (2 used), K = 9 x 16
//
// upsample_flow1to0 (2 -> 2, 0.01% of the operations) runs on the CUDA
// cores. Every operand lives in shared memory channels innermost,
// [pixel][16] bf16 per chunk with the 16-byte halves swapped by unit(), so
// one stage's epilogue writes the next stage's A operand as it is, and
// ldmatrix reads both A and B without bank conflicts. Weights come packed
// by ops/head_conv.py::pack_head_weight, [tap][cout_pad][cin_pad].
//
// Streaming. concat1 (11 chunks, twice: inter_conv1, then deconv0 on a
// smaller window) and c0 (4 chunks) are NCHW in device memory. cp.async
// copies each chunk raw ([16][rows][cols], 16 bytes at a time from a column
// that is a multiple of 8, where the width is one too) into a ring, two
// chunks deep for concat1 (with the chunk's weights, three stages) and one
// for c0; one pass in shared memory then transposes it to channels
// innermost. No register holds a chunk in flight, so the accumulators keep
// the registers; the next copies overlap the current chunk's products and
// the stages between the GEMMs.
//
// Resources: 512 threads (16 warps), 213,504 bytes of shared memory, one
// block an SM, 128 registers (__launch_bounds__(512, 1)), no spills (-Xptxas
// -v for sm_90a, printed by chip_smoke.py's [build]).

#include <cstdint>

#include "common.cuh"
#include "fusion_head.cuh"
#include "mma.cuh"

namespace fusion_head {
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int CH = 16;                         // channels of a chunk: one k16 step
constexpr int C1_PAD = 176, C0_CHUNKS = 4;     // concat1 padded to 11 chunks; c0's 64 in 4
constexpr int C1_CHUNKS = C1_PAD / CH;
constexpr int I0_CHUNKS = 6;                   // c0 0-3, upfeat 4, upflow (+14 zeros) 5

// shared memory, in bytes
constexpr int PIX = 2 * CH;  // bytes of one pixel's chunk
constexpr int SZ_I = (2 * N_I1 > N_I0 ? 2 * N_I1 : N_I0) * PIX;  // inter1 (2 chunks), then inter0
constexpr int SZ_U = N_UP * PIX;                                  // upfeat
constexpr int SZ_X = N_UP * PIX;                                  // transposed chunk: concat1, upflow, c0
// raw chunks: windows widened to 16-byte columns from a multiple of 8
// (XA, XB: n0 - 8; c0: x0 - 8); RAW_* in 4-byte words
constexpr int RA_C = 32, RB_C = 32, R0_C = 48, COL_A = 4, COL_B = 6, COL_0 = 6;
constexpr int RAW_A = CH * XA_R * RA_C / 2, RAW_B = CH * XB_R * RB_C / 2;
constexpr int SZ_RAW = CH * UP_R * R0_C * 2;  // two concat1 chunks, or one of c0
constexpr int W_I1 = 9 * CI1 * CH * 2, W_DC = 16 * CD * CH * 2, W_I0 = I0_CHUNKS * 9 * CI0 * CH * 2;
constexpr int SZ_W = (3 * W_I1 > W_I0 ? 3 * W_I1 : W_I0);
constexpr int SZ_PF1 = 2 * 9 * 8 * CH * 2, SZ_PF0 = 9 * 8 * CH * 2;
constexpr int SZ_F1 = 2 * N_F1 * 4, SZ_UPW = 2 * 16 * 4 * 4;
constexpr int OFF_U = SZ_I, OFF_X = OFF_U + SZ_U, OFF_RAW = OFF_X + SZ_X, OFF_W = OFF_RAW + SZ_RAW;
constexpr int OFF_PF1 = OFF_W + SZ_W;
constexpr int OFF_PF0 = OFF_PF1 + SZ_PF1, OFF_F1 = OFF_PF0 + SZ_PF0, OFF_UPW = OFF_F1 + SZ_F1;
constexpr int SMEM_TC = OFF_UPW + SZ_UPW;
static_assert(XA_R * XA_C * PIX <= SZ_X && 2 * RAW_A * 4 <= SZ_RAW && 2 * RAW_B * 4 <= SZ_RAW && 3 * W_DC <= SZ_W,
              "staging fits");
static_assert(COL_A + XA_C <= RA_C && COL_B + XB_C <= RB_C && COL_0 + UP_C <= R0_C && WT % 8 == 0,
              "the widened windows cover the windows");
static_assert(SMEM_TC <= 232448, "one block's shared memory");
static_assert(SZ_I % 16 == 0 && SZ_U % 16 == 0 && SZ_W % 16 == 0 && SZ_F1 % 16 == 0, "16-byte alignment");

struct TcArgs {
  const uint16_t* cat1;
  const uint16_t* c0;
  const uint4 *w_i1, *w_pf1, *w_dc, *w_i0, *w_pf0;  // packed [tap][cout_pad][cin_pad]
  const __nv_bfloat16* w_up;                         // packed [2][16][4] (pack_head_weight_f32's layout)
  const __nv_bfloat16 *b_i1, *b_pf1, *b_dc, *b_up, *b_i0, *b_pf0;
  __nv_bfloat16 *flow0, *flow1;
  int h2, w2;
};

__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// A 16-channel chunk of an NCHW window, raw: [16][WR][RC] bf16 from row gy0
// and column gx0 (a multiple of 8), zero beyond cin and outside the image.
// Where the width is a multiple of 8 (`vec`) cp.async copies 16 bytes (8
// columns, all in or all out of the image) at a time; else the threads
// load and store one element at a time.
template <int WR, int RC>
__device__ __forceinline__ void fetch_raw(uint32_t* raw, const uint16_t* __restrict__ img, long long hw, int h,
                                          int w, int cin, int ch0, int gy0, int gx0, bool vec) {
  static_assert(RC % 8 == 0, "whole 16-byte groups");
  if (vec) {
    constexpr int GROUPS = WR * RC / 8;
    for (int i = threadIdx.x; i < CH * GROUPS; i += kThreads) {
      const int ch = ch0 + i / GROUPS, rc = i % GROUPS;
      const int gy = gy0 + rc / (RC / 8), gx = gx0 + 8 * (rc % (RC / 8));
      const bool valid = ch < cin && gy >= 0 && gy < h && gx >= 0 && gx < w;
      cp_async<16>(raw + 4 * i, valid ? img + ch * hw + static_cast<long long>(gy) * w + gx : img, valid);
    }
    return;
  }
  uint16_t* raw16 = reinterpret_cast<uint16_t*>(raw);
  for (int i = threadIdx.x; i < CH * WR * RC; i += kThreads) {
    const int ch = ch0 + i / (WR * RC), rc = i % (WR * RC);
    const int gy = gy0 + rc / RC, gx = gx0 + rc % RC;
    const bool valid = ch < cin && gy >= 0 && gy < h && gx >= 0 && gx < w;
    raw16[i] = valid ? __ldg(img + ch * hw + static_cast<long long>(gy) * w + gx) : uint16_t{0};
  }
}

// Columns col0 .. col0 + WC - 1 (col0 even) of the raw chunk into xs as
// [pixel][16] (pixel = row * WC + column), halves swapped by unit(): per item
// two neighbouring pixels x 8 channels.
template <int WR, int WC, int RC>
__device__ __forceinline__ void transpose_raw(uint4* xs, const uint32_t* raw, int col0) {
  constexpr int PAIRS = WR * WC / 2;
  for (int i = threadIdx.x; i < 2 * PAIRS; i += kThreads) {
    const int half = i / PAIRS, rc = i % PAIRS;
    const int r = rc / (WC / 2), c = 2 * (rc % (WC / 2));
    const uint32_t* src = raw + (half * 8 * WR * RC + r * RC + col0 + c) / 2;
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = src[j * WR * RC / 2];
    const int p = r * WC + c;
    xs[unit(p, half)] = make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                                   __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
    xs[unit(p + 1, half)] = make_uint4(__byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632),
                                       __byte_perm(v[4], v[5], 0x7632), __byte_perm(v[6], v[7], 0x7632));
  }
}

// cp.async of one chunk of packed weights, rows (tap, cout) of cin_pad
// channels, into [row][16] with the halves swapped by unit()
__device__ __forceinline__ void stage_weights(uint4* dst, const uint4* __restrict__ src, int rows, int cin_pad,
                                              int ch0) {
  for (int i = threadIdx.x; i < 2 * rows; i += kThreads) {
    const int row = i >> 1;
    cp_async<16>(dst + unit(row, i & 1), src + (row * cin_pad + ch0) / 8 + (i & 1), true);
  }
}

// The lane's A-fragment pixel (row lane % 16 of m tile `mt`) of a region
// of `rw` columns and `npos` positions, as the pixel its tap (0, 0) reads
// in an input of `iw` columns whose origin is that of the region's tap
// (0, 0); positions past the region read pixel 0 and are discarded.
__device__ __forceinline__ int a_pixel(int mt, int rw, int npos, int iw) {
  int p = mt * 16 + (threadIdx.x & 15);
  p = p < npos ? p : 0;
  return (p / rw) * iw + p % rw;
}

// acc[mt][j] += the tap products of one 16-channel chunk: NMT m tiles of
// this warp (pixels a_pix, those past `nmt` skipped), NT n8 tiles, taps
// given as (input pixel offset, packed weight row base).
template <int NMT, int NT, int KH, int KW>
__device__ __forceinline__ void mma_chunk(float (&acc)[NMT][NT][4], const int (&a_pix)[NMT], int nmt,
                                          uint32_t x_addr, int x_base, uint32_t w_addr, int w_row0, int iw,
                                          int tap_stride_w) {
  const int lane = threadIdx.x & 31;
  const int a_half = lane >> 4;
  const int b_row = (lane & 7) + (NT > 1 ? ((lane >> 4) & 1) * 8 : 0);
  const uint32_t b_off = 16u * unit(b_row, (lane >> 3) & 1);
#pragma unroll 1  // one kernel row at a time: unrolled, the taps' addresses are hoisted and spill
  for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
    for (int dx = 0; dx < KW; ++dx) {
      const uint32_t w_tap = w_addr + b_off + 32u * (w_row0 + (dy * KW + dx) * tap_stride_w);
      uint32_t bb[NT][2];
      if constexpr (NT == 1) {
        ldsm_x2(w_tap, bb[0][0], bb[0][1]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4(w_tap + 32u * (j * 8), r);
          bb[j][0] = r[0];
          bb[j][1] = r[1];
          bb[j + 1][0] = r[2];
          bb[j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
        if (mt >= nmt) break;
        uint32_t a[4];
        ldsm_x4(x_addr + 16u * unit(x_base + a_pix[mt] + dy * iw + dx, a_half), a);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[mt][j], a, bb[j][0], bb[j][1]);
      }
    }
  }
}

// Streams `n` chunks two deep: fetch(k) starts chunk k's copies (the raw
// window and its weights), transpose(k) moves raw chunk k into the staging
// buffer, compute(k) reads it there. The caller has started and committed
// chunks 0 and 1, one cp.async group each.
template <class Fetch, class Transpose, class Compute>
__device__ __forceinline__ void stream2(int n, Fetch fetch, Transpose transpose, Compute compute) {
  cp_async_wait<1>();
  __syncthreads();
  transpose(0);
  __syncthreads();
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    if (k + 2 < n) fetch(k + 2);  // into the raw and weight stages chunks k and k - 1 used
    cp_async_commit();
    compute(k);
    cp_async_wait<1>();  // chunk k + 1 has landed
    __syncthreads();
    if (k + 1 < n) transpose(k + 1);
    __syncthreads();
  }
}

template <int NMT, int NT>
__device__ __forceinline__ void zero(float (&acc)[NMT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

__global__ void __launch_bounds__(kThreads, 1) fusion_head_tc_kernel(TcArgs args) {
  extern __shared__ uint4 smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  uint4* s_i = reinterpret_cast<uint4*>(base);  // inter1 [2][N_I1][16], then inter0 [N_I0][16]
  uint4* s_u = reinterpret_cast<uint4*>(base + OFF_U);
  uint4* s_x = reinterpret_cast<uint4*>(base + OFF_X);
  uint32_t* s_raw = reinterpret_cast<uint32_t*>(base + OFF_RAW);
  uint4* s_w = reinterpret_cast<uint4*>(base + OFF_W);
  uint4* s_pf1 = reinterpret_cast<uint4*>(base + OFF_PF1);
  uint4* s_pf0 = reinterpret_cast<uint4*>(base + OFF_PF0);
  float* s_f1 = reinterpret_cast<float*>(base + OFF_F1);   // flow1 [2][N_F1], float32 of bf16 values
  float* s_upw = reinterpret_cast<float*>(base + OFF_UPW);  // upsample_flow1to0 [2][16][4]
  const uint32_t a_i = smem_addr(s_i), a_u = smem_addr(s_u), a_x = smem_addr(s_x), a_w = smem_addr(s_w);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // accumulator fragment: rows g, g + 8; columns 2q, 2q + 1
  const int h2 = args.h2, w2 = args.w2, h = 2 * h2, w = 2 * w2;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW, m0 = y0 / 2, n0 = x0 / 2;
  const long long hw2 = static_cast<long long>(h2) * w2, hw = static_cast<long long>(h) * w;
  const uint16_t* catb = args.cat1 + static_cast<long long>(b) * C1 * hw2;
  const uint16_t* c0b = args.c0 + static_cast<long long>(b) * C0 * hw;
  const bool vec2 = (w2 & 7) == 0, vec = (w & 7) == 0;  // 16-byte copies

  // the small weights, once
  // as [chunk][tap][8][16], like every chunked weight here
  for (int c = 0; c < 2; ++c) stage_weights(s_pf1 + c * 9 * 8 * 2, args.w_pf1, 9 * 8, 32, c * CH);
  stage_weights(s_pf0, args.w_pf0, 9 * 8, 16, 0);
  for (int i = tid; i < 2 * 16 * 4; i += kThreads) s_upw[i] = __bfloat162float(args.w_up[i]);

  const auto fetch_dc = [&](int k) {
    fetch_raw<XB_R, RB_C>(s_raw + (k & 1) * RAW_B, catb, hw2, h2, w2, C1, k * CH, m0 - 2, n0 - 8, vec2);
    stage_weights(s_w + (k % 3) * (W_DC / 16), args.w_dc, 16 * CD, C1_PAD, k * CH);
  };

  // --- inter1 on I1 (22 x 22, origin -3) over concat1's XA window (origin -4)
  {
    constexpr int NMT = 2, MTS = (N_I1 + 15) / 16;
    const int nmt = (warp + kWarps < MTS) ? 2 : (warp < MTS ? 1 : 0);
    int a_pix[NMT];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) a_pix[mt] = a_pixel(warp + mt * kWarps, I1_C, N_I1, XA_C);
    float acc[NMT][4][4];
    zero(acc);
    const auto fetch = [&](int k) {
      fetch_raw<XA_R, RA_C>(s_raw + (k & 1) * RAW_A, catb, hw2, h2, w2, C1, k * CH, m0 - 4, n0 - 8, vec2);
      stage_weights(s_w + (k % 3) * (W_I1 / 16), args.w_i1, 9 * CI1, C1_PAD, k * CH);
    };
    fetch(0);
    cp_async_commit();
    fetch(1);
    cp_async_commit();
    stream2(
        C1_CHUNKS, fetch, [&](int k) { transpose_raw<XA_R, XA_C, RA_C>(s_x, s_raw + (k & 1) * RAW_A, COL_A); },
        [&](int k) { mma_chunk<NMT, 4, 3, 3>(acc, a_pix, nmt, a_x, 0, a_w + (k % 3) * W_I1, 0, XA_C, CI1); });
    // deconv0's first two chunks fly while inter1's epilogue and flow1 run
    fetch_dc(0);
    cp_async_commit();
    fetch_dc(1);
    cp_async_commit();
    // bias, one rounding, zero outside the image: inter1 as [chunk][N_I1][16]
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      if (mt >= nmt) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (warp + mt * kWarps) * 16 + g + 8 * hh;
        if (p >= N_I1) continue;
        const int gy = m0 - 3 + p / I1_C, gx = n0 - 3 + p % I1_C;
        const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = j * 8 + 2 * q;
          const float v0 = in ? acc[mt][j][2 * hh] + __bfloat162float(args.b_i1[co]) : 0.f;
          const float v1 = in ? acc[mt][j][2 * hh + 1] + __bfloat162float(args.b_i1[co + 1]) : 0.f;
          reinterpret_cast<uint32_t*>(s_i + unit((j >> 1) * N_I1 + p, j & 1))[q] = pack2(v0, v1);
        }
      }
    }
  }
  __syncthreads();

  // --- flow1 on F1 (20 x 20, origin -2) from inter1 (origin -3)
  {
    constexpr int NMT = 2, MTS = (N_F1 + 15) / 16;
    const int nmt = (warp + kWarps < MTS) ? 2 : (warp < MTS ? 1 : 0);
    int a_pix[NMT];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) a_pix[mt] = a_pixel(warp + mt * kWarps, F1_C, N_F1, I1_C);
    float acc[NMT][1][4];
    zero(acc);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      mma_chunk<NMT, 1, 3, 3>(acc, a_pix, nmt, a_i, c * N_I1, smem_addr(s_pf1), c * 9 * 8, I1_C, 8);
    if (q == 0) {
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
        if (mt >= nmt) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = (warp + mt * kWarps) * 16 + g + 8 * hh;
          if (p >= N_F1) continue;
          const int r = p / F1_C, c = p % F1_C;
          const int gy = m0 - 2 + r, gx = n0 - 2 + c;
          const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
          const float v0 = in ? rbf(acc[mt][0][2 * hh] + __bfloat162float(args.b_pf1[0])) : 0.f;
          const float v1 = in ? rbf(acc[mt][0][2 * hh + 1] + __bfloat162float(args.b_pf1[1])) : 0.f;
          s_f1[p] = v0;
          s_f1[N_F1 + p] = v1;
          if (in && r >= 2 && r < 2 + HT && c >= 2 && c < 2 + WT) {
            __nv_bfloat16* o = args.flow1 + static_cast<long long>(b) * 2 * hw2 + static_cast<long long>(gy) * w2 + gx;
            o[0] = __float2bfloat16_rn(v0);
            o[hw2] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }

  // --- upfeat on UP (36 x 36 full resolution, origin -2): deconv0 in four
  // phases over concat1's XB window (half resolution, origin -2)
  {
    constexpr int NMT = 6, MTS = (N_PH + 15) / 16;  // m tiles of one phase
    const int phase = warp >> 2, sub = warp & 3;
    const int py = phase >> 1, px = phase & 1;
    const int nmt = (MTS - sub + 3) / 4;
    int a_pix[NMT];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) a_pix[mt] = a_pixel(sub + 4 * mt, PH_C, N_PH, XB_C) + py * XB_C + px;
    float acc[NMT][2][4];
    zero(acc);
    stream2(
        C1_CHUNKS, fetch_dc, [&](int k) { transpose_raw<XB_R, XB_C, RB_C>(s_x, s_raw + (k & 1) * RAW_B, COL_B); },
        [&](int k) {
          mma_chunk<NMT, 2, 2, 2>(acc, a_pix, nmt, a_x, 0, a_w + (k % 3) * W_DC, phase * 4 * CD, XB_C, CD);
        });
    // inter_conv0's weights, all six chunks, and c0's first chunk fly while
    // upfeat's epilogue and upflow run
    for (int c = 0; c < I0_CHUNKS; ++c) stage_weights(s_w + c * 9 * CI0 * 2, args.w_i0, 9 * CI0, 96, c * CH);
    cp_async_commit();
    fetch_raw<UP_R, R0_C>(s_raw, c0b, hw, h, w, C0, 0, y0 - 2, x0 - 8, vec);
    cp_async_commit();
    // bias, leaky, one rounding, zero outside the image: upfeat as [N_UP][16]
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      if (mt >= nmt) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (sub + 4 * mt) * 16 + g + 8 * hh;
        if (p >= N_PH) continue;
        const int rr = 2 * (p / PH_C) + py, cc = 2 * (p % PH_C) + px;
        const int gy = y0 - 2 + rr, gx = x0 - 2 + cc;
        const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = j * 8 + 2 * q;
          float v0 = acc[mt][j][2 * hh] + __bfloat162float(args.b_dc[co]);
          float v1 = acc[mt][j][2 * hh + 1] + __bfloat162float(args.b_dc[co + 1]);
          v0 = v0 < 0.f ? v0 * 0.1f : v0;
          v1 = v1 < 0.f ? v1 * 0.1f : v1;
          reinterpret_cast<uint32_t*>(s_u + unit(rr * UP_C + cc, j))[q] = in ? pack2(v0, v1) : 0u;
        }
      }
    }
  }

  // upflow on the CUDA cores into the staging buffer as inter_conv0's chunk
  // 5 ([N_UP][16], channels 0-1 of 16)
  for (int pos = tid; pos < N_UP; pos += kThreads) {
    const int rr = pos / UP_C, cc = pos % UP_C;
    const int gy = y0 - 2 + rr, gx = x0 - 2 + cc;
    const int py = rr & 1, px = cc & 1;
    const int fr = (rr >> 1) + py, fc = (cc >> 1) + px;  // flow1 (origin -2) at tap (0, 0)
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
    const uint32_t v = in ? pack2(s0 + __bfloat162float(args.b_up[0]), s1 + __bfloat162float(args.b_up[1])) : 0u;
    s_x[unit(pos, 0)] = make_uint4(v, 0u, 0u, 0u);
    s_x[unit(pos, 1)] = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<1>();  // inter_conv0's weights
  __syncthreads();

  // --- inter0 on I0 (34 x 34, origin -1) over [c0 | upfeat | upflow] (origin -2)
  {
    constexpr int NMT = 5, MTS = (N_I0 + 15) / 16;
    const int nmt = (MTS - warp + kWarps - 1) / kWarps;
    int a_pix[NMT];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) a_pix[mt] = a_pixel(warp + mt * kWarps, I0_C, N_I0, UP_C);
    float acc[NMT][2][4];
    zero(acc);
    mma_chunk<NMT, 2, 3, 3>(acc, a_pix, nmt, a_x, 0, a_w, 5 * 9 * CI0, UP_C, CI0);  // upflow
    mma_chunk<NMT, 2, 3, 3>(acc, a_pix, nmt, a_u, 0, a_w, 4 * 9 * CI0, UP_C, CI0);  // upfeat
    // c0, one chunk deep: chunk k + 1's copies fly while chunk k computes
#pragma unroll 1
    for (int k = 0; k < C0_CHUNKS; ++k) {
      cp_async_wait<0>();
      __syncthreads();
      transpose_raw<UP_R, UP_C, R0_C>(s_x, s_raw, COL_0);
      __syncthreads();
      if (k + 1 < C0_CHUNKS) fetch_raw<UP_R, R0_C>(s_raw, c0b, hw, h, w, C0, (k + 1) * CH, y0 - 2, x0 - 8, vec);
      cp_async_commit();
      mma_chunk<NMT, 2, 3, 3>(acc, a_pix, nmt, a_x, 0, a_w, k * 9 * CI0, UP_C, CI0);
    }
    __syncthreads();  // inter1's place is read (flow1 long ago); inter0 goes there
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) {
      if (mt >= nmt) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (warp + mt * kWarps) * 16 + g + 8 * hh;
        if (p >= N_I0) continue;
        const int gy = y0 - 1 + p / I0_C, gx = x0 - 1 + p % I0_C;
        const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = j * 8 + 2 * q;
          const float v0 = acc[mt][j][2 * hh] + __bfloat162float(args.b_i0[co]);
          const float v1 = acc[mt][j][2 * hh + 1] + __bfloat162float(args.b_i0[co + 1]);
          reinterpret_cast<uint32_t*>(s_i + unit(p, j))[q] = in ? pack2(v0, v1) : 0u;
        }
      }
    }
  }
  __syncthreads();

  // --- flow0 on the tile (32 x 32) from inter0 (origin -1)
  {
    constexpr int NMT = 4;  // (TH x TW / 16) / 16 warps
    static_assert(TH * TW == NMT * 16 * kWarps, "flow0's m tiles, four a warp");
    int a_pix[NMT];
#pragma unroll
    for (int mt = 0; mt < NMT; ++mt) a_pix[mt] = a_pixel(warp + mt * kWarps, TW, TH * TW, I0_C);
    float acc[NMT][1][4];
    zero(acc);
    mma_chunk<NMT, 1, 3, 3>(acc, a_pix, NMT, a_i, 0, smem_addr(s_pf0), 0, I0_C, 8);
    if (q == 0) {
#pragma unroll
      for (int mt = 0; mt < NMT; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = (warp + mt * kWarps) * 16 + g + 8 * hh;
          const int gy = y0 + p / TW, gx = x0 + p % TW;
          if (gy >= h || gx >= w) continue;
          __nv_bfloat16* o = args.flow0 + static_cast<long long>(b) * 2 * hw + static_cast<long long>(gy) * w + gx;
          o[0] = __float2bfloat16_rn(acc[mt][0][2 * hh] + __bfloat162float(args.b_pf0[0]));
          o[hw] = __float2bfloat16_rn(acc[mt][0][2 * hh + 1] + __bfloat162float(args.b_pf0[1]));
        }
      }
    }
  }
}

}  // namespace

int launch_tc(const void* cat1, const void* c0, const void* const* weights, void* flow0, void* flow1, int n,
              int h2, int w2, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fusion_head_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_TC);
  if (e != cudaSuccess) return static_cast<int>(e);
  const TcArgs args{
      static_cast<const uint16_t*>(cat1), static_cast<const uint16_t*>(c0),
      static_cast<const uint4*>(weights[0]), static_cast<const uint4*>(weights[2]),
      static_cast<const uint4*>(weights[4]), static_cast<const uint4*>(weights[8]),
      static_cast<const uint4*>(weights[10]), static_cast<const __nv_bfloat16*>(weights[6]),
      static_cast<const __nv_bfloat16*>(weights[1]), static_cast<const __nv_bfloat16*>(weights[3]),
      static_cast<const __nv_bfloat16*>(weights[5]), static_cast<const __nv_bfloat16*>(weights[7]),
      static_cast<const __nv_bfloat16*>(weights[9]), static_cast<const __nv_bfloat16*>(weights[11]),
      static_cast<__nv_bfloat16*>(flow0), static_cast<__nv_bfloat16*>(flow1), h2, w2};
  const dim3 grid((2 * w2 + TW - 1) / TW, (2 * h2 + TH - 1) / TH, n);
  fusion_head_tc_kernel<<<grid, kThreads, SMEM_TC, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fusion_head
