// The bfloat16 route of the full-resolution head convolutions (K3) on the
// tensor cores: the k x k conv (pad k/2, stride 1 or 2) and the k4/s2/p1
// deconv, each with bias and an optional leaky ReLU (slope 0.1) fused into
// the epilogue. head_conv.cu's entry points send bfloat16 calls here; its
// CUDA-core kernels keep the float32 route.
//
// Replaces flownet2_tpu/ops/pallas/s2d_conv.py::matmul_conv_pallas, which
// runs these layers as tap-accumulated bf16 matmuls with float32 sums on the
// TPU's matrix unit. Here the same function is an implicit GEMM: M = output
// pixels, N = Cout, K = taps x Cin, on mma.sync.m16n8k16 (bf16 in, float32
// accumulators), rounded once to bf16 after bias and leaky.
//
// Layouts: x (N, Cin, H, W) and out (N, Cout, Ho, Wo), bf16, contiguous;
// bias (Cout) bf16; the weight packed by ops/head_conv.py::pack_head_weight
// as [tap][cout_pad][cin_pad] bf16, zero in the padding: cout_pad = 8 NT
// (8, 16 or 64), cin_pad the next multiple of 16. Conv taps are ky * k + kx;
// the deconv's 16 are phase * 4 + a * 2 + b for output phase (py, px),
// phase = 2 py + px, holding weight[ci, co, 3 - py - 2a, 3 - px - 2b].
//
// Design. A block of 8 warps computes a tile of 256 output pixels for all
// cout_pad channels of one image: for the conv, 8 output rows by 32 columns,
// a warp per row; for the deconv, 2 half-resolution rows by 32 columns in
// each of the four phases (output (2m + py, 2n + px)), a warp per (phase,
// row), since a phase is a 2x2 stride-1 conv over input (m - 1 + py + a,
// n - 1 + px + b) (the tap algebra of ops/s2d.py:211-232). A warp holds two
// m16 tiles (its 32 pixels) times NT n8 tiles of float32 sums.
// K runs over chunks of 16 input channels; per chunk the input patch with
// its halo is staged in shared memory channels innermost, [row][col][16]
// bf16 (32 bytes a pixel; zero outside the image, which is the conv's
// padding, and in the padded channels), so that for one tap the A fragment's
// 16 rows are 16 pixels of 16 contiguous channels and one ldmatrix.x4 loads
// it. At stride 2 each patch row is split into its even and its odd columns,
// [row][column parity][col / 2][16], so a tap's 16 pixels are neighbours
// there too. The two 16-byte halves of a pixel swap places when bit 2 of its
// index is set: then the 8 pixels of one ldmatrix row group fall on 8
// distinct 16-byte bank groups, with no conflict. The chunk's packed
// weights, [tap][cout_pad][16] with the same swap, feed the B fragments
// through ldmatrix as well; the 7x7 convs stage them one kernel row at a
// time, to keep shared memory at 61 KB. The epilogue adds bias, applies
// leaky, rounds to bf16 into shared memory as [cout][row][col] and stores
// NCHW with neighbouring threads on neighbouring columns of one channel, 16
// bytes a thread where the output width is a multiple of 8.
//
// Low-Cin layers (3, 6, 11, 12 channels) are padded to 16 per tap: up to
// 5.3x the useful operations. At the tensor cores' peak the padded 3x3
// layers still take less time than their bytes (0.034 against 0.08 ms at
// Sintel b4), the 7x7 ones a little more (0.047 against 0.02-0.035 ms); the
// kernel runs well above both, so the waste is accepted. Cout 2 pads to an
// 8-wide n tile (4x).
//
// Bound on the H100: bytes. At Sintel size (1024x448, batch 4) the twelve
// head layers of FlowNet2 move about 2.1 GB in bf16 and do about 272 GFLOP:
// 0.63 ms at 3.35 TB/s against 0.28 ms at 989 TFLOP/s. Staging is plain
// synchronous loads through registers (no cp.async ring: the patch is a
// transpose of NCHW), one block's loads overlapping other blocks' math.

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTX = 32;  // output columns of a warp: two m16 tiles
constexpr int kCK = 16;  // input channels of a staged chunk: one k16 step

template <int K, int S, bool DECONV, int NT>
struct MmaGeom {
  static constexpr int TY = DECONV ? kWarps / 4 : kWarps;  // (half-resolution) rows of the tile
  static constexpr int KT = DECONV ? 2 : K;                // taps along a side, per output phase
  static constexpr int IR = DECONV ? TY + 2 : (TY - 1) * S + K;
  static constexpr int IC = DECONV ? kTX + 2 : (kTX - 1) * S + K;
  // stride 2: a patch row is two planes (even, odd columns) of ICP pixels
  static constexpr int PLANES = (!DECONV && S == 2) ? 2 : 1;
  static constexpr int ICP = (IC + PLANES - 1) / PLANES;
  static constexpr int ROW_PIX = PLANES * ICP;  // pixels from one patch row to the next
  static constexpr int NPAD = 8 * NT;
  // kernel rows of weights per staged piece, and pieces per chunk
  static constexpr int WROWS = (DECONV || K < 7) ? KT : 1;
  static constexpr int PIECES = DECONV ? 1 : K / WROWS;
  static constexpr int PIECE_TAPS = DECONV ? 16 : WROWS * K;
  static constexpr int X_ELEMS = IR * ROW_PIX * kCK;
  static constexpr int W_ELEMS = PIECE_TAPS * NPAD * kCK;
  static constexpr int OUT_ROWS = DECONV ? 2 * TY : TY;
  static constexpr int OUT_COLS = DECONV ? 2 * kTX : kTX;
  // per output channel in the epilogue; +8 spreads the channels over banks
  static constexpr int O_STRIDE = OUT_ROWS * OUT_COLS + 8;
  static constexpr int O_ELEMS = NPAD * O_STRIDE;
  static constexpr size_t SMEM =
      2 * static_cast<size_t>(X_ELEMS + W_ELEMS > O_ELEMS ? X_ELEMS + W_ELEMS : O_ELEMS);
};

template <int K, int S, bool DECONV, int NT>
__global__ void __launch_bounds__(kThreads)
head_conv_mma_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ wpacked,
                     const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int cin,
                     int h, int w, int cout, int ho, int wo, bool leaky) {
  using Geo = MmaGeom<K, S, DECONV, NT>;
  constexpr int IR = Geo::IR, IC = Geo::IC, NPAD = Geo::NPAD;
  extern __shared__ uint4 smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);  // [IR][PLANES][ICP][16], halves swapped by unit()
  uint16_t* ws = xs + Geo::X_ELEMS;                   // [PIECE_TAPS][NPAD][16], the same

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int cin_pad = (cin + kCK - 1) / kCK * kCK;
  const int row0 = blockIdx.y * Geo::TY, col0 = blockIdx.x * kTX;  // first (half-resolution) output
  const int iy0 = DECONV ? row0 - 1 : row0 * S - K / 2;            // patch origin in the input
  const int ix0 = DECONV ? col0 - 1 : col0 * S - K / 2;
  const long long hw = static_cast<long long>(h) * w;
  const uint16_t* xb = x + static_cast<long long>(b) * cin * hw;

  // this warp's output row and, for the deconv, phase; the patch row and
  // column of its first pixel's tap (0, 0), and its first packed tap
  const int phase = DECONV ? warp >> 1 : 0;
  const int wrow = DECONV ? warp & 1 : warp;
  const int py = phase >> 1, px = phase & 1;
  const int prow = DECONV ? wrow + py : wrow * S;
  const int pcol = DECONV ? px : 0;
  const int tap_base = DECONV ? phase * 4 : 0;

  // ldmatrix addresses. A: lane l gives pixel l % 16, channels 8 (l / 16)..
  // B: lane l gives cout row l % 8 of n tile (l / 16) (x4: two tiles), channels 8 ((l / 8) % 2)..
  const uint32_t xs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  const uint32_t ws_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ws));
  const int a_half = lane >> 4;
  int a_pix[2];  // patch pixel index of the lane's pixel at tap (0, 0)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) a_pix[mt] = prow * Geo::ROW_PIX + mt * 16 + (lane & 15) + pcol;
  const int b_row = (lane & 7) + (NT > 1 ? ((lane >> 4) & 1) * 8 : 0);
  // weight rows t * NPAD + b_row (+ 8 j): bit 2 is bit 2 of the lane
  const uint32_t b_off = 16u * unit(b_row, (lane >> 3) & 1);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kCK) {
#pragma unroll 1
    for (int piece = 0; piece < Geo::PIECES; ++piece) {
      __syncthreads();  // the previous piece has been read
      if (piece == 0) {
        // the patch: one 16-byte unit (8 channels of one pixel) per item,
        // neighbouring threads on neighbouring columns
        for (int i = tid; i < IR * IC * 2; i += kThreads) {
          const int half = i / (IR * IC);
          const int rc = i - half * (IR * IC);
          const int r = rc / IC, c = rc - r * IC;
          const int pix = r * Geo::ROW_PIX + (Geo::PLANES == 2 ? (c & 1) * Geo::ICP + (c >> 1) : c);
          const int gy = iy0 + r, gx = ix0 + c;
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
            const int ch0 = c0 + half * 8;
            const uint16_t* p = xb + static_cast<long long>(gy) * w + gx;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int ch = ch0 + j;
              const uint32_t e = ch < cin ? static_cast<uint32_t>(__ldg(p + ch * hw)) : 0u;
              v[j >> 1] |= e << (16 * (j & 1));
            }
          }
          reinterpret_cast<uint4*>(xs)[unit(pix, half)] = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      // the piece's weights: 32 bytes (16 channels) per (tap, cout row)
      const int tap0 = piece * Geo::PIECE_TAPS;
      for (int i = tid; i < Geo::PIECE_TAPS * NPAD * 2; i += kThreads) {
        const int row = i >> 1;  // tap * NPAD + cout row, within the piece
        reinterpret_cast<uint4*>(ws)[unit(row, i & 1)] =
            wpacked[((static_cast<long long>(tap0) * NPAD + row) * cin_pad + c0) / 8 + (i & 1)];
      }
      __syncthreads();

#pragma unroll
      for (int ky = 0; ky < Geo::WROWS; ++ky) {
#pragma unroll
        for (int kx = 0; kx < Geo::KT; ++kx) {
          // the tap's patch offset (conv: kernel row piece * WROWS + ky) and packed weight row
          const int dy = DECONV ? ky : piece * Geo::WROWS + ky;
          const int dpix = dy * Geo::ROW_PIX + (Geo::PLANES == 2 ? (kx & 1) * Geo::ICP + (kx >> 1) : kx);
          const int t = DECONV ? tap_base + ky * 2 + kx : ky * K + kx;
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) ldsm_x4(xs_addr + 16u * unit(a_pix[mt] + dpix, a_half), a[mt]);
          const uint32_t w_tap = ws_addr + b_off + 2u * (t * NPAD * kCK);
          if constexpr (NT == 1) {
            uint32_t b0, b1;
            ldsm_x2(w_tap, b0, b1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][0], a[mt], b0, b1);
          } else {
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
              uint32_t bb[4];
              ldsm_x4(w_tap + 2u * (j * 8 * kCK), bb);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt][j], a[mt], bb[0], bb[1]);
                mma_bf16(acc[mt][j + 1], a[mt], bb[2], bb[3]);
              }
            }
          }
        }
      }
    }
  }

  // epilogue: bias, leaky, one rounding to bf16, staged as [cout][row][col]
  __syncthreads();
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2, q = lane & 3;  // fragment row (pixel) and column pair (channels)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = j * 8 + 2 * q + e;
      const float bv = co < cout ? __bfloat162float(bias[co]) : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = mt * 16 + g + hh * 8;  // the pixel's column in the warp's row
          const int orow = DECONV ? 2 * wrow + py : wrow;
          const int ocol = DECONV ? 2 * c + px : c;
          float v = acc[mt][j][hh * 2 + e] + bv;
          if (leaky && v < 0.f) v *= 0.1f;
          os[co * Geo::O_STRIDE + orow * Geo::OUT_COLS + ocol] = __float2bfloat16_rn(v);
        }
      }
    }
  }
  __syncthreads();
  constexpr int OPIX = Geo::OUT_ROWS * Geo::OUT_COLS;
  const int oy0 = DECONV ? 2 * row0 : row0, ox0 = DECONV ? 2 * col0 : col0;
  const long long howo = static_cast<long long>(ho) * wo;
  __nv_bfloat16* ob = out + static_cast<long long>(b) * cout * howo;
  if ((wo & 7) == 0) {  // every output row and tile column starts 16-byte aligned
    for (int i = tid; i < cout * (OPIX / 8); i += kThreads) {
      const int co = i / (OPIX / 8);
      const int rem = (i - co * (OPIX / 8)) * 8;
      const int orow = rem / Geo::OUT_COLS, ocol = rem - orow * Geo::OUT_COLS;
      const int gy = oy0 + orow, gx = ox0 + ocol;
      if (gy < ho && gx < wo)
        *reinterpret_cast<uint4*>(ob + co * howo + static_cast<long long>(gy) * wo + gx) =
            *reinterpret_cast<const uint4*>(os + co * Geo::O_STRIDE + rem);
    }
    return;
  }
  const bool pairs = (wo & 1) == 0;  // then every even column starts an aligned bf16 pair
  for (int i = tid; i < cout * (OPIX / 2); i += kThreads) {
    const int co = i / (OPIX / 2);
    const int rem = (i - co * (OPIX / 2)) * 2;
    const int orow = rem / Geo::OUT_COLS, ocol = rem - orow * Geo::OUT_COLS;
    const int gy = oy0 + orow, gx = ox0 + ocol;
    if (gy >= ho || gx >= wo) continue;
    const __nv_bfloat16* src = os + co * Geo::O_STRIDE + rem;
    __nv_bfloat16* dst = ob + co * howo + static_cast<long long>(gy) * wo + gx;
    if (pairs && gx + 1 < wo) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = *reinterpret_cast<const __nv_bfloat162*>(src);
    } else {
      dst[0] = src[0];
      if (gx + 1 < wo) dst[1] = src[1];
    }
  }
}

template <int K, int S, bool DECONV, int NT>
int launch_mma(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
               int cout, int ho, int wo, bool leaky, cudaStream_t stream) {
  using Geo = MmaGeom<K, S, DECONV, NT>;
  auto kernel = head_conv_mma_kernel<K, S, DECONV, NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Geo::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  // the grid walks the (half-resolution, for the deconv) output in tiles
  const int rows = DECONV ? h : ho, cols = DECONV ? w : wo;
  const dim3 grid((cols + kTX - 1) / kTX, (rows + Geo::TY - 1) / Geo::TY, n);
  kernel<<<grid, kThreads, Geo::SMEM, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(wpacked),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), cin, h, w, cout, ho, wo, leaky);
  return static_cast<int>(cudaGetLastError());
}

// n tiles of 8 output channels: Cout <= 8, <= 16, <= 64
template <int K, int S, bool DECONV>
int dispatch_nt(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                int cout, int ho, int wo, bool leaky, cudaStream_t stream) {
  if (cout <= 8)
    return launch_mma<K, S, DECONV, 1>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (cout <= 16)
    return launch_mma<K, S, DECONV, 2>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if constexpr (!DECONV)
    return launch_mma<K, S, DECONV, 8>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 k x k conv, pad k/2: (k, stride) in {(3, 1), (3, 2), (7, 2)}, 1 <= Cout <= 64,
// weight packed as [k*k][cout_pad][cin_pad].
int head_conv_mma(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                  int cout, int k, int stride, bool leaky, cudaStream_t stream) {
  const int ho = (h + 2 * (k / 2) - k) / stride + 1;
  const int wo = (w + 2 * (k / 2) - k) / stride + 1;
  if (k == 3 && stride == 1)
    return dispatch_nt<3, 1, false>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (k == 3 && stride == 2)
    return dispatch_nt<3, 2, false>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  if (k == 7 && stride == 2)
    return dispatch_nt<7, 2, false>(x, wpacked, bias, out, n, cin, h, w, cout, ho, wo, leaky, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 k4/s2/p1 deconv: (N, Cin, H, W) -> (N, Cout, 2H, 2W), 1 <= Cout <= 16,
// weight packed as [16][cout_pad][cin_pad].
int head_deconv_mma(const void* x, const void* wpacked, const void* bias, void* out, int n, int cin, int h, int w,
                    int cout, bool leaky, cudaStream_t stream) {
  return dispatch_nt<4, 2, true>(x, wpacked, bias, out, n, cin, h, w, cout, 2 * h, 2 * w, leaky, stream);
}
