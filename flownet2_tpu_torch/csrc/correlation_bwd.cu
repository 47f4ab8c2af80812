// Correlation backward, FlowNet configuration (multiply mode, kernel_size 1,
// stride1 1, pad == max_displacement, any stride2): the VJP of
// csrc/correlation.cu.
//
//   df1[n, y, x, c]   = (1/C) sum_d g[n, d, y, x] * f2[n, y+dy, x+dx, c]
//   df2[n, y', x', c] = (1/C) sum_d g[n, d, y'-dy, x'-dx] * f1[n, y'-dy, x'-dx, c]
//
// over the displacements d whose partner pixel lies inside the map (the
// zero padding contributes nothing), (dy, dx) as in the forward.
//
// Replaces flownet2_tpu/ops/correlation.py::_corr_selmm_bwd, which on the
// TPU runs both products as banded matmuls on the MXU (a selection matmul
// to un-band g, then a channel contraction, and for df2 a scan over 8-row
// output blocks). Here both are gather-form: each output element is summed
// by one thread, so there are no atomics and each output is written once.
// One block per (n, y, column tile); the tile's g values for every
// displacement sit in shared memory as float32 (zero where the partner
// pixel is outside), and each thread owns one channel, so the f loads of a
// warp read contiguous channels of one pixel.
//
// Layout: f1, f2, df1, df2 (N, H, W, C) contiguous; g (N, gw*gw, H, W)
// contiguous, the forward's output layout. Accumulation in float32, output
// in the input dtype.
//
// Bound on the H100: like the forward, load issue. At FlowNetC's
// 8x40x56x256 with 441 displacements each pass reads one f vector per
// (pixel, displacement), about 8 GB of mostly L1/L2-resident loads, for
// 2.0 G multiply-adds.

#include "common.cuh"

namespace {

template <typename T, bool kSecond>
__global__ void correlation_backward_kernel(const T* __restrict__ f, const T* __restrict__ g,
                                            T* __restrict__ df, int h, int w, int c,
                                            int stride2, int gr, int tile, float inv_c) {
  extern __shared__ float sg[];  // [displacement][column of the tile]
  const int gw = 2 * gr + 1;
  const int nd = gw * gw;
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile;
  const int ntx = min(tile, w - x0);

  // df1 (kSecond false) pairs (y, x) with f2 at (y+dy, x+dx) and g at (y, x);
  // df2 (kSecond true) pairs (y', x') with f1 and g both at (y'-dy, x'-dx).
  for (int i = threadIdx.x; i < nd * ntx; i += blockDim.x) {
    const int d = i / ntx;
    const int px = i - d * ntx;
    const int dy = (d / gw - gr) * stride2;
    const int dx = (d % gw - gr) * stride2;
    const int x = x0 + px;
    const int sy = kSecond ? y - dy : y + dy;
    const int sx = kSecond ? x - dx : x + dx;
    float v = 0.f;
    if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
      const int gy = kSecond ? sy : y;
      const int gx = kSecond ? sx : x;
      v = to_f32(g[((static_cast<long long>(b) * nd + d) * h + gy) * w + gx]);
    }
    sg[d * tile + px] = v;
  }
  __syncthreads();

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    for (int px = 0; px < ntx; ++px) {
      const int x = x0 + px;
      float acc = 0.f;
      // displacement rows, then columns: no division in the loop, and a
      // row whose partner row is outside the map is skipped whole
      for (int p = 0; p < gw; ++p) {
        const int dy = (p - gr) * stride2;
        const int sy = kSecond ? y - dy : y + dy;
        if (sy < 0 || sy >= h) continue;  // uniform across the block
        const T* frow = f + (static_cast<long long>(b) * h + sy) * w * c + ch;
        const float* grow = sg + p * gw * tile + px;
        for (int o = 0; o < gw; ++o) {
          const int dx = (o - gr) * stride2;
          const int sx = kSecond ? x - dx : x + dx;
          if (sx >= 0 && sx < w) {  // uniform across the block
            acc = fmaf(grow[o * tile], to_f32(frow[static_cast<long long>(sx) * c]), acc);
          }
        }
      }
      df[((static_cast<long long>(b) * h + y) * w + x) * c + ch] = from_f32<T>(acc * inv_c);
    }
  }
}

// Columns per block: the tile's g values (tile * displacements float32)
// must fit the 48 KB of shared memory a launch gets without opting in.
constexpr int kMaxTile = 8;
constexpr int kSmemFloats = 48 * 1024 / 4;

template <typename T>
void launch(const void* f1, const void* f2, const void* g, void* df1, void* df2, int n, int h,
            int w, int c, int stride2, int gr, int tile, cudaStream_t stream) {
  const dim3 grid((w + tile - 1) / tile, h, n);
  const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
  const int nd = (2 * gr + 1) * (2 * gr + 1);
  const size_t smem = static_cast<size_t>(tile) * nd * sizeof(float);
  const float inv_c = 1.f / static_cast<float>(c);
  if (df1 != nullptr) {
    correlation_backward_kernel<T, false><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(f2), static_cast<const T*>(g), static_cast<T*>(df1), h, w, c,
        stride2, gr, tile, inv_c);
  }
  if (df2 != nullptr) {
    correlation_backward_kernel<T, true><<<grid, threads, smem, stream>>>(
        static_cast<const T*>(f1), static_cast<const T*>(g), static_cast<T*>(df2), h, w, c,
        stride2, gr, tile, inv_c);
  }
}

}  // namespace

// df1 / df2: (N, H, W, C) outputs in the inputs' dtype, or null to skip one.
extern "C" int fn2_correlation_backward(const void* f1, const void* f2, const void* g, void* df1,
                                        void* df2, int n, int h, int w, int c,
                                        int max_displacement, int stride2, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = max_displacement / stride2;
  const int nd = (2 * gr + 1) * (2 * gr + 1);
  if (nd > kSmemFloats) return static_cast<int>(cudaErrorInvalidValue);
  const int tile = nd > kSmemFloats / kMaxTile ? kSmemFloats / nd : kMaxTile;
  if (dtype == kFloat32) {
    launch<float>(f1, f2, g, df1, df2, n, h, w, c, stride2, gr, tile, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(f1, f2, g, df1, df2, n, h, w, c, stride2, gr, tile, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
