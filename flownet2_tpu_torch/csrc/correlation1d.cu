// 1-D (stereo) correlation forward, DispNet configuration: multiply mode,
// kernel_size 1, stride1 1, pad == max_displacement, any stride2 and
// single_direction.
//
//   out[n, j, y, x] = (1/C) * sum_c f1[n, c, y, x] * f2[n, c, y, x + (j + xs) * stride2]
//   gr = max_displacement / stride2; single_direction -1: gw = gr + 1,
//   xs = -gr; +1: gw = gr + 1, xs = 0; 0: gw = 2 gr + 1, xs = -gr;
//   f2 = 0 outside the map.
//
// Replaces flownet2_tpu/ops/correlation.py::_corr1d_selmm_fwd, an XLA
// banded matmul: per image row, the product of f1's row [W x C] with f2's
// padded row [C x (W + 2 md)], of which a one-hot selection matmul keeps
// the gw-wide band. This kernel computes the band alone.
//
// Layout: f1 and f2 (N, C, H, W) contiguous, the nets' own layout, so the
// caller copies nothing; out (N, gw, H, W). Sums in float32 on the CUDA
// cores, output in the input dtype (one rounding).
//
// Bound on the H100: bytes. At DispNetC's FlyingThings3D features
// (4x128x144x240, gw 41) the kernel reads 142 MB of f1 and f2 and writes
// 23 MB in float32 (0.049 ms at 3.35 TB/s) for 0.73 G multiply-adds
// (0.022 ms at the 67 TFLOP/s float32 peak).
//
// Design. The grid is persistent: each block walks work items (n, y, column
// tile) blockIdx.x, blockIdx.x + gridDim.x, .. and streams their channel
// chunks through one ring of kStages = 4 stages filled by cp.async. The
// ring runs across items: while a block computes an item's last chunk and
// stores its outputs, the next item's first chunks are in flight. A block
// has at most 256 threads, so that three share an SM and one block's
// barrier or copy tail is covered by the others' work: the tile is the
// whole row where the row's threads fit (up to 160 columns at gw 41), else
// the row is split evenly (DispNetC's 240 columns into two tiles of 120).
// On an NVIDIA H100 one 384-thread block a row took 0.20 ms at
// 4x128x144x240 f32 against 0.15 for the tiles (scripts/corr1d_variants.py).
// A chunk stages, channel-major, ck channel rows of f1's tile and of f2's
// tile with its one-sided halo; each is a contiguous run of one NCHW row,
// copied 16 bytes at a time where aligned (narrower copies at an unaligned
// start, an odd width, a storage offset or the map's edge; corr1d.cuh),
// zero outside the map. A thread owns kXT = 4 neighbouring columns times
// kJT = 8 displacements in registers: per channel one f1 vector and, at
// stride2 1, three f2 vectors (the 11-column sliding run) feed 32 FMAs, 8
// per shared load; neighbouring lanes own neighbouring columns, so the loads
// are conflict-free and each displacement row leaves straight from
// registers as coalesced vector stores.

#include "corr1d.cuh"

namespace {

using corr1d::kUnit;

constexpr int kXT = 4;  // columns a thread
constexpr int kJT = 8;  // displacements a thread
constexpr int kStages = 4;
constexpr int kMaxThreads = 256;

// The launch's geometry, computed on the host.
struct Plan {
  int tiles;   // column tiles a row
  int tw;      // columns a tile, a multiple of the copy unit
  int runs;    // column runs of kXT a tile: tw / kXT
  int njg;     // displacement groups of kJT: ceil(gw / kJT)
  int ck;      // channels a chunk
  int nk;      // chunks an item: ceil(C / ck)
  int l1, lr;  // staged f1 columns; f1 and f2 columns of one staged channel row
  int items;   // n * h * tiles
  int threads;
  int stage_elems;
  size_t smem;
};

// S: stride2 as a compile-time constant (1 or 2), or 0 for any stride2
template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
correlation1d_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out, int c, int h,
                     int w, int stride2, int gw, int x_shift, Plan plan) {
  constexpr int V = kUnit<T>;
  extern __shared__ uint4 smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  const int s = S > 0 ? S : stride2;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int units1 = plan.l1 / V;
  const corr1d::Split split(plan.lr / V, tid, nthreads);
  const int f2_x = x_shift * s;  // f2 column of staged f2 column 0, less the tile start

  const int my_items = (plan.items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_items * plan.nk;  // chunks this block streams

  // issue the copies of this block's chunk t into its ring stage
  auto issue = [&](int t) {
    const int k = t / plan.nk;
    const int item = blockIdx.x + k * gridDim.x;
    const int c0 = (t - k * plan.nk) * plan.ck;
    const int tile = item % plan.tiles, row = item / plan.tiles;
    const int y = row % h, b = row / h;
    const int x0 = tile * plan.tw;
    const int nch = min(plan.ck, c - c0);
    T* st = stages + (t % kStages) * plan.stage_elems;
    for (int ch = split.r0; ch < nch; ch += split.rstep) {
      const long long rofs = ((static_cast<long long>(b) * c + c0 + ch) * h + y) * w;
      T* dst = st + ch * plan.lr;
      for (int u = split.u0; u < plan.lr / V; u += split.ustep) {
        if (u < units1)
          corr1d::stage_unit(dst + u * V, f1 + rofs, x0 + u * V, w);
        else
          corr1d::stage_unit(dst + u * V, f2 + rofs, x0 + f2_x + (u - units1) * V, w);
      }
    }
  };

  // this thread: columns xl .. xl + 3 of the tile, displacements j0 .. j0 + 7
  const bool active = tid < plan.runs * plan.njg;
  const int r = tid % plan.runs, jg = tid / plan.runs;
  const int xl = kXT * r, j0 = kJT * jg;
  const float norm = static_cast<float>(c);
  const long long plane = static_cast<long long>(h) * w;
  const bool vec_out = w % 4 == 0;

  float acc[kXT][kJT];
#pragma unroll
  for (int a = 0; a < kXT; ++a)
#pragma unroll
    for (int j = 0; j < kJT; ++j) acc[a][j] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) issue(t);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk t is staged; every thread is done with chunk t - 1's stage
    if (t + kStages - 1 < total) issue(t + kStages - 1);
    cp_async_commit();

    const int k = t / plan.nk;
    const int kc = t - k * plan.nk;
    if (active) {
      const int nch = min(plan.ck, c - kc * plan.ck);
      const T* p1 = stages + (t % kStages) * plan.stage_elems + xl;
      const T* p2 = p1 + plan.l1 + j0 * s;
#pragma unroll 4
      for (int ch = 0; ch < nch; ++ch) {
        float fa[kXT];
        corr1d::load4(fa, p1 + ch * plan.lr);
        if constexpr (S > 0) {
          // f2 column xl + j0 s + m pairs column a with displacement (m - a) / S
          constexpr int NV = (kXT + (kJT - 1) * S + 3) / 4;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            float fb[4];
            corr1d::load4(fb, p2 + ch * plan.lr + 4 * v);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int a = 0; a < kXT; ++a) {
                const int d = 4 * v + e - a;
                if (d >= 0 && d % S == 0 && d / S < kJT) acc[a][d / S] = fmaf(fa[a], fb[e], acc[a][d / S]);
              }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kJT; ++j)
#pragma unroll
            for (int a = 0; a < kXT; ++a)
              acc[a][j] = fmaf(fa[a], to_f32(p2[ch * plan.lr + j * s + a]), acc[a][j]);
        }
      }
    }

    if (kc == plan.nk - 1) {  // the item's last chunk: its outputs leave from registers
      const int item = blockIdx.x + k * gridDim.x;
      const int tile = item % plan.tiles, row = item / plan.tiles;
      const int y = row % h, b = row / h;
      const int x = tile * plan.tw + xl;
      if (active && x < w) {
        T* ob = out + ((static_cast<long long>(b) * gw + j0) * h + y) * w + x;
#pragma unroll
        for (int j = 0; j < kJT; ++j) {
          if (j0 + j < gw) {
            float v[kXT];
#pragma unroll
            for (int a = 0; a < kXT; ++a) v[a] = acc[a][j] / norm;
            corr1d::store_cols(ob + j * plane, v, x, w, vec_out);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kXT; ++a)
#pragma unroll
        for (int j = 0; j < kJT; ++j) acc[a][j] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// The fewest column tiles whose threads (kXT-column runs x displacement
// groups) fit kMaxThreads and whose ring fits shared memory with chunks of
// 64 bytes a column (16 float32 or 32 bfloat16 channels); past one column
// unit a tile, smaller chunks.
bool make_plan(int n, int h, int w, int c, int gw, int s, int elem, Plan* plan) {
  Plan p{};
  const int unit = 16 / elem;
  p.njg = (gw + kJT - 1) / kJT;
  for (int ck = 64 / elem; ck >= 1; ck /= 2) {
    for (p.tiles = 1;; ++p.tiles) {
      p.tw = corr1d::round_up((w + p.tiles - 1) / p.tiles, unit);
      p.runs = p.tw / kXT;
      p.l1 = p.tw;
      // f2's staged columns: those its threads read, tw - 1 + (kJT njg - 1) s past the start at most
      p.lr = p.l1 + corr1d::round_up(p.tw + kJT * p.njg * s, unit);
      p.ck = std::min(ck, c);
      p.stage_elems = p.ck * p.lr;
      p.smem = static_cast<size_t>(kStages) * p.stage_elems * elem;
      p.threads = corr1d::round_up(p.runs * p.njg, 32);
      if (p.threads <= kMaxThreads && p.smem <= corr1d::kSmemLimit) {
        p.tiles = (w + p.tw - 1) / p.tw;
        p.nk = (c + p.ck - 1) / p.ck;
        const long long items = static_cast<long long>(n) * h * p.tiles;
        if (items >= (1LL << 31)) return false;
        p.items = static_cast<int>(items);
        *plan = p;
        return true;
      }
      if (p.tw <= unit) break;
    }
  }
  return false;
}

template <typename T, int S>
int launch_s(const void* f1, const void* f2, void* out, int n, int c, int h, int w, int stride2, int gw,
             int x_shift, const Plan& plan, cudaStream_t stream) {
  auto kernel = correlation1d_kernel<T, S>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int resident = corr1d::resident_blocks(kernel, plan.threads, plan.smem);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = std::min(plan.items, resident);
  kernel<<<grid, plan.threads, plan.smem, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                                    static_cast<T*>(out), c, h, w, stride2, gw, x_shift, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int n, int c, int h, int w, int stride2, int gw, int x_shift,
           cudaStream_t stream) {
  Plan plan;
  if (!make_plan(n, h, w, c, gw, stride2, sizeof(T), &plan)) return static_cast<int>(cudaErrorInvalidValue);
  if (stride2 == 1) return launch_s<T, 1>(f1, f2, out, n, c, h, w, stride2, gw, x_shift, plan, stream);
  if (stride2 == 2) return launch_s<T, 2>(f1, f2, out, n, c, h, w, stride2, gw, x_shift, plan, stream);
  return launch_s<T, 0>(f1, f2, out, n, c, h, w, stride2, gw, x_shift, plan, stream);
}

}  // namespace

// f1, f2 (N, C, H, W) contiguous, out (N, gw, H, W); single_direction's sign
// picks the side. Takes any C, alignment and stride2, and N H (column tiles)
// < 2^31; a gw whose f2 halo does not fit shared memory fails.
extern "C" int fn2_correlation_1d(const void* f1, const void* f2, void* out, int n, int c, int h, int w,
                                  int max_displacement, int stride2, int single_direction, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = max_displacement / stride2;
  const int gw = single_direction != 0 ? gr + 1 : 2 * gr + 1;
  const int x_shift = single_direction > 0 ? 0 : -gr;
  if (dtype == kFloat32) return launch<float>(f1, f2, out, n, c, h, w, stride2, gw, x_shift, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(f1, f2, out, n, c, h, w, stride2, gw, x_shift, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
