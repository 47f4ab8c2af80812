// Correlation forward, FlowNet configuration: multiply mode, kernel_size 1,
// stride1 1, pad == max_displacement, any stride2.
//
//   out[n, d, y, x] = (1/C) * sum_c f1[n, y, x, c] * f2[n, y+dy, x+dx, c]
//   (dy, dx) = ((d / gw - gr) * stride2, (d % gw - gr) * stride2),
//   gr = max_displacement / stride2, gw = 2*gr + 1, f2 = 0 outside the map.
//
// Replaces flownet2_tpu/ops/correlation.py::correlation_auto, whose FlowNet
// route _corr_selmm_fwd is an XLA banded matmul: for each (n, y, dy) the
// product of f1's row [W x C] with f2's shifted row [C x (W + 2 md)], of
// which only the band x + dx is kept. This kernel computes that band.
//
// Layout: f1 and f2 (N, H, W, C) contiguous, channels innermost; out
// (N, gw*gw, H, W), the layout the next convolution takes. Sums in float32,
// output in the input dtype (one rounding).
//
// Bound on the H100: float32 FMAs and shared-memory bandwidth. At FlowNetC's
// 8x40x56x256 -> 441 channels the kernel does 2.0 G multiply-adds on 37 MB
// of inputs (0.06 ms at the 67 TFLOP/s float32 peak). Each product reads
// one f1 and one f2 value; without reuse in registers every FMA would need
// its own shared-memory load, and the SM loads 128 bytes a cycle against
// 128 FMAs. The design keeps XT f1 vectors and a sliding run of f2 vectors
// in registers: in float32 (XT 4) 14 16-byte loads feed 112 FMAs (2 bytes
// a multiply-add), in bfloat16 (XT 2) 10 loads feed 112 (1.4 bytes).
//
// Design. A block owns (n, y, DY consecutive displacement rows dy) and the
// whole width. Per chunk of 16 float32 (32 bfloat16) channels, 64 bytes a
// pixel, it stages in shared memory the f1 row and the DY f2 rows it needs
// (each with gr * stride2 columns of zero halo), through a ring of two
// stages filled by cp.async (16-byte copies where a pixel's channels are
// 16-byte aligned, else 4-byte ones), zero-filled outside the map and past
// the last channel. Columns are stored split by x mod stride2 into planes,
// so that along one plane the displacements dx = stride2 (j - gr) step one
// row at a time: output (x = q + stride2 i, j) pairs f1 row i of plane q
// with f2 row i + j of plane q. A thread owns XT neighbouring columns i of
// one plane times 7 displacements j of one dy: per 16-byte channel vector,
// it loads the XT f1 vectors and the XT + 6 f2 vectors i + j its 7 XT sums
// need. The lanes of a warp own neighbouring column runs, so they read rows
// XT apart; one padding unit every XT rows puts 8 such rows in 8 distinct
// bank groups. Blocks of at most 320 threads at up to 102 registers, two an
// SM, so that one block's staging and barriers overlap the other's math. Which pixel fills a staged row is a table built once per block:
// no integer division in the staging or compute loops, and no shuffles.
// The 441 x W output tile goes through shared memory and leaves as rows of
// neighbouring x, so stores are coalesced.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kJT = 7;          // horizontal displacements a thread
constexpr int kUnits = 4;       // 16-byte units of a staged pixel chunk (64 bytes)
constexpr int kStages = 2;
constexpr int kMaxThreads = 320;  // two blocks an SM at up to 102 registers a thread

// f1 columns (of one plane) a thread: 4 in float32, 2 in bfloat16, whose
// 8-channel units widen to twice the registers
template <typename T>
constexpr int kXT = sizeof(T) == 4 ? 4 : 2;

// shared-memory unit of staged row `row`: 4 units a row, one padding unit
// every XT rows, so that the rows XT apart that neighbouring lanes read sit
// in distinct bank groups
template <int XT>
__device__ __forceinline__ int row_unit(int row) {
  return kUnits * row + row / XT;
}

// one 16-byte unit as float32 values: 4 floats, or 8 bfloat16 widened
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(float (&v)[N], const uint4& u) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(float (&v)[N], const uint4& u) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// The launch's geometry, computed on the host.
struct Plan {
  int runs;     // column runs of XT per plane
  int nip;      // f1 rows per plane: runs * XT
  int njg;      // displacement groups of kJT: ceil(gw / kJT)
  int f2p;      // f2 rows per plane: nip + njg * kJT - 1, rounded up to XT
  int dy;       // displacement rows per block (divides gw)
  int items;    // threads with work: dy * stride2 * njg * runs
  int rows;     // staged rows: stride2 * nip + dy * stride2 * f2p
  int threads;  // items rounded up to whole warps
  int stage_units;
  size_t smem;  // the row table, then kStages stages
};

template <typename T, int BYTES>
__global__ void __launch_bounds__(kMaxThreads, 2)
correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out, int h, int w, int c,
                   int stride2, int gr, Plan plan) {
  constexpr int EPU = 16 / sizeof(T);  // channels a unit
  constexpr int CK = kUnits * EPU;     // channels a chunk
  constexpr int XT = kXT<T>;
  extern __shared__ uint4 smem[];
  int* table = reinterpret_cast<int*>(smem);  // pixel (yy * w + xx) of each staged row, or -1
  uint4* stages = smem + (plan.rows + 3) / 4;

  const int gw = 2 * gr + 1;
  const int b = blockIdx.z, y = blockIdx.y;
  const int p0 = blockIdx.x * plan.dy;  // first displacement row of the block
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int f1_rows = stride2 * plan.nip;

  // the staged rows: f1 plane q row i is column q + stride2 i of row y; f2
  // row (dyl, q, k) is column q + stride2 (k - gr) of row y + (p0 + dyl - gr) stride2
  for (int row = tid; row < plan.rows; row += nthreads) {
    int yy, xx;
    if (row < f1_rows) {
      const int q = row / plan.nip;
      yy = y;
      xx = q + stride2 * (row - q * plan.nip);
    } else {
      const int r2 = row - f1_rows;
      const int plane = r2 / plan.f2p;  // dyl * stride2 + q
      const int dyl = plane / stride2, q = plane - dyl * stride2;
      yy = y + (p0 + dyl - gr) * stride2;
      xx = q + stride2 * (r2 - plane * plan.f2p - gr);
    }
    table[row] = (yy >= 0 && yy < h && xx >= 0 && xx < w) ? yy * w + xx : -1;
  }

  // this thread's work: column run r of plane q, displacements jg * kJT ..,
  // displacement row dyl; the staged units of its f1 and f2 rows
  const bool active = tid < plan.items;
  int t = active ? tid : 0;
  const int r = t % plan.runs;
  t /= plan.runs;
  const int q = t % stride2;
  t /= stride2;
  const int jg = t % plan.njg;
  const int dyl = t / plan.njg;
  // f1 rows q * nip + XT r + a (a < XT) share one padding group: units u1 + 4 a
  const int u1 = row_unit<XT>(q * plan.nip + XT * r);
  int u2[XT + kJT - 1];
#pragma unroll
  for (int k = 0; k < XT + kJT - 1; ++k)
    u2[k] = row_unit<XT>(f1_rows + (dyl * stride2 + q) * plan.f2p + XT * r + jg * kJT + k);

  float acc[XT][kJT];
#pragma unroll
  for (int a = 0; a < XT; ++a)
#pragma unroll
    for (int j = 0; j < kJT; ++j) acc[a][j] = 0.f;

  const long long img = static_cast<long long>(b) * h * w;
  const T* f1b = f1 + img * c;
  const T* f2b = f2 + img * c;
  __syncthreads();  // the table is built

  // issue the copies of channels c0 .. c0 + CK - 1 into stage s
  auto stage_chunk = [&](int s, int c0) {
    uint4* st = stages + s * plan.stage_units;
    constexpr int PER_ROW = kUnits * 16 / BYTES;  // copies a row
    for (int i = tid; i < plan.rows * PER_ROW; i += nthreads) {
      const int row = i / PER_ROW, k = i % PER_ROW;  // compile-time divisor
      const int pix = table[row];
      const int ch = c0 + k * (BYTES / static_cast<int>(sizeof(T)));
      const bool valid = pix >= 0 && ch < c;
      const T* base = row < f1_rows ? f1b : f2b;
      const T* src = valid ? base + static_cast<long long>(pix) * c + ch : f1b;
      char* dst = reinterpret_cast<char*>(st + row_unit<XT>(row)) + k * BYTES;
      cp_async<BYTES>(dst, src, valid);
    }
  };

  const int nchunks = (c + CK - 1) / CK;
  stage_chunk(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int kc = 0; kc < nchunks; ++kc) {
    if (kc + 1 < nchunks) stage_chunk((kc + 1) % kStages, (kc + 1) * CK);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const uint4* st = stages + (kc % kStages) * plan.stage_units;
    if (active) {
#pragma unroll
      for (int v = 0; v < kUnits; ++v) {
        float fa[XT][Vec<T>::N];
#pragma unroll
        for (int a = 0; a < XT; ++a) Vec<T>::load(fa[a], st[u1 + 4 * a + v]);
#pragma unroll
        for (int k = 0; k < XT + kJT - 1; ++k) {
          float fb[Vec<T>::N];
          Vec<T>::load(fb, st[u2[k] + v]);
#pragma unroll
          for (int a = 0; a < XT; ++a) {
            const int j = k - a;
            if (j >= 0 && j < kJT) {
#pragma unroll
              for (int e = 0; e < Vec<T>::N; ++e) acc[a][j] = fmaf(fa[a][e], fb[e], acc[a][j]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is read; it is refilled next
  }

  // the block's (dy rows x gw) x w outputs through shared memory, then out
  // as rows of neighbouring x
  cp_async_wait<0>();
  float* os = reinterpret_cast<float*>(stages);
  const float norm = static_cast<float>(c);
  if (active) {
#pragma unroll
    for (int a = 0; a < XT; ++a) {
      const int x = q + stride2 * (XT * r + a);
#pragma unroll
      for (int jl = 0; jl < kJT; ++jl) {
        const int j = jg * kJT + jl;
        if (x < w && j < gw) os[(dyl * gw + j) * w + x] = acc[a][jl] / norm;
      }
    }
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  T* ob = out + ((static_cast<long long>(b) * gw * gw + p0 * gw) * h + y) * w;
  for (int row = warp; row < plan.dy * gw; row += nthreads >> 5)
    for (int x = lane; x < w; x += 32) ob[static_cast<long long>(row) * h * w + x] = from_f32<T>(os[row * w + x]);
}

// The largest block that fits: dy a divisor of gw, at most kMaxThreads
// threads and 227 KB of shared memory, preferring two blocks an SM
// (<= 113 KB).
bool make_plan(int w, int gw, int stride2, int xt, Plan* plan) {
  const int cols = (w + stride2 - 1) / stride2;  // columns of the widest plane
  Plan p{};
  p.runs = (cols + xt - 1) / xt;
  p.nip = p.runs * xt;
  p.njg = (gw + kJT - 1) / kJT;
  p.f2p = (p.nip + p.njg * kJT - 1 + xt - 1) / xt * xt;
  for (int limit : {113 * 1024, 227 * 1024}) {
    for (int dy = gw; dy >= 1; --dy) {
      if (gw % dy != 0) continue;
      p.dy = dy;
      p.items = dy * stride2 * p.njg * p.runs;
      p.threads = (p.items + 31) / 32 * 32;
      p.rows = stride2 * p.nip + dy * stride2 * p.f2p;
      p.stage_units = kUnits * p.rows + (p.rows + xt - 1) / xt;
      const size_t stages = static_cast<size_t>(kStages) * p.stage_units * 16;
      p.smem = static_cast<size_t>((p.rows + 3) / 4) * 16 + stages;
      const size_t out_tile = static_cast<size_t>(dy) * gw * w * sizeof(float);
      if (p.threads <= kMaxThreads && p.smem <= static_cast<size_t>(limit) && out_tile <= stages) {
        *plan = p;
        return true;
      }
    }
  }
  return false;
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int n, int h, int w, int c, int stride2, int gr,
           cudaStream_t stream) {
  const int gw = 2 * gr + 1;
  Plan plan;
  if (!make_plan(w, gw, stride2, kXT<T>, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(gw / plan.dy, h, n);
  // 16-byte copies need every pixel's channels to start 16-byte aligned
  const bool vec16 = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0;
  auto kernel = vec16 ? correlation_kernel<T, 16> : correlation_kernel<T, 4>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, plan.threads, plan.smem, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                                    static_cast<T*>(out), h, w, c, stride2, gr, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1, f2 (N, H, W, C), out (N, gw*gw, H, W); bfloat16 needs an even C (4-byte copies).
extern "C" int fn2_correlation(const void* f1, const void* f2, void* out, int n, int h, int w,
                               int c, int max_displacement, int stride2, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = max_displacement / stride2;
  if (dtype == kFloat32) return launch<float>(f1, f2, out, n, h, w, c, stride2, gr, s);
  if (dtype == kBFloat16 && c % 2 == 0) return launch<__nv_bfloat16>(f1, f2, out, n, h, w, c, stride2, gr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
