// 1-D (stereo) correlation forward, DispNet configuration: multiply mode,
// kernel_size 1, stride1 1, pad == max_displacement, any stride2 and
// single_direction.
//
//   out[n, j, y, x] = (1/C) * sum_c f1[n, y, x, c] * f2[n, y, x + (j + xs) * stride2, c]
//   gr = max_displacement / stride2; single_direction -1: gw = gr + 1,
//   xs = -gr; +1: gw = gr + 1, xs = 0; 0: gw = 2 gr + 1, xs = -gr;
//   f2 = 0 outside the map.
//
// Replaces flownet2_tpu/ops/correlation.py::_corr1d_selmm_fwd, an XLA
// banded matmul: per image row, the product of f1's row [W x C] with f2's
// padded row [C x (W + 2 md)], of which a one-hot selection matmul keeps
// the gw-wide band. This kernel computes the band alone.
//
// Layout: f1 and f2 (N, H, W, C) contiguous, channels innermost; out
// (N, gw, H, W), the layout the next convolution takes. Sums in float32,
// output in the input dtype (one rounding).
//
// Bound on the H100: bytes. At DispNetC's FlyingThings3D features
// (4x128x144x240, gw 41) the kernel reads 142 MB of f1 and f2 and writes
// 23 MB in float32 (0.049 ms at 3.35 TB/s) for 0.73 G multiply-adds
// (0.022 ms at the 67 TFLOP/s float32 peak). Without reuse in registers
// every FMA would need its own shared-memory load; as in csrc/correlation.cu
// a thread keeps XT f1 vectors and a sliding run of f2 vectors in
// registers: in float32 (XT 4) 14 16-byte loads feed 112 FMAs, in bfloat16
// (XT 2) 10 loads feed 112.
//
// Design. A block owns (n, y, a tile of columns). A whole padded row does
// not fit shared memory twice ((W/4 + 80) x 128 channels x 4 bytes is 205 KB
// at KITTI's width), so the tile is at most 128 columns a plane and the
// channels come in chunks of 16 float32 (32 bfloat16), 64 bytes a pixel:
// per chunk the f1 tile and the f2 tile with its one-sided halo of
// (gw - 1) stride2 columns are staged through a ring of two stages filled
// by cp.async (16-byte copies where a pixel's channels are 16-byte aligned,
// else 4-byte ones), zero-filled outside the map and past the last channel.
// Columns are stored split by x mod stride2 into planes, so that along one
// plane the displacements step one row at a time: output (x = x0 + q +
// stride2 i, j) pairs f1 row i of plane q with f2 row i + j of plane q. A
// thread owns XT neighbouring columns i of one plane times 7 displacements
// j; the lanes of a warp own neighbouring column runs, so they read rows XT
// apart, and one padding unit every XT rows puts 8 such rows in 8 distinct
// bank groups. Which column fills a staged row is a table built once per
// block: no integer division in the staging or compute loops. The gw x tile
// outputs go through shared memory and leave as rows of neighbouring x, so
// stores are coalesced.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kJT = 7;           // displacements a thread
constexpr int kUnits = 4;        // 16-byte units of a staged pixel chunk (64 bytes)
constexpr int kStages = 2;
constexpr int kMaxThreads = 256;
constexpr int kMaxTileCols = 128;  // plane columns a tile

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
  int runs;     // column runs of XT a plane and tile
  int nip;      // plane columns a tile: runs * XT
  int tiles;    // column tiles: gridDim.x
  int njg;      // displacement groups of kJT: ceil(gw / kJT)
  int f2p;      // f2 rows a plane: nip + njg * kJT - 1, rounded up to XT
  int items;    // threads with work: stride2 * njg * runs
  int rows;     // staged rows: stride2 * (nip + f2p)
  int threads;  // items rounded up to whole warps
  int stage_units;
  size_t smem;  // the row table, then kStages stages (the output tile reuses them)
};

template <typename T, int BYTES>
__global__ void __launch_bounds__(kMaxThreads, 2)
correlation1d_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out, int h, int w,
                     int c, int stride2, int gw, int x_shift, Plan plan) {
  constexpr int EPU = 16 / sizeof(T);  // channels a unit
  constexpr int CK = kUnits * EPU;     // channels a chunk
  constexpr int XT = kXT<T>;
  extern __shared__ uint4 smem[];
  int* table = reinterpret_cast<int*>(smem);  // map column of each staged row, or -1
  uint4* stages = smem + (plan.rows + 3) / 4;

  const int s = stride2;
  const int tile_cols = s * plan.nip;
  const int x0 = blockIdx.x * tile_cols;  // first column of the tile
  const int y = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int f1_rows = s * plan.nip;

  // the staged rows: f1 plane q row i is column x0 + q + s i; f2 plane q
  // row k is column x0 + q + s (k + x_shift)
  for (int row = tid; row < plan.rows; row += nthreads) {
    int xx;
    if (row < f1_rows) {
      const int q = row / plan.nip;
      xx = x0 + q + s * (row - q * plan.nip);
    } else {
      const int r2 = row - f1_rows;
      const int q = r2 / plan.f2p;
      xx = x0 + q + s * (r2 - q * plan.f2p + x_shift);
    }
    table[row] = xx >= 0 && xx < w ? xx : -1;
  }

  // this thread's work: column run r of plane q, displacements jg * kJT ..;
  // the staged units of its f1 and f2 rows
  const bool active = tid < plan.items;
  int t = active ? tid : 0;
  const int r = t % plan.runs;
  t /= plan.runs;
  const int q = t % s;
  const int jg = t / s;
  // f1 rows q * nip + XT r + a (a < XT) share one padding group: units u1 + 4 a
  const int u1 = row_unit<XT>(q * plan.nip + XT * r);
  int u2[XT + kJT - 1];
#pragma unroll
  for (int k = 0; k < XT + kJT - 1; ++k) u2[k] = row_unit<XT>(f1_rows + q * plan.f2p + XT * r + jg * kJT + k);

  float acc[XT][kJT];
#pragma unroll
  for (int a = 0; a < XT; ++a)
#pragma unroll
    for (int j = 0; j < kJT; ++j) acc[a][j] = 0.f;

  // row y of both maps; offsets within a row are 32-bit (W C < 2^31)
  const long long row0 = (static_cast<long long>(b) * h + y) * w * c;
  const T* f1r = f1 + row0;
  const T* f2r = f2 + row0;
  __syncthreads();  // the table is built

  // issue the copies of channels c0 .. c0 + CK - 1 into stage st
  auto stage_chunk = [&](int st, int c0) {
    uint4* dst_stage = stages + st * plan.stage_units;
    constexpr int PER_ROW = kUnits * 16 / BYTES;  // copies a row
    for (int i = tid; i < plan.rows * PER_ROW; i += nthreads) {
      const int row = i / PER_ROW, k = i % PER_ROW;  // compile-time divisor
      const int xx = table[row];
      const int ch = c0 + k * (BYTES / static_cast<int>(sizeof(T)));
      const bool valid = xx >= 0 && ch < c;
      const T* base = row < f1_rows ? f1r : f2r;
      const T* src = valid ? base + xx * c + ch : f1r;
      char* dst = reinterpret_cast<char*>(dst_stage + row_unit<XT>(row)) + k * BYTES;
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

  // the gw x tile outputs through shared memory, then out as rows of
  // neighbouring x
  cp_async_wait<0>();
  float* os = reinterpret_cast<float*>(stages);
  const float norm = static_cast<float>(c);
  if (active) {
#pragma unroll
    for (int a = 0; a < XT; ++a) {
      const int lx = q + s * (XT * r + a);
#pragma unroll
      for (int jl = 0; jl < kJT; ++jl) {
        const int j = jg * kJT + jl;
        if (x0 + lx < w && j < gw) os[j * tile_cols + lx] = acc[a][jl] / norm;
      }
    }
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  const int cols = min(tile_cols, w - x0);
  const long long plane = static_cast<long long>(h) * w;
  T* ob = out + (static_cast<long long>(b) * gw * h + y) * w + x0;
  for (int j = warp; j < gw; j += nthreads >> 5)
    for (int lx = lane; lx < cols; lx += 32) ob[j * plane + lx] = from_f32<T>(os[j * tile_cols + lx]);
}

// The widest tile of at most kMaxTileCols columns a plane whose threads
// (stride2 * njg * runs) fit kMaxThreads and whose stages fit 227 KB; the
// tiles split a plane's column runs evenly.
bool make_plan(int w, int gw, int stride2, int xt, Plan* plan) {
  Plan p{};
  p.njg = (gw + kJT - 1) / kJT;
  const int cols = (w + stride2 - 1) / stride2;  // columns of the widest plane
  const int runs_all = (cols + xt - 1) / xt;
  const int max_runs = std::min(kMaxTileCols / xt, kMaxThreads / (stride2 * p.njg));
  for (int per_tile = max_runs; per_tile >= 1; --per_tile) {
    p.tiles = (runs_all + per_tile - 1) / per_tile;
    p.runs = (runs_all + p.tiles - 1) / p.tiles;
    p.nip = p.runs * xt;
    p.f2p = (p.nip + p.njg * kJT - 1 + xt - 1) / xt * xt;
    p.items = stride2 * p.njg * p.runs;
    p.threads = (p.items + 31) / 32 * 32;
    p.rows = stride2 * (p.nip + p.f2p);
    p.stage_units = kUnits * p.rows + (p.rows + xt - 1) / xt;
    const size_t stages = static_cast<size_t>(kStages) * p.stage_units * 16;
    const size_t out_tile = static_cast<size_t>(gw) * stride2 * p.nip * sizeof(float);
    p.smem = static_cast<size_t>((p.rows + 3) / 4) * 16 + std::max(stages, out_tile);
    if (p.smem <= 227 * 1024) {
      *plan = p;
      return true;
    }
  }
  return false;
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int n, int h, int w, int c, int stride2, int gw,
           int x_shift, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(w, gw, stride2, kXT<T>, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(plan.tiles, h, n);
  // 16-byte copies need every pixel's channels to start 16-byte aligned
  const bool vec16 = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  auto kernel = vec16 ? correlation1d_kernel<T, 16> : correlation1d_kernel<T, 4>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, plan.threads, plan.smem, stream>>>(static_cast<const T*>(f1), static_cast<const T*>(f2),
                                                    static_cast<T*>(out), h, w, c, stride2, gw, x_shift, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f1, f2 (N, H, W, C), out (N, gw, H, W); single_direction's sign picks the
// side. Takes W C < 2^31, stride2 * ceil(gw / 7) <= 256, and in bfloat16 an
// even C (4-byte copies).
extern "C" int fn2_correlation_1d(const void* f1, const void* f2, void* out, int n, int h, int w, int c,
                                  int max_displacement, int stride2, int single_direction, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = max_displacement / stride2;
  const int gw = single_direction != 0 ? gr + 1 : 2 * gr + 1;
  const int x_shift = single_direction > 0 ? 0 : -gr;
  if (dtype == kFloat32) return launch<float>(f1, f2, out, n, h, w, c, stride2, gw, x_shift, s);
  if (dtype == kBFloat16 && c % 2 == 0)
    return launch<__nv_bfloat16>(f1, f2, out, n, h, w, c, stride2, gw, x_shift, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
