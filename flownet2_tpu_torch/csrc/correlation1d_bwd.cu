// 1-D (stereo) correlation backward, DispNet configuration (multiply mode,
// kernel_size 1, stride1 1, pad == max_displacement, any stride2 and
// single_direction): the VJP of csrc/correlation1d.cu.
//
//   df1[n, y, x, c]  = (1/C) sum_j g[n, j, y, x] * f2[n, y, x + (j + xs) s, c]
//   df2[n, y, x', c] = (1/C) sum_j g[n, j, y, x' - (j + xs) s] * f1[n, y, x' - (j + xs) s, c]
//
// over the displacements j whose partner column lies inside the map (the
// zero padding contributes nothing); s = stride2, gw and xs as in the
// forward.
//
// Replaces flownet2_tpu/ops/correlation.py::_corr1d_selmm_bwd, which on the
// TPU runs both transposed products as banded matmuls on the MXU (a
// selection matmul to un-band g, then a contraction over the band for df1
// and over x for df2). Here both are gather-form, so each output element is
// summed in one thread's registers and written once, with no atomics.
//
// One form for both passes. With the displacement inverted (o = gw - 1 - j),
// df2 has df1's form:
//
//   out[y, x, c] = (1/C) sum_o G(o, x) * F[y, x + (o + xs') s, c]
//
// with F = f2, G = g[o, y, x], xs' = xs for df1, and F = f1,
// G = g[gw - 1 - o, y, x + (o + xs') s], xs' = -(gw - 1 + xs) for df2. One
// kernel template serves both; blockIdx.x carries the pass, so a call that
// asks for both gradients is one launch.
//
// Layout: f1, f2, df1, df2 (N, H, W, C) contiguous, channels innermost; g
// (N, gw, H, W) contiguous, the forward's output layout. Sums in float32 on
// the CUDA cores in both dtypes, one rounding to the input dtype.
//
// Bound on the H100: bytes. At DispNetC's FlyingThings3D features
// (4x128x144x240, gw 41) the two passes read f1, f2 and g and write df1 and
// df2, 306 MB in float32 (0.091 ms at 3.35 TB/s), for 1.45 G multiply-adds
// (0.043 ms at the 67 TFLOP/s float32 peak). As in csrc/correlation_bwd.cu,
// one f vector serves every (column, displacement) pair on its diagonal: at
// stride2 s, output column i of plane q = x mod s at displacement o reads
// staged f row i + o of that plane, so (i + 1, o - 1) reads the same row.
//
// Design. A block owns (pass, n, output row y, a tile of at most 16 column
// runs across the planes; above stride2 16, a group of the planes) and walks
// the channels in runs of 64. The tile's gw x columns g values are staged
// once, as float32 split by plane, zero where the partner pixel is outside.
// Per channel run the f row with its (gw - 1) s columns of halo is staged
// channels-innermost through a two-stage cp.async ring (16-byte copies where
// a pixel's channels are 16-byte aligned, 4-byte copies elsewhere,
// zero-filled outside the map and past the last channel), so the next run's
// copies fly while this one computes. A thread owns XT = 4 neighbouring
// columns of one plane times CT = 4 channels: per displacement it loads one
// new f vector (the sliding run along the diagonal; 16 bytes in float32, 8
// in bfloat16) and one 16-byte vector of the 4 columns' g values, for 16
// FMAs. The 16 lanes of a column run read 16 neighbouring channel vectors of
// one row (conflict-free) and share one g vector (a broadcast). Which column
// fills a staged f row is a table built once per block: no integer division
// in the staging or compute loops.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kXT = 4;                  // columns of one plane a thread
constexpr int kCT = 4;                  // channels a thread
constexpr int kLanes = 16;              // threads a column run
constexpr int kCB = kLanes * kCT;       // channels a run
constexpr int kMaxThreads = 256;        // 16 column runs a block
constexpr int kMaxRuns = kMaxThreads / kLanes;
constexpr int kStages = 2;

// kCT staged channels as float32: one 16-byte float32 vector, or one 8-byte
// vector of 4 bfloat16 widened
__device__ __forceinline__ void load_ct(float (&v)[kCT], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load_ct(float (&v)[kCT], const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// kCT outputs of one pixel: one vector store where the channels are aligned
template <bool kVec>
__device__ __forceinline__ void store_ct(float* dst, const float (&v)[kCT], int valid) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kCT; ++e)
      if (e < valid) dst[e] = v[e];
  }
}
template <bool kVec>
__device__ __forceinline__ void store_ct(__nv_bfloat16* dst, const float (&v)[kCT], int valid) {
  if constexpr (kVec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  } else {
#pragma unroll
    for (int e = 0; e < kCT; ++e)
      if (e < valid) dst[e] = __float2bfloat16_rn(v[e]);
  }
}

// The launch's geometry, computed on the host.
struct Plan {
  int planes;    // x mod stride2 planes a block
  int qgroups;   // plane groups: stride2 <= qgroups * planes
  int runs;      // column runs of kXT a plane and tile
  int nip;       // plane columns a tile: runs * kXT
  int tiles;     // column tiles
  int cruns;     // channel runs of kCB
  int fpp;       // staged f rows a plane: nip + gw - 1
  int frows;     // staged f rows: planes * fpp
  int gtile;     // staged g values: gw * planes * nip
  int threads;   // planes * runs * kLanes
  int npass;     // 1, or 2 when both gradients are asked for
  int pass0;     // 0 (df1) or 1 (df2): the first pass
  size_t g_bytes;      // the staged g values, rounded up to 16 bytes
  size_t table_bytes;  // the f table, rounded up to 16 bytes
  size_t stage_bytes;  // one ring stage of f rows
  size_t smem;
};

template <typename T, int BYTES>
__global__ void __launch_bounds__(kMaxThreads, 3)
correlation1d_backward_kernel(const T* __restrict__ f1, const T* __restrict__ f2, const T* __restrict__ g,
                              T* __restrict__ df1, T* __restrict__ df2, int h, int w, int c, int stride2, int gw,
                              int x_shift, Plan plan) {
  constexpr int ROW = kCB * static_cast<int>(sizeof(T));  // bytes of a staged f row
  constexpr int PER_ROW = ROW / BYTES;                      // copies a row
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  float* gs = reinterpret_cast<float*>(base);                  // G of each staged g slot
  int* ftab = reinterpret_cast<int*>(base + plan.g_bytes);     // map column of each staged f row, or -1
  char* stages = base + plan.g_bytes + plan.table_bytes;

  const int s = stride2, np = plan.planes;
  // blockIdx.x = (pass * qgroups + qgroup) * tiles + tile
  int bx = blockIdx.x;
  const int tile = bx % plan.tiles;
  bx /= plan.tiles;
  const int q0 = (bx % plan.qgroups) * np;  // first plane of the block; planes >= s are empty
  const int pass = plan.pass0 + bx / plan.qgroups;
  const int y = blockIdx.y, b = blockIdx.z;
  const int ibase = tile * plan.nip;  // first plane column of the tile
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long hw = static_cast<long long>(h) * w;
  // the partner column of x at displacement o is x + (o + xs) s
  const int xs = pass == 0 ? x_shift : -(gw - 1 + x_shift);

  // g slot e = (o * np + jq) * nip + i holds G(o) at column x = q0 + jq + s (ibase + i):
  // df1 reads g[o, y, x], df2 g[gw - 1 - o, y, x + (o + xs) s]
  const T* gb = g + (static_cast<long long>(b) * gw * h + y) * w;
  for (int e = tid; e < plan.gtile; e += nthreads) {
    const int o = e / (np * plan.nip);
    const int rem = e - o * np * plan.nip;
    const int jq = rem / plan.nip;
    const int x = q0 + jq + s * (ibase + rem - jq * plan.nip);
    const int xp = x + (o + xs) * s;
    const bool valid = q0 + jq < s && x < w && xp >= 0 && xp < w;
    gs[e] = !valid ? 0.f : to_f32(pass == 0 ? gb[o * hw + x] : gb[(gw - 1 - o) * hw + xp]);
  }
  // f row k of plane q0 + jq is map column q0 + jq + s (ibase + k + xs)
  for (int row = tid; row < plan.frows; row += nthreads) {
    const int jq = row / plan.fpp;
    const int xx = q0 + jq + s * (ibase + row - jq * plan.fpp + xs);
    ftab[row] = q0 + jq < s && xx >= 0 && xx < w ? xx : -1;
  }

  // this thread: channel lane l of column run r of plane q = q0 + jq
  const int l = tid % kLanes;
  const int cr = tid / kLanes;
  const int jq = cr / plan.runs;
  const int q = q0 + jq;
  const int i0 = kXT * (cr - jq * plan.runs);

  // row y of the partner map and of the output; offsets within a row are
  // 32-bit (W C < 2^31)
  const T* F = pass == 0 ? f2 : f1;
  const long long row0 = (static_cast<long long>(b) * h + y) * w * c;
  const T* Fr = F + row0;
  T* outr = (pass == 0 ? df1 : df2) + row0;
  __syncthreads();  // g and the table are staged

  auto stage_f = [&](int st, int c0) {
    char* dst = stages + st * plan.stage_bytes;
    for (int i = tid; i < plan.frows * PER_ROW; i += nthreads) {
      const int row = i / PER_ROW, k = i % PER_ROW;  // compile-time divisor
      const int xx = ftab[row];
      const int cc = c0 + k * (BYTES / static_cast<int>(sizeof(T)));
      const bool valid = xx >= 0 && cc < c;
      const T* src = valid ? Fr + xx * c + cc : F;
      cp_async<BYTES>(dst + row * ROW + k * BYTES, src, valid);
    }
  };

  const int gstride = np * plan.nip;  // floats between the g rows of two o
  const float* grow = gs + jq * plan.nip + i0;
  const float inv_c = 1.f / static_cast<float>(c);
  stage_f(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int run = 0; run < plan.cruns; ++run) {
    const int st = run & 1;
    if (run + 1 < plan.cruns) stage_f(st ^ 1, (run + 1) * kCB);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // the f rows of this channel run are staged

    float acc[kXT][kCT];
#pragma unroll
    for (int a = 0; a < kXT; ++a)
#pragma unroll
      for (int e = 0; e < kCT; ++e) acc[a][e] = 0.f;
    // column a at displacement o reads f row i0 + o + a of plane q, held
    // in slot (o + a) % kXT of a sliding window
    const T* frow = reinterpret_cast<const T*>(stages + st * plan.stage_bytes + (jq * plan.fpp + i0) * ROW) +
                    l * kCT;
    float fw[kXT][kCT];
#pragma unroll
    for (int a = 0; a < kXT - 1; ++a) load_ct(fw[a], frow + a * kCB);
#pragma unroll 1
    for (int og = 0; og < gw; og += kXT) {
#pragma unroll
      for (int u = 0; u < kXT; ++u) {
        const int o = og + u;
        if (o < gw) {  // uniform across the block
          load_ct(fw[(u + kXT - 1) % kXT], frow + (o + kXT - 1) * kCB);
          const float4 gq = *reinterpret_cast<const float4*>(grow + o * gstride);
          const float gg[kXT] = {gq.x, gq.y, gq.z, gq.w};
#pragma unroll
          for (int a = 0; a < kXT; ++a)
#pragma unroll
            for (int e = 0; e < kCT; ++e) acc[a][e] = fmaf(gg[a], fw[(u + a) % kXT][e], acc[a][e]);
        }
      }
    }

    const int ch = run * kCB + l * kCT;
    if (ch < c && q < s) {
#pragma unroll
      for (int a = 0; a < kXT; ++a) {
        const int x = q + s * (ibase + i0 + a);
        if (x < w) {
          float v[kCT];
#pragma unroll
          for (int e = 0; e < kCT; ++e) v[e] = acc[a][e] * inv_c;
          store_ct<BYTES == 16>(outr + x * c + ch, v, c - ch);
        }
      }
    }
    __syncthreads();  // the stage is read; it is refilled next
  }
  cp_async_wait<0>();
}

// Planes in groups of at most kMaxRuns, then the widest column tile of at
// most kMaxRuns column runs across a group's planes whose g values and two
// ring stages fit shared memory.
bool make_plan(int w, int c, int stride2, int gw, bool need1, bool need2, size_t elem, Plan* plan) {
  Plan p{};
  p.qgroups = (stride2 + kMaxRuns - 1) / kMaxRuns;
  p.planes = (stride2 + p.qgroups - 1) / p.qgroups;
  p.cruns = (c + kCB - 1) / kCB;
  p.npass = need1 && need2 ? 2 : 1;
  p.pass0 = need1 ? 0 : 1;
  const int cols = (w + stride2 - 1) / stride2;  // columns of the widest plane
  const int runs = (cols + kXT - 1) / kXT;
  for (int per_tile = kMaxRuns / p.planes; per_tile >= 1; --per_tile) {
    p.tiles = (runs + per_tile - 1) / per_tile;
    p.runs = (runs + p.tiles - 1) / p.tiles;
    p.nip = p.runs * kXT;
    p.fpp = p.nip + gw - 1;
    p.frows = p.planes * p.fpp;
    p.gtile = gw * p.planes * p.nip;
    p.threads = p.planes * p.runs * kLanes;
    p.g_bytes = (static_cast<size_t>(p.gtile) * 4 + 15) / 16 * 16;
    p.table_bytes = (static_cast<size_t>(p.frows) * 4 + 15) / 16 * 16;
    p.stage_bytes = static_cast<size_t>(p.frows) * kCB * elem;
    p.smem = p.g_bytes + p.table_bytes + kStages * p.stage_bytes;
    if (p.smem <= 227 * 1024) {
      *plan = p;
      return true;
    }
  }
  return false;
}

template <typename T>
int launch(const void* f1, const void* f2, const void* g, void* df1, void* df2, int n, int h, int w, int c,
           int stride2, int gw, int x_shift, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(w, c, stride2, gw, df1 != nullptr, df2 != nullptr, sizeof(T), &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(plan.npass * plan.qgroups * plan.tiles, h, n);
  // 16-byte copies need every pixel's channels to start 16-byte aligned
  const bool vec16 = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  auto kernel = vec16 ? correlation1d_backward_kernel<T, 16> : correlation1d_backward_kernel<T, 4>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, plan.threads, plan.smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const T*>(g), static_cast<T*>(df1),
      static_cast<T*>(df2), h, w, c, stride2, gw, x_shift, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// df1 / df2: (N, H, W, C) outputs in the inputs' dtype, or null to skip one
// (not both). Takes any stride2, a gw whose g values and f rows of one
// column run fit shared memory, W C < 2^31, and in bfloat16 an even C
// (4-byte copies).
extern "C" int fn2_correlation_1d_backward(const void* f1, const void* f2, const void* g, void* df1, void* df2,
                                           int n, int h, int w, int c, int max_displacement, int stride2,
                                           int single_direction, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = max_displacement / stride2;
  const int gw = single_direction != 0 ? gr + 1 : 2 * gr + 1;
  const int x_shift = single_direction > 0 ? 0 : -gr;
  if (df1 == nullptr && df2 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) return launch<float>(f1, f2, g, df1, df2, n, h, w, c, stride2, gw, x_shift, s);
  if (dtype == kBFloat16 && c % 2 == 0)
    return launch<__nv_bfloat16>(f1, f2, g, df1, df2, n, h, w, c, stride2, gw, x_shift, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
