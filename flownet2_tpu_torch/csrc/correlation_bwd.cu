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
// output blocks). Here both are gather-form, so each output element is
// summed in one thread's registers and written once, with no atomics.
//
// One form for both passes. With the displacement inverted (p -> 2gr - p,
// o -> 2gr - o, so d -> gw*gw - 1 - d), df2 has df1's form:
//
//   out[y, x, c] = (1/C) sum_(p, o) G(p, o, y, x) * F[y + dy_p, x + dx_o, c]
//
// with F = f2, G = g[p gw + o, y, x] for df1, and F = f1,
// G = g[gw*gw - 1 - (p gw + o), y + dy_p, x + dx_o] for df2. One kernel
// template serves both; blockIdx.x carries the pass, so a call that asks
// for both gradients is one launch.
//
// Layout: f1, f2, df1, df2 (N, H, W, C) contiguous, channels innermost; g
// (N, gw*gw, H, W) contiguous, the forward's output layout. Sums in
// float32 on the CUDA cores in both dtypes, one rounding to the input dtype.
//
// Bound on the H100: float32 FMAs against shared-memory loads. At FlowNetC's
// 8x40x56x256 with 441 displacements each pass is 2.0 G multiply-adds (both
// passes 0.12 ms at the 67 TFLOP/s float32 peak) on 55 MB of inputs and
// outputs. A gather with one channel a thread pays a 4-byte global f load
// and a 4-byte shared g load for every FMA (2.9-3.1 ms on an H100, 4% of
// the bound's rate). Here one f vector serves every (column, displacement)
// pair on its diagonal: at stride2 s, output column i of plane q = x mod s
// at horizontal displacement o reads staged f row i + o of that plane, so
// (i + 1, o - 1) reads the same row.
//
// Design. A block owns (pass, n, output row y, a run of 64 channels, a tile
// of at most 16 column runs across the planes; above stride2 16, a group of
// the planes) and keeps its outputs in registers across all gw displacement
// rows. A thread owns XT = 4
// neighbouring columns of one plane times CT = 4 channels: per horizontal
// displacement it loads one new f vector (the sliding run along the
// diagonal; 16 bytes in float32, 8 in bfloat16) and one 16-byte vector of
// the 4 columns' g values, for 16 FMAs. The 16 lanes of a column run read
// 16 neighbouring channel vectors of one row (conflict-free) and share one
// g vector (a broadcast). Per displacement row p whose partner row lies in
// the map (the others are skipped whole), the f row with its gr * stride2
// columns of halo is staged channels-innermost in shared memory through a
// two-stage cp.async ring (16-byte copies where a pixel's channels are
// 16-byte aligned, 4-byte copies elsewhere, zero-filled outside the map and
// past the last channel), and the row's gw x tile g values are loaded into
// registers while the previous row computes, then stored as float32 split
// by plane, zero where the partner pixel is outside. Where a row has more g
// values than 12 a thread (gw above 48 at FlowNet's widths), they go
// straight to shared memory after the row computes, and the column tile
// narrows until the ring fits, so gw is bounded by shared memory alone
// (about 400 at stride2 1 in float32). Which pixel fills a
// staged f row, and which g element fills a staged g slot, are tables built
// once per block: no integer division in the staging or compute loops.
// Three blocks an SM (at most 85 registers a thread, 64-70 KB of shared
// memory a block at FlowNetC's widths), so that one block's staging and
// barriers overlap two others' math: on an H100 (700 W) this takes 0.44 ms
// at 8x256x40x56 float32 where two blocks an SM at 110 registers took
// 0.50, and a third ring stage with one barrier a row gained nothing.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kXT = 4;                  // columns of one plane a thread
constexpr int kCT = 4;                  // channels a thread
constexpr int kLanes = 16;              // threads a column run
constexpr int kCB = kLanes * kCT;       // channels a block
constexpr int kMaxThreads = 256;        // 16 column runs a block, three blocks an SM
constexpr int kMaxRuns = kMaxThreads / kLanes;
constexpr int kMaxKG = 12;              // g values a thread stages a row through registers
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
  int gtile;     // staged g values a displacement row: gw * planes * nip
  int threads;   // planes * runs * kLanes
  int npass;     // 1, or 2 when both gradients are asked for
  int pass0;     // 0 (df1) or 1 (df2): the first pass
  size_t table_bytes;  // the g and f tables, rounded up to 16 bytes
  size_t stage_bytes;  // one ring stage: the f rows, then the g values
  size_t smem;
};

// kRegG: a thread's g values of a row (at most kMaxKG) are loaded into
// registers while the previous row computes; else they go straight to
// shared memory after it, and gw is bounded by shared memory alone.
template <typename T, int BYTES, bool kRegG>
__global__ void __launch_bounds__(kMaxThreads, 3)
correlation_backward_kernel(const T* __restrict__ f1, const T* __restrict__ f2, const T* __restrict__ g,
                            T* __restrict__ df1, T* __restrict__ df2, int h, int w, int c, int stride2,
                            int gr, Plan plan) {
  constexpr int ROW = kCB * static_cast<int>(sizeof(T));  // bytes of a staged f row
  constexpr int PER_ROW = ROW / BYTES;                      // copies a row
  extern __shared__ uint4 smem[];
  int* gtab = reinterpret_cast<int*>(smem);  // g offset of each staged g slot, or -1
  int* ftab = gtab + plan.gtile;             // map column of each staged f row, or -1
  char* stages = reinterpret_cast<char*>(smem) + plan.table_bytes;

  const int s = stride2, np = plan.planes, gw = 2 * gr + 1, nd = gw * gw;
  // blockIdx.x = ((pass * qgroups + qgroup) * tiles + tile) * cruns + crun
  int bx = blockIdx.x;
  const int crun = bx % plan.cruns;
  bx /= plan.cruns;
  const int tile = bx % plan.tiles;
  bx /= plan.tiles;
  const int q0 = (bx % plan.qgroups) * np;  // first plane of the block; planes >= s are empty
  const int pass = plan.pass0 + bx / plan.qgroups;
  const int y = blockIdx.y, b = blockIdx.z;
  const int c0 = crun * kCB;
  const int ibase = tile * plan.nip;  // first plane column of the tile
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long hw = static_cast<long long>(h) * w;

  // g slot e = (o * np + j) * nip + i holds G(p, o) at column x = q0 + j + s (ibase + i):
  // df1 reads g[p gw + o, y, x], df2 g[nd - 1 - (p gw + o), y + dy_p, x + dx_o]
  for (int e = tid; e < plan.gtile; e += nthreads) {
    const int o = e / (np * plan.nip);
    const int rem = e - o * np * plan.nip;
    const int j = rem / plan.nip;
    const int x = q0 + j + s * (ibase + rem - j * plan.nip);
    const int xp = x + (o - gr) * s;
    const bool valid = q0 + j < s && x < w && xp >= 0 && xp < w;
    gtab[e] = !valid ? -1 : pass == 0 ? o * static_cast<int>(hw) + x : (gw - 1 - o) * static_cast<int>(hw) + xp;
  }
  // f row k of plane q0 + j is map column q0 + j + s (ibase + k - gr) of the partner row
  for (int row = tid; row < plan.frows; row += nthreads) {
    const int j = row / plan.fpp;
    const int xx = q0 + j + s * (ibase + row - j * plan.fpp - gr);
    ftab[row] = q0 + j < s && xx >= 0 && xx < w ? xx : -1;
  }

  // this thread: channel lane l of column run r of plane q = q0 + j
  const int l = tid % kLanes;
  const int cr = tid / kLanes;
  const int j = cr / plan.runs;
  const int q = q0 + j;
  const int i0 = kXT * (cr - j * plan.runs);
  const int ch = c0 + l * kCT;

  const T* F = pass == 0 ? f2 : f1;
  const T* Fb = F + static_cast<long long>(b) * hw * c + c0;
  const T* gb = g + static_cast<long long>(b) * nd * hw;
  // displacement rows whose partner row y + (p - gr) s lies in the map
  const int p_lo = max(0, gr - y / s);
  const int p_hi = min(gw - 1, gr + (h - 1 - y) / s);
  // g of displacement row p: df1 channel p gw at row y, df2 channel
  // nd - (p + 1) gw at the partner row; the table adds o's channel and the column
  auto g_row = [&](int p) -> const T* {
    return pass == 0 ? gb + (static_cast<long long>(p) * gw * h + y) * w
                     : gb + (static_cast<long long>(nd - (p + 1) * gw) * h + y + (p - gr) * s) * w;
  };
  auto f_stage = [&](int st) { return stages + st * plan.stage_bytes; };
  auto g_stage = [&](int st) {
    return reinterpret_cast<float*>(stages + st * plan.stage_bytes + static_cast<size_t>(plan.frows) * ROW);
  };
  __syncthreads();  // the tables are built

  auto stage_f = [&](int st, int p) {
    char* dst = f_stage(st);
    const T* src_row = Fb + static_cast<long long>(y + (p - gr) * s) * w * c;
    for (int i = tid; i < plan.frows * PER_ROW; i += nthreads) {
      const int row = i / PER_ROW, k = i % PER_ROW;  // compile-time divisor
      const int xx = ftab[row];
      const int cc = k * (BYTES / static_cast<int>(sizeof(T)));
      const bool valid = xx >= 0 && c0 + cc < c;
      const T* src = valid ? src_row + static_cast<long long>(xx) * c + cc : F;
      cp_async<BYTES>(dst + row * ROW + k * BYTES, src, valid);
    }
  };
  float gv[kMaxKG];
  auto load_g = [&](int p) {
    const T* src = g_row(p);
#pragma unroll
    for (int k = 0; k < kMaxKG; ++k) {
      const int e = tid + k * nthreads;
      if (e < plan.gtile) {
        const int off = gtab[e];
        gv[k] = off >= 0 ? to_f32(src[off]) : 0.f;
      }
    }
  };
  auto store_g = [&](int st) {
    float* dst = g_stage(st);
#pragma unroll
    for (int k = 0; k < kMaxKG; ++k) {
      const int e = tid + k * nthreads;
      if (e < plan.gtile) dst[e] = gv[k];
    }
  };
  auto stage_g = [&](int st, int p) {  // !kRegG: any number of g values a row
    const T* src = g_row(p);
    float* dst = g_stage(st);
    for (int e = tid; e < plan.gtile; e += nthreads) {
      const int off = gtab[e];
      dst[e] = off >= 0 ? to_f32(src[off]) : 0.f;
    }
  };

  float acc[kXT][kCT];
#pragma unroll
  for (int a = 0; a < kXT; ++a)
#pragma unroll
    for (int e = 0; e < kCT; ++e) acc[a][e] = 0.f;

  stage_f(0, p_lo);
  cp_async_commit();
  if constexpr (kRegG) {
    load_g(p_lo);
    store_g(0);
  } else {
    stage_g(0, p_lo);
  }
  const int gstride = np * plan.nip;  // floats between the g rows of two o
#pragma unroll 1
  for (int p = p_lo; p <= p_hi; ++p) {
    const int st = (p - p_lo) & 1;
    if (p < p_hi) {
      stage_f(st ^ 1, p + 1);
      if constexpr (kRegG) load_g(p + 1);  // in flight while this row computes
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // f and g of row p are staged

    // column a at displacement o reads f row i0 + o + a of plane q, held
    // in slot (o + a) % kXT of a sliding window
    const T* frow = reinterpret_cast<const T*>(f_stage(st) + (j * plan.fpp + i0) * ROW) + l * kCT;
    const float* grow = g_stage(st) + j * plan.nip + i0;
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
    if (p < p_hi) {
      if constexpr (kRegG)
        store_g(st ^ 1);
      else
        stage_g(st ^ 1, p + 1);
    }
    __syncthreads();  // the stage is read; it is refilled next
  }
  cp_async_wait<0>();

  if (ch < c && q < s) {
    const float inv_c = 1.f / static_cast<float>(c);
    T* out = (pass == 0 ? df1 : df2) + (static_cast<long long>(b) * h + y) * w * c + ch;
#pragma unroll
    for (int a = 0; a < kXT; ++a) {
      const int x = q + s * (ibase + i0 + a);
      if (x < w) {
        float v[kCT];
#pragma unroll
        for (int e = 0; e < kCT; ++e) v[e] = acc[a][e] * inv_c;
        store_ct<BYTES == 16>(out + static_cast<long long>(x) * c, v, c - ch);
      }
    }
  }
}

// Planes in groups of at most kMaxRuns, then the widest column tile of at
// most kMaxRuns column runs across a group's planes whose two ring stages
// fit shared memory; one channel run of kCB a block.
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
    p.table_bytes = (static_cast<size_t>(p.gtile + p.frows) * 4 + 15) / 16 * 16;
    p.stage_bytes = static_cast<size_t>(p.frows) * kCB * elem + static_cast<size_t>(p.gtile) * 4;
    p.smem = p.table_bytes + kStages * p.stage_bytes;
    if (p.smem <= 227 * 1024) {
      *plan = p;
      return true;
    }
  }
  return false;
}

template <typename T>
int launch(const void* f1, const void* f2, const void* g, void* df1, void* df2, int n, int h, int w,
           int c, int stride2, int gr, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(w, c, stride2, 2 * gr + 1, df1 != nullptr, df2 != nullptr, sizeof(T), &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(plan.npass * plan.qgroups * plan.tiles * plan.cruns, h, n);
  // 16-byte copies need every pixel's channels to start 16-byte aligned
  const bool vec16 = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0;
  const bool reg_g = plan.gtile <= kMaxKG * plan.threads;
  auto kernel = vec16 ? (reg_g ? correlation_backward_kernel<T, 16, true> : correlation_backward_kernel<T, 16, false>)
                      : (reg_g ? correlation_backward_kernel<T, 4, true> : correlation_backward_kernel<T, 4, false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, plan.threads, plan.smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const T*>(g), static_cast<T*>(df1),
      static_cast<T*>(df2), h, w, c, stride2, gr, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// df1 / df2: (N, H, W, C) outputs in the inputs' dtype, or null to skip one
// (not both). Takes any stride2, a gw = 2 (max_displacement / stride2) + 1
// whose f rows of one column run fit shared memory (about 400 at stride2 1
// in float32), gw H W < 2^31, and in bfloat16 an even C (4-byte copies).
extern "C" int fn2_correlation_backward(const void* f1, const void* f2, const void* g, void* df1,
                                        void* df2, int n, int h, int w, int c,
                                        int max_displacement, int stride2, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = max_displacement / stride2;
  if (df1 == nullptr && df2 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) return launch<float>(f1, f2, g, df1, df2, n, h, w, c, stride2, gr, s);
  if (dtype == kBFloat16 && c % 2 == 0)
    return launch<__nv_bfloat16>(f1, f2, g, df1, df2, n, h, w, c, stride2, gr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
