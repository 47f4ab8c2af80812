// 1-D (stereo) correlation backward, DispNet configuration (multiply mode,
// kernel_size 1, stride1 1, pad == max_displacement, any stride2 and
// single_direction): the VJP of csrc/correlation1d.cu.
//
//   df1[n, c, y, x]  = (1/C) sum_j g[n, j, y, x] * f2[n, c, y, x + (j + xs) s]
//   df2[n, c, y, x'] = (1/C) sum_j g[n, j, y, x' - (j + xs) s] * f1[n, c, y, x' - (j + xs) s]
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
//   out[c, y, x] = (1/C) sum_o G(o, x) * F[c, y, x + (o + xs') s]
//
// with F = f2, G = g[o, y, x], xs' = xs for df1, and F = f1,
// G = g[gw - 1 - o, y, x + (o + xs') s], xs' = -(gw - 1 + xs) for df2. One
// kernel serves both; a work item carries its pass, so a call that asks
// for both gradients is one launch.
//
// Layout: f1, f2, df1, df2 (N, C, H, W) and g (N, gw, H, W), contiguous:
// the nets' own layout, so the caller copies nothing. Sums in float32 on
// the CUDA cores in both dtypes, one rounding to the input dtype.
//
// Bound on the H100: bytes. At DispNetC's FlyingThings3D features
// (4x128x144x240, gw 41) the two passes read f1, f2 and g and write df1 and
// df2, 306 MB in float32 (0.091 ms at 3.35 TB/s), for 1.45 G multiply-adds
// (0.043 ms at the 67 TFLOP/s float32 peak).
//
// Design, the forward's. The grid is persistent over work items (n, y,
// pass, column tile), whole rows where they fit, and each block streams its
// items' channel chunks through one ring of cp.async stages that runs
// across items: the next item's first chunk is in flight while this item's
// last chunk computes and stores. A chunk stages up to 64 channel rows of
// F's tile with its halo, channel-major, as the forward stages f2; with an
// item's first chunk come its gw rows of G, staged raw in the input dtype
// (df2's rows shifted by their partner offset, so G(o, x) sits at column x
// of row o), into one of ng buffers that outlive the ring's stages. A
// thread owns kXT = 4 neighbouring columns times kCT = 8 channels: per 4 / s
// displacements it loads one G vector per displacement, shared by its 8
// channels, and one new F vector per channel (the sliding run along x), 12
// loads for 128 FMAs at stride2 1; the displacement loop is unrolled twice,
// so the run's two vectors swap roles instead of being copied. A chunk's
// outputs are final (each channel is its own product), so they leave from
// registers as coalesced vectors along x while the next chunk's copies fly.
// The ring has kStages = 2 stages: at 240 float32 columns a stage of 64
// channels is 74 KB, and 3 stages beside the G buffers leave room for 32
// channels and 240 threads a block only. On an NVIDIA H100 at
// 4x128x144x240 f32 that ran 0.245 ms against 0.195 for 2 stages of 64
// channels and 480 threads (scripts/corr1d_variants.py).

#include "corr1d.cuh"

namespace {

using corr1d::kUnit;

constexpr int kXT = 4;  // columns a thread
constexpr int kCT = 8;  // channels a thread
constexpr int kStages = 2;
constexpr int kMaxThreads = 512;

// The launch's geometry, computed on the host.
struct Plan {
  int tiles;  // column tiles a row
  int tw;     // columns a tile, a multiple of the copy unit
  int runs;   // column runs of kXT a tile: tw / kXT
  int ck;     // channels a chunk, a multiple of kCT
  int nk;     // chunks an item: ceil(C / ck)
  int lf;     // staged F columns of one channel row
  int ng;     // G buffers: an item's G lives from its first chunk's copy to its last chunk
  int npass;  // 1, or 2 when both gradients are asked for
  int pass0;  // 0 (df1) or 1 (df2): the first pass
  int items;  // n * h * npass * tiles
  int threads;
  int stage_elems;  // one ring stage: ck * lf
  int g_elems;      // one G buffer: gw * tw
  size_t smem;
};

// S: stride2 as a compile-time constant (1 or 2), or 0 for any stride2
template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
correlation1d_backward_kernel(const T* __restrict__ f1, const T* __restrict__ f2, const T* __restrict__ g,
                              T* __restrict__ df1, T* __restrict__ df2, int c, int h, int w, int stride2, int gw,
                              int x_shift, Plan plan) {
  constexpr int V = kUnit<T>;
  extern __shared__ uint4 smem_raw[];
  T* gbufs = reinterpret_cast<T*>(smem_raw);
  T* stages = gbufs + plan.ng * plan.g_elems;
  const int s = S > 0 ? S : stride2;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const corr1d::Split fsplit(plan.lf / V, tid, nthreads);
  const corr1d::Split gsplit(plan.tw / V, tid, nthreads);

  const int my_items = (plan.items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int total = my_items * plan.nk;

  struct Item {
    int b, y, pass, x0, xs;  // xs: the pass's xs'
  };
  auto item_of = [&](int k) {
    int it = blockIdx.x + k * gridDim.x;
    Item r;
    r.x0 = (it % plan.tiles) * plan.tw;
    it /= plan.tiles;
    r.pass = plan.pass0 + it % plan.npass;
    const int row = it / plan.npass;
    r.y = row % h;
    r.b = row / h;
    r.xs = r.pass == 0 ? x_shift : -(gw - 1 + x_shift);
    return r;
  };

  auto issue = [&](int t) {
    const int k = t / plan.nk;
    const int kc = t - k * plan.nk;
    const Item it = item_of(k);
    if (kc == 0) {  // the item's G rows
      T* gb = gbufs + (k % plan.ng) * plan.g_elems;
      const long long gbase = static_cast<long long>(it.b) * gw * h + it.y;
      for (int o = gsplit.r0; o < gw; o += gsplit.rstep) {
        const int src_o = it.pass == 0 ? o : gw - 1 - o;
        const int shift = it.pass == 0 ? 0 : (o + it.xs) * s;
        const T* grow = g + (gbase + static_cast<long long>(src_o) * h) * w;
        for (int u = gsplit.u0; u < plan.tw / V; u += gsplit.ustep)
          corr1d::stage_unit(gb + o * plan.tw + u * V, grow, it.x0 + shift + u * V, w);
      }
    }
    const T* F = it.pass == 0 ? f2 : f1;
    const int c0 = kc * plan.ck;
    const int nch = min(plan.ck, c - c0);
    T* st = stages + (t % kStages) * plan.stage_elems;
    const int fx = it.x0 + it.xs * s;  // map column of staged F column 0
    for (int ch = fsplit.r0; ch < nch; ch += fsplit.rstep) {
      const T* frow = F + ((static_cast<long long>(it.b) * c + c0 + ch) * h + it.y) * w;
      for (int u = fsplit.u0; u < plan.lf / V; u += fsplit.ustep)
        corr1d::stage_unit(st + ch * plan.lf + u * V, frow, fx + u * V, w);
    }
  };

  // this thread: columns xl .. xl + 3 of the tile, chunk channels cg * 8 ..
  const int r = tid % plan.runs, cg = tid / plan.runs;
  const int xl = kXT * r;
  const bool active = cg * kCT < plan.ck;
  const float inv_c = 1.f / static_cast<float>(c);
  const bool vec_out = w % 4 == 0;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < total) issue(t);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk t (and its item's G) is staged; chunk t - 1's stage is free
    if (t + kStages - 1 < total) issue(t + kStages - 1);
    cp_async_commit();

    const int k = t / plan.nk;
    const int c0 = (t - k * plan.nk) * plan.ck + cg * kCT;
    if (!active || c0 >= c) continue;
    const Item it = item_of(k);
    const int x = it.x0 + xl;
    const T* G = gbufs + (k % plan.ng) * plan.g_elems + xl;
    const T* F = stages + (t % kStages) * plan.stage_elems + cg * kCT * plan.lf + xl;

    float acc[kXT][kCT];
#pragma unroll
    for (int a = 0; a < kXT; ++a)
#pragma unroll
      for (int e = 0; e < kCT; ++e) acc[a][e] = 0.f;

    if constexpr (S > 0) {
      // column a at displacement o reads F column xl + a + o S: per step of
      // OS = 4 / S displacements, the window w0 | w1 of 8 columns
      constexpr int OS = 4 / S;
      float w0[kCT][4];
#pragma unroll
      for (int e = 0; e < kCT; ++e) corr1d::load4(w0[e], F + e * plan.lf);
#pragma unroll 2
      for (int og = 0; og < gw; og += OS) {
        float gv[OS][4];
#pragma unroll
        for (int u = 0; u < OS; ++u) {
          if (og + u < gw) {
            corr1d::load4(gv[u], G + (og + u) * plan.tw);
          } else {
#pragma unroll
            for (int a = 0; a < kXT; ++a) gv[u][a] = 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < kCT; ++e) {
          float w1[4];
          corr1d::load4(w1, F + e * plan.lf + (og + OS) * S);
#pragma unroll
          for (int u = 0; u < OS; ++u)
#pragma unroll
            for (int a = 0; a < kXT; ++a) {
              const int m = u * S + a;
              acc[a][e] = fmaf(gv[u][a], m < 4 ? w0[e][m] : w1[m - 4], acc[a][e]);
            }
#pragma unroll
          for (int q = 0; q < 4; ++q) w0[e][q] = w1[q];
        }
      }
    } else {
#pragma unroll 1
      for (int o = 0; o < gw; ++o) {
        float gv[4];
        corr1d::load4(gv, G + o * plan.tw);
#pragma unroll
        for (int e = 0; e < kCT; ++e)
#pragma unroll
          for (int a = 0; a < kXT; ++a)
            acc[a][e] = fmaf(gv[a], to_f32(F[e * plan.lf + a + o * s]), acc[a][e]);
      }
    }

    if (x < w) {
      T* ob = (it.pass == 0 ? df1 : df2) + ((static_cast<long long>(it.b) * c + c0) * h + it.y) * w + x;
      const long long plane = static_cast<long long>(h) * w;
#pragma unroll
      for (int e = 0; e < kCT; ++e) {
        if (c0 + e < c) {
          float v[kXT];
#pragma unroll
          for (int a = 0; a < kXT; ++a) v[a] = acc[a][e] * inv_c;
          corr1d::store_cols(ob + e * plane, v, x, w, vec_out);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Whole rows where they fit: the fewest column tiles, then the largest
// chunk (64 channels down to kCT), whose threads (kXT-column
// runs x channel groups) fit kMaxThreads and whose ring and G buffers fit
// shared memory.
bool make_plan(int n, int h, int w, int c, int gw, int s, int elem, bool need1, bool need2, Plan* plan) {
  Plan p{};
  const int unit = 16 / elem;
  p.npass = need1 && need2 ? 2 : 1;
  p.pass0 = need1 ? 0 : 1;
  const int ck_max = std::max(kCT, std::min(64, corr1d::round_up(c, kCT)));
  for (p.tiles = 1;; ++p.tiles) {
    p.tw = corr1d::round_up((w + p.tiles - 1) / p.tiles, unit);
    p.runs = p.tw / kXT;
    // F columns read: xl + a + o s for o < gw, and the window's vector past
    // the last step
    p.lf = corr1d::round_up(p.tw + s * gw + 4, unit);
    p.g_elems = gw * p.tw;
    for (p.ck = ck_max; p.ck >= kCT; p.ck -= kCT) {
      p.nk = (c + p.ck - 1) / p.ck;
      p.ng = std::min(kStages, 1 + (kStages - 1 + p.nk - 1) / p.nk);
      p.stage_elems = p.ck * p.lf;
      p.smem = (static_cast<size_t>(p.ng) * p.g_elems + static_cast<size_t>(kStages) * p.stage_elems) * elem;
      p.threads = corr1d::round_up(p.runs * (p.ck / kCT), 32);
      if (p.threads <= kMaxThreads && p.smem <= corr1d::kSmemLimit) {
        p.tiles = (w + p.tw - 1) / p.tw;
        const long long items = static_cast<long long>(n) * h * p.npass * p.tiles;
        if (items >= (1LL << 31)) return false;
        p.items = static_cast<int>(items);
        *plan = p;
        return true;
      }
    }
    if (p.tw <= unit) return false;
  }
}

template <typename T, int S>
int launch_s(const void* f1, const void* f2, const void* g, void* df1, void* df2, int c, int h, int w, int stride2,
             int gw, int x_shift, const Plan& plan, cudaStream_t stream) {
  auto kernel = correlation1d_backward_kernel<T, S>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(plan.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int resident = corr1d::resident_blocks(kernel, plan.threads, plan.smem);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = std::min(plan.items, resident);
  kernel<<<grid, plan.threads, plan.smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const T*>(g), static_cast<T*>(df1),
      static_cast<T*>(df2), c, h, w, stride2, gw, x_shift, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* f1, const void* f2, const void* g, void* df1, void* df2, int n, int c, int h, int w,
           int stride2, int gw, int x_shift, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(n, h, w, c, gw, stride2, sizeof(T), df1 != nullptr, df2 != nullptr, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  if (stride2 == 1) return launch_s<T, 1>(f1, f2, g, df1, df2, c, h, w, stride2, gw, x_shift, plan, stream);
  if (stride2 == 2) return launch_s<T, 2>(f1, f2, g, df1, df2, c, h, w, stride2, gw, x_shift, plan, stream);
  return launch_s<T, 0>(f1, f2, g, df1, df2, c, h, w, stride2, gw, x_shift, plan, stream);
}

}  // namespace

// f1, f2 (N, C, H, W), g (N, gw, H, W), contiguous; df1 / df2 (N, C, H, W)
// outputs in the inputs' dtype, or null to skip one (not both). Takes any C,
// alignment and stride2, and N H (passes, column tiles) < 2^31; a gw whose
// G rows and F halo do not fit shared memory fails.
extern "C" int fn2_correlation_1d_backward(const void* f1, const void* f2, const void* g, void* df1, void* df2,
                                           int n, int c, int h, int w, int max_displacement, int stride2,
                                           int single_direction, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = max_displacement / stride2;
  const int gw = single_direction != 0 ? gr + 1 : 2 * gr + 1;
  const int x_shift = single_direction > 0 ? 0 : -gr;
  if (df1 == nullptr && df2 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) return launch<float>(f1, f2, g, df1, df2, n, c, h, w, stride2, gw, x_shift, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(f1, f2, g, df1, df2, n, c, h, w, stride2, gw, x_shift, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
