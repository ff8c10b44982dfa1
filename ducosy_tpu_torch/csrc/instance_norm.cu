// K2: InstanceNorm (+ReLU) (+reflect pad) over H, W of an NHWC tensor, for
// Hopper (sm_90a), with K2p's options: statistics pooled over phase groups,
// and a shifted-grid int8 write.
//
// Replaces: instance_norm_pallas (ducosy_tpu/ops/pallas/instance_norm.py:
// 206, pallas_call at :245), forward with `relu`, `pad`, `phases` and
// `int8_scale`. On the serving path (trunks chain and mega, quant None and
// "trunk"): the stem and up2 norms (N, 512, 512, 64), down1 and up1
// (N, 256, 256, 128), all with ReLU, and down2 (N, 128, 128, 256) with ReLU
// and the trunk's first reflect pad folded into the write. On the training
// trunk each block's first norm (N, 128, 128, 256), pad 1. Under quantized
// serving with the tail trunk, each block's first norm writes int8
// (N, 130, 130, 256) for the int8 conv2. `phases` is on no serving path
// (fused.py:69 turns phase fusion off) and is held against its plain
// version all the same.
//
// What bounds it: bytes. A per-channel reduction and an elementwise
// normalize, ~3 bytes moved per FLOP; the least traffic is one read of x and
// one write of the (padded) output.
//
// Design: two launches on the caller's stream, the second overlapping the
// tail of the first through programmatic dependent launch (PDL). The
// wrapper's `plan` cuts the batch into tiles of pixels x all channels, as
// many samples at once as there are SMs (at N = 16 on 132 SMs, 8 tiles a
// sample of 32768 pixels at the stem, 128 blocks):
//  - in_stats (in_tiles.cuh, shared with K3): a block reduces its tile, 16
//    bytes a load, into per-channel (mean, M2) partials; the last block of a
//    sample to finish merges the sample's partials, pooled over `phases`,
//    into mean and 1/std.
//  - in_apply: a thread keeps its channels' statistics in registers and
//    normalizes pixels 16 bytes at a time, IN_UNROLL loads in flight,
//    writing the io dtype or int8 codes with streaming stores. With pad 1
//    the pixels of rows and columns 1 and h - 2 also write the border places
//    that mirror them, as the resident conv epilogue does
//    (conv_resident.cuh), so every output place is written once.
// Device memory sees x read twice and the output written once (1.5x the
// bytes of the bound). Reading x once needs the apply to hit the L2: per
// group of samples that fits 70% of it, a pair of launches (the plan's
// group_bytes, kept for the by-parts reading) measured slower, its apply
// missing the L2 and each group paying its launches' ramp and drain. One
// cooperative launch with a grid barrier between the passes measured 1-3%
// slower than these two launches, per group or for the whole batch.
//
// Numerics as the plain version: fp32 centred statistics, biased variance,
// eps, (x - mean) * rstd in fp32, one rounding; the int8 write quantizes the
// io-rounded value (instance_norm.py:172, 196-199).
#include "in_tiles.cuh"

namespace ducosy {
namespace {

constexpr int IN_UNROLL = 4;      // pixels an apply thread keeps in flight

// What one thread writes for its V channels of a pixel: 16 bytes of the io
// dtype, or V int8 codes on the shifted grid (8 or 4 bytes).
template <typename T, typename TOut> struct Chunk {
  using type = uint4;
  __device__ static type make(const float (&v)[Io<T>::V], float) {
    return Io<T>::pack(v);
  }
};
template <typename T> __device__ __forceinline__ uint32_t codes4(
    const float* v, float k) {
  uint32_t u = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u |= (uint32_t)(uint8_t)quantize_shifted(round_io<T>(v[j]), k) << (8 * j);
  return u;
}
template <> struct Chunk<bf16, int8_t> {
  using type = uint2;
  __device__ static type make(const float (&v)[8], float k) {
    return make_uint2(codes4<bf16>(v, k), codes4<bf16>(v + 4, k));
  }
};
template <> struct Chunk<float, int8_t> {
  using type = unsigned int;
  __device__ static type make(const float (&v)[4], float k) {
    return codes4<float>(v, k);
  }
};

// y = (x - mean) * rstd (ReLU) of pixels [lo, hi) of one sample xs (hw, c)
// in chunks of rows x U pixels, chunks k0, k0 + kstep, ...; written to os
// (h + 2 pad, w + 2 pad, c) in the io dtype, or as shifted-grid int8 codes
// at int8_k = 255 / S (TOut = int8_t, called with relu set). mean / rstd
// (c floats, shared or global memory) are read once into registers.
template <int U, typename T, typename TOut>
__device__ __forceinline__ void apply_pixels(const T* xs, TOut* os,
                                             const float* mean,
                                             const float* rstd, int h, int w,
                                             int c, int pad, int relu,
                                             float int8_k, int lo, int hi,
                                             int k0, int kstep) {
  constexpr int V = Io<T>::V;
  using C = Chunk<T, TOut>;
  const Lanes<T> ln(c);
  if (!ln.active()) return;
  float mu[V], rs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = mean[ln.lane * V + j];
    rs[j] = rstd[ln.lane * V + j];
  }
  xs += ln.lane * V;
  os += ln.lane * V;
  const int wp = w + 2 * pad, chunk = ln.rows * U;
  for (int base = lo + k0 * chunk; base < hi; base += kstep * chunk) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * ln.rows + ln.row;
      if (p < hi)
        raw[u] = __ldcs(reinterpret_cast<const uint4*>(xs + (size_t)p * c));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * ln.rows + ln.row;
      if (p >= hi) continue;
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float y = (Io<T>::at(raw[u], j) - mu[j]) * rs[j];
        v[j] = relu ? fmaxf(y, 0.f) : y;
      }
      const typename C::type val = C::make(v, int8_k);
      const int hh = p / w, ww = p - hh * w;
      auto put = [&](int ho, int wo) {
        __stcs(reinterpret_cast<typename C::type*>(
                   os + ((size_t)ho * wp + wo) * c),
               val);
      };
      put(hh + pad, ww + pad);
      // with pad 1 the pixels of rows and columns 1 and h - 2 (w - 2) also
      // fill the border places that mirror them
      if (pad && (hh == 1 || hh == h - 2 || ww == 1 || ww == w - 2)) {
        const int ro[3] = {hh + 1, hh == 1 ? 0 : -1, hh == h - 2 ? h + 1 : -1};
        const int co[3] = {ww + 1, ww == 1 ? 0 : -1, ww == w - 2 ? w + 1 : -1};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            if (a + b > 0 && ro[a] >= 0 && co[b] >= 0) put(ro[a], co[b]);
      }
    }
  }
}

// Apply: grid (blocks, gz) over the samples of x (gz, h, w, c); out (gz, h +
// 2 pad, w + 2 pad, c) in TOut (the io dtype, or int8 codes at int8_k).
template <typename T, typename TOut>
__global__ void __launch_bounds__(IN_THREADS, 2)
in_apply(const T* __restrict__ x, const float* gmean, const float* grstd,
         TOut* __restrict__ out, int h, int w, int c, int pad, int relu,
         float int8_k) {
  pdl_wait();        // the statistics grid has completed
  pdl_trigger();
  const size_t ni = blockIdx.y;
  apply_pixels<IN_UNROLL>(x + ni * h * w * c,
                          out + ni * (h + 2 * pad) * (w + 2 * pad) * c,
                          gmean + ni * c, grstd + ni * c, h, w, c, pad, relu,
                          int8_k, 0, h * w, blockIdx.x, gridDim.x);
}

// Parts of a call (the by-parts probe skips parts; production runs all):
// the tile statistics, their merge, the apply.
constexpr int PART_STATS = 1, PART_MERGE = 2, PART_APPLY = 4;

// K2 over the batch in groups of `group` samples: statistics, then apply,
// per group, 2 * blocks / group apply blocks a sample. The first launch
// waits for the stream as any launch does (it reads x, which the grid
// before it wrote); each later one may overlap its predecessor when
// allow_pdl. Scratch: pmean/pm2 (n, tiles, c), gmean/grstd (n, c), done (n)
// ints, zeroed here.
template <typename T>
int instance_norm(const T* x, void* out, float* pmean, float* pm2,
                  float* gmean, float* grstd, int* done, int n, int h, int w,
                  int c, int relu, int pad, int phases, float int8_k,
                  float eps, int group, int tiles, int tile, int blocks,
                  int parts, bool allow_pdl, cudaStream_t s) {
  const int hw = h * w;
  const bool merge = (parts & PART_STATS) && (parts & PART_MERGE);
  if (merge) {
    const cudaError_t e = cudaMemsetAsync(done, 0, n * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t xs = (size_t)hw * c,
               os = (size_t)(h + 2 * pad) * (w + 2 * pad) * c;
  bool pdl = false;
  for (int g0 = 0; g0 < n; g0 += group) {
    const int gz = min(group, n - g0);
    const T* xg = x + g0 * xs;
    const float *gm = gmean + (size_t)g0 * c, *gr = grstd + (size_t)g0 * c;
    int st = 0;
    if (parts & PART_STATS) {
      st = launch(in_stats<T>, dim3(tiles, gz), s, pdl, xg,
                  pmean + (size_t)g0 * tiles * c,
                  pm2 + (size_t)g0 * tiles * c, gmean + (size_t)g0 * c,
                  grstd + (size_t)g0 * c, merge ? done + g0 : (int*)nullptr,
                  hw, c, tile, phases, eps);
      if (st) return st;
      pdl = allow_pdl;
    }
    if (parts & PART_APPLY) {
      const dim3 grid(max(1, 2 * blocks / gz), gz);
      st = int8_k > 0.f
               ? launch(in_apply<T, int8_t>, grid, s, pdl, xg, gm, gr,
                        static_cast<int8_t*>(out) + g0 * os, h, w, c, pad, 1,
                        int8_k)
               : launch(in_apply<T, T>, grid, s, pdl, xg, gm, gr,
                        static_cast<T*>(out) + g0 * os, h, w, c, pad, relu,
                        int8_k);
      if (st) return st;
      pdl = allow_pdl;
    }
  }
  return 0;
}

// ---- the 3-D route: a channels-last volume, affine, LeakyReLU

// Apply of the 3-D route: grid (blocks, gz) over the samples of x (gz, m, c),
// m = d * h * w pixels of c channels (c a multiple of 32); y = ((x - mean) *
// rstd) * gamma + beta, then LeakyReLU at `slope`, rounded to the io dtype
// in place of x's layout (out (gz, m, c)). Without an affine gamma and beta
// read as 1 and 0 (the same float values as no affine); slope 0 is ReLU,
// slope 1 no activation. A kernel of its own: the 2-D route's in_apply is
// not touched.
template <typename T>
__global__ void __launch_bounds__(IN_THREADS, 2)
in_apply3d(const T* __restrict__ x, const float* gmean, const float* grstd,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           T* __restrict__ out, int m, int c, float slope) {
  constexpr int V = Io<T>::V, U = IN_UNROLL;
  pdl_wait();        // the statistics grid has completed
  pdl_trigger();
  const Lanes<T> ln(c);
  if (!ln.active()) return;
  const size_t ni = blockIdx.y;
  float mu[V], rs[V], g[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = ln.lane * V + j;
    mu[j] = gmean[ni * c + ch];
    rs[j] = grstd[ni * c + ch];
    g[j] = gamma ? gamma[ch] : 1.f;
    b[j] = beta ? beta[ch] : 0.f;
  }
  const T* xs = x + ni * m * c + ln.lane * V;
  T* os = out + ni * m * c + ln.lane * V;
  const int chunk = ln.rows * U;
  for (int base = blockIdx.x * chunk; base < m; base += gridDim.x * chunk) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * ln.rows + ln.row;
      if (p < m)
        raw[u] = __ldcs(reinterpret_cast<const uint4*>(xs + (size_t)p * c));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * ln.rows + ln.row;
      if (p >= m) continue;
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float y = (Io<T>::at(raw[u], j) - mu[j]) * rs[j] * g[j] + b[j];
        v[j] = y > 0.f ? y : y * slope;
      }
      __stcs(reinterpret_cast<uint4*>(os + (size_t)p * c), Io<T>::pack(v));
    }
  }
}

// The 3-D route over the batch in groups of `group` samples, on K2's plan
// and its statistics launch (in_stats over m pixels), then in_apply3d.
template <typename T>
int instance_norm3d(const T* x, T* out, const float* gamma,
                    const float* beta, float* pmean, float* pm2,
                    float* gmean, float* grstd, int* done, int n, int m,
                    int c, float slope, float eps, int group, int tiles,
                    int tile, int blocks, cudaStream_t s) {
  const cudaError_t e = cudaMemsetAsync(done, 0, n * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const size_t xs = (size_t)m * c;
  bool pdl = false;
  for (int g0 = 0; g0 < n; g0 += group) {
    const int gz = min(group, n - g0);
    int st = launch(in_stats<T>, dim3(tiles, gz), s, pdl, x + g0 * xs,
                    pmean + (size_t)g0 * tiles * c,
                    pm2 + (size_t)g0 * tiles * c, gmean + (size_t)g0 * c,
                    grstd + (size_t)g0 * c, done + g0, m, c, tile, 1, eps);
    if (st) return st;
    st = launch(in_apply3d<T>, dim3(max(1, 2 * blocks / gz), gz), s, true,
                x + g0 * xs, gmean + (size_t)g0 * c, grstd + (size_t)g0 * c,
                gamma, beta, out + g0 * xs, m, c, slope);
    if (st) return st;
    pdl = true;
  }
  return 0;
}

// ---- for the by-parts reading only

// The original three launches (common.cuh: 128-pixel x 64-channel tiles, a
// serial finalize per (sample, channel), one block per output pixel): parts
// 1 tile_stats_kernel, 2 finalize_stats, 4 norm_apply.
template <typename T>
int pr1_parts(const T* x, T* out, float* pmean, float* pm2, float* mean,
              float* rstd, int n, int h, int w, int c, int relu, int pad,
              float eps, int parts, cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  if (parts & 1) {
    tile_stats_kernel<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
        x, pmean, pm2, nullptr, hw, c);
    DUCOSY_CHECK_LAUNCH();
  }
  if (parts & 2) {
    finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                        n, tiles, c, hw, eps);
    DUCOSY_CHECK_LAUNCH();
  }
  if (parts & 4) {
    norm_apply<T, T><<<dim3(w + 2 * pad, h + 2 * pad, n), APPLY_THREADS, 0,
                       s>>>(x, mean, rstd, out, h, w, c, pad, relu);
    DUCOSY_CHECK_LAUNCH();
  }
  return 0;
}

template <typename T>
int probe(const T* x, T* out, float* pmean, float* pm2, float* mean,
          float* rstd, int* done, int n, int h, int w, int c, int relu,
          int pad, int design, int parts, int group, int tiles, int tile,
          int blocks, cudaStream_t s) {
  const float eps = 1e-5f;
  if (design == 0)
    return pr1_parts<T>(x, out, pmean, pm2, mean, rstd, n, h, w, c, relu, pad,
                        eps, parts, s);
  return instance_norm<T>(x, out, pmean, pm2, mean, rstd, done, n, h, w, c,
                          relu, pad, 1, 0.f, eps, group, tiles, tile, blocks,
                          parts, design == 1, s);
}

}  // namespace
}  // namespace ducosy

// x (n, h, w, c) -> out (n, h+2*pad, w+2*pad, c): the io dtype, or int8 on
// the shifted grid when int8_k = 255 / S > 0 (then relu must be set).
// phases > 1 pools the statistics over the phase groups of c. The wrapper's
// plan: groups of `group` samples, `tiles` tiles of `tile` pixels a sample,
// `blocks` the SM count. Scratch: pmean/pm2 (n, tiles, c) and gmean/grstd
// (n, c) fp32, done (n) ints (zeroed here). Returns the CUDA error of the
// first failing call, or 0. Launches on `stream` and does not synchronize.
extern "C" int ducosy_instance_norm(const void* x, void* out, float* pmean,
                                    float* pm2, float* gmean, float* grstd,
                                    int* done, int n, int h, int w, int c,
                                    int relu, int pad, int phases,
                                    float int8_k, float eps, int group,
                                    int tiles, int tile, int blocks,
                                    int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return instance_norm<bf16>(static_cast<const bf16*>(x), out, pmean, pm2,
                               gmean, grstd, done, n, h, w, c, relu, pad,
                               phases, int8_k, eps, group, tiles, tile,
                               blocks, 7, true, s);
  return instance_norm<float>(static_cast<const float*>(x), out, pmean, pm2,
                              gmean, grstd, done, n, h, w, c, relu, pad,
                              phases, int8_k, eps, group, tiles, tile, blocks,
                              7, true, s);
}

// By parts, for measurement (io-dtype write, phases 1): design 0 the
// original launches (parts 1 tile statistics, 2 finalize, 4 per-pixel apply;
// pmean/pm2 (n, ceil(h*w / 128), c)), design 1 the kernel above (parts 1
// tile statistics, 2 their merge, 4 the apply; pmean/pm2 (n, tiles, c)),
// design 2 design 1 with every launch after the one before it (no PDL).
// mean/rstd (n, c), done (n) ints.
extern "C" int ducosy_instance_norm_probe(
    const void* x, void* out, float* pmean, float* pm2, float* mean,
    float* rstd, int* done, int n, int h, int w, int c, int relu, int pad,
    int design, int parts, int group, int tiles, int tile, int blocks,
    int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return probe<bf16>(static_cast<const bf16*>(x), static_cast<bf16*>(out),
                       pmean, pm2, mean, rstd, done, n, h, w, c, relu, pad,
                       design, parts, group, tiles, tile, blocks, s);
  return probe<float>(static_cast<const float*>(x), static_cast<float*>(out),
                      pmean, pm2, mean, rstd, done, n, h, w, c, relu, pad,
                      design, parts, group, tiles, tile, blocks, s);
}

// The 3-D route: x (n, m, c) channels-last, m = d * h * w -> out (n, m, c)
// in the io dtype: IN over m, optional per-channel affine (gamma, beta:
// c floats each, or null), LeakyReLU at `slope`. The plan and scratch as
// ducosy_instance_norm's (phases 1). Returns the CUDA error of the first
// failing call, or 0. Launches on `stream` and does not synchronize.
extern "C" int ducosy_instance_norm3d(const void* x, void* out,
                                      const float* gamma, const float* beta,
                                      float* pmean, float* pm2, float* gmean,
                                      float* grstd, int* done, int n, int m,
                                      int c, float slope, float eps,
                                      int group, int tiles, int tile,
                                      int blocks, int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return instance_norm3d<bf16>(static_cast<const bf16*>(x),
                                 static_cast<bf16*>(out), gamma, beta, pmean,
                                 pm2, gmean, grstd, done, n, m, c, slope, eps,
                                 group, tiles, tile, blocks, s);
  return instance_norm3d<float>(static_cast<const float*>(x),
                                static_cast<float*>(out), gamma, beta, pmean,
                                pm2, gmean, grstd, done, n, m, c, slope, eps,
                                group, tiles, tile, blocks, s);
}
