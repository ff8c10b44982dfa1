// K3: the backward of InstanceNorm (+ReLU) (+reflect pad) over H, W of an
// NHWC tensor, for Hopper (sm_90a).
//
// Replaces: instance_norm_bwd_pallas (ducosy_tpu/ops/pallas/
// instance_norm.py:297, pallas_call at :316), the backward of the training
// trunk's first norm of each block (K2 with ReLU and pad 1):
//   g  = fold(g_out)                      reflect-pad adjoint, fp32
//   y  = (x - mean) * rstd                fp32 statistics of x, recomputed
//   g *= (y > 0)                          the ReLU mask
//   dx = (g - mean(g) - y * mean(g * y)) * rstd
// with x (N, 128, 128, 256) and g_out (N, 130, 130, 256) in the io dtype.
//
// What bounds it: bytes. Two whole-image reductions in sequence (the
// statistics of x, then mean(g) and mean(g*y)), a few FLOP per element; the
// least traffic is one read of x and g and one write of dx.
//
// Design: three launches on K2's tile plan (in_tiles.cuh: a block takes a
// tile of pixels x all channels, a thread 16 bytes of channels of a stripe
// of its pixels), each after the first started early through programmatic
// dependent launch:
//  1. in_stats, K2's own statistics launch: mean and 1/std of x, the
//     forward's bits on the same x; the last block of a sample merges.
//  2. bwd_sums: a thread streams x and g, 16 bytes a pixel each, through its
//     own slots of a shared-memory ring (cp.async, RING - 1 pixels in
//     flight, no block barrier), and adds up the folded, masked cotangent
//     and its product with y in fp32; the stripes add per channel through
//     shared memory into the tile's partials, and the last block of a sample
//     to finish (an arrival counter a sample, as in in_stats) sums the
//     sample's tiles in order into mean(g) and mean(g*y).
//  3. bwd_apply: the same tiles and ring; x and g in, dx out with 16-byte
//     streaming stores, the sample's four statistics in registers.
// Launches 2 and 3 issue their first copies of x and g before they wait on
// the launch before them (griddepcontrol.wait): those are the call's inputs,
// so the copies overlap the previous launch's tail and last-block merge.
// Device memory sees x read three times and g twice (2x the bytes of the
// bound); the reductions need a whole sample before any dx, and a sample
// kept on chip across them costs grid barriers that the streaming form does
// not pay.
// On an H100 SXM at (8, 128, 128, 256) bf16 the same passes with 4-8 pixels
// held in registers instead of the ring read slower (the bf16 sums spilled
// at 8), and so did two ring blocks an SM on half tiles (64 registers).
// Timed against the batch size (chip_smoke.py, "6 parts K3") the passes
// stream near the card's rate, and each launch carries a fixed cost besides
// (ramp, drain, the merges): most of what separates the training size from
// its bound.
// The reflect-pad adjoint is a gather: with pad 1 a pixel of rows or
// columns 1 and h - 2 (w - 2) also reads the pad places that mirror it, 16
// bytes each, and adds them in fp32 in the plain version's order (rows
// first, then columns), so the folded cotangent is the plain version's bits;
// no pass writes a folded copy of g and no atomics are needed.
//
// Numerics as the plain version: fp32 centred statistics (Chan), biased
// variance, eps; fp32 sums; one rounding of dx to the io dtype. The TPU
// kernel's statistics are E[x^2] - E[x]^2.
//
// For the by-parts reading only: the original five launches (128-pixel x
// 64-channel tiles with 2-byte loads, two serial finalizers, one block per
// output pixel) stay reachable through the probe entry point as design 0.
#include "in_tiles.cuh"
#include "tile_regs.cuh"

namespace ducosy {
namespace {

// The shared-memory ring of the sums and the apply: RING stages, each a
// thread's 16 bytes of x, of g and of the first mirror term of its pixel.
constexpr int RING = 6;
constexpr int RING_SLOTS = 3;
constexpr int RING_BYTES = RING * RING_SLOTS * IN_THREADS * 16;   // 147,456

// Whether pad 1 folds pad places onto interior pixel (i, j): rows and
// columns 1 and h - 2 (w - 2).
__device__ __forceinline__ bool folds(int i, int j, int h, int w) {
  return i == 1 || i == h - 2 || j == 1 || j == w - 2;
}

// Where in g (pad 1) the first mirror term of a folding pixel sits, in the
// order fold_border adds them: the pad row above or below it, else the pad
// column beside it.
__device__ __forceinline__ int2 first_mirror(int i, int j, int h, int w) {
  if (i == 1) return make_int2(0, j + 1);
  if (i == h - 2) return make_int2(h + 1, j + 1);
  return make_int2(i + 1, j == 1 ? 0 : w + 1);
}

// Adds the mirror terms of folding pixel (i, j) (pad 1) to v, its own
// cotangent in fp32, as reflect_pad_adjoint sums them: the pad rows of
// column j + 1, then each mirrored column folded over its rows first. gl is
// g of the sample (h + 2, w + 2, c) at the thread's first channel; `first`
// holds the first term (first_mirror), the others are read here.
template <typename T>
__device__ __forceinline__ void fold_border(const T* gl, const uint4& first,
                                            int i, int j, int h, int w, int c,
                                            float (&v)[Io<T>::V]) {
  constexpr int V = Io<T>::V;
  const int2 fm = first_mirror(i, j, h, w);
  auto add = [&](int r, int col, float (&acc)[V]) {
    const uint4 u = r == fm.x && col == fm.y
                        ? first
                        : __ldcg(reinterpret_cast<const uint4*>(
                              gl + ((size_t)r * (w + 2) + col) * c));
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += Io<T>::at(u, k);
  };
  if (i == 1) add(0, j + 1, v);
  if (i == h - 2) add(h + 1, j + 1, v);
  const int cols[2] = {j == 1 ? 0 : -1, j == w - 2 ? w + 1 : -1};
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (cols[b] < 0) continue;
    float s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = 0.f;
    add(i + 1, cols[b], s);
    if (i == 1) add(0, cols[b], s);
    if (i == h - 2) add(h + 1, cols[b], s);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] += s[k];
  }
}

// Streams one thread's stripe of a tile through its own slots of the ring
// (dynamic shared memory): pixels m0 + row + k * rows, k < mine, of sample
// x (hw, c) and its cotangent g (h + 2 pad, w + 2 pad, c), both at the
// thread's first channel. Stage k % RING holds pixel k's 16 bytes of x and
// of g and, for a folding pixel, its first mirror term; RING - 1 pixels stay
// in flight (cp.async, one group a pixel), and the thread reads only what it
// copied, so no block barrier is needed. `ready` runs once the first copies
// are issued; body(p, xv, gv) then gets each pixel p, x and the folded
// cotangent in fp32.
template <typename T, typename R, typename B>
__device__ __forceinline__ void stream_stripe(const T* x, const T* g,
                                              uint4* ring, int m0, int row,
                                              int rows, int mine, int h,
                                              int w, int c, int pad,
                                              R&& ready, B&& body) {
  constexpr int V = Io<T>::V;
  const int wp = w + 2 * pad;
  auto slot = [&](int k, int q) {
    return ring + ((k % RING) * RING_SLOTS + q) * IN_THREADS + threadIdx.x;
  };
  auto issue = [&](int k) {
    if (k < mine) {
      const int p = m0 + row + k * rows, i = p / w, j = p - i * w;
      cp_async16(smem_u32(slot(k, 0)), x + (size_t)p * c, true);
      cp_async16(smem_u32(slot(k, 1)),
                 g + ((size_t)(i + pad) * wp + j + pad) * c, true);
      if (pad && folds(i, j, h, w)) {
        const int2 fm = first_mirror(i, j, h, w);
        cp_async16(smem_u32(slot(k, 2)),
                   g + ((size_t)fm.x * wp + fm.y) * c, true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < RING - 1; ++k) issue(k);
  ready();
  for (int k = 0; k < mine; ++k) {
    issue(k + RING - 1);
    cp_async_wait<RING - 1>();
    const int p = m0 + row + k * rows, i = p / w, j = p - i * w;
    const uint4 xr = *slot(k, 0), gr = *slot(k, 1);
    float xv[V], gv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xv[e] = Io<T>::at(xr, e);
      gv[e] = Io<T>::at(gr, e);
    }
    if (pad && folds(i, j, h, w))
      fold_border<T>(g, *slot(k, 2), i, j, h, w, c, gv);
    body(p, xv, gv);
  }
  cp_async_wait<0>();
}

// Sums: grid (tiles, gz); block (t, i) takes pixels t * tile .. of sample i
// of x (gz, hw, c) and g (gz, h + 2 pad, w + 2 pad, c), with in_stats' mean
// and 1/std at gmean / grstd[i * c + ch], and writes its tile's sum(g) and
// sum(g * y) of the folded, masked cotangent at psg / psgy[(i * tiles + t) *
// c + ch]. The last block of a sample to finish (done: gz zeroed counters)
// sums the sample's tiles in order into gmg / gmgy[i * c + ch] = mean(g),
// mean(g * y). Dynamic shared memory: the ring (RING_BYTES), then the
// per-row sums (2 IN_STAGE floats) in the same place.
template <typename T>
__global__ void __launch_bounds__(IN_THREADS, 1)
bwd_sums(const T* __restrict__ x, const T* __restrict__ g,
         const float* gmean, const float* grstd, float* psg, float* psgy,
         float* gmg, float* gmgy, int* done, int h, int w, int c, int pad,
         int relu, int tile) {
  constexpr int V = Io<T>::V;
  extern __shared__ __align__(16) uint4 ring[];
  float* s0 = reinterpret_cast<float*>(ring);
  float* s1 = s0 + IN_STAGE;
  __shared__ int last;
  pdl_trigger();     // the apply's blocks may take the SMs this grid frees
  const int t = blockIdx.x, ni = blockIdx.y, hw = h * w, m0 = t * tile;
  const int npx = min(tile, hw - m0), lds = c + 1;
  const Lanes<T> ln(c);
  const int ch0 = ln.lane * V;
  float sg[V], sgy[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sg[k] = sgy[k] = 0.f;
  if (ln.active()) {
    float mu[V], rs[V];
    stream_stripe<T>(
        x + (size_t)ni * hw * c + ch0,
        g + (size_t)ni * (h + 2 * pad) * (w + 2 * pad) * c + ch0, ring, m0,
        ln.row, ln.rows,
        ln.row < npx ? (npx - ln.row + ln.rows - 1) / ln.rows : 0, h, w, c,
        pad,
        [&] {
          pdl_wait();                   // in_stats has completed
#pragma unroll
          for (int k = 0; k < V; ++k) {
            mu[k] = __ldcg(gmean + (size_t)ni * c + ch0 + k);
            rs[k] = __ldcg(grstd + (size_t)ni * c + ch0 + k);
          }
        },
        [&](int, const float (&xv)[V], const float (&gv)[V]) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float y = (xv[k] - mu[k]) * rs[k];
            const float gk = relu && !(y > 0.f) ? 0.f : gv[k];
            sg[k] += gk;
            sgy[k] += gk * y;
          }
        });
  } else {
    pdl_wait();
  }
  __syncthreads();   // the ring is free: the per-row sums take its place
  if (ln.active()) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s0[ln.row * lds + ch0 + k] = sg[k];
      s1[ln.row * lds + ch0 + k] = sgy[k];
    }
  }
  __syncthreads();
  const size_t base = ((size_t)ni * gridDim.x + t) * c;
  for (int ch = threadIdx.x; ch < c; ch += IN_THREADS) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < ln.rows; ++r) {
      a += s0[r * lds + ch];
      b += s1[r * lds + ch];
    }
    psg[base + ch] = a;
    psgy[base + ch] = b;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(done + ni, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int tiles = gridDim.x;
  for (int ch = threadIdx.x; ch < c; ch += IN_THREADS) {
    float a = 0.f, b = 0.f;
    for (int t0 = 0; t0 < tiles; t0 += MERGE_LOADS) {
      float va[MERGE_LOADS], vb[MERGE_LOADS];
#pragma unroll
      for (int u = 0; u < MERGE_LOADS; ++u) {
        va[u] = vb[u] = 0.f;
        if (t0 + u < tiles) {
          const size_t k = ((size_t)ni * tiles + t0 + u) * c + ch;
          va[u] = __ldcg(psg + k);
          vb[u] = __ldcg(psgy + k);
        }
      }
#pragma unroll
      for (int u = 0; u < MERGE_LOADS; ++u) {
        a += va[u];
        b += vb[u];
      }
    }
    gmg[(size_t)ni * c + ch] = a / (float)hw;
    gmgy[(size_t)ni * c + ch] = b / (float)hw;
  }
}

// Apply: grid (tiles, gz); block (t, i) writes dx (gz, hw, c) at pixels t *
// tile .. of sample i from x, g and the sample's mean, 1/std, mean(g) and
// mean(g * y) at [i * c + ch]. Dynamic shared memory: the ring.
template <typename T>
__global__ void __launch_bounds__(IN_THREADS, 1)
bwd_apply(const T* __restrict__ x, const T* __restrict__ g,
          const float* gmean, const float* grstd, const float* gmg,
          const float* gmgy, T* __restrict__ dx, int h, int w, int c,
          int pad, int relu, int tile) {
  constexpr int V = Io<T>::V;
  extern __shared__ __align__(16) uint4 ring[];
  pdl_trigger();
  const int t = blockIdx.x, ni = blockIdx.y, hw = h * w, m0 = t * tile;
  const int npx = min(tile, hw - m0);
  const Lanes<T> ln(c);
  if (!ln.active()) return;
  const int ch0 = ln.lane * V;
  T* ds = dx + (size_t)ni * hw * c + ch0;
  float mu[V], rs[V], mg[V], mgy[V];
  stream_stripe<T>(
      x + (size_t)ni * hw * c + ch0,
      g + (size_t)ni * (h + 2 * pad) * (w + 2 * pad) * c + ch0, ring, m0,
      ln.row, ln.rows,
      ln.row < npx ? (npx - ln.row + ln.rows - 1) / ln.rows : 0, h, w, c, pad,
      [&] {
        pdl_wait();                     // the sums' merge has completed
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const size_t q = (size_t)ni * c + ch0 + k;
          mu[k] = __ldcg(gmean + q);
          rs[k] = __ldcg(grstd + q);
          mg[k] = __ldcg(gmg + q);
          mgy[k] = __ldcg(gmgy + q);
        }
      },
      [&](int p, const float (&xv)[V], const float (&gv)[V]) {
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float y = (xv[k] - mu[k]) * rs[k];
          const float gk = relu && !(y > 0.f) ? 0.f : gv[k];
          v[k] = (gk - mg[k] - y * mgy[k]) * rs[k];
        }
        __stcs(reinterpret_cast<uint4*>(ds + (size_t)p * c), Io<T>::pack(v));
      });
}

// Lets the ring kernels of io type T take RING_BYTES of dynamic shared
// memory; once a type and device (a static in a function of internal
// linkage).
template <typename T>
int allow_ring() {
  static DeviceFlags raised;
  return once_per_device(raised, [] {
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const cudaError_t e = cudaFuncSetAttribute(bwd_sums<T>, attr, RING_BYTES);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(bwd_apply<T>, attr, RING_BYTES);
  });
}

// Parts of a call (the by-parts probe skips parts; production runs all):
// the statistics, the sums, the apply.
constexpr int PART_STATS = 1, PART_SUMS = 2, PART_APPLY = 4;

// K3 over the batch in groups of `group` samples, `tiles` tiles of `tile`
// pixels a sample: statistics, sums, apply per group. The first launch waits
// for the stream as any launch does; each later one may overlap its
// predecessor when allow_pdl. Scratch: pmean/pm2/psg/psgy (n, tiles, c),
// mean/rstd/mg/mgy (n, c), done (2 n) ints, zeroed here.
template <typename T>
int instance_norm_bwd(const T* x, const T* g, T* dx, float* pmean, float* pm2,
                      float* psg, float* psgy, float* mean, float* rstd,
                      float* mg, float* mgy, int* done, int n, int h, int w,
                      int c, int relu, int pad, float eps, int group,
                      int tiles, int tile, int parts, bool allow_pdl,
                      cudaStream_t s) {
  DUCOSY_TRY(allow_ring<T>());
  const cudaError_t e = cudaMemsetAsync(done, 0, 2 * n * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const int hw = h * w;
  const size_t xs = (size_t)hw * c, gsz = (size_t)(h + 2 * pad) *
                                          (w + 2 * pad) * c,
               pt = (size_t)tiles * c;
  bool pdl = false;
  for (int g0 = 0; g0 < n; g0 += group) {
    const dim3 grid(tiles, min(group, n - g0));
    const T* xg = x + g0 * xs;
    const T* gg = g + g0 * gsz;
    float *gm = mean + (size_t)g0 * c, *gr = rstd + (size_t)g0 * c,
          *gmg = mg + (size_t)g0 * c, *gmgy = mgy + (size_t)g0 * c;
    if (parts & PART_STATS) {
      DUCOSY_TRY(launch(in_stats<T>, grid, s, pdl, xg, pmean + g0 * pt,
                        pm2 + g0 * pt, gm, gr, done + g0, hw, c, tile, 1,
                        eps));
      pdl = allow_pdl;
    }
    if (parts & PART_SUMS) {
      DUCOSY_TRY(launch_smem(bwd_sums<T>, grid, RING_BYTES, s, pdl, xg, gg,
                             gm, gr, psg + g0 * pt, psgy + g0 * pt, gmg, gmgy,
                             done + n + g0, h, w, c, pad, relu, tile));
      pdl = allow_pdl;
    }
    if (parts & PART_APPLY) {
      DUCOSY_TRY(launch_smem(bwd_apply<T>, grid, RING_BYTES, s, pdl, xg, gg,
                             gm, gr, gmg, gmgy, dx + g0 * xs, h, w, c, pad,
                             relu, tile));
      pdl = allow_pdl;
    }
  }
  return 0;
}

// ---- for the by-parts reading only: the original five launches

// Original: sum(g) and sum(g*y) of the folded, ReLU-masked cotangent over
// one 128 x 64 tile. Grid (c / TILE_N, tiles, n), STATS_THREADS threads.
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
grad_sums(const T* __restrict__ x, const T* __restrict__ g,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          float* __restrict__ psg, float* __restrict__ psgy, int h, int w,
          int c, int pad, int relu) {
  const int k = blockIdx.x * TILE_N + threadIdx.x % TILE_N;
  const int grp = threadIdx.x / TILE_N, ni = blockIdx.z;
  const int hw = h * w, m0 = blockIdx.y * TILE_M;
  const int rows = min(TILE_M, hw - m0);
  const float mu = mean[ni * c + k], rs = rstd[ni * c + k];
  const T* gs = g + (size_t)ni * (h + 2 * pad) * (w + 2 * pad) * c;
  float acc[2] = {0.f, 0.f};
  for (int rr = grp; rr < rows; rr += SUM_GROUPS) {
    const int m = m0 + rr;
    const float y = (to_f32(x[((size_t)ni * hw + m) * c + k]) - mu) * rs;
    float gv = fold_reflect(gs, m / w, m % w, k, h, w, c, pad);
    if (relu && !(y > 0.f)) gv = 0.f;
    acc[0] += gv;
    acc[1] += gv * y;
  }
  float* const outs[2] = {psg, psgy};
  store_tile_sums<2>(acc, outs, c);
}

// mean(g), mean(g*y) per (sample, channel) from the tile sums.
__global__ void grad_means(const float* __restrict__ psg,
                           const float* __restrict__ psgy,
                           float* __restrict__ mg, float* __restrict__ mgy,
                           int n, int tiles, int c, int hw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * c) return;
  mg[idx] = sum_tiles(psg, idx, tiles, c) / hw;
  mgy[idx] = sum_tiles(psgy, idx, tiles, c) / hw;
}

// dx at one pixel per block (grid w, h, n), threads over channels.
template <typename T>
__global__ void grad_apply(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const float* __restrict__ mg,
                           const float* __restrict__ mgy, T* __restrict__ dx,
                           int h, int w, int c, int pad, int relu) {
  const int j = blockIdx.x, i = blockIdx.y, ni = blockIdx.z;
  const size_t pix = ((size_t)ni * h + i) * w + j;
  const T* gs = g + (size_t)ni * (h + 2 * pad) * (w + 2 * pad) * c;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    const int q = ni * c + k;
    const float y = (to_f32(x[pix * c + k]) - mean[q]) * rstd[q];
    float gv = fold_reflect(gs, i, j, k, h, w, c, pad);
    if (relu && !(y > 0.f)) gv = 0.f;
    dx[pix * c + k] = from_f32<T>((gv - mg[q] - y * mgy[q]) * rstd[q]);
  }
}

// The original launches: parts 1 the 128 x 64 tile statistics and their
// serial finalize, 2 the tile gradient sums and their serial merge, 4 the
// per-pixel apply. Scratch (n, ceil(h * w / 128), c) and (n, c).
template <typename T>
int original_parts(const T* x, const T* g, T* dx, float* pmean, float* pm2,
                   float* psg, float* psgy, float* mean, float* rstd,
                   float* mg, float* mgy, int n, int h, int w, int c,
                   int relu, int pad, float eps, int parts, cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  const dim3 tgrid(c / TILE_N, tiles, n);
  if (parts & PART_STATS) {
    tile_stats_kernel<T><<<tgrid, STATS_THREADS, 0, s>>>(x, pmean, pm2,
                                                         nullptr, hw, c);
    DUCOSY_CHECK_LAUNCH();
    finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                        n, tiles, c, hw, eps);
    DUCOSY_CHECK_LAUNCH();
  }
  if (parts & PART_SUMS) {
    grad_sums<T><<<tgrid, STATS_THREADS, 0, s>>>(x, g, mean, rstd, psg, psgy,
                                                 h, w, c, pad, relu);
    DUCOSY_CHECK_LAUNCH();
    grad_means<<<(n * c + 255) / 256, 256, 0, s>>>(psg, psgy, mg, mgy, n,
                                                    tiles, c, hw);
    DUCOSY_CHECK_LAUNCH();
  }
  if (parts & PART_APPLY) {
    grad_apply<T><<<dim3(w, h, n), APPLY_THREADS, 0, s>>>(
        x, g, mean, rstd, mg, mgy, dx, h, w, c, pad, relu);
    DUCOSY_CHECK_LAUNCH();
  }
  return 0;
}

// design 0 the original launches, 1 the kernel, 2 the kernel with every
// launch after the one before it (no programmatic dependent launch).
template <typename T>
int dispatch(const void* x, const void* g, void* dx, float* pmean, float* pm2,
             float* psg, float* psgy, float* mean, float* rstd, float* mg,
             float* mgy, int* done, int n, int h, int w, int c, int relu,
             int pad, float eps, int group, int tiles, int tile, int design,
             int parts, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (design == 0)
    return original_parts<T>(xt, gt, dxt, pmean, pm2, psg, psgy, mean, rstd,
                             mg, mgy, n, h, w, c, relu, pad, eps, parts, s);
  return instance_norm_bwd<T>(xt, gt, dxt, pmean, pm2, psg, psgy, mean, rstd,
                              mg, mgy, done, n, h, w, c, relu, pad, eps,
                              group, tiles, tile, parts, design == 1, s);
}

}  // namespace
}  // namespace ducosy

// x (n, h, w, c) and g (n, h+2*pad, w+2*pad, c) -> dx (n, h, w, c), all the
// io dtype. The wrapper's plan (K2's): groups of `group` samples, `tiles`
// tiles of `tile` pixels a sample. Scratch, fp32: pmean/pm2/psg/psgy
// (n, tiles, c), mean/rstd/mg/mgy (n, c); done (2 n) ints, zeroed here.
// Returns the CUDA error of the first failing call, or 0. Launches on
// `stream` and does not synchronize.
extern "C" int ducosy_instance_norm_bwd(
    const void* x, const void* g, void* dx, float* pmean, float* pm2,
    float* psg, float* psgy, float* mean, float* rstd, float* mg, float* mgy,
    int* done, int n, int h, int w, int c, int relu, int pad, float eps,
    int group, int tiles, int tile, int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = is_bf16 ? dispatch<bf16> : dispatch<float>;
  return run(x, g, dx, pmean, pm2, psg, psgy, mean, rstd, mg, mgy, done, n, h,
             w, c, relu, pad, eps, group, tiles, tile, 1, 7, s);
}

// By parts, for measurement: design 0 the original launches (scratch
// (n, ceil(h*w / 128), c)), 1 the kernel above, 2 the kernel without
// programmatic dependent launch; parts 1 the statistics, 2 the sums (each
// with its merge), 4 the apply. Otherwise as ducosy_instance_norm_bwd.
extern "C" int ducosy_instance_norm_bwd_probe(
    const void* x, const void* g, void* dx, float* pmean, float* pm2,
    float* psg, float* psgy, float* mean, float* rstd, float* mg, float* mgy,
    int* done, int n, int h, int w, int c, int relu, int pad, float eps,
    int group, int tiles, int tile, int design, int parts, int is_bf16,
    void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = is_bf16 ? dispatch<bf16> : dispatch<float>;
  return run(x, g, dx, pmean, pm2, psg, psgy, mean, rstd, mg, mgy, done, n, h,
             w, c, relu, pad, eps, group, tiles, tile, design, parts, s);
}
