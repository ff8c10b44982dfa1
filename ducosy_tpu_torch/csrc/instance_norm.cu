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
//  - in_stats: a block reduces its tile. A thread owns 8 (bf16) or 4 (fp32)
//    consecutive channels, read 16 bytes at a time over a stripe of pixels,
//    IN_BATCH pixels at a time with the next batch's loads in flight; it
//    folds each batch's mean and centred M2 into its running (count, mean,
//    M2) with Chan's formula (chan_step); the stripes merge per channel
//    through shared memory (merge_channels) into the tile's partials. The
//    last block of a sample to finish (an arrival counter a sample) merges
//    the sample's partials, coalesced and pooled over `phases`, into mean
//    and 1/std.
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
#include "common.cuh"

namespace ducosy {
namespace {

constexpr int IN_THREADS = 512;
constexpr int IN_BATCH = 8;       // pixels a statistics thread folds at once
constexpr int IN_STAGE = 4608;    // per-row states: rows x (c + 1) floats
constexpr int MERGE_LOADS = 8;    // states a merging thread reads at once
constexpr int IN_UNROLL = 4;      // pixels an apply thread keeps in flight

// 16 bytes of the io dtype: element j as a float (exact), and V floats back
// (round to nearest even).
template <typename T> struct Io;
template <> struct Io<bf16> {
  static constexpr int V = 8;
  __device__ static float at(const uint4& u, int j) {
    const uint32_t word = (&u.x)[j / 2];
    return __uint_as_float(j % 2 ? word & 0xffff0000u : word << 16);
  }
  __device__ static uint4 pack(const float (&f)[V]) {
    uint4 u;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < V / 2; ++j)
      p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return u;
  }
};
template <> struct Io<float> {
  static constexpr int V = 4;
  __device__ static float at(const uint4& u, int j) {
    return __uint_as_float((&u.x)[j]);
  }
  __device__ static uint4 pack(const float (&f)[V]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

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

// Chan merges of the `entries` (count, mean, M2) states of each of `nch`
// channels (nch <= IN_THREADS): get(ch, e, cnt, mean, m2) reads entry e of
// channel ch. S = IN_THREADS / nch threads share a channel (neighbouring
// threads take neighbouring channels, so reads of one entry coalesce);
// thread sub of channel ch folds entries sub, sub + S, ... in order,
// MERGE_LOADS read at once, and thread ch then folds the S states in order
// through `red` (3 IN_THREADS floats of shared memory) and calls put(ch,
// count, mean, M2). Every thread of the block must call it; ends with a
// block barrier.
template <typename G, typename P>
__device__ __forceinline__ void merge_channels(int nch, int entries,
                                               float* red, G&& get,
                                               P&& put) {
  const int tid = threadIdx.x, S = IN_THREADS / nch;
  const int ch = tid % nch, sub = tid / nch;
  float cc = 0.f, mm = 0.f, qq = 0.f;
  if (sub < S) {
    for (int e0 = sub; e0 < entries; e0 += S * MERGE_LOADS) {
      float vn[MERGE_LOADS], vm[MERGE_LOADS], vq[MERGE_LOADS];
#pragma unroll
      for (int u = 0; u < MERGE_LOADS; ++u) {
        const int e = e0 + S * u;
        vn[u] = 0.f;
        if (e < entries) get(ch, e, vn[u], vm[u], vq[u]);
      }
#pragma unroll
      for (int u = 0; u < MERGE_LOADS; ++u)
        if (vn[u] > 0.f) chan_step(cc, mm, qq, vm[u], vq[u], vn[u]);
    }
  }
  red[tid] = cc;
  red[IN_THREADS + tid] = mm;
  red[2 * IN_THREADS + tid] = qq;
  __syncthreads();
  if (tid < nch) {
    for (int s = 1; s < S; ++s) {
      const int k = s * nch + tid;
      if (red[k] > 0.f)
        chan_step(cc, mm, qq, red[IN_THREADS + k], red[2 * IN_THREADS + k],
                  red[k]);
    }
    put(tid, cc, mm, qq);
  }
  __syncthreads();
}

// The pixel rows and channel lanes of a block: thread `row` x `lane` owns
// channels lane * V .. + V - 1 of pixels row, row + rows, ... (threads from
// rows * (c / V) on own none).
template <typename T> struct Lanes {
  int cv, rows, lane, row;
  __device__ explicit Lanes(int c)
      : cv(c / Io<T>::V), rows(IN_THREADS / cv),
        lane((int)threadIdx.x % cv), row((int)threadIdx.x / cv) {}
  __device__ bool active() const { return row < rows; }
};

// Per-channel (count, mean, M2) of pixels m0 .. m0 + npx - 1 of one sample
// xs (hw, c), every channel: put(ch, count, mean, M2) for each. sm / sq
// (IN_STAGE floats), scnt (IN_THREADS) and red (3 IN_THREADS) are shared
// memory. Every thread of the block must call it; ends with a block barrier.
template <typename T, typename P>
__device__ __forceinline__ void tile_stats_all(const T* xs, int c, int m0,
                                               int npx, float* sm, float* sq,
                                               float* scnt, float* red,
                                               P&& put) {
  constexpr int V = Io<T>::V;
  const Lanes<T> ln(c);
  const int lds = c + 1;
  if (ln.active()) {
    const int mine = ln.row < npx ? (npx - ln.row + ln.rows - 1) / ln.rows : 0;
    const T* src = xs + (size_t)(m0 + ln.row) * c + ln.lane * V;
    const size_t step = (size_t)ln.rows * c;
    auto load = [&](uint4 (&r)[IN_BATCH], int k0) {
#pragma unroll
      for (int b = 0; b < IN_BATCH; ++b)
        if (k0 + b < mine)
          r[b] = __ldcg(reinterpret_cast<const uint4*>(src + (k0 + b) * step));
    };
    float cnt = 0.f, m[V], q[V];
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = q[j] = 0.f;
    uint4 raw[IN_BATCH], nxt[IN_BATCH];
    load(raw, 0);
    for (int k0 = 0; k0 < mine; k0 += IN_BATCH) {
      const int nb = min(IN_BATCH, mine - k0);
      load(nxt, k0 + IN_BATCH);
      const float fb = (float)nb;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < IN_BATCH; ++b)
          if (b < nb) sum += Io<T>::at(raw[b], j);
        const float mb = sum / fb;
        float qb = 0.f;
#pragma unroll
        for (int b = 0; b < IN_BATCH; ++b)
          if (b < nb) {
            const float d = Io<T>::at(raw[b], j) - mb;
            qb += d * d;
          }
        float cj = cnt;
        chan_step(cj, m[j], q[j], mb, qb, fb);
      }
      cnt += fb;
#pragma unroll
      for (int b = 0; b < IN_BATCH; ++b) raw[b] = nxt[b];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sm[ln.row * lds + ln.lane * V + j] = m[j];
      sq[ln.row * lds + ln.lane * V + j] = q[j];
    }
    if (ln.lane == 0) scnt[ln.row] = cnt;
  }
  __syncthreads();
  for (int c0 = 0; c0 < c; c0 += IN_THREADS)
    merge_channels(
        min(IN_THREADS, c - c0), ln.rows, red,
        [&](int ch, int r, float& n, float& mr, float& qr) {
          n = scnt[r];
          mr = sm[r * lds + c0 + ch];
          qr = sq[r * lds + c0 + ch];
        },
        [&](int ch, float n, float mr, float qr) { put(c0 + ch, n, mr, qr); });
}

// The statistics of sample ni from its `tiles` partials per channel at
// pmean / pm2[(ni * tiles + t) * c + ch] (count of tile t: min(tile, hw -
// t * tile)), pooled over the `phases` groups of c in phase-major order:
// put(true channel, mean, 1/std). Reads through L2 (__ldcg): the partials
// are other blocks' writes. Every thread of the block must call it.
template <typename P>
__device__ __forceinline__ void sample_stats(const float* pmean,
                                             const float* pm2, float* red,
                                             int ni, int tiles, int tile,
                                             int hw, int c, int phases,
                                             float eps, P&& put) {
  const int cg = c / phases;
  for (int c0 = 0; c0 < cg; c0 += IN_THREADS)
    merge_channels(
        min(IN_THREADS, cg - c0), phases * tiles, red,
        [&](int ch, int e, float& n, float& m, float& q) {
          const int t = e % tiles;
          const size_t k = ((size_t)ni * tiles + t) * c + (e / tiles) * cg +
                           c0 + ch;
          n = (float)max(0, min(tile, hw - t * tile));
          m = __ldcg(pmean + k);
          q = __ldcg(pm2 + k);
        },
        [&](int ch, float, float m, float q) {
          put(c0 + ch, m, inv_std(q, hw * phases, eps));
        });
}

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

// Programmatic dependent launch (sm_90): a grid launched with programmatic
// stream serialization may start while the grid before it in the stream
// still runs. pdl_wait blocks until that grid has completed and its writes
// are visible; pdl_trigger lets the next grid's blocks be scheduled once
// every block of this grid has issued it or exited. Both are no-ops in a
// grid launched without the attribute.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Statistics: grid (tiles, gz); block (t, i) reduces pixels t * tile .. of
// sample i of x (gz, hw, c) into pmean / pm2[(i * tiles + t) * c + ch].
// With `done` (gz zeroed arrival counters) the last block of a sample to
// finish merges its partials into gmean / grstd[i * c + ch].
template <typename T>
__global__ void __launch_bounds__(IN_THREADS, 1)
in_stats(const T* __restrict__ x, float* pmean, float* pm2, float* gmean,
         float* grstd, int* done, int hw, int c, int tile, int phases,
         float eps) {
  __shared__ __align__(16) float sm[IN_STAGE];
  __shared__ __align__(16) float sq[IN_STAGE];
  __shared__ float scnt[IN_THREADS], red[3 * IN_THREADS];
  __shared__ int last;
  pdl_trigger();     // the apply's blocks may take the SMs this grid frees
  const int t = blockIdx.x, ni = blockIdx.y, m0 = t * tile;
  tile_stats_all<T>(x + (size_t)ni * hw * c, c, m0, min(tile, hw - m0), sm,
                    sq, scnt, red, [&](int ch, float, float m, float q) {
                      const size_t k = ((size_t)ni * gridDim.x + t) * c + ch;
                      pmean[k] = m;
                      pm2[k] = q;
                    });
  if (done) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(done + ni, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      sample_stats(pmean, pm2, red, ni, gridDim.x, tile, hw, c, phases, eps,
                   [&](int ch, float m, float rs) {
                     for (int p = 0; p < phases; ++p) {
                       gmean[(size_t)ni * c + p * (c / phases) + ch] = m;
                       grstd[(size_t)ni * c + p * (c / phases) + ch] = rs;
                     }
                   });
    }
  }
  pdl_wait();        // complete only after the grid before this one
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

// Launch `kernel` with IN_THREADS threads on s, with programmatic stream
// serialization when `pdl`.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, cudaStream_t s, bool pdl,
           A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(IN_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  DUCOSY_CHECK_LAUNCH();
  return 0;
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
