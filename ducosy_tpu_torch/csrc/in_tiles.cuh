// What K2 (instance_norm.cu) and K3 (instance_norm_bwd.cu) share: the tile
// plan's statistics launch and the pieces it is built from.
//
// The wrapper's `plan` (ops/kernels/instance_norm.py) cuts the batch into
// tiles of pixels x all channels, one tile a block of IN_THREADS threads, as
// many samples at once as there are SMs. `in_stats` reduces a tile: a thread
// owns 8 (bf16) or 4 (fp32) consecutive channels (`Lanes`), read 16 bytes at
// a time over a stripe of pixels, IN_BATCH pixels at a time with the next
// batch's loads in flight; it folds each batch's mean and centred M2 into
// its running (count, mean, M2) with Chan's formula (chan_step); the stripes
// merge per channel through shared memory (merge_channels) into the tile's
// partials. The last block of a sample to finish (an arrival counter a
// sample) merges the sample's partials, coalesced and pooled over `phases`,
// into mean and 1/std. K3 runs the same launch on the same plan, so its
// statistics are K2's bits on the same x. `launch` starts a kernel with
// programmatic dependent launch (PDL) so that it overlaps the tail of the
// one before it; pdl_wait / pdl_trigger are the device side.
//
// Each library is one translation unit that includes this header once;
// everything here has internal linkage.
#pragma once

#include "common.cuh"

namespace ducosy {
namespace {

constexpr int IN_THREADS = 512;
constexpr int IN_BATCH = 8;       // pixels a statistics thread folds at once
constexpr int IN_STAGE = 4608;    // per-row states: rows x (c + 1) floats
constexpr int MERGE_LOADS = 8;    // states a merging thread reads at once

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

// Launch `kernel` with IN_THREADS threads and `smem` bytes of dynamic shared
// memory on s, with programmatic stream serialization when `pdl`.
template <typename... P, typename... A>
int launch_smem(void (*kernel)(P...), dim3 grid, size_t smem, cudaStream_t s,
                bool pdl, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(IN_THREADS);
  cfg.dynamicSmemBytes = smem;
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

template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, cudaStream_t s, bool pdl,
           A... args) {
  return launch_smem(kernel, grid, 0, s, pdl, args...);
}

}  // namespace
}  // namespace ducosy
