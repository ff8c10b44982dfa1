// Shared device code of the port's InstanceNorm-bearing kernels (K1-K5,
// K7, K8) and the int8 tap probe (P3).
//
// Whole-image reductions are split into per-tile partials and an apply
// step: a tile of TILE_M pixels x TILE_N channels reports its per-channel
// mean and centred sum of squares (M2), and finalize_stats merges the
// tiles of each (sample, channel) with Chan's parallel formula. That keeps
// the centred variance of the reference composition (conv_in.py:79-83,
// instance_norm.py:349-359) without a second pass over the image.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ducosy {

using bf16 = __nv_bfloat16;

constexpr int TILE_M = 128;          // pixels per tile (flattened h*W + w)
constexpr int TILE_N = 64;           // channels per tile
constexpr int CS_LD = TILE_N + 4;    // fp32 row stride of a tile in smem
constexpr int TILE_SMEM = TILE_M * CS_LD * 4;   // 34,816 bytes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}
// A value cast, toward zero and saturating: what K7 writes for an int8
// input without an int8 scale (the TPU kernel's astype, conv_in.py:111).
template <> __device__ __forceinline__ int8_t from_f32<int8_t>(float v) {
  return static_cast<int8_t>(fminf(fmaxf(truncf(v), -128.f), 127.f));
}

// Round an fp32 value to the io type and back: the reference casts its
// intermediates to the io dtype at these points (conv_in.py:176-219).
template <typename T> __device__ __forceinline__ float round_io(float v) {
  return to_f32(from_f32<T>(v));
}

// Reflect index i into [0, n) without repeating the edge
// (ReflectionPad2d; valid for -n < i < 2n - 1).
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// Per-channel partials of one tile held in shared memory as
// cs[row * CS_LD + channel], `rows` valid rows: mean, centred M2 and
// (if pmax) max, for TILE_N channels, written at pmean[base + channel].
__device__ __forceinline__ void tile_stats(const float* cs, int rows,
                                           float* pmean, float* pm2,
                                           float* pmax, size_t base) {
  const int c = threadIdx.x;
  if (c >= TILE_N) return;
  float s = 0.f, mx = -INFINITY;
  for (int r = 0; r < rows; ++r) {
    const float v = cs[r * CS_LD + c];
    s += v;
    mx = fmaxf(mx, v);
  }
  const float m = s / rows;
  float q = 0.f;
  for (int r = 0; r < rows; ++r) {
    const float d = cs[r * CS_LD + c] - m;
    q += d * d;
  }
  pmean[base + c] = m;
  pm2[base + c] = q;
  if (pmax) pmax[base + c] = mx;
}

// Merge the `tiles` partials of channel ci of sample ni (Chan et al.):
// returns the mean in *mean and the centred M2 in *m2; *mx gets the max
// when pmax is given.
// One step of Chan's merge: the running (count, mean, M2) takes in a tile of
// nb pixels with mean pm and centred M2 pq. Every merge of the port goes
// through here, so every route gives a channel the same bits.
__device__ __forceinline__ void chan_step(float& cnt, float& m, float& q,
                                          float pm, float pq, float nb) {
  const float tot = cnt + nb;
  const float d = pm - m;
  m += d * (nb / tot);
  q += pq + d * d * (cnt * nb / tot);
  cnt = tot;
}

__device__ __forceinline__ void merge_tiles(const float* pmean,
                                            const float* pm2,
                                            const float* pmax, int ni, int ci,
                                            int tiles, int hw, int c,
                                            float* mean, float* m2,
                                            float* mx) {
  float cnt = 0.f, m = 0.f, q = 0.f, x = -INFINITY;
  for (int t = 0; t < tiles; ++t) {
    const size_t k = ((size_t)ni * tiles + t) * c + ci;
    chan_step(cnt, m, q, pmean[k], pm2[k],
              (float)min(TILE_M, hw - t * TILE_M));
    if (pmax) x = fmaxf(x, pmax[k]);
  }
  *mean = m;
  *m2 = q;
  *mx = x;
}

__device__ __forceinline__ float inv_std(float m2, int hw, float eps) {
  return 1.f / sqrtf(fmaxf(m2 / hw, 0.f) + eps);
}

// A barrier across the `nblocks` blocks that share `word`, for kernels
// launched cooperatively (every block resident at once). The word counts
// arrivals and is never reset: a barrier is passed when the count reaches
// the next multiple of nblocks, so the word is zeroed once, when its scratch
// is made, and must then only ever serve groups of the same size whose
// blocks all pass the same number of barriers. `target` is the block's own
// record of that multiple, 0 before its first barrier of the launch: the
// first arrival reads the count back to learn it, later ones only add
// (a reduction, no round trip). What the block wrote before the barrier is
// visible to every block after it, to loads that do not go through L1
// (__ldcg).
__device__ __forceinline__ void grid_barrier(unsigned long long* word,
                                             unsigned nblocks,
                                             unsigned long long& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (target == 0) {
      __threadfence();
      target = (atomicAdd(word, 1ULL) / nblocks + 1) * nblocks;
    } else {
      target += nblocks;
      asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(word)
                   : "memory");
    }
    unsigned long long now;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
                   : "=l"(now)
                   : "l"(word)
                   : "memory");
    } while (now < target);
  }
  __syncthreads();
}

// The statistics of sample ni for a cooperative kernel whose blocks have
// each written their tile's partials: after a grid barrier the group's
// blocks share the c channels out (block `bid` of `nblocks` takes channels
// bid, bid + nblocks, ...), each stages its channels' `tiles` partials from
// L2 in `work` (3 (c / nblocks + 1) tiles floats of shared memory) and
// merges them, one warp a channel: lane l takes tiles l, l + 32, ... in
// order with chan_step, then the lanes' (count, mean, M2) combine pairwise
// with the same formula (a tree, so the last bits may differ from
// merge_tiles' serial order: one thread walking 128 tiles took 4 us a
// sample). The block publishes mean and 1/std (and max with pmax) in gmean /
// grstd / gmax at [ni * c + channel]; after a second barrier every block
// reads the bn channels from co0 that it normalizes into smean / srstd
// (/ smax). One merge per channel and sample on the whole card: letting
// every block merge all of its channels itself re-reads the sample's
// partials once per block (49 MB a sample at the trunk shape, 30 us).
// Ends with a block barrier.
__device__ __forceinline__ void merge_sample(
    const float* pmean, const float* pm2, const float* pmax, float* gmean,
    float* grstd, float* gmax, unsigned long long* bar, unsigned nblocks,
    unsigned long long& target, int bid, int ni, int co0, int bn, int tiles,
    int hw, int c, float eps, float* work, float* smean, float* srstd,
    float* smax) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  grid_barrier(bar, nblocks, target);
  const int mine = bid < c ? (c - bid + (int)nblocks - 1) / (int)nblocks : 0;
  float* wm = work;
  float* wq = wm + mine * tiles;
  float* wx = wq + mine * tiles;
  for (int e0 = 0; e0 < mine * tiles; e0 += 4 * nth) {
    float vm[4], vq[4], vx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nth + tid;
      if (e < mine * tiles) {
        const size_t k = ((size_t)ni * tiles + e % tiles) * c + bid +
                         (e / tiles) * nblocks;
        vm[u] = __ldcg(pmean + k);
        vq[u] = __ldcg(pm2 + k);
        if (pmax) vx[u] = __ldcg(pmax + k);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nth + tid;
      if (e < mine * tiles) {
        wm[e] = vm[u];
        wq[e] = vq[u];
        if (pmax) wx[e] = vx[u];
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < mine; i += nth / 32) {
    float cnt = 0.f, m = 0.f, q = 0.f, x = -INFINITY;
    for (int t = lane; t < tiles; t += 32) {
      chan_step(cnt, m, q, wm[i * tiles + t], wq[i * tiles + t],
                (float)min(TILE_M, hw - t * TILE_M));
      if (pmax) x = fmaxf(x, wx[i * tiles + t]);
    }
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float cb = __shfl_xor_sync(0xffffffffu, cnt, off);
      const float mb = __shfl_xor_sync(0xffffffffu, m, off);
      const float qb = __shfl_xor_sync(0xffffffffu, q, off);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      // the lower lane's tiles come first: both lanes compute the same bits
      const bool low = !(lane & off);
      float c0 = low ? cnt : cb, m0 = low ? m : mb, q0 = low ? q : qb;
      const float c1 = low ? cb : cnt, m1 = low ? mb : m, q1 = low ? qb : q;
      if (c1 > 0.f) {
        if (c0 > 0.f) {
          chan_step(c0, m0, q0, m1, q1, c1);
        } else {
          c0 = c1; m0 = m1; q0 = q1;
        }
      }
      cnt = c0; m = m0; q = q0;
    }
    if (lane == 0) {
      const size_t k = (size_t)ni * c + bid + i * nblocks;
      gmean[k] = m;
      grstd[k] = inv_std(q, hw, eps);
      if (pmax) gmax[k] = x;
    }
  }
  grid_barrier(bar, nblocks, target);
  if (tid < bn) {
    const size_t k = (size_t)ni * c + co0 + tid;
    smean[tid] = __ldcg(gmean + k);
    srstd[tid] = __ldcg(grstd + k);
    if (pmax) smax[tid] = __ldcg(gmax + k);
  }
  __syncthreads();
}

constexpr int STATS_THREADS = 256;

// Per-tile partials of x (n, h*w, c) in the io dtype: mean, M2 and (if
// pmax) max of each channel over TILE_M pixels. Grid (c / TILE_N, tiles, n).
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
tile_stats_kernel(const T* __restrict__ x, float* __restrict__ pmean,
                  float* __restrict__ pm2, float* __restrict__ pmax, int hw,
                  int c) {
  __shared__ __align__(16) float cs[TILE_M * CS_LD];
  const int co0 = blockIdx.x * TILE_N, tile = blockIdx.y, ni = blockIdx.z;
  const int m0 = tile * TILE_M, rows = min(TILE_M, hw - m0);
  for (int i = threadIdx.x; i < TILE_M * TILE_N; i += STATS_THREADS) {
    const int r = i / TILE_N, k = i % TILE_N;
    cs[r * CS_LD + k] =
        r < rows ? to_f32(x[((size_t)ni * hw + m0 + r) * c + co0 + k]) : 0.f;
  }
  __syncthreads();
  tile_stats(cs, rows, pmean, pm2, pmax,
             ((size_t)ni * gridDim.y + tile) * c + co0);
}

// Channel sums over a tile, for kernels that reduce NSUM per-pixel values
// of each channel: a block of STATS_THREADS is 4 pixel groups x TILE_N
// channels; each thread adds its pixels, then the groups are summed in
// shared memory and written at out[s][(ni * tiles + tile) * c + channel].
constexpr int SUM_GROUPS = STATS_THREADS / TILE_N;

template <int NSUM>
__device__ __forceinline__ void store_tile_sums(const float (&acc)[NSUM],
                                                float* const (&out)[NSUM],
                                                int c) {
  __shared__ float red[NSUM][SUM_GROUPS][TILE_N];
  const int k = threadIdx.x % TILE_N, grp = threadIdx.x / TILE_N;
#pragma unroll
  for (int s = 0; s < NSUM; ++s) red[s][grp][k] = acc[s];
  __syncthreads();
  if (grp == 0) {
    const size_t o = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * c +
                     blockIdx.x * TILE_N + k;
#pragma unroll
    for (int s = 0; s < NSUM; ++s) {
      float v = 0.f;
      for (int g = 0; g < SUM_GROUPS; ++g) v += red[s][g][k];
      out[s][o] = v;
    }
  }
}

// Sum of the `tiles` partials of (sample, channel) idx in p (n, tiles, c).
__device__ __forceinline__ float sum_tiles(const float* p, int idx, int tiles,
                                           int c) {
  const int ni = idx / c, ci = idx % c;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += p[((size_t)ni * tiles + t) * c + ci];
  return s;
}

// The reflect-pad adjoint as a gather: channel k of the cotangent g of a
// tensor reflect-padded by `pad` (0 or 1), folded back onto interior pixel
// (i, j). g points at one sample, (h + 2 pad, w + 2 pad, c). With pad 1
// the pad row 0 mirrors row 1 and the pad row h + 1 mirrors row h - 2
// (likewise columns), so rows and columns 1 and h - 2 gather two terms and
// their crossings four. A gather writes each output once: no atomics.
template <typename T>
__device__ __forceinline__ float fold_reflect(const T* g, int i, int j, int k,
                                              int h, int w, int c, int pad) {
  if (!pad) return to_f32(g[((size_t)i * w + j) * c + k]);
  int rows[3], cols[3], nr = 0, nc = 0;
  rows[nr++] = i + 1;
  cols[nc++] = j + 1;
  if (i == 1) rows[nr++] = 0;
  if (i == h - 2) rows[nr++] = h + 1;
  if (j == 1) cols[nc++] = 0;
  if (j == w - 2) cols[nc++] = w + 1;
  float s = 0.f;
  for (int a = 0; a < nr; ++a)
    for (int b = 0; b < nc; ++b)
      s += to_f32(g[((size_t)rows[a] * (w + 2) + cols[b]) * c + k]);
  return s;
}

// (sample, channel) mean and 1/sqrt(var + eps) from the tile partials.
__global__ void finalize_stats(const float* __restrict__ pmean,
                               const float* __restrict__ pm2,
                               float* __restrict__ mean,
                               float* __restrict__ rstd, int n, int tiles,
                               int c, int hw, float eps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * c) return;
  float m, q, unused;
  merge_tiles(pmean, pm2, nullptr, idx / c, idx % c, tiles, hw, c, &m, &q,
              &unused);
  mean[idx] = m;
  rstd[idx] = inv_std(q, hw, eps);
}

// y = (x - mean) * rstd, optional ReLU, written reflect-padded by `pad`:
// one block per output pixel (grid w+2p, h+2p, n), threads over channels.
// x is (n, h*w, c); out is (n, h+2p, w+2p, c).
template <typename TIn, typename TOut>
__global__ void norm_apply(const TIn* __restrict__ x,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           TOut* __restrict__ out, int h, int w, int c,
                           int pad, int relu) {
  const int wo = blockIdx.x, ho = blockIdx.y, ni = blockIdx.z;
  const int hi = reflect(ho - pad, h), wi = reflect(wo - pad, w);
  const TIn* src = x + (((size_t)ni * h + hi) * w + wi) * c;
  TOut* dst = out + (((size_t)ni * (h + 2 * pad) + ho) * (w + 2 * pad) + wo) * c;
  const float* mu = mean + (size_t)ni * c;
  const float* rs = rstd + (size_t)ni * c;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    float y = (to_f32(src[k]) - mu[k]) * rs[k];
    if (relu) y = fmaxf(y, 0.f);
    dst[k] = from_f32<TOut>(y);
  }
}

constexpr int APPLY_THREADS = 128;

// One mma.sync.m16n8k32 s8 x s8 -> s32 step: d += a * b, exact. a is the
// 16x32 row-major fragment (4 registers of 4 bytes), b the 32x8
// column-major fragment (2 registers), d the 16x8 accumulator; lane l holds
// rows l/4 and l/4 + 8, at k offsets 4 (l%4) and 16 + 4 (l%4) of a and b,
// and columns 2 (l%4), 2 (l%4) + 1 of d.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The int8 operand tiles of K1q's conv2 and the P3 probe: BK8 input
// channels (bytes) per K step, rows LD8 bytes apart (80 B, so the 8 x 4
// lane pattern of the 32-bit fragment loads hits distinct banks).
constexpr int BK8 = 64;
constexpr int LD8 = BK8 + 16;

// One BK8-deep K step of a TILE_M x TILE_N block tile on mma.sync s8. as
// holds the tile's TILE_M A rows (pixels), bs its TILE_N B rows (output
// channels: B transposed), each BK8 input channels at stride LD8. The warp
// at (wm, wn) of the 4 x 2 warp grid adds its 32 x 32 tile, 2 x 4 m16n8
// fragments, to d.
__device__ __forceinline__ void warp_mma_s8_step(const int8_t* as,
                                                 const int8_t* bs, int wm,
                                                 int wn, int lane,
                                                 int (&d)[2][4][4]) {
  const int g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int kk = 0; kk < BK8; kk += 32) {
    uint32_t fa[2][4], fb[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* p = as + (wm * 32 + i * 16 + g) * LD8 + kk + tg * 4;
      fa[i][0] = *reinterpret_cast<const uint32_t*>(p);
      fa[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD8);
      fa[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      fa[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD8 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = bs + (wn * 32 + j * 8 + g) * LD8 + kk + tg * 4;
      fb[j][0] = *reinterpret_cast<const uint32_t*>(p);
      fb[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(d[i][j], fa[i], fb[j][0], fb[j][1]);
  }
}

// The shifted int8 grid of quantized serving (ducosy_tpu/ops/pallas/
// instance_norm.py:27-55, :186-199): q = trunc(min(y * k + 0.5, 255)) - 128
// for y >= 0, k = 255 / S, in fp32. The product and the sum are rounded
// separately (no FMA), as the reference and the plain version compute them.
__device__ __forceinline__ int8_t quantize_shifted(float y, float k) {
  const float q = fminf(__fadd_rn(__fmul_rn(y, k), 0.5f), 255.f);
  return static_cast<int8_t>(static_cast<int>(q) - 128);
}

// norm_apply with ReLU and a shifted-grid int8 write at k = 255 / S. The
// normalized value is rounded to TRound before the quantize: the io dtype
// for K2's int8 write (instance_norm.py:172-199), float (no rounding) for
// K1q's intermediate (conv_in.py:380-386).
template <typename TIn, typename TRound>
__global__ void norm_apply_int8(const TIn* __restrict__ x,
                                const float* __restrict__ mean,
                                const float* __restrict__ rstd,
                                int8_t* __restrict__ out, int h, int w, int c,
                                int pad, float k) {
  const int wo = blockIdx.x, ho = blockIdx.y, ni = blockIdx.z;
  const int hi = reflect(ho - pad, h), wi = reflect(wo - pad, w);
  const TIn* src = x + (((size_t)ni * h + hi) * w + wi) * c;
  int8_t* dst = out + (((size_t)ni * (h + 2 * pad) + ho) * (w + 2 * pad) + wo) * c;
  const float* mu = mean + (size_t)ni * c;
  const float* rs = rstd + (size_t)ni * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float y = fmaxf((to_f32(src[ch]) - mu[ch]) * rs[ch], 0.f);
    dst[ch] = quantize_shifted(round_io<TRound>(y), k);
  }
}

}  // namespace ducosy

#define DUCOSY_CHECK_LAUNCH()                     \
  do {                                            \
    cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

// Return a nonzero status of `call` (a launch function's) at once.
#define DUCOSY_TRY(call)            \
  do {                              \
    const int e_ = (call);          \
    if (e_ != 0) return e_;         \
  } while (0)

// Each library is one translation unit that includes this header once.
extern "C" const char* ducosy_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
