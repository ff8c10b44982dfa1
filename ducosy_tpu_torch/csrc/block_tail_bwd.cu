// K5: the backward of K4 (x + CBAM(IN(h)), reflect-padded), for Hopper
// (sm_90a).
//
// Replaces: block_tail_bwd_pallas (ducosy_tpu/ops/pallas/cbam_block.py:272,
// pallas_calls at :288 (stats pass) and :329 (apply pass)), the analytic
// VJP of block_tail_fused (_analytic_tail_bwd, :372-469). It recomputes
// the forward from h, as the TPU wrapper does.
//
// What bounds it: a handful of FLOP per element of h (N, 128, 128, 256) and
// of the cotangent g (N, 130, 130, 256), both in the io dtype: memory. h
// and g read once, dh and dx written once are 272 MB at (8, 128, 128, 256)
// bf16, 0.081 ms at 3.35 TB/s.
//
// Two routes, which the wrapper picks from shape, dtype and the device's
// co-resident block count (ops/kernels/block_tail.py, tail_route):
//   resident (block_tail_bwd_resident below: bf16, C = 64, 128 or 256,
//     W <= 256, a sample's tiles on the card at once): one cooperative
//     launch; a block keeps its 128 pixels x C channels of h (then y, then
//     dh) and of the folded cotangent in shared memory, runs the 7x7
//     adjoint itself on the map rows within reach of its tile, and writes
//     dh, dx (the fold in fp32, rounded once; what the wrapper did before)
//     and the per-sample (dw1, dw2) and per-tile (dwsa) weight partials.
//     h and g cross device memory once; six grid barriers a sample.
//   tiled (the original two passes, everything else: fp32, C = 192, wide or large
//     images): two entry points with the 7x7 adjoint in PyTorch between
//     them, as the JAX package runs it in XLA (:314-327); the wrapper folds
//     g for dx (:363-368). h is read 4 times, g 3 times.
//
// Tiled design. Every whole-image reduction splits into per-tile partials
// and a merge (common.cuh); the max-pool adjoints split the gradient
// equally among tied maxima (:434-437, :450-454):
//   stats entry point
//   1. tile statistics of h (mean, M2, max);
//   2. channel gate (cbam_tail.cuh): mean, rstd, mx = max y, gate_c;
//   3. per-pixel maps, one warp per pixel over the channels: sa_avg,
//      sa_max and dgs = sum_c g*t of the forward, plus mcnt, the number of
//      channels tied at sa_max;
//   (wrapper: gs = sigmoid(conv7x7(sa_avg, sa_max)), dm_avg, dm_max, dwsa)
//   apply entry point
//   4. per tile and channel: sum dt, sum dt*y and the count of pixels tied
//      at mx, where dt = g*gs + dm_avg/C + [t == sa_max] dm_max/mcnt;
//   5. channel-gate adjoint, one block of C threads per sample: dgc =
//      sum dt*y, the sigmoid and MLP adjoints, dw1/dw2 partials, and the
//      two means of dy = dt*gate_c + [y == mx] dpool_max/ycnt that the IN
//      adjoint needs (mean(dy) and mean(dy*y) follow from the tile sums in
//      closed form, so dy is never stored);
//   6. apply, one block per pixel: dh = (dy - mean dy - y*mean(dy*y))*rstd.
// The reflect-pad adjoint is a gather (fold_reflect), as in K3.
// Rounding: y and t as K4 computes them (cbam_tail.cuh); dt, dy and dh in
// fp32, rounded once at the end, where the reference rounds dt and dy to
// the io dtype (and folds g in it) before its reductions; the resident
// route takes gf as the plain version does, the fold rounded to the io
// dtype (once, in fp32), where the tiled route keeps it in fp32. The
// avg-pool path of the channel gate is zero, as in the forward, so its
// adjoint (the dpool_avg/count term of dy, which the IN adjoint cancels,
// and the avg terms of dw1, dw2) is zero too.
#include <limits.h>

#include "tail_resident.cuh"

namespace ducosy {
namespace {

constexpr int MAP_WARPS = 8;   // pixels per block of the maps kernel

// Per-pixel maps (n, 4, h*w): sa_avg, sa_max, dgs, mcnt. Grid
// (ceil(hw / MAP_WARPS), n); dynamic shared memory 3*c floats.
template <typename T>
__global__ void __launch_bounds__(MAP_WARPS * 32)
tail_maps(const T* __restrict__ h, const T* __restrict__ g,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float* __restrict__ gate, float* __restrict__ maps, int hh,
          int ww, int c, int pad) {
  extern __shared__ float s_chan[];
  float* mu = s_chan;
  float* rs = s_chan + c;
  float* gc = s_chan + 2 * c;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ni = blockIdx.y, hw = hh * ww;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    mu[k] = mean[ni * c + k];
    rs[k] = rstd[ni * c + k];
    gc[k] = round_io<T>(gate[ni * c + k]);
  }
  __syncthreads();
  const int p = blockIdx.x * MAP_WARPS + warp;
  if (p >= hw) return;
  const T* a = h + ((size_t)ni * hw + p) * c;
  const T* gs = g + (size_t)ni * (hh + 2 * pad) * (ww + 2 * pad) * c;
  float s = 0.f, m = -INFINITY, d = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float t = gated<T>(a, mu, rs, gc, k);
    s += t;
    m = fmaxf(m, t);
    d += fold_reflect(gs, p / ww, p % ww, k, hh, ww, c, pad) * t;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  float cnt = 0.f;
  for (int k = lane; k < c; k += 32) cnt += gated<T>(a, mu, rs, gc, k) == m;
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) {
    float* out = maps + (size_t)ni * 4 * hw + p;
    out[0] = s / c;
    out[hw] = m;
    out[2 * hw] = d;
    out[3 * hw] = cnt;
  }
}

// The per-pixel inputs of the apply pass, maps2 (n, 5, h*w): gs, dm_avg,
// dm_max, sa_max, mcnt.
struct PixelAdj {
  float gs, dm_avg, dm_max, sa_max, mcnt;
};

template <typename T>
__device__ __forceinline__ PixelAdj load_pixel(const float* maps2, int ni,
                                               int hw, int p) {
  const float* q = maps2 + (size_t)ni * 5 * hw + p;
  return {round_io<T>(q[0]), q[hw], q[2 * hw], q[3 * hw], q[4 * hw]};
}

// dt of one channel at one pixel, given its t and folded cotangent gf.
__device__ __forceinline__ float tail_dt(const PixelAdj& a, float t, float gf,
                                         int c) {
  float dt = gf * a.gs + a.dm_avg / c;
  if (t == a.sa_max) dt += a.dm_max / a.mcnt;
  return dt;
}

// Tile sums of dt, dt*y and [y == mx]. Grid (c / TILE_N, tiles, n).
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
dt_sums(const T* __restrict__ h, const T* __restrict__ g,
        const float* __restrict__ mean, const float* __restrict__ rstd,
        const float* __restrict__ maxy, const float* __restrict__ gate,
        const float* __restrict__ maps2, float* __restrict__ pdt,
        float* __restrict__ pdty, float* __restrict__ pcnt, int hh, int ww,
        int c, int pad) {
  const int k = blockIdx.x * TILE_N + threadIdx.x % TILE_N;
  const int grp = threadIdx.x / TILE_N, ni = blockIdx.z;
  const int hw = hh * ww, m0 = blockIdx.y * TILE_M;
  const int rows = min(TILE_M, hw - m0);
  const int q = ni * c + k;
  const float mu = mean[q], rs = rstd[q], mx = maxy[q];
  const float gc = round_io<T>(gate[q]);
  const T* gs = g + (size_t)ni * (hh + 2 * pad) * (ww + 2 * pad) * c;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int rr = grp; rr < rows; rr += SUM_GROUPS) {
    const int m = m0 + rr;
    const PixelAdj a = load_pixel<T>(maps2, ni, hw, m);
    const float y = round_io<T>((to_f32(h[((size_t)ni * hw + m) * c + k]) - mu)
                                * rs);
    const float t = round_io<T>(y * gc);
    const float dt = tail_dt(a, t, fold_reflect(gs, m / ww, m % ww, k, hh, ww,
                                                c, pad), c);
    acc[0] += dt;
    acc[1] += dt * y;
    acc[2] += y == mx;
  }
  float* const outs[3] = {pdt, pdty, pcnt};
  store_tile_sums<3>(acc, outs, c);
}

// Channel-gate adjoint, one block of c threads per sample. Writes the
// dw1 (c, r) and dw2 (r, c) partials of the sample and vec (n, 3, c):
// mean(dy), mean(dy*y) and the max-pool coefficient dpool_max / ycnt.
// Dynamic shared memory: 2*c + 2*r floats.
template <typename T>
__global__ void gate_bwd(const float* __restrict__ pdt,
                         const float* __restrict__ pdty,
                         const float* __restrict__ pcnt,
                         const float* __restrict__ maxy,
                         const float* __restrict__ gate,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2, float* __restrict__ vec,
                         float* __restrict__ dw1, float* __restrict__ dw2,
                         int tiles, int hw, int c, int r) {
  extern __shared__ float sh[];
  float* s_da = sh;              // c
  float* s_mx = sh + c;          // c
  float* s_hid = sh + 2 * c;     // r
  float* s_dhid = s_hid + r;     // r
  const int ni = blockIdx.x, k = threadIdx.x, q = ni * c + k;
  const float sdt = sum_tiles(pdt, q, tiles, c);
  const float sdty = sum_tiles(pdty, q, tiles, c);
  const float ycnt = sum_tiles(pcnt, q, tiles, c);
  const float gc = gate[q];
  const float da = sdty * gc * (1.f - gc);     // dgc = sum dt*y
  s_da[k] = da;
  s_mx[k] = maxy[q];
  __syncthreads();
  if (k < r) {
    float pre = 0.f, back = 0.f;
    for (int i = 0; i < c; ++i) {
      pre += s_mx[i] * w1[i * r + k];
      back += s_da[i] * w2[k * c + i];
    }
    s_hid[k] = fmaxf(pre, 0.f);
    s_dhid[k] = pre > 0.f ? back : 0.f;
  }
  __syncthreads();
  float dpool = 0.f;
  for (int j = 0; j < r; ++j) {
    dpool += s_dhid[j] * w1[k * r + j];
    dw1[((size_t)ni * c + k) * r + j] = s_mx[k] * s_dhid[j];
    dw2[((size_t)ni * r + j) * c + k] = s_hid[j] * da;
  }
  const float gio = round_io<T>(gc);
  float* v = vec + (size_t)ni * 3 * c + k;
  v[0] = (gio * sdt + dpool) / hw;
  v[c] = (gio * sdty + dpool * s_mx[k]) / hw;
  v[2 * c] = dpool / ycnt;
}

// dh at one pixel per block (grid w, h, n), threads over channels.
template <typename T>
__global__ void tail_bwd_apply(const T* __restrict__ h,
                               const T* __restrict__ g,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               const float* __restrict__ maxy,
                               const float* __restrict__ gate,
                               const float* __restrict__ maps2,
                               const float* __restrict__ vec,
                               T* __restrict__ dh, int hh, int ww, int c,
                               int pad) {
  const int j = blockIdx.x, i = blockIdx.y, ni = blockIdx.z;
  const int hw = hh * ww, p = i * ww + j;
  const PixelAdj a = load_pixel<T>(maps2, ni, hw, p);
  const size_t pix = (size_t)ni * hw + p;
  const T* gs = g + (size_t)ni * (hh + 2 * pad) * (ww + 2 * pad) * c;
  const float* v = vec + (size_t)ni * 3 * c;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    const int q = ni * c + k;
    const float y = round_io<T>((to_f32(h[pix * c + k]) - mean[q]) * rstd[q]);
    const float gio = round_io<T>(gate[q]);
    const float dt = tail_dt(a, round_io<T>(y * gio),
                             fold_reflect(gs, i, j, k, hh, ww, c, pad), c);
    float dy = dt * gio;
    if (y == maxy[q]) dy += v[2 * c + k];
    dh[pix * c + k] = from_f32<T>((dy - v[k] - y * v[c + k]) * rstd[q]);
  }
}

template <typename T>
int tail_bwd_stats(const T* h, const T* g, const float* w1, const float* w2,
                   float* pmean, float* pm2, float* pmax, float* mean,
                   float* rstd, float* maxy, float* gate, float* maps, int n,
                   int hh, int ww, int c, int r, int pad, float eps,
                   cudaStream_t s) {
  const int hw = hh * ww, tiles = (hw + TILE_M - 1) / TILE_M;
  tile_stats_kernel<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
      h, pmean, pm2, pmax, hw, c);
  DUCOSY_CHECK_LAUNCH();
  channel_gate<T><<<n, c, (c + r) * sizeof(float), s>>>(
      pmean, pm2, pmax, w1, w2, mean, rstd, maxy, gate, tiles, hw, c, r, eps);
  DUCOSY_CHECK_LAUNCH();
  tail_maps<T><<<dim3((hw + MAP_WARPS - 1) / MAP_WARPS, n), MAP_WARPS * 32,
                 3 * c * sizeof(float), s>>>(h, g, mean, rstd, gate, maps, hh,
                                             ww, c, pad);
  DUCOSY_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int tail_bwd_apply_all(const T* h, const T* g, const float* w1,
                       const float* w2, const float* mean, const float* rstd,
                       const float* maxy, const float* gate,
                       const float* maps2, float* pdt, float* pdty,
                       float* pcnt, float* vec, T* dh, float* dw1, float* dw2,
                       int n, int hh, int ww, int c, int r, int pad,
                       int parts, cudaStream_t s) {
  const int hw = hh * ww, tiles = (hw + TILE_M - 1) / TILE_M;
  if (parts & 1) {
    dt_sums<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
        h, g, mean, rstd, maxy, gate, maps2, pdt, pdty, pcnt, hh, ww, c, pad);
    DUCOSY_CHECK_LAUNCH();
    gate_bwd<T><<<n, c, (2 * c + 2 * r) * sizeof(float), s>>>(
        pdt, pdty, pcnt, maxy, gate, w1, w2, vec, dw1, dw2, tiles, hw, c, r);
    DUCOSY_CHECK_LAUNCH();
  }
  if (parts & 2) {
    tail_bwd_apply<T><<<dim3(ww, hh, n), APPLY_THREADS, 0, s>>>(
        h, g, mean, rstd, maxy, gate, maps2, vec, dh, hh, ww, c, pad);
    DUCOSY_CHECK_LAUNCH();
  }
  return 0;
}

// ---- the resident route

// Shared memory of block_tail_bwd_resident at c == BN, in bytes from the
// (16-byte aligned) base: per-channel vectors (BN floats each: mean, 1/std,
// the io-rounded and the fp32 gate, the io-rounded max of y, the MLP's
// hidden units and their adjoint, the merged tile sums and da, the three
// coefficients of the IN adjoint), per-pixel values of the tile (TILE_M
// each: gs rounded, dm_avg / C, dm_max / mcnt), the 7x7 taps; then
// one work area that serves in turn as tile_partials' and the tile sums'
// reductions, merge_sample's staging and the map rows within 3 of the tile;
// dz of the same rows; the tile of h (then y, then dh) and of the
// folded cotangent gf, rows LD bytes apart; the tile's pixels.
template <int BN> struct K5Smem {
  static constexpr int LD = BN * 2 + 16;
  static constexpr int MEAN = 0, RSTD = BN, GATE = 2 * BN, GATE32 = 3 * BN;
  static constexpr int MAXY = 4 * BN, HID = 5 * BN, DHID = 6 * BN;
  static constexpr int SDT = 7 * BN, SDTY = 8 * BN, YCNT = 9 * BN;
  static constexpr int DA = 10 * BN, V0 = 11 * BN, V1 = 12 * BN, V2 = 13 * BN;
  static constexpr int PGS = 14 * BN, PCA = PGS + TILE_M, PCB = PCA + TILE_M;
  static constexpr int WSA = PCB + TILE_M;
  static constexpr int FLOATS = WSA + 128;
  // the map rows within 3: at most TILE_M + 8 W pixels of (mean, max)
  static constexpr int STAT_FLOATS = 2 * (TILE_M + 8 * RESIDENT_TAIL_W);
  static constexpr int WORK_FLOATS =
      24 * BN > STAT_FLOATS ? 24 * BN : STAT_FLOATS;
  static constexpr int WORK = FLOATS * 4;
  static constexpr int DZ = WORK + WORK_FLOATS * 4;
  static constexpr int HS = DZ + (TILE_M + 8 * RESIDENT_TAIL_W) * 4;
  static constexpr int GFS = HS + TILE_M * LD;
  static constexpr int PIX = GFS + TILE_M * LD;
  static constexpr int BYTES = PIX + PIX_BYTES;
};

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const uint32_t* u = &v.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(u + i));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  uint32_t* u = &v.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return v;
}

__device__ __forceinline__ float2 bf16x2_at(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The interior of the tile's cotangent: for each 16-byte chunk of a pixel,
// the chunk of g (n, hh+2 pad, ww+2 pad, c) at the pixel's own place, to
// gfs with cp.async (one group). fold_write_dx then adds what the reflect
// pad mirrored onto the pixels next to the border.
template <int BN, int LD>
__device__ __forceinline__ void copy_g_async(unsigned char* gfs,
                                             const bf16* __restrict__ g,
                                             const int2* pix, int ni,
                                             int rows, int hh, int ww,
                                             int pad) {
  constexpr int CPP = BN / 8;
  const int wp = ww + 2 * pad;
  const bf16* gs = g + (size_t)ni * (hh + 2 * pad) * wp * BN;
  for (int i = threadIdx.x; i < rows * CPP; i += CONV_THREADS) {
    const int2 q = pix[i / CPP];
    cp_async16(smem_u32(gfs + (i / CPP) * LD + (i % CPP) * 16),
               gs + ((size_t)(q.x + pad) * wp + q.y + pad) * BN +
                   (i % CPP) * 8, true);
  }
  cp_async_commit();
}

// The folded cotangent gf: with pad 1, the chunks of the pixels in rows and
// columns 1 and hh-2 / ww-2 add the 1 or 3 places of g the reflect pad
// mirrored onto them, in fp32, rounded to bf16 once (elsewhere gf is g's
// chunk as copied: one term, exact); then each chunk goes out as dx's
// interior (x_pad 1: with the zero border places the tile's edge pixels
// own). A thread fixes and writes the chunks it will own: no barrier
// between. The tiles of rows 1 and hh-2 load a mirrored row here, one chunk
// after another; the kernel has asked the L2 for it at the sample's start
// (their loads four at a time in registers made the kernel 10% slower: the
// registers ran out elsewhere).
template <int BN, int LD>
__device__ __forceinline__ void fold_write_dx(unsigned char* gfs,
                                              const bf16* __restrict__ g,
                                              bf16* __restrict__ dx,
                                              const int2* pix, int ni,
                                              int rows, int hh, int ww,
                                              int pad, int x_pad) {
  constexpr int CPP = BN / 8;
  const int wp = ww + 2 * pad, wx = ww + 2 * x_pad;
  const bf16* gs = g + (size_t)ni * (hh + 2 * pad) * wp * BN;
  bf16* ds = dx + (size_t)ni * (hh + 2 * x_pad) * wx * BN;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < rows * CPP; i += CONV_THREADS) {
    const int p = i / CPP, k = i % CPP;
    const int a = pix[p].x, b = pix[p].y;
    uint4* at = reinterpret_cast<uint4*>(gfs + p * LD + k * 16);
    uint4 o = *at;
    if (pad && (a == 1 || a == hh - 2 || b == 1 || b == ww - 2)) {
      float f[8];
      unpack8(o, f);
      const int ro[3] = {a + 1, a == 1 ? 0 : -1, a == hh - 2 ? hh + 1 : -1};
      const int co[3] = {b + 1, b == 1 ? 0 : -1, b == ww - 2 ? ww + 1 : -1};
      for (int x = 0; x < 3; ++x)
        for (int y = 0; y < 3; ++y)
          if (x + y > 0 && ro[x] >= 0 && co[y] >= 0) {
            float e[8];
            unpack8(__ldg(reinterpret_cast<const uint4*>(
                        gs + ((size_t)ro[x] * wp + co[y]) * BN + k * 8)),
                    e);
#pragma unroll
            for (int t = 0; t < 8; ++t) f[t] += e[t];
          }
      o = pack8(f);
      *at = o;
    }
    auto put = [&](int r, int q, uint4 val) {
      *reinterpret_cast<uint4*>(ds + ((size_t)r * wx + q) * BN + k * 8) = val;
    };
    put(a + x_pad, b + x_pad, o);
    // dx's zero border: each edge pixel owns the border places beside it
    if (x_pad && (a == 0 || a == hh - 1 || b == 0 || b == ww - 1)) {
      const int ro[3] = {a + 1, a == 0 ? 0 : -1, a == hh - 1 ? hh + 1 : -1};
      const int co[3] = {b + 1, b == 0 ? 0 : -1, b == ww - 1 ? ww + 1 : -1};
      for (int x = 0; x < 3; ++x)
        for (int y = 0; y < 3; ++y)
          if (x + y > 0 && ro[x] >= 0 && co[y] >= 0) put(ro[x], co[y], zero);
    }
  }
}

// The parts of the resident backward that its timing probe can leave out:
// the copies in and out (h, g, dx, dh); the grid barriers and merges; the
// statistics' partials, the gate and the per-pixel maps; the 7x7 adjoint;
// the tile sums and the gate adjoint; dh.
constexpr int K5_MEM = 1, K5_SYNC = 2, K5_STATS = 4, K5_ADJ = 8,
              K5_SUMS = 16, K5_DH = 32, K5_ALL = 63;

// K5, resident, bf16, c == BN. h (n, hh*ww, c), g (n, hh+2 pad, ww+2 pad,
// c) -> dh (n, hh*ww, c), dx (n, hh+2 x_pad, ww+2 x_pad, c), dw1 (n, c, r),
// dw2 (n, r, c), pdwsa (n, tiles, 2 x 49: the per-tile partials of dwsa,
// avg taps then max taps); w1 (c, r), w2 (r, c), wsa (2 x 49) fp32.
// Scratch: part (6, n, tiles, c): mean, M2, max of h and sum dt, sum dt*y,
// [y == max y] per tile; stats (7, n, c): mean, 1/std, max, and the merged
// sums and da; maps (2, n, hh*ww, 2): (sa_avg, sa_max) and (dgs, mcnt) per
// pixel, dgs then overwritten by dz; bar one zeroed barrier word per group.
// Cooperative launch, grid (1, tiles, groups), CONV_THREADS threads,
// K5Smem<BN>::BYTES. Per sample, a block:
//   A. sends its tiles of h and of g's interior to shared memory
//      (cp.async), asks the L2 for the rows the reflect pad mirrors onto
//      them, and waits for h's;
//   B. tile partials of h from the registers, the channel-split merge (two
//      grid barriers) and the channel gate, while g's tile lands; then the
//      fold of g at the pixels next to the border, and dx out;
//   C. y = IN(h) over the tile (a bf16 value: stored over h), t = y * gate
//      rounded; per pixel sa_avg, sa_max and dgs = sum gf * t into the
//      maps, the [t == sa_max] tie mask as bits in registers (a running
//      max that keeps the positions it ties with) and its count mcnt; a
//      grid barrier;
//   D. the 7x7 adjoint: z, gs and dz = dgs gs (1 - gs) at its own pixels
//      from the stat rows within 3, dz published; a grid barrier; dstat at
//      its pixels from the dz rows within 3, and dwsa's partial;
//   E. tile sums of dt, dt * y, [y == max y]; the merge (two grid
//      barriers), the gate adjoint in every block;
//   F. dh, staged over y's tile and written with 16-byte stores.
// Measured and dropped (at (8, 128, 128, 256), one call each): prefetching
// the next sample's tiles into the L2 (7% slower: the L2 then holds two
// samples' traffic); folding g before the merge, so that dx's stores drain
// during it (4% slower).
template <int BN, int PARTS = K5_ALL>
__global__ void __launch_bounds__(CONV_THREADS, 1)
block_tail_bwd_resident(const bf16* __restrict__ h, const bf16* __restrict__ g,
                        const float* __restrict__ w1,
                        const float* __restrict__ w2,
                        const float* __restrict__ wsa, bf16* __restrict__ dh,
                        bf16* __restrict__ dx, float* __restrict__ dw1,
                        float* __restrict__ dw2, float* __restrict__ pdwsa,
                        float* part, float* stats, float* maps,
                        unsigned long long* bar, int n, int hh, int ww, int r,
                        int pad, int x_pad, float eps) {
  using S = K5Smem<BN>;
  constexpr int LD = S::LD, c = BN, NT = 2 * SA_K * SA_K;
  // tie-mask words of a row: 2 bits (the channel pair) a j, 16 j a word
  constexpr int WORDS = BN / 8 > 16 ? BN / 128 : 1;
  constexpr int JW = BN / 8 > 16 ? 16 : BN / 8;     // j a word
  extern __shared__ __align__(16) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  float *smean = sf + S::MEAN, *srstd = sf + S::RSTD, *sgate = sf + S::GATE;
  float *sgate32 = sf + S::GATE32, *smaxy = sf + S::MAXY, *hid = sf + S::HID;
  float *dhid = sf + S::DHID, *ssdt = sf + S::SDT, *ssdty = sf + S::SDTY;
  float *sycnt = sf + S::YCNT, *sda = sf + S::DA;
  float *v0 = sf + S::V0, *v1 = sf + S::V1, *v2 = sf + S::V2;
  float *pgs = sf + S::PGS, *pca = sf + S::PCA, *pcb = sf + S::PCB;
  float *swsa = sf + S::WSA;
  float* work = reinterpret_cast<float*>(smem + S::WORK);
  float2* sstat = reinterpret_cast<float2*>(work);
  float* sdz = reinterpret_cast<float*>(smem + S::DZ);
  unsigned char* hs = smem + S::HS;
  unsigned char* gfs = smem + S::GFS;
  int2* pix = reinterpret_cast<int2*>(smem + S::PIX);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.y, tiles = gridDim.y;
  const int hw = hh * ww, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);
  const unsigned nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  unsigned long long target = 0;    // the barrier's, kept by thread 0
  unsigned long long* word = bar + blockIdx.z;
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;
  const size_t pq = (size_t)n * tiles * c;          // one partial array
  const size_t sq = (size_t)n * c;                  // one vector array
  float2* stat = reinterpret_cast<float2*>(maps);
  float2* aux = stat + (size_t)n * hw;
  // the map rows within 3 of the tile (a 7x7 window's reach)
  const int row_a = m0 / ww, row_b = (m0 + rows - 1) / ww;
  const int s3_0 = max((row_a - 3) * ww, 0);
  const int s3_1 = min((row_b + 4) * ww, hw);
  // the thread's places in the tiles: rows r0 and r0 + 8 of the
  // accumulator layout, channel pairs 8 j + cq
  unsigned char* y0 = hs + r0 * LD + cq * sizeof(bf16);
  const unsigned char* f0 = gfs + r0 * LD + cq * sizeof(bf16);
  fill_pixels(pix, m0, ww);
  if (tid < NT) swsa[tid] = wsa[tid];

  auto sync_grid = [&]() {
    if constexpr (PARTS & K5_SYNC) grid_barrier(word, nblocks, target);
    else __syncthreads();
  };

  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    const size_t pbase = ((size_t)ni * tiles + tile) * c;
    // ---- A. h's and g's tiles on their way into shared memory
    if constexpr (PARTS & K5_MEM) {
      copy_tile_async<BN, LD>(hs, h + ((size_t)ni * hw + m0) * BN, rows);
      copy_g_async<BN, LD>(gfs, g, pix, ni, rows, hh, ww, pad);
      if (pad)            // the rows mirrored onto this tile's, into the L2
        for (int rr = row_a; rr <= row_b; ++rr) {
          const int mr = rr == 1 ? 0 : rr == hh - 2 ? hh + 1 : -1;
          if (mr < 0) continue;
          const int c0 = max(m0 - rr * ww, 0);
          const int c1 = min(m0 + rows - rr * ww, ww);
          prefetch_l2(g + (((size_t)ni * (hh + 2) + mr) * (ww + 2) + 1 + c0) *
                              BN, (size_t)(c1 - c0) * BN * sizeof(bf16));
        }
      cp_async_wait<1>();                           // h's tile
    }
    __syncthreads();

    // ---- B. statistics of h: tile partials from the registers, the
    // channel-split merge, the channel gate in every block
    if constexpr (PARTS & K5_STATS) {
      float d[BN / 2];
      tile_to_regs<BN, LD>(hs, d);
      tile_partials<BN>(d, work, rows, part + pbase, part + pq + pbase,
                        part + 2 * pq + pbase);
    }
    if constexpr (PARTS & K5_SYNC) {
      merge_sample(part, part + pq, part + 2 * pq, stats, stats + sq,
                   stats + 2 * sq, word, nblocks, target, bid, ni, 0, BN,
                   tiles, hw, c, eps, work, smean, srstd, smaxy);
    } else {
      if (tid < BN) { smean[tid] = 0.f; srstd[tid] = 1.f; smaxy[tid] = 1.f; }
      __syncthreads();
    }
    if constexpr (PARTS & K5_STATS)
      sample_gate<BN>(w1, w2, r, smean, srstd, smaxy, hid, sgate, sgate32);
    // g's tile has landed meanwhile: its fold, and dx out
    if constexpr (PARTS & K5_MEM) {
      cp_async_wait<0>();
      __syncthreads();
      fold_write_dx<BN, LD>(gfs, g, dx, pix, ni, rows, hh, ww, pad, x_pad);
    }
    __syncthreads();

    // ---- C. y = IN(h) over the tile (stored over h); per pixel sa_avg,
    // sa_max and dgs = sum gf * t; the tie mask [t == sa_max] as bits: a
    // running max with the positions that tie with it, merged over the quad
    uint32_t tie[2][WORDS];
#pragma unroll
    for (int w8 = 0; w8 < WORDS; ++w8) tie[0][w8] = tie[1][w8] = 0u;
    if constexpr (PARTS & K5_STATS) {
      float sum[2] = {0.f, 0.f}, mx[2] = {-INFINITY, -INFINITY};
      float dg[2] = {0.f, 0.f};
#pragma unroll
      for (int wd = 0; wd < WORDS; ++wd) {
#pragma unroll 4
        for (int jj = 0; jj < JW; ++jj) {
          const int j = wd * JW + jj;
          const float2 mu = *reinterpret_cast<const float2*>(smean + 8 * j + cq);
          const float2 rs = *reinterpret_cast<const float2*>(srstd + 8 * j + cq);
          const float2 gc = *reinterpret_cast<const float2*>(sgate + 8 * j + cq);
          const float2 ha = bf16x2_at(y0 + j * 16);
          const float2 hb = bf16x2_at(y0 + 8 * LD + j * 16);
          const float2 fa = bf16x2_at(f0 + j * 16);
          const float2 fb = bf16x2_at(f0 + 8 * LD + j * 16);
          const float hv[4] = {ha.x, ha.y, hb.x, hb.y};
          const float gv[4] = {fa.x, fa.y, fb.x, fb.y};
          float yv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = e / 2;
            yv[e] = round_io<bf16>((hv[e] - (e & 1 ? mu.y : mu.x)) *
                                   (e & 1 ? rs.y : rs.x));
            const float t = round_io<bf16>(yv[e] * (e & 1 ? gc.y : gc.x));
            const uint32_t bit = 1u << (2 * jj + (e & 1));
            sum[k] += t;
            dg[k] += gv[e] * t;
            if (t > mx[k]) {
              mx[k] = t;
#pragma unroll
              for (int w8 = 0; w8 < WORDS; ++w8) tie[k][w8] = 0u;
              tie[k][wd] = bit;
            } else if (t == mx[k]) {
              tie[k][wd] |= bit;
            }
          }
          // y is exact in bf16: it replaces h in the tile
          *reinterpret_cast<__nv_bfloat162*>(y0 + j * 16) =
              __floats2bfloat162_rn(yv[0], yv[1]);
          *reinterpret_cast<__nv_bfloat162*>(y0 + 8 * LD + j * 16) =
              __floats2bfloat162_rn(yv[2], yv[3]);
        }
      }
      int cnt[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float m = mx[k];
#pragma unroll
        for (int off = 1; off < 4; off *= 2) {
          sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], off);
          dg[k] += __shfl_xor_sync(0xffffffffu, dg[k], off);
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        // a lane whose own max is below the pixel's holds no tie
        cnt[k] = 0;
#pragma unroll
        for (int w8 = 0; w8 < WORDS; ++w8) {
          if (mx[k] != m) tie[k][w8] = 0u;
          cnt[k] += __popc(tie[k][w8]);
        }
#pragma unroll
        for (int off = 1; off < 4; off *= 2)
          cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], off);
        mx[k] = m;
      }
      if (lane % 4 == 0) {
        const size_t q = (size_t)ni * hw + m0 + r0;
        if (ok0) {
          stat[q] = make_float2(sum[0] / c, mx[0]);
          aux[q] = make_float2(dg[0], (float)cnt[0]);
        }
        if (ok1) {
          stat[q + 8] = make_float2(sum[1] / c, mx[1]);
          aux[q + 8] = make_float2(dg[1], (float)cnt[1]);
        }
      }
    }
    sync_grid();

    // ---- D. the 7x7 adjoint: the stat rows within 3 staged; z, gs and dz
    // at the tile's own pixels (two threads a pixel: tap rows 0-3 | 4-6),
    // dz published over dgs; then the dz rows within 3, dstat at the tile's
    // pixels and the tile's partials of dwsa
    if constexpr (PARTS & K5_ADJ) {
      for (int e0 = 0; e0 < s3_1 - s3_0; e0 += 4 * CONV_THREADS) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * CONV_THREADS + tid;
          if (e < s3_1 - s3_0) v[u] = __ldcg(stat + (size_t)ni * hw + s3_0 + e);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * CONV_THREADS + tid;
          if (e < s3_1 - s3_0) sstat[e] = v[u];
        }
      }
      __syncthreads();
      {
        const int p = tid / 2, upper = tid % 2;
        float z = 0.f;
        if (p < rows) {
          const int py = pix[p].x, px = pix[p].y;
          const int d0 = upper ? 4 : 0, d1 = upper ? SA_K : 4;
          for (int di = d0; di < d1; ++di) {
            const int yy = py + di - SA_R;
            if (yy < 0 || yy >= hh) continue;
#pragma unroll
            for (int dj = 0; dj < SA_K; ++dj) {
              const int xx = px + dj - SA_R;
              if (xx < 0 || xx >= ww) continue;
              const float2 v = sstat[yy * ww + xx - s3_0];
              z += swsa[di * SA_K + dj] * v.x +
                   swsa[SA_K * SA_K + di * SA_K + dj] * v.y;
            }
          }
        }
        z += __shfl_xor_sync(0xffffffffu, z, 1);
        if (!upper && p < rows) {
          const float gsv = 1.f / (1.f + expf(-z));
          pgs[p] = round_io<bf16>(gsv);
          float* dgs = &aux[(size_t)ni * hw + m0 + p].x;
          *dgs = __ldcg(dgs) * gsv * (1.f - gsv);     // dz over dgs
        }
      }
      sync_grid();
      for (int e0 = 0; e0 < s3_1 - s3_0; e0 += 4 * CONV_THREADS) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * CONV_THREADS + tid;
          if (e < s3_1 - s3_0) v[u] = __ldcg(&aux[(size_t)ni * hw + s3_0 + e].x);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * CONV_THREADS + tid;
          if (e < s3_1 - s3_0) sdz[e] = v[u];
        }
      }
      __syncthreads();
      {
        const int p = tid / 2, ch = tid % 2;     // two threads a pixel
        if (p < rows) {
          const int py = pix[p].x, px = pix[p].y;
          float acc = 0.f;
#pragma unroll
          for (int di = 0; di < SA_K; ++di) {
            const int uy = py - di + SA_R;
            const bool in_row = uy >= 0 && uy < hh;
#pragma unroll
            for (int dj = 0; dj < SA_K; ++dj) {
              const int ux = px - dj + SA_R;
              if (in_row && ux >= 0 && ux < ww)
                acc += swsa[ch * SA_K * SA_K + di * SA_K + dj] *
                       sdz[uy * ww + ux - s3_0];
            }
          }
          if (ch == 0) pca[p] = acc / c;
          else pcb[p] = acc / __ldcg(&aux[(size_t)ni * hw + m0 + p].y);
        }
      }
      // dwsa's partial: a warp a tap at a time, lanes over the pixels, in
      // a fixed order
      for (int tap = warp; tap < NT; tap += CONV_THREADS / 32) {
        const int ch = tap / (SA_K * SA_K), di = tap % (SA_K * SA_K) / SA_K;
        const int dj = tap % SA_K;
        float acc = 0.f;
        for (int p = lane; p < rows; p += 32) {
          const int yy = pix[p].x + di - SA_R, xx = pix[p].y + dj - SA_R;
          if (yy < 0 || yy >= hh || xx < 0 || xx >= ww) continue;
          const float2 v = sstat[yy * ww + xx - s3_0];
          acc += sdz[m0 + p - s3_0] * (ch ? v.y : v.x);
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) pdwsa[((size_t)ni * tiles + tile) * NT + tap] = acc;
      }
      __syncthreads();
    } else {
      sync_grid();
    }

    // dt = gf gs + dm_avg / C + [t == sa_max] dm_max / mcnt at channel
    // pair j of the thread's rows, with y
    const float gs0 = pgs[r0], ca0 = pca[r0], cb0 = pcb[r0];
    const float gs1 = pgs[r0 + 8], ca1 = pca[r0 + 8], cb1 = pcb[r0 + 8];
    auto dt_of = [&](int wd, int jj, float (&y)[4], float (&dt)[4]) {
      const int j = wd * JW + jj;
      const float2 ya = bf16x2_at(y0 + j * 16), yb = bf16x2_at(y0 + 8 * LD + j * 16);
      const float2 fa = bf16x2_at(f0 + j * 16), fb = bf16x2_at(f0 + 8 * LD + j * 16);
      y[0] = ya.x; y[1] = ya.y; y[2] = yb.x; y[3] = yb.y;
      const float gv[4] = {fa.x, fa.y, fb.x, fb.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        dt[e] = gv[e] * (lo ? gs0 : gs1) + (lo ? ca0 : ca1);
        if (tie[e / 2][wd] >> (2 * jj + (e & 1)) & 1u) dt[e] += lo ? cb0 : cb1;
      }
    };

    // ---- E. tile sums of dt, dt * y and [y == max y] per channel, by the
    // reduce-scatter of tile_partials
    if constexpr (PARTS & K5_SUMS) {
#pragma unroll
      for (int q = 0; q < BN / 64; ++q) {
        float s[3][16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * q + jj;
          float y[4], dt[4];
          dt_of(j / JW, j % JW, y, dt);
          const float2 mxy = *reinterpret_cast<const float2*>(smaxy + 8 * j + cq);
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float m = e2 ? mxy.y : mxy.x;
            const int a = e2, b = e2 + 2;        // rows r0 and r0 + 8
            s[0][2 * jj + e2] = (ok0 ? dt[a] : 0.f) + (ok1 ? dt[b] : 0.f);
            s[1][2 * jj + e2] = (ok0 ? dt[a] * y[a] : 0.f) +
                                (ok1 ? dt[b] * y[b] : 0.f);
            s[2][2 * jj + e2] = (ok0 && y[a] == m ? 1.f : 0.f) +
                                (ok1 && y[b] == m ? 1.f : 0.f);
          }
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          warp_columns<false>(s[k], lane);
          *reinterpret_cast<float2*>(work + (k * 8 + warp) * BN + 64 * q +
                                     2 * lane) = make_float2(s[k][0], s[k][1]);
        }
      }
      __syncthreads();
      if (tid < BN) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float t = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < 8; ++w8) t += work[(k * 8 + w8) * BN + tid];
          part[(3 + k) * pq + pbase + tid] = t;
        }
      }
    }

    // the tile sums merged, a warp a channel over the block's share of the
    // channels; da published; every block then takes all of them
    if constexpr (PARTS & K5_SYNC) {
      grid_barrier(word, nblocks, target);
      const int mine =
          bid < c ? (c - bid + (int)nblocks - 1) / (int)nblocks : 0;
      for (int i = warp; i < mine; i += CONV_THREADS / 32) {
        const int ch = bid + i * (int)nblocks;
        float a = 0.f, b = 0.f, e = 0.f;
        for (int t = lane; t < tiles; t += 32) {
          const size_t k = ((size_t)ni * tiles + t) * c + ch;
          a += __ldcg(part + 3 * pq + k);
          b += __ldcg(part + 4 * pq + k);
          e += __ldcg(part + 5 * pq + k);
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          b += __shfl_xor_sync(0xffffffffu, b, off);
          e += __shfl_xor_sync(0xffffffffu, e, off);
        }
        if (lane == 0) {
          const size_t k = (size_t)ni * c + ch;
          const float g32 = sgate32[ch];
          stats[3 * sq + k] = a;
          stats[4 * sq + k] = b;
          stats[5 * sq + k] = e;
          stats[6 * sq + k] = b * g32 * (1.f - g32);   // dgc = sum dt * y
        }
      }
      grid_barrier(word, nblocks, target);
      if (tid < BN) {
        const size_t k = (size_t)ni * c + tid;
        ssdt[tid] = __ldcg(stats + 3 * sq + k);
        ssdty[tid] = __ldcg(stats + 4 * sq + k);
        sycnt[tid] = __ldcg(stats + 5 * sq + k);
        sda[tid] = __ldcg(stats + 6 * sq + k);
      }
    } else {
      if (tid < BN) {
        ssdt[tid] = ssdty[tid] = 0.f;
        sycnt[tid] = 1.f;
        sda[tid] = 0.f;
      }
    }
    __syncthreads();

    // the gate adjoint in every block (2 C R MACs): sigmoid and MLP (ReLU
    // mask from the forward's hidden units), the IN adjoint's means; block
    // 0 of the group writes the sample's dw1, dw2
    if constexpr (PARTS & K5_SUMS) {
      for (int j = warp; j < r; j += CONV_THREADS / 32) {
        float back = 0.f;
        for (int k = lane; k < c; k += 32) back += sda[k] * w2[j * c + k];
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          back += __shfl_xor_sync(0xffffffffu, back, off);
        if (lane == 0) dhid[j] = hid[j] > 0.f ? back : 0.f;
      }
      __syncthreads();
      if (tid < BN) {
        // dpool = w1's row of the channel times dhid: the row's r floats
        // 16 bytes at a time where r allows
        const float* wr = w1 + (size_t)tid * r;
        float dpool = 0.f;
        int j = 0;
        if (r % 4 == 0)
          for (; j < r; j += 4) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(wr + j));
            dpool += dhid[j] * q.x;
            dpool += dhid[j + 1] * q.y;
            dpool += dhid[j + 2] * q.z;
            dpool += dhid[j + 3] * q.w;
          }
        for (; j < r; ++j) dpool += dhid[j] * wr[j];
        const float gio = sgate[tid], mxk = smaxy[tid];
        v0[tid] = (gio * ssdt[tid] + dpool) / hw;
        v1[tid] = (gio * ssdty[tid] + dpool * mxk) / hw;
        v2[tid] = dpool / sycnt[tid];
      }
      // the sample's dw1 and dw2, shared out over the group's blocks by
      // channel (each block holds every channel's gate adjoint)
      for (int e = tid; e < r * (c / (int)nblocks + 1); e += CONV_THREADS) {
        const int jr = e % r, k = bid + (e / r) * (int)nblocks;
        if (k < c) {
          dw1[((size_t)ni * c + k) * r + jr] = smaxy[k] * dhid[jr];
          dw2[((size_t)ni * r + jr) * c + k] = hid[jr] * sda[k];
        }
      }
      __syncthreads();
    }

    // ---- F. dh = (dy - mean dy - y mean(dy y)) / std, dy = dt gate_c +
    // [y == max y] dpool_max / ycnt, staged over y's tile
    if constexpr (PARTS & K5_DH) {
#pragma unroll
      for (int wd = 0; wd < WORDS; ++wd) {
#pragma unroll 4
        for (int jj = 0; jj < JW; ++jj) {
          const int j = wd * JW + jj;
          float y[4], dt[4];
          dt_of(wd, jj, y, dt);
          const float2 rs = *reinterpret_cast<const float2*>(srstd + 8 * j + cq);
          const float2 gc = *reinterpret_cast<const float2*>(sgate + 8 * j + cq);
          const float2 mxy = *reinterpret_cast<const float2*>(smaxy + 8 * j + cq);
          const float2 a0 = *reinterpret_cast<const float2*>(v0 + 8 * j + cq);
          const float2 a1 = *reinterpret_cast<const float2*>(v1 + 8 * j + cq);
          const float2 a2 = *reinterpret_cast<const float2*>(v2 + 8 * j + cq);
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 1;
            float dy = dt[e] * (hi ? gc.y : gc.x);
            if (y[e] == (hi ? mxy.y : mxy.x)) dy += hi ? a2.y : a2.x;
            o[e] = (dy - (hi ? a0.y : a0.x) - y[e] * (hi ? a1.y : a1.x)) *
                   (hi ? rs.y : rs.x);
          }
          *reinterpret_cast<__nv_bfloat162*>(y0 + j * 16) =
              __floats2bfloat162_rn(o[0], o[1]);
          *reinterpret_cast<__nv_bfloat162*>(y0 + 8 * LD + j * 16) =
              __floats2bfloat162_rn(o[2], o[3]);
        }
      }
      __syncthreads();
    }
    if constexpr (PARTS & K5_MEM)
      write_padded_tile<bf16, BN>(hs, pix, dh, ni, rows, 0, hh, ww, c, 0,
                                  [](uint4 v, int, int) { return v; });
    __syncthreads();   // the tiles' space is free for the next sample
  }
}

template <int BN, int PARTS = K5_ALL>
static int launch_bwd_resident(const bf16* h, const bf16* g, const float* w1,
                               const float* w2, const float* wsa, bf16* dh,
                               bf16* dx, float* dw1, float* dw2, float* pdwsa,
                               float* part, float* stats, float* maps,
                               unsigned long long* bar, int n, int hh, int ww,
                               int r, int pad, int x_pad, float eps,
                               int groups, cudaStream_t s) {
  constexpr int smem = K5Smem<BN>::BYTES;
  auto kernel = block_tail_bwd_resident<BN, PARTS>;
  static DeviceFlags raised;
  DUCOSY_TRY(once_per_device(raised, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }));
  const int tiles = (hh * ww + TILE_M - 1) / TILE_M;
  void* args[] = {&h,    &g,     &w1,   &w2,  &wsa, &dh, &dx,  &dw1,
                  &dw2,  &pdwsa, &part, &stats, &maps, &bar, &n, &hh,
                  &ww,   &r,     &pad,  &x_pad, &eps};
  return launch_cooperative(kernel, dim3(1, tiles, groups), smem, args, s);
}

}  // namespace
}  // namespace ducosy

// Pass 1. h (n, hh, ww, c), g (n, hh+2pad, ww+2pad, c) in the io dtype;
// w1 (c, r), w2 (r, c) fp32. Writes mean/rstd/maxy/gate (n, c) and maps
// (n, 4, hh*ww): sa_avg, sa_max, sum_c g*t, mcnt. Scratch pmean/pm2/pmax
// (n, tiles, c). All fp32 but h and g. Returns the first launch error or 0.
extern "C" int ducosy_block_tail_bwd_stats(
    const void* h, const void* g, const float* w1, const float* w2,
    float* pmean, float* pm2, float* pmax, float* mean, float* rstd,
    float* maxy, float* gate, float* maps, int n, int hh, int ww, int c,
    int r, int pad, float eps, int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tail_bwd_stats<bf16>(static_cast<const bf16*>(h),
                                static_cast<const bf16*>(g), w1, w2, pmean,
                                pm2, pmax, mean, rstd, maxy, gate, maps, n, hh,
                                ww, c, r, pad, eps, s);
  return tail_bwd_stats<float>(static_cast<const float*>(h),
                               static_cast<const float*>(g), w1, w2, pmean,
                               pm2, pmax, mean, rstd, maxy, gate, maps, n, hh,
                               ww, c, r, pad, eps, s);
}

// Pass 2. maps2 (n, 5, hh*ww): gs, dm_avg, dm_max, sa_max, mcnt. Writes dh
// (n, hh, ww, c) in the io dtype and the per-sample partials dw1 (n, c, r)
// and dw2 (n, r, c). Scratch pdt/pdty/pcnt (n, tiles, c), vec (n, 3, c).
// `parts` (3 for the pass) sums what runs: 1 the tile sums and the gate
// adjoint, 2 the apply (either alone for timing only).
extern "C" int ducosy_block_tail_bwd_apply(
    const void* h, const void* g, const float* w1, const float* w2,
    const float* mean, const float* rstd, const float* maxy,
    const float* gate, const float* maps2, float* pdt, float* pdty,
    float* pcnt, float* vec, void* dh, float* dw1, float* dw2, int n, int hh,
    int ww, int c, int r, int pad, int is_bf16, int parts, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tail_bwd_apply_all<bf16>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(g), w1, w2, mean,
        rstd, maxy, gate, maps2, pdt, pdty, pcnt, vec, static_cast<bf16*>(dh),
        dw1, dw2, n, hh, ww, c, r, pad, parts, s);
  return tail_bwd_apply_all<float>(
      static_cast<const float*>(h), static_cast<const float*>(g), w1, w2,
      mean, rstd, maxy, gate, maps2, pdt, pdty, pcnt, vec,
      static_cast<float*>(dh), dw1, dw2, n, hh, ww, c, r, pad, parts, s);
}

// The resident route: bf16 h (n, hh, ww, c) and g (n, hh+2pad, ww+2pad, c),
// c 64, 128 or 256, ww <= 256. Writes dh (n, hh, ww, c), dx (n, hh+2x_pad,
// ww+2x_pad, c) bf16 (g folded in fp32, rounded once, zero border), dw1
// (n, c, r), dw2 (n, r, c) and pdwsa (n, tiles, 2 x 49) fp32. Scratch part
// (6, n, tiles, c), stats (7, n, c), maps (2, n, hh*ww, 2) fp32, and bar,
// `groups` zeroed barrier words (a word serves one tile count for ever);
// groups * tiles blocks must be resident at once. `parts` 63, or at c = 256
// one of the probe's sets of K5_* parts (1 the copies in and out, 2 the grid
// barriers and merges, 4 statistics, gate and maps, 8 the 7x7 adjoint, 16
// the tile sums and gate adjoint, 32 dh) to time the kernel with the others
// compiled out: 1, 3, 5, 9, 17, 33, 61. Returns the
// launch status (a refused cooperative launch is an error, never a
// fallback).
extern "C" int ducosy_block_tail_bwd_resident(
    const void* h, const void* g, const float* w1, const float* w2,
    const float* wsa, void* dh, void* dx, float* dw1, float* dw2,
    float* pdwsa, float* part, float* stats, float* maps,
    unsigned long long* bar, int n, int hh, int ww, int c, int r, int pad,
    int x_pad, float eps, int groups, int parts, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* dhb = static_cast<bf16*>(dh);
  bf16* dxb = static_cast<bf16*>(dx);
  if (ww > RESIDENT_TAIL_W || (parts != K5_ALL && c != 256))
    return (int)cudaErrorInvalidValue;
#define DUCOSY_K5R(BN, P)                                                    \
  launch_bwd_resident<BN, P>(hb, gb, w1, w2, wsa, dhb, dxb, dw1, dw2, pdwsa, \
                             part, stats, maps, bar, n, hh, ww, r, pad,      \
                             x_pad, eps, groups, s)
  switch (parts) {
    case K5_ALL:
      if (c == 256) return DUCOSY_K5R(256, K5_ALL);
      if (c == 128) return DUCOSY_K5R(128, K5_ALL);
      if (c == 64) return DUCOSY_K5R(64, K5_ALL);
      return (int)cudaErrorInvalidValue;
    // the probe's sets at c = 256: copies alone; with the barriers; with
    // each arithmetic part alone; all but the barriers
    case K5_MEM: return DUCOSY_K5R(256, K5_MEM);
    case K5_MEM | K5_SYNC: return DUCOSY_K5R(256, K5_MEM | K5_SYNC);
    case K5_MEM | K5_STATS: return DUCOSY_K5R(256, K5_MEM | K5_STATS);
    case K5_MEM | K5_ADJ: return DUCOSY_K5R(256, K5_MEM | K5_ADJ);
    case K5_MEM | K5_SUMS: return DUCOSY_K5R(256, K5_MEM | K5_SUMS);
    case K5_MEM | K5_DH: return DUCOSY_K5R(256, K5_MEM | K5_DH);
    case K5_ALL & ~K5_SYNC: return DUCOSY_K5R(256, K5_ALL & ~K5_SYNC);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DUCOSY_K5R
}

// How many blocks of the resident kernel the current device holds at once:
// its SM count times the least occupancy of the three widths; 0 where the
// device cannot launch cooperatively.
extern "C" int ducosy_block_tail_bwd_resident_blocks(int* blocks) {
  using namespace ducosy;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  int least = coop ? INT_MAX : 0;
  DUCOSY_TRY(least_occupancy(block_tail_bwd_resident<256>,
                             K5Smem<256>::BYTES, &least));
  DUCOSY_TRY(least_occupancy(block_tail_bwd_resident<128>,
                             K5Smem<128>::BYTES, &least));
  DUCOSY_TRY(least_occupancy(block_tail_bwd_resident<64>,
                             K5Smem<64>::BYTES, &least));
  *blocks = sms * least;
  return 0;
}
