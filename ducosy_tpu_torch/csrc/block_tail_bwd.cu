// K5: the backward of K4 (x + CBAM(IN(h)), reflect-padded), for Hopper
// (sm_90a), in two passes with the 7x7 spatial-gate adjoint between them.
//
// Replaces: block_tail_bwd_pallas (ducosy_tpu/ops/pallas/cbam_block.py:272,
// pallas_calls at :288 (stats pass) and :329 (apply pass)), the analytic
// VJP of block_tail_fused (_analytic_tail_bwd, :372-469). It recomputes
// the forward from h, as the TPU wrapper does, and returns dh and the
// per-sample partials of dw1, dw2; the wrapper (ops/kernels/block_tail.py)
// runs the 7x7 adjoint on the (N, H, W) maps and folds g for dx in plain
// PyTorch, as the JAX package runs them in XLA (:314-327, :363-368).
//
// What bounds it: a handful of FLOP per element of h (N, 128, 128, 256) and
// of the cotangent g (N, 130, 130, 256), both in the io dtype, which each
// pass re-reads: memory-bound. h is read 4 times, g 3 times, dh written once.
//
// Design. Every whole-image reduction splits into per-tile partials and a
// merge (common.cuh); the max-pool adjoints split the gradient equally
// among tied maxima (:434-437, :450-454):
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
// the io dtype (and folds g in it) before its reductions. The avg-pool path
// of the channel gate is zero, as in the forward, so its adjoint (the
// dpool_avg/count term of dy, which the IN adjoint cancels, and the avg
// terms of dw1, dw2) is zero too.
#include "cbam_tail.cuh"

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
                       cudaStream_t s) {
  const int hw = hh * ww, tiles = (hw + TILE_M - 1) / TILE_M;
  dt_sums<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
      h, g, mean, rstd, maxy, gate, maps2, pdt, pdty, pcnt, hh, ww, c, pad);
  DUCOSY_CHECK_LAUNCH();
  gate_bwd<T><<<n, c, (2 * c + 2 * r) * sizeof(float), s>>>(
      pdt, pdty, pcnt, maxy, gate, w1, w2, vec, dw1, dw2, tiles, hw, c, r);
  DUCOSY_CHECK_LAUNCH();
  tail_bwd_apply<T><<<dim3(ww, hh, n), APPLY_THREADS, 0, s>>>(
      h, g, mean, rstd, maxy, gate, maps2, vec, dh, hh, ww, c, pad);
  DUCOSY_CHECK_LAUNCH();
  return 0;
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
extern "C" int ducosy_block_tail_bwd_apply(
    const void* h, const void* g, const float* w1, const float* w2,
    const float* mean, const float* rstd, const float* maxy,
    const float* gate, const float* maps2, float* pdt, float* pdty,
    float* pcnt, float* vec, void* dh, float* dw1, float* dw2, int n, int hh,
    int ww, int c, int r, int pad, int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tail_bwd_apply_all<bf16>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(g), w1, w2, mean,
        rstd, maxy, gate, maps2, pdt, pdty, pcnt, vec, static_cast<bf16*>(dh),
        dw1, dw2, n, hh, ww, c, r, pad, s);
  return tail_bwd_apply_all<float>(
      static_cast<const float*>(h), static_cast<const float*>(g), w1, w2,
      mean, rstd, maxy, gate, maps2, pdt, pdty, pcnt, vec,
      static_cast<float*>(dh), dw1, dw2, n, hh, ww, c, r, pad, s);
}
