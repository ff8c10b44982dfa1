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
// What bounds it: two whole-image reductions in sequence (the statistics
// of x, then mean(g) and mean(g*y)), each a few FLOP per element: memory-
// bound. x is read three times and g twice; dx is written once.
//
// Design: the TPU kernel holds one sample's (H, W, 128-channel) window in
// VMEM and reduces it twice in place. Here each reduction splits into
// per-tile partials and a merge, as K2's statistics do (common.cuh):
//   1. tile statistics of x (mean, M2 per 128-pixel x 64-channel tile);
//   2. finalize: Chan-merge -> mean, rstd per (sample, channel);
//   3. gradient sums: per tile, sum(g) and sum(g*y) of the masked, folded
//      cotangent; 4 pixel groups x 64 channels per block;
//   4. merge the tile sums -> mean(g), mean(g*y);
//   5. apply: one block per pixel, threads over channels.
// The reflect-pad adjoint is a gather (fold_reflect): each dx pixel reads
// its own cotangent and those of its mirror images, so no pass writes a
// folded copy of g and no atomics are needed. Statistics are centred
// (Chan) where the TPU kernel's are E[x^2]-E[x]^2.
#include "common.cuh"

namespace ducosy {
namespace {

// sum(g) and sum(g*y) of the folded, ReLU-masked cotangent over one tile.
// Grid (c / TILE_N, tiles, n), STATS_THREADS threads.
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

template <typename T>
int instance_norm_bwd(const T* x, const T* g, T* dx, float* pmean, float* pm2,
                      float* psg, float* psgy, float* mean, float* rstd,
                      float* mg, float* mgy, int n, int h, int w, int c,
                      int relu, int pad, float eps, cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  const dim3 tgrid(c / TILE_N, tiles, n);
  tile_stats_kernel<T><<<tgrid, STATS_THREADS, 0, s>>>(x, pmean, pm2, nullptr,
                                                       hw, c);
  DUCOSY_CHECK_LAUNCH();
  finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                      n, tiles, c, hw, eps);
  DUCOSY_CHECK_LAUNCH();
  grad_sums<T><<<tgrid, STATS_THREADS, 0, s>>>(x, g, mean, rstd, psg, psgy, h,
                                               w, c, pad, relu);
  DUCOSY_CHECK_LAUNCH();
  grad_means<<<(n * c + 255) / 256, 256, 0, s>>>(psg, psgy, mg, mgy, n, tiles,
                                                  c, hw);
  DUCOSY_CHECK_LAUNCH();
  grad_apply<T><<<dim3(w, h, n), APPLY_THREADS, 0, s>>>(
      x, g, mean, rstd, mg, mgy, dx, h, w, c, pad, relu);
  DUCOSY_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace ducosy

// x (n, h, w, c) and g (n, h+2*pad, w+2*pad, c) -> dx (n, h, w, c), all the
// io dtype. Scratch, fp32: pmean/pm2/psg/psgy (n, tiles, c), mean/rstd/mg/
// mgy (n, c). Returns cudaGetLastError() of the first failing launch, or
// 0. Launches on `stream` and does not synchronize.
extern "C" int ducosy_instance_norm_bwd(const void* x, const void* g, void* dx,
                                        float* pmean, float* pm2, float* psg,
                                        float* psgy, float* mean, float* rstd,
                                        float* mg, float* mgy, int n, int h,
                                        int w, int c, int relu, int pad,
                                        float eps, int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return instance_norm_bwd<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<bf16*>(dx), pmean, pm2, psg, psgy, mean, rstd, mg, mgy, n,
        h, w, c, relu, pad, eps, s);
  return instance_norm_bwd<float>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(dx), pmean, pm2, psg, psgy, mean, rstd, mg, mgy, n,
      h, w, c, relu, pad, eps, s);
}
