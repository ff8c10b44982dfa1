// K2: InstanceNorm (+ReLU) (+reflect pad) over H, W of an NHWC tensor, for
// Hopper (sm_90a), with K2p's options: statistics pooled over phase groups,
// and a shifted-grid int8 write.
//
// Replaces: instance_norm_pallas (ducosy_tpu/ops/pallas/instance_norm.py:
// 206, pallas_call at :245), forward with `relu`, `pad`, `phases` and
// `int8_scale`. On the serving path: down1 (N, 256, 256, 128) with ReLU,
// and down2 (N, 128, 128, 256) with ReLU and the trunk's first reflect pad
// folded into the write. Under quantized serving with the tail trunk, each
// block's first norm writes int8 (N, 130, 130, 256) for the int8 conv2.
// `phases` is on no serving path (fused.py:69 turns phase fusion off) and
// is held against its plain version all the same.
//
// What bounds it: a per-channel reduction followed by an elementwise
// normalize: ~3 bytes moved per FLOP, memory-bound (the input is read
// twice and the padded output written once; the int8 write is a quarter
// of an fp32 one).
//
// Design: the TPU kernel holds one sample's (H, W, 128-channel) block in
// VMEM and reduces it in one go. Here the reduction is split: each block
// of the stats launch reduces a tile of 128 pixels x 64 channels to
// per-channel (mean, M2), finalize_stats merges the tiles with Chan's
// formula (centred variance, like the plain version; the TPU kernel uses
// one-pass E[x^2] - E[x]^2), and norm_apply writes the normalized,
// optionally ReLU'd output, reading each pad pixel's reflected source.
// These last two are the same kernels K1 uses for its first norm
// (common.cuh). With phases > 1 (packed channel = phase * C + c) the
// finalize step does one more Chan merge, over the phase groups of each
// true channel, and writes the pooled statistics to every phase. With an
// int8 write, the apply step rounds the normalized value to the io dtype
// and quantizes it in fp32 (instance_norm.py:172, 196-199); the reflect pad
// copies codes. Three launches; a later PR can fuse finalize into apply.
#include "common.cuh"

namespace ducosy {
namespace {

// finalize_stats over phase groups: thread idx owns true channel idx % cg
// of sample idx / cg, cg = c / phases, and merges the per-tile partials of
// its `phases` packed channels (count hw each).
__global__ void finalize_phase_stats(const float* __restrict__ pmean,
                                     const float* __restrict__ pm2,
                                     float* __restrict__ mean,
                                     float* __restrict__ rstd, int n,
                                     int tiles, int c, int hw, int phases,
                                     float eps) {
  const int cg = c / phases;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * cg) return;
  const int ni = idx / cg, ci = idx % cg;
  float cnt = 0.f, m = 0.f, q = 0.f;
  for (int p = 0; p < phases; ++p) {
    float mp, qp, unused;
    merge_tiles(pmean, pm2, nullptr, ni, p * cg + ci, tiles, hw, c, &mp, &qp,
                &unused);
    const float tot = cnt + hw, d = mp - m;
    m += d * (hw / tot);
    q += qp + d * d * (cnt * hw / tot);
    cnt = tot;
  }
  const float rs = inv_std(q, hw * phases, eps);
  for (int p = 0; p < phases; ++p) {
    mean[(size_t)ni * c + p * cg + ci] = m;
    rstd[(size_t)ni * c + p * cg + ci] = rs;
  }
}

template <typename T>
int instance_norm(const T* x, void* out, float* pmean, float* pm2,
                  float* mean, float* rstd, int n, int h, int w, int c,
                  int relu, int pad, int phases, float int8_k, float eps,
                  cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  tile_stats_kernel<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
      x, pmean, pm2, nullptr, hw, c);
  DUCOSY_CHECK_LAUNCH();
  if (phases > 1)
    finalize_phase_stats<<<(n * (c / phases) + 255) / 256, 256, 0, s>>>(
        pmean, pm2, mean, rstd, n, tiles, c, hw, phases, eps);
  else
    finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                        n, tiles, c, hw, eps);
  DUCOSY_CHECK_LAUNCH();
  const dim3 grid(w + 2 * pad, h + 2 * pad, n);
  if (int8_k > 0.f)
    norm_apply_int8<T, T><<<grid, APPLY_THREADS, 0, s>>>(
        x, mean, rstd, static_cast<int8_t*>(out), h, w, c, pad, int8_k);
  else
    norm_apply<T, T><<<grid, APPLY_THREADS, 0, s>>>(
        x, mean, rstd, static_cast<T*>(out), h, w, c, pad, relu);
  DUCOSY_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace ducosy

// x (n, h, w, c) -> out (n, h+2*pad, w+2*pad, c): the io dtype, or int8 on
// the shifted grid when int8_k = 255 / S > 0 (then relu must be set).
// phases > 1 pools the statistics over the phase groups of c. Scratch:
// pmean/pm2 (n, tiles, c), mean/rstd (n, c), fp32. Returns
// cudaGetLastError() of the first failing launch, or 0. Launches on
// `stream` and does not synchronize.
extern "C" int ducosy_instance_norm(const void* x, void* out, float* pmean,
                                    float* pm2, float* mean, float* rstd,
                                    int n, int h, int w, int c, int relu,
                                    int pad, int phases, float int8_k,
                                    float eps, int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return instance_norm<bf16>(static_cast<const bf16*>(x), out, pmean, pm2,
                               mean, rstd, n, h, w, c, relu, pad, phases,
                               int8_k, eps, s);
  return instance_norm<float>(static_cast<const float*>(x), out, pmean, pm2,
                              mean, rstd, n, h, w, c, relu, pad, phases,
                              int8_k, eps, s);
}
