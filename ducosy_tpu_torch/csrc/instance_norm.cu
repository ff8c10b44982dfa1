// K2: InstanceNorm (+ReLU) (+reflect pad) over H, W of an NHWC tensor, for
// Hopper (sm_90a).
//
// Replaces: instance_norm_pallas (ducosy_tpu/ops/pallas/instance_norm.py:
// 206, pallas_call at :245), forward with `relu` and `pad`; `phases` and
// `int8_scale` are not ported. On the serving path: down1
// (N, 256, 256, 128) with ReLU, and down2 (N, 128, 128, 256) with ReLU and
// the trunk's first reflect pad folded into the write.
//
// What bounds it: a per-channel reduction followed by an elementwise
// normalize: ~3 bytes moved per FLOP, memory-bound (the input is read
// twice and the padded output written once).
//
// Design: the TPU kernel holds one sample's (H, W, 128-channel) block in
// VMEM and reduces it in one go. Here the reduction is split: each block
// of the stats launch reduces a tile of 128 pixels x 64 channels to
// per-channel (mean, M2), finalize_stats merges the tiles with Chan's
// formula (centred variance, like the plain version; the TPU kernel uses
// one-pass E[x^2] - E[x]^2), and norm_apply writes the normalized,
// optionally ReLU'd output, reading each pad pixel's reflected source.
// These last two are the same kernels K1 uses for its first norm
// (common.cuh). Three launches; a later PR can fuse finalize into apply.
#include "common.cuh"

namespace ducosy {
namespace {

template <typename T>
int instance_norm(const T* x, T* out, float* pmean, float* pm2, float* mean,
                  float* rstd, int n, int h, int w, int c, int relu, int pad,
                  float eps, cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  tile_stats_kernel<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
      x, pmean, pm2, nullptr, hw, c);
  DUCOSY_CHECK_LAUNCH();
  finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                      n, tiles, c, hw, eps);
  DUCOSY_CHECK_LAUNCH();
  norm_apply<T, T><<<dim3(w + 2 * pad, h + 2 * pad, n), APPLY_THREADS, 0, s>>>(
      x, mean, rstd, out, h, w, c, pad, relu);
  DUCOSY_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace ducosy

// x (n, h, w, c) -> out (n, h+2*pad, w+2*pad, c), both the io dtype.
// Scratch: pmean/pm2 (n, tiles, c), mean/rstd (n, c), fp32. Returns
// cudaGetLastError() of the first failing launch, or 0. Launches on
// `stream` and does not synchronize.
extern "C" int ducosy_instance_norm(const void* x, void* out, float* pmean,
                                    float* pm2, float* mean, float* rstd,
                                    int n, int h, int w, int c, int relu,
                                    int pad, float eps, int is_bf16,
                                    void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return instance_norm<bf16>(static_cast<const bf16*>(x),
                               static_cast<bf16*>(out), pmean, pm2, mean,
                               rstd, n, h, w, c, relu, pad, eps, s);
  return instance_norm<float>(static_cast<const float*>(x),
                              static_cast<float*>(out), pmean, pm2, mean, rstd,
                              n, h, w, c, relu, pad, eps, s);
}
