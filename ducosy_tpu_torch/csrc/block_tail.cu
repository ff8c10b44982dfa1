// K4: the residual-block tail x + CBAM(IN(h)), optionally reflect-padded,
// for Hopper (sm_90a).
//
// Replaces: block_tail_pallas (ducosy_tpu/ops/pallas/cbam_block.py:108,
// pallas_call at :123), the forward of block_tail_fused on the training
// trunk (models/fused.py:695-698): h is conv2's output (N, 128, 128, 256)
// in the io dtype, x the block input as the previous block's reflect-padded
// output (x_pad = 1), and the output is padded by 1 for the next block (pad
// 0 after the last one).
//
// What bounds it: ~10 FLOP per element of h against 2-4 bytes read and
// written per element (h twice, x once, the output once, plus the halo):
// memory-bound.
//
// Design: the TPU kernel holds one sample's (H, W, C) block in VMEM; here
// the whole-image reductions split into tiles, exactly as K1's tail does,
// and the kernels are K1's (cbam_tail.cuh):
//   1. tile statistics of h: per 128-pixel x 64-channel tile, (mean, M2,
//      max) of the io-dtype values in fp32;
//   2. channel gate: Chan-merge -> mean, rstd; max pool of y = IN(max h)
//      exactly; MLP; sigmoid;
//   3. spatial tail: channel mean/max of t over a 16x32 tile plus a halo
//      of 3, the 7x7 conv, sigmoid, the skip from x's interior and the
//      reflect-padded write.
// Rounding: y = bf16((h - mean) * rstd) with fp32 mean and rstd. The TPU
// kernel rounds mean and rstd to the io dtype first and normalizes in it,
// (h - bf16(mean)) * bf16(rstd) (cbam_block.py:44-58); the port rounds
// once instead, as the plain version (_xla_block_tail's composition) and
// K1 do, so the kernel, its plain version and K5's recompute of y agree
// and the max-pool tie masks of the backward see the forward's y. Its
// statistics are centred (Chan) where the TPU kernel's are E[h^2]-E[h]^2.
// The avg-pool path of the channel gate is zero, as in K1.
#include "cbam_tail.cuh"

namespace ducosy {
namespace {

template <typename T>
int block_tail(const T* h, const T* x, const float* w1, const float* w2,
               const float* wsa, T* out, float* pmean, float* pm2,
               float* pmax, float* mean, float* rstd, float* gate, int n,
               int hh, int ww, int c, int r, int pad, int x_pad, float eps,
               cudaStream_t s) {
  const int hw = hh * ww, tiles = (hw + TILE_M - 1) / TILE_M;
  tile_stats_kernel<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
      h, pmean, pm2, pmax, hw, c);
  DUCOSY_CHECK_LAUNCH();
  return launch_tail<T, T>(h, x, w1, w2, wsa, out, pmean, pm2, pmax, mean,
                           rstd, gate, n, hh, ww, c, r, tiles, pad, x_pad, eps,
                           s);
}

}  // namespace
}  // namespace ducosy

// h (n, hh, ww, c), x (n, hh+2x_pad, ww+2x_pad, c) -> out
// (n, hh+2pad, ww+2pad, c), all the io dtype; w1 (c, r), w2 (r, c), wsa
// (2*49: avg taps then max taps) fp32. Scratch: pmean/pm2/pmax
// (n, tiles, c), mean/rstd/gate (n, c), fp32. Returns cudaGetLastError()
// of the first failing launch, or 0. Launches on `stream`, no sync.
extern "C" int ducosy_block_tail(const void* h, const void* x, const float* w1,
                                 const float* w2, const float* wsa, void* out,
                                 float* pmean, float* pm2, float* pmax,
                                 float* mean, float* rstd, float* gate, int n,
                                 int hh, int ww, int c, int r, int pad,
                                 int x_pad, float eps, int is_bf16,
                                 void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return block_tail<bf16>(static_cast<const bf16*>(h),
                            static_cast<const bf16*>(x), w1, w2, wsa,
                            static_cast<bf16*>(out), pmean, pm2, pmax, mean,
                            rstd, gate, n, hh, ww, c, r, pad, x_pad, eps, s);
  return block_tail<float>(static_cast<const float*>(h),
                           static_cast<const float*>(x), w1, w2, wsa,
                           static_cast<float*>(out), pmean, pm2, pmax, mean,
                           rstd, gate, n, hh, ww, c, r, pad, x_pad, eps, s);
}
