// K1: one CBAM residual block on a reflect-padded NHWC carry, for Hopper
// (sm_90a). The Python wrapper (ops/kernels/residual_chain.py) runs k of
// these back to back; k = 3 is the serving path's chain3, k = 1 is K6.
//
// Replaces: residual_chain_pallas (ducosy_tpu/ops/pallas/conv_in.py:399,
// pallas_call at :433) with quant=False and quant=True (K1q), and
// residual_block_pallas (conv_in.py:308). Each block computes
//   t   = ReflectPad1(ReLU(IN(conv3x3_valid(xp, wa))))
//   y   = IN(conv3x3_valid(t, wb))
//   y  *= sigmoid(MLP(avgpool(y)) + MLP(maxpool(y)))          channel gate
//   y  *= sigmoid(conv7x7_zero([mean_c(y), max_c(y)]))         spatial gate
//   out = ReflectPad_pad(xp[1:-1, 1:-1] + y)
// with fp32 accumulators and statistics, and the io dtype (bf16 or fp32)
// at the same rounding points as the reference (conv_in.py:162-219).
// K1q (quant=True, conv_in.py:380-386) writes t as shifted-grid int8,
// trunc(min(y * 255/S + 0.5, 255)) - 128 of the fp32 normalized value y,
// and runs conv2 int8 x int8 -> exact int32 with per-output-channel int8
// weights quantized once by the caller. The int32 accumulator goes to fp32
// and straight into the tail's IN, which absorbs the weight scale and the
// grid's 128 * sum(wq) offset, as the TPU kernel does (conv_in.py:171-176).
// conv1, the carry and the output keep the io dtype.
//
// What bounds it: each 3x3 conv at the trunk shape (128x128 pixels,
// 256 -> 256 channels) is 2*128*128*256*256*9 = 19.3 GFLOP per sample,
// against ~17 MB of bf16 activations: compute-bound, so the convs run on
// the tensor cores through wgmma (bf16 m64n256k16 with fp32 accumulate;
// K1q's conv2 s8 x s8 -> s32 m64n256k32, twice the bf16 rate on paper, on
// half the bytes of t). The fp32 parity mode uses exact FMA on the CUDA
// cores. Below the tensor cores the conv is bound by what an SM can pull
// from L2, which is why its tile is 128 pixels x 256 channels (see
// conv3x3.cuh). The other launches of a block move ~1.5 GB at N = 16 and are
// bound by bytes.
//
// Design: the TPU kernel keeps one sample's whole 130x130x256 carry in
// VMEM (8.6 MB); a Hopper block has at most 227 KB of shared memory. So a
// block is a short sequence of launches, and every whole-image reduction
// is split into per-tile partials plus a later apply step:
//   1. conv1: implicit-GEMM tile of 128 pixels x up to 256 output channels,
//      wgmma fed from a four-stage cp.async ring of 128-byte swizzled
//      shared memory (conv3x3.cuh); the epilogue writes the fp32
//      accumulator and per-tile (mean, M2) from the registers;
//   2. finalize: Chan-merge the tiles -> per-(n, c) mean, 1/std;
//   3. apply: IN + ReLU + reflect-pad 1 -> t (io dtype; int8 for K1q);
//   4. conv2 on t, epilogue also emits the per-tile channel max (K1q:
//      the int32 accumulator converted to fp32 first);
//   5. channel gate, one block per sample: finalize, max of the
//      normalized output = (max acc - mean) * rstd exactly (rstd > 0,
//      rounding is monotone), the C -> C/16 -> C MLP, sigmoid;
//   6. spatial tail: a block owns a 16x32 pixel tile with all channels,
//      takes the channel mean/max of the gated output over the tile plus
//      a halo of 3, runs the 7x7 zero-padded conv (98 taps ordered
//      avg | max, as at conv_in.py:428-430), sigmoid, adds the skip from
//      the carry's interior and writes the reflect-padded output.
//   Steps 5 and 6 live in cbam_tail.cuh, shared with K4 and K5.
// What this design still gives up: the conv accumulator and t round-trip
// device memory between launches (the TPU kernel never leaves VMEM), and the
// tail re-reads the halo. Tried before this loop and dropped: WMMA / mma.sync
// tiles of 128 x 64 on one synchronously filled buffer (a ninth of the
// card's bf16 rate). Later work: fusing apply into conv2's operand loads.
#include "cbam_tail.cuh"
#include "conv3x3.cuh"

namespace ducosy {
namespace {

template <typename T>
int residual_block(const T* xp, const T* wa, const void* wb, const float* w1,
                   const float* w2, const float* wsa, T* out, float* acc,
                   void* tp, float* pmean, float* pm2, float* pmax,
                   float* mean, float* rstd, float* gate, int n, int h, int w,
                   int c, int r, int pad, float eps, float int8_k,
                   cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  DUCOSY_TRY(launch_conv<T>(xp, wa, acc, pmean, pm2, nullptr, n, h, w, c,
                            tiles, s));
  finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                      n, tiles, c, hw, eps);
  DUCOSY_CHECK_LAUNCH();
  const dim3 agrid(w + 2, h + 2, n);
  if (int8_k > 0.f) {
    norm_apply_int8<float, float><<<agrid, APPLY_THREADS, 0, s>>>(
        acc, mean, rstd, static_cast<int8_t*>(tp), h, w, c, 1, int8_k);
    DUCOSY_CHECK_LAUNCH();
    DUCOSY_TRY(launch_conv_int8(static_cast<const int8_t*>(tp),
                                static_cast<const int8_t*>(wb), acc, pmean,
                                pm2, pmax, n, h, w, c, tiles, s));
  } else {
    norm_apply<float, T><<<agrid, APPLY_THREADS, 0, s>>>(
        acc, mean, rstd, static_cast<T*>(tp), h, w, c, 1, 1);
    DUCOSY_CHECK_LAUNCH();
    DUCOSY_TRY(launch_conv<T>(static_cast<const T*>(tp),
                              static_cast<const T*>(wb), acc, pmean, pm2, pmax,
                              n, h, w, c, tiles, s));
  }
  return launch_tail<T, float>(acc, xp, w1, w2, wsa, out, pmean, pm2, pmax,
                               mean, rstd, gate, n, h, w, c, r, tiles, pad, 1,
                               eps, s);
}

}  // namespace
}  // namespace ducosy

// One residual block: xp (n, h+2, w+2, c) -> out (n, h+2*pad, w+2*pad, c).
// wa and wb (9, c, c) in the io dtype: (tap, cout, cin) for bf16, (tap, cin,
// cout) for fp32; when int8_k = 255 / S > 0 (K1q) wb is int8 as (tap, cout,
// cin). w1 (c, r), w2 (r, c), wsa (2*49) fp32. Scratch: acc (n, h*w, c) fp32, tp like xp
// (int8 for K1q), pmean/pm2/pmax (n, tiles, c), mean/rstd/gate (n, c).
// Returns cudaGetLastError() of the first failing launch, or 0. Launches
// on `stream` and does not synchronize.
extern "C" int ducosy_residual_block(
    const void* xp, const void* wa, const void* wb, const float* w1,
    const float* w2, const float* wsa, void* out, float* acc, void* tp,
    float* pmean, float* pm2, float* pmax, float* mean, float* rstd,
    float* gate, int n, int h, int w, int c, int r, int pad, float eps,
    float int8_k, int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return residual_block<bf16>(
        static_cast<const bf16*>(xp), static_cast<const bf16*>(wa), wb, w1,
        w2, wsa, static_cast<bf16*>(out), acc, tp, pmean, pm2, pmax, mean,
        rstd, gate, n, h, w, c, r, pad, eps, int8_k, s);
  return residual_block<float>(
      static_cast<const float*>(xp), static_cast<const float*>(wa), wb, w1,
      w2, wsa, static_cast<float*>(out), acc, tp, pmean, pm2, pmax, mean,
      rstd, gate, n, h, w, c, r, pad, eps, int8_k, s);
}
