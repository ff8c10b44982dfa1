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
// conv3x3.cuh). On the tiled route the other launches of a block move
// ~1.5 GB at N = 16 and are bound by bytes; on the resident route they are
// the conv kernels' epilogues and move only t, the carry and the output.
//
// Design: a block is K7 (conv1 + IN + ReLU + pad -> t) followed by K8 (conv2
// + CBAM tail + skip + pad), the launches of conv_in.cu, each by one of two
// routes that the wrapper picks from the shape, the dtype and the device's
// co-resident block count (ops/kernels/conv_in.py:conv_route):
//   resident (conv_resident.cuh; bf16 io, a sample's tiles all on the card at
//   once, and for K8 C = 64, 128 or 256): two cooperative launches a block.
//   The TPU kernel keeps one sample's whole 130x130x256 carry in VMEM
//   (8.6 MB); here one sample's fp32 accumulator (16.8 MB at the trunk
//   shape) stays in the registers of the 128 blocks that computed it, across
//   a grid barrier, and the statistics' merge, the gates and the padded
//   write are the conv kernel's epilogue. Only t and the carry cross device
//   memory, in bf16 (t in int8 for K1q).
//   tiled (fp32 and whatever does not fit): six launches a block, every
//   whole-image reduction split into per-tile partials plus a later apply
//   step:
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
// What this design still gives up: t and the carry between blocks cross
// device memory (the TPU kernel never leaves VMEM); a chain that walks
// sample-major in one launch would keep them in L2. Tried before the wgmma
// loop and dropped: WMMA / mma.sync tiles of 128 x 64 on one synchronously
// filled buffer (a ninth of the card's bf16 rate).
#include "cbam_tail.cuh"
#include "conv3x3.cuh"
#include "conv_resident.cuh"

namespace ducosy {
namespace {

// groups_in / groups_tail > 0: that half runs on the resident route.
template <typename T>
int residual_block(const T* xp, const T* wa, const void* wb, const float* w1,
                   const float* w2, const float* wsa, T* out, float* acc,
                   void* tp, float* pmean, float* pm2, float* pmax,
                   float* mean, float* rstd, float* gate, float* map,
                   unsigned long long* bar, int n, int h, int w, int c, int r,
                   int pad, float eps, float int8_k, int groups_in,
                   int groups_tail, cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  const bool quant = int8_k > 0.f;
  if constexpr (sizeof(T) == 4) {
    if (groups_in > 0 || groups_tail > 0) return (int)cudaErrorInvalidValue;
  }
  // ---- K7: t = ReflectPad1(ReLU(IN(conv1))) into tp
  if (groups_in > 0) {
    if constexpr (sizeof(T) == 2) {
      if (quant)
        DUCOSY_TRY((conv3x3_in_resident_any<T, int8_t>(
            xp, wa, static_cast<int8_t*>(tp), pmean, pm2, mean, rstd, bar, n,
            h, w, c, 1, 1, eps, int8_k, groups_in, s)));
      else
        DUCOSY_TRY((conv3x3_in_resident_any<T, T>(
            xp, wa, static_cast<T*>(tp), pmean, pm2, mean, rstd, bar, n, h, w,
            c, 1, 1, eps, 0.f, groups_in, s)));
    }
  } else {
    DUCOSY_TRY(launch_conv<T>(xp, wa, acc, pmean, pm2, nullptr, n, h, w, c,
                              tiles, s));
    finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                        n, tiles, c, hw, eps);
    DUCOSY_CHECK_LAUNCH();
    const dim3 agrid(w + 2, h + 2, n);
    if (quant)
      norm_apply_int8<float, float><<<agrid, APPLY_THREADS, 0, s>>>(
          acc, mean, rstd, static_cast<int8_t*>(tp), h, w, c, 1, int8_k);
    else
      norm_apply<float, T><<<agrid, APPLY_THREADS, 0, s>>>(
          acc, mean, rstd, static_cast<T*>(tp), h, w, c, 1, 1);
    DUCOSY_CHECK_LAUNCH();
  }
  // ---- K8: out = ReflectPad_pad(xp interior + CBAM(IN(conv2(t))))
  if (groups_tail > 0) {
    if constexpr (sizeof(T) == 2) {
      if (quant)
        return conv_tail_resident_any<int8_t>(
            static_cast<const int8_t*>(tp), static_cast<const int8_t*>(wb), xp,
            w1, w2, wsa, out, pmean, pm2, pmax, mean, rstd, gate, map, bar, n,
            h, w, c, r, pad, 1, eps, groups_tail, s);
      return conv_tail_resident_any<T>(
          static_cast<const T*>(tp), static_cast<const T*>(wb), xp, w1, w2,
          wsa, out, pmean, pm2, pmax, mean, rstd, gate, map, bar, n, h, w, c,
          r, pad, 1, eps, groups_tail, s);
    }
  }
  if (quant)
    DUCOSY_TRY(launch_conv_int8(static_cast<const int8_t*>(tp),
                                static_cast<const int8_t*>(wb), acc, pmean,
                                pm2, pmax, n, h, w, c, tiles, s));
  else
    DUCOSY_TRY(launch_conv<T>(static_cast<const T*>(tp),
                              static_cast<const T*>(wb), acc, pmean, pm2, pmax,
                              n, h, w, c, tiles, s));
  return launch_tail<T, float>(acc, xp, w1, w2, wsa, out, pmean, pm2, pmax,
                               mean, rstd, gate, n, h, w, c, r, tiles, pad, 1,
                               eps, s);
}

}  // namespace
}  // namespace ducosy

// One residual block: xp (n, h+2, w+2, c) -> out (n, h+2*pad, w+2*pad, c).
// wa and wb (9, c, c) in the io dtype: (tap, cout, cin) for bf16, (tap, cin,
// cout) for fp32; when int8_k = 255 / S > 0 (K1q) wb is int8 as (tap, cout,
// cin). w1 (c, r), w2 (r, c), wsa (2*49) fp32. Scratch: tp like xp (int8 for
// K1q), pmean/pm2/pmax (n, tiles, c), mean/rstd/gate (n, c); for a tiled half
// (groups_in or groups_tail = 0) acc (n, h*w, c) fp32; for a
// resident half (its groups > 0, is_bf16 only; see ducosy_conv3x3_in and
// ducosy_conv_block_tail in conv_in.cu) map (n, h*w, 2) fp32 and `bar`, one
// zeroed 64-bit barrier word per group. Returns the first failing launch's
// error, or 0. Launches on `stream` and does not synchronize.
extern "C" int ducosy_residual_block(
    const void* xp, const void* wa, const void* wb, const float* w1,
    const float* w2, const float* wsa, void* out, float* acc, void* tp,
    float* pmean, float* pm2, float* pmax, float* mean, float* rstd,
    float* gate, float* map, void* bar, int n, int h, int w, int c, int r,
    int pad, float eps, float int8_k, int is_bf16, int groups_in,
    int groups_tail, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* b = static_cast<unsigned long long*>(bar);
  if (is_bf16)
    return residual_block<bf16>(
        static_cast<const bf16*>(xp), static_cast<const bf16*>(wa), wb, w1,
        w2, wsa, static_cast<bf16*>(out), acc, tp, pmean, pm2, pmax, mean,
        rstd, gate, map, b, n, h, w, c, r, pad, eps, int8_k, groups_in,
        groups_tail, s);
  return residual_block<float>(
      static_cast<const float*>(xp), static_cast<const float*>(wa), wb, w1,
      w2, wsa, static_cast<float*>(out), acc, tp, pmean, pm2, pmax, mean,
      rstd, gate, map, b, n, h, w, c, r, pad, eps, int8_k, groups_in,
      groups_tail, s);
}
