// K7 and K8: the two halves of a CBAM residual block as separate entry
// points, for Hopper (sm_90a). The Python wrapper is ops/kernels/conv_in.py;
// the generator's trunk="mega" runs K7 then K8 for each block, and
// ops/kernels/proto_conv_in.py drives the same two entry points without the
// int8 modes (P1, P2).
//
// Replaces: conv3x3_in_pallas (ducosy_tpu/ops/pallas/conv_in.py:119,
// pallas_call at :142) and conv_block_tail_pallas (conv_in.py:231, :258);
// with the int8 modes off, their prototypes in scripts/proto_conv_in.py
// (:55 and :156).
//   K7  out = ReflectPad_pad(act(IN(conv3x3_valid(xp, w))))
//       act = ReLU or identity, rounded once to the io dtype; with
//       int8_k = 255 / S > 0 the fp32 normalized value is written as
//       shifted-grid int8, trunc(min(y * k + 0.5, 255)) - 128, quantized
//       before the pad, so the pad copies codes (conv_in.py:99-109). xp may
//       itself be int8 with int8 weights (exact int32 taps, :135-138).
//   K8  y   = IN(conv3x3_valid(tp, w)), rounded to the io dtype
//       y  *= sigmoid(MLP(avgpool y) + MLP(maxpool y))        channel gate
//       y  *= sigmoid(conv7x7_zero([mean_c y, max_c y]))       spatial gate
//       out = ReflectPad_pad(x[x_pad:-x_pad] + y)
//       tp is the io dtype, or shifted-grid int8 with int8 weights
//       (in_int8): the int32 accumulator goes to fp32 and straight into the
//       IN, which absorbs the weight scale and the grid's 128 * sum(wq)
//       offset, so no scale enters (conv_in.py:171-176).
//
// What bounds them: one 3x3 conv at (16, 128, 128, 256 -> 256) is 3.09e11
// FLOP against ~280 MB of bf16 reads and writes: compute-bound on the
// tensor cores by a factor of ~4 over the memory time.
//
// Design: K1's block (residual_chain.cu) is K7 followed by K8 with t kept
// in scratch, so both are sequences of the same launches, from conv3x3.cuh,
// common.cuh and cbam_tail.cuh: K7 = conv tile kernel -> finalize_stats ->
// norm_apply (or norm_apply_int8); K8 = conv tile kernel with the per-tile
// channel max -> channel_gate -> spatial_tail. The TPU kernels keep one
// sample's whole (130, 130, 256) window in VMEM on a grid of (N,); here the
// conv is tiled over 128 pixels x 64 output channels and every whole-image
// reduction is per-tile partials plus an apply step. What it gives up is
// what K1 gives up: the fp32 accumulator round-trips device memory
// (n * h * w * c * 4 bytes per conv), and the conv main loop is WMMA /
// mma.sync without cp.async or TMA pipelining.
#include "cbam_tail.cuh"
#include "conv3x3.cuh"

namespace ducosy {
namespace {

// The conv of either half: TIn is bf16, float or int8_t.
template <typename TIn>
void conv_any(const void* xp, const void* wt, float* acc, float* pmean,
              float* pm2, float* pmax, int n, int h, int w, int c, int tiles,
              cudaStream_t s) {
  if constexpr (sizeof(TIn) == 1)
    launch_conv_int8(static_cast<const int8_t*>(xp),
                     static_cast<const int8_t*>(wt), acc, pmean, pm2, pmax, n,
                     h, w, c, tiles, s);
  else
    launch_conv<TIn>(static_cast<const TIn*>(xp), static_cast<const TIn*>(wt),
                     acc, pmean, pm2, pmax, n, h, w, c, tiles, s);
}

// K7. The output is int8 codes when int8_k > 0, else TIn (for an int8 input
// that is the normalized value cast to int8, as the TPU kernel's astype).
template <typename TIn>
int conv3x3_in(const void* xp, const void* wt, void* out, float* acc,
               float* pmean, float* pm2, float* mean, float* rstd, int n,
               int h, int w, int c, int pad, int relu, float eps, float int8_k,
               cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  conv_any<TIn>(xp, wt, acc, pmean, pm2, nullptr, n, h, w, c, tiles, s);
  DUCOSY_CHECK_LAUNCH();
  finalize_stats<<<(n * c + 255) / 256, 256, 0, s>>>(pmean, pm2, mean, rstd,
                                                      n, tiles, c, hw, eps);
  DUCOSY_CHECK_LAUNCH();
  const dim3 agrid(w + 2 * pad, h + 2 * pad, n);
  if (int8_k > 0.f)
    norm_apply_int8<float, float><<<agrid, APPLY_THREADS, 0, s>>>(
        acc, mean, rstd, static_cast<int8_t*>(out), h, w, c, pad, int8_k);
  else
    norm_apply<float, TIn><<<agrid, APPLY_THREADS, 0, s>>>(
        acc, mean, rstd, static_cast<TIn*>(out), h, w, c, pad, relu);
  DUCOSY_CHECK_LAUNCH();
  return 0;
}

// K8. T is the io dtype (x and out); TIn the conv input's (T or int8_t).
template <typename T, typename TIn>
int conv_block_tail(const void* tp, const T* x, const void* wt,
                    const float* w1, const float* w2, const float* wsa, T* out,
                    float* acc, float* pmean, float* pm2, float* pmax,
                    float* mean, float* rstd, float* gate, int n, int h, int w,
                    int c, int r, int pad, int x_pad, float eps,
                    cudaStream_t s) {
  const int tiles = (h * w + TILE_M - 1) / TILE_M;
  conv_any<TIn>(tp, wt, acc, pmean, pm2, pmax, n, h, w, c, tiles, s);
  DUCOSY_CHECK_LAUNCH();
  return launch_tail<T, float>(acc, x, w1, w2, wsa, out, pmean, pm2, pmax,
                               mean, rstd, gate, n, h, w, c, r, tiles, pad,
                               x_pad, eps, s);
}

}  // namespace
}  // namespace ducosy

// K7: xp (n, h+2, w+2, c) -> out (n, h+2*pad, w+2*pad, c). in_kind 0: fp32
// xp and wt; 1: bf16; 2: int8 xp with int8 wt. wt is (9*c, c) as (tap, cin,
// cout) for fp32/bf16 and (9, c, c) as (tap, cout, cin) for int8. out has
// xp's type, or int8 codes when int8_k = 255 / S > 0 (then ReLU is applied
// whatever `relu` says; the wrapper refuses relu = 0). Scratch: acc
// (n, h*w, c) fp32, pmean/pm2 (n, tiles, c), mean/rstd (n, c). Returns
// cudaGetLastError() of the first failing launch, or 0. Launches on
// `stream` and does not synchronize.
extern "C" int ducosy_conv3x3_in(const void* xp, const void* wt, void* out,
                                 float* acc, float* pmean, float* pm2,
                                 float* mean, float* rstd, int n, int h, int w,
                                 int c, int pad, int relu, float eps,
                                 float int8_k, int in_kind, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_kind == 2)
    return conv3x3_in<int8_t>(xp, wt, out, acc, pmean, pm2, mean, rstd, n, h,
                              w, c, pad, relu, eps, int8_k, s);
  if (in_kind == 1)
    return conv3x3_in<bf16>(xp, wt, out, acc, pmean, pm2, mean, rstd, n, h, w,
                            c, pad, relu, eps, int8_k, s);
  return conv3x3_in<float>(xp, wt, out, acc, pmean, pm2, mean, rstd, n, h, w,
                           c, pad, relu, eps, int8_k, s);
}

// K8: tp (n, h+2, w+2, c), x (n, h+2*x_pad, w+2*x_pad, c) -> out
// (n, h+2*pad, w+2*pad, c). x and out are bf16 (is_bf16) or fp32; tp and wt
// have that type with wt as (tap, cin, cout), or, with in_int8, tp is
// shifted-grid int8 and wt int8 as (tap, cout, cin). w1 (c, r), w2 (r, c),
// wsa (2*49) fp32. Scratch as K7 plus pmax (n, tiles, c) and gate (n, c).
// Returns the first failing launch's error, or 0.
extern "C" int ducosy_conv_block_tail(
    const void* tp, const void* x, const void* wt, const float* w1,
    const float* w2, const float* wsa, void* out, float* acc, float* pmean,
    float* pm2, float* pmax, float* mean, float* rstd, float* gate, int n,
    int h, int w, int c, int r, int pad, int x_pad, float eps, int in_int8,
    int is_bf16, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DUCOSY_TAIL(T, TIn)                                                   \
  return conv_block_tail<T, TIn>(tp, static_cast<const T*>(x), wt, w1, w2,    \
                                 wsa, static_cast<T*>(out), acc, pmean, pm2,  \
                                 pmax, mean, rstd, gate, n, h, w, c, r, pad,  \
                                 x_pad, eps, s)
  if (is_bf16) {
    if (in_int8) DUCOSY_TAIL(bf16, int8_t);
    DUCOSY_TAIL(bf16, bf16);
  }
  if (in_int8) DUCOSY_TAIL(float, int8_t);
  DUCOSY_TAIL(float, float);
#undef DUCOSY_TAIL
}
