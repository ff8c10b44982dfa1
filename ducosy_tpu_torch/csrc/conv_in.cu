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
// in scratch, so both run the same launches, by one of two routes that the
// wrapper picks from the shape, the dtype and the device's co-resident block
// count (ops/kernels/conv_in.py:conv_route), never by failure:
//   resident (conv_resident.cuh; `groups` > 0): one cooperative launch per
//     kernel; a sample's accumulator stays in the registers of the blocks
//     that computed it, across a grid barrier, and the statistics' merge,
//     the gates and the reflect-padded write are the conv kernel's epilogue.
//     bf16 or int8 input, bf16 io, every block of a sample resident at once,
//     and for K8 C = 64, 128 or 256. This is what the TPU kernels do with
//     one sample's window in VMEM on a grid of (N,).
//   tiled (`groups` = 0; fp32, wider C, larger images, smaller cards): K7 =
//     conv tile kernel -> finalize_stats -> norm_apply (or norm_apply_int8);
//     K8 = conv tile kernel with the per-tile channel max -> channel_gate ->
//     spatial_tail, from conv3x3.cuh, common.cuh and cbam_tail.cuh. The fp32
//     accumulator round-trips device memory (n * h * w * c * 4 bytes per
//     conv).
#include "cbam_tail.cuh"
#include "conv3x3.cuh"
#include "conv_resident.cuh"

namespace ducosy {
namespace {

// The conv of either half: TIn is bf16, float or int8_t.
template <typename TIn>
int conv_any(const void* xp, const void* wt, float* acc, float* pmean,
             float* pm2, float* pmax, int n, int h, int w, int c, int tiles,
             cudaStream_t s) {
  if constexpr (sizeof(TIn) == 1)
    return launch_conv_int8(static_cast<const int8_t*>(xp),
                            static_cast<const int8_t*>(wt), acc, pmean, pm2,
                            pmax, n, h, w, c, tiles, s);
  else
    return launch_conv<TIn>(static_cast<const TIn*>(xp),
                            static_cast<const TIn*>(wt), acc, pmean, pm2, pmax,
                            n, h, w, c, tiles, s);
}

// K7. The output is int8 codes when int8_k > 0, else TIn (for an int8 input
// that is the normalized value cast to int8, as the TPU kernel's astype).
// groups > 0: the resident route (not for float).
template <typename TIn>
int conv3x3_in(const void* xp, const void* wt, void* out, float* acc,
               float* pmean, float* pm2, float* mean, float* rstd,
               unsigned long long* bar, int n, int h, int w, int c, int pad,
               int relu, float eps, float int8_k, int groups, cudaStream_t s) {
  const int hw = h * w, tiles = (hw + TILE_M - 1) / TILE_M;
  if (groups > 0) {
    if constexpr (sizeof(TIn) == 4) {
      return (int)cudaErrorInvalidValue;
    } else {
      const TIn* xi = static_cast<const TIn*>(xp);
      const TIn* wi = static_cast<const TIn*>(wt);
      if (sizeof(TIn) == 1 || int8_k > 0.f)
        return conv3x3_in_resident_any<TIn, int8_t>(
            xi, wi, static_cast<int8_t*>(out), pmean, pm2, mean, rstd, bar, n,
            h, w, c, pad, relu, eps, int8_k, groups, s);
      if constexpr (sizeof(TIn) == 2)
        return conv3x3_in_resident_any<TIn, TIn>(
            xi, wi, static_cast<TIn*>(out), pmean, pm2, mean, rstd, bar, n, h,
            w, c, pad, relu, eps, int8_k, groups, s);
    }
  }
  DUCOSY_TRY(conv_any<TIn>(xp, wt, acc, pmean, pm2, nullptr, n, h, w, c, tiles,
                           s));
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
// groups > 0: the resident route (bf16 io only).
template <typename T, typename TIn>
int conv_block_tail(const void* tp, const T* x, const void* wt,
                    const float* w1, const float* w2, const float* wsa, T* out,
                    float* acc, float* pmean, float* pm2, float* pmax,
                    float* mean, float* rstd, float* gate, float* map,
                    unsigned long long* bar, int n, int h, int w, int c, int r,
                    int pad, int x_pad, float eps, int groups,
                    cudaStream_t s) {
  const int tiles = (h * w + TILE_M - 1) / TILE_M;
  if (groups > 0) {
    if constexpr (sizeof(T) == 2)
      return conv_tail_resident_any<TIn>(
          static_cast<const TIn*>(tp), static_cast<const TIn*>(wt), x, w1, w2,
          wsa, out, pmean, pm2, pmax, mean, rstd, gate, map, bar, n, h, w, c,
          r, pad, x_pad, eps, groups, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  DUCOSY_TRY(conv_any<TIn>(tp, wt, acc, pmean, pm2, pmax, n, h, w, c, tiles,
                           s));
  return launch_tail<T, float>(acc, x, w1, w2, wsa, out, pmean, pm2, pmax,
                               mean, rstd, gate, n, h, w, c, r, tiles, pad,
                               x_pad, eps, s);
}

}  // namespace
}  // namespace ducosy

// K7: xp (n, h+2, w+2, c) -> out (n, h+2*pad, w+2*pad, c). in_kind 0: fp32
// xp and wt; 1: bf16; 2: int8 xp with int8 wt. wt is (9, c, c): (tap, cin,
// cout) for fp32, (tap, cout, cin) for bf16 and int8. out has
// xp's type, or int8 codes when int8_k = 255 / S > 0 (then ReLU is applied
// whatever `relu` says; the wrapper refuses relu = 0). Scratch: pmean/pm2
// (n, tiles, c) and mean/rstd (n, c); on the tiled route (groups = 0) acc
// (n, h*w, c) fp32; on the resident route (groups > 0 sample groups, in_kind
// 1 or 2, tiles * c / BN * groups blocks resident at once) `bar`, one zeroed
// 64-bit barrier word per group. Returns the first failing launch's error, or
// 0. Launches on `stream` and does not synchronize.
extern "C" int ducosy_conv3x3_in(const void* xp, const void* wt, void* out,
                                 float* acc, float* pmean, float* pm2,
                                 float* mean, float* rstd, void* bar, int n,
                                 int h, int w, int c, int pad, int relu,
                                 float eps, float int8_k, int in_kind,
                                 int groups, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* b = static_cast<unsigned long long*>(bar);
  if (in_kind == 2)
    return conv3x3_in<int8_t>(xp, wt, out, acc, pmean, pm2, mean, rstd, b, n,
                              h, w, c, pad, relu, eps, int8_k, groups, s);
  if (in_kind == 1)
    return conv3x3_in<bf16>(xp, wt, out, acc, pmean, pm2, mean, rstd, b, n, h,
                            w, c, pad, relu, eps, int8_k, groups, s);
  return conv3x3_in<float>(xp, wt, out, acc, pmean, pm2, mean, rstd, b, n, h,
                           w, c, pad, relu, eps, int8_k, groups, s);
}

// K8: tp (n, h+2, w+2, c), x (n, h+2*x_pad, w+2*x_pad, c) -> out
// (n, h+2*pad, w+2*pad, c). x and out are bf16 (is_bf16) or fp32; tp and wt
// have that type with wt as in K7, or, with in_int8, tp is shifted-grid
// int8 and wt int8 as (tap, cout, cin). w1 (c, r), w2 (r, c),
// wsa (2*49) fp32. Scratch as K7 plus pmax (n, tiles, c) and gate (n, c);
// resident (groups > 0: is_bf16, c 64, 128 or 256, w <= 256): map
// (n, h*w, 2) fp32.
// Returns the first failing launch's error, or 0.
extern "C" int ducosy_conv_block_tail(
    const void* tp, const void* x, const void* wt, const float* w1,
    const float* w2, const float* wsa, void* out, float* acc, float* pmean,
    float* pm2, float* pmax, float* mean, float* rstd, float* gate,
    float* map, void* bar, int n, int h, int w, int c, int r, int pad,
    int x_pad, float eps, int in_int8, int is_bf16, int groups,
    void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* b = static_cast<unsigned long long*>(bar);
#define DUCOSY_TAIL(T, TIn)                                                   \
  return conv_block_tail<T, TIn>(tp, static_cast<const T*>(x), wt, w1, w2,    \
                                 wsa, static_cast<T*>(out), acc, pmean, pm2,  \
                                 pmax, mean, rstd, gate, map, b, n, h, w, c,  \
                                 r, pad, x_pad, eps, groups, s)
  if (is_bf16) {
    if (in_int8) DUCOSY_TAIL(bf16, int8_t);
    DUCOSY_TAIL(bf16, bf16);
  }
  if (in_int8) DUCOSY_TAIL(float, int8_t);
  DUCOSY_TAIL(float, float);
#undef DUCOSY_TAIL
}

// How many blocks of the resident kernels the current device holds at once
// (SM count x the occupancy the runtime reports), in *blocks; 0 where it
// cannot launch cooperatively. Returns a CUDA error, or 0.
extern "C" int ducosy_resident_blocks(int* blocks) {
  return ducosy::resident_blocks(blocks);
}

// The bf16 resident kernels at c = 256 with parts compiled out, to time what
// each costs: `parts` sums RPART_MMA = 1 (ring, MMAs and partials),
// RPART_SYNC = 2 (the barriers, merges and channel gate) and RPART_EPI = 4
// (the epilogue from the registers). `tail` = 0: K7's kernel, bf16 out
// (x, w1, w2, wsa, pmax, gate, map unused); 1: K8's. What a missing part would
// compute is replaced by constants; the output is then not K7's or K8's.
// Other values of `parts` than 1-6 run the whole kernel.
extern "C" int ducosy_resident_probe(
    const void* xp, const void* x, const void* wt, const float* w1,
    const float* w2, const float* wsa, void* out, float* pmean, float* pm2,
    float* pmax, float* mean, float* rstd, float* gate, float* map, void* bar,
    int n, int h, int w, int c, int r, int parts, int tail, int groups,
    void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c != 256) return (int)cudaErrorInvalidValue;
  const int tiles = (h * w + TILE_M - 1) / TILE_M;
  const bf16* xi = static_cast<const bf16*>(xp);
  const bf16* wi = static_cast<const bf16*>(wt);
  bf16* o = static_cast<bf16*>(out);
  unsigned long long* b = static_cast<unsigned long long*>(bar);
#define DUCOSY_RPROBE(P)                                                      \
  if (parts == P)                                                             \
    return tail ? launch_tail_resident<bf16, 128, 256, P>(                    \
                      xi, wi, static_cast<const bf16*>(x), w1, w2, wsa, o,    \
                      pmean, pm2, pmax, mean, rstd, gate, map, b, n, h, w, r, \
                      1, 1, 1e-5f, tiles, groups, s)                          \
                : launch_in_resident<bf16, bf16, 128, 256, P>(                \
                      xi, wi, o, pmean, pm2, mean, rstd, b, n, h, w, c, 1, 1, \
                      1e-5f, 0.f, tiles, groups, s)
  DUCOSY_RPROBE(1);
  DUCOSY_RPROBE(2);
  DUCOSY_RPROBE(3);
  DUCOSY_RPROBE(4);
  DUCOSY_RPROBE(5);
  DUCOSY_RPROBE(6);
  DUCOSY_RPROBE(RPART_ALL);
  parts = RPART_ALL;
  DUCOSY_RPROBE(RPART_ALL);
  return (int)cudaErrorInvalidValue;
#undef DUCOSY_RPROBE
}

// The bare conv launch K7, K8 and K1 share, for measuring the loop alone:
// xp (n, h+2, w+2, c) and wt of in_kind as in K7 -> acc (n, h*w, c) fp32 and
// the per-tile partials pmean, pm2, pmax (n, tiles, c).
extern "C" int ducosy_conv3x3(const void* xp, const void* wt, float* acc,
                              float* pmean, float* pm2, float* pmax, int n,
                              int h, int w, int c, int in_kind, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (h * w + TILE_M - 1) / TILE_M;
  if (in_kind == 2)
    return conv_any<int8_t>(xp, wt, acc, pmean, pm2, pmax, n, h, w, c, tiles, s);
  if (in_kind == 1)
    return conv_any<bf16>(xp, wt, acc, pmean, pm2, pmax, n, h, w, c, tiles, s);
  return conv_any<float>(xp, wt, acc, pmean, pm2, pmax, n, h, w, c, tiles, s);
}

// The bf16 loop at c % 256 == 0 with parts compiled out, to time what each
// costs: `parts` is a sum of PART_STORE = 1 (the accumulator's store),
// PART_STATS = 2 (the statistics) and PART_MMA = 4 (the MMAs; without them
// the ring's loads run alone). What a missing part would write is not
// written. Other values of `parts` than the five below run the whole loop.
extern "C" int ducosy_conv3x3_probe(const void* xp, const void* wt, float* acc,
                                    float* pmean, float* pm2, float* pmax,
                                    int n, int h, int w, int c, int parts,
                                    void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (h * w + TILE_M - 1) / TILE_M;
  const bf16* x = static_cast<const bf16*>(xp);
  const bf16* k = static_cast<const bf16*>(wt);
#define DUCOSY_PROBE(P)                                                     \
  return launch_wgmma<bf16, 128, 256, P>(x, k, acc, pmean, pm2, pmax, n, h, \
                                         w, c, tiles, s)
  if (parts == 0) DUCOSY_PROBE(0);
  if (parts == PART_MMA) DUCOSY_PROBE(PART_MMA);
  if (parts == (PART_MMA | PART_STORE)) DUCOSY_PROBE(PART_MMA | PART_STORE);
  if (parts == (PART_MMA | PART_STATS)) DUCOSY_PROBE(PART_MMA | PART_STATS);
  DUCOSY_PROBE(PART_ALL);
#undef DUCOSY_PROBE
}

// The tile geometry the wrappers size their scratch by: pixels per
// statistics tile, and the granule C must be a multiple of.
extern "C" void ducosy_conv_tile_geometry(int* tile_m, int* tile_n) {
  *tile_m = ducosy::TILE_M;
  *tile_n = ducosy::TILE_N;
}
