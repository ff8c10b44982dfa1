// The sample-resident route of K7 (conv3x3 + IN) and K8 (conv3x3 + CBAM
// tail), and through them of K1, K1q and K6: one cooperative launch in which
// a sample's fp32 accumulator never leaves the registers.
//
// What the TPU kernels do (conv3x3_in_pallas and conv_block_tail_pallas,
// ducosy_tpu/ops/pallas/conv_in.py:119, :231): a grid of (N,), one sample's
// whole accumulator in VMEM, statistics, gates and the padded write all
// taken from there. The tiled route (conv3x3.cuh + common.cuh +
// cbam_tail.cuh) sends the accumulator through device memory instead: a
// 268 MB fp32 store and one to 2.6 reads of it per conv at the trunk shape
// (16, 128, 128, 256), in three launches after the conv.
//
// What this card offers instead: its register files. The conv kernel runs
// one block of 128 pixels x BN channels per SM and ends its loop with the
// tile's accumulator in registers; where a sample's tiles x (C / BN) blocks
// fit on the card at once (128 of 132 SMs at the trunk shape), those
// registers hold the whole sample. So block (co, tile) of a cooperative
// launch walks the samples in order and, per sample:
//   1. runs the ring and the MMAs of its tile (conv_tile_mma) and writes the
//      tile's (mean, M2[, max]) partials from the registers (tile_partials),
//      as the tiled kernel does, without the accumulator's store;
//   2. passes a grid barrier (common.cuh: an arrival counter in scratch);
//   3. takes its share of the sample's channels (2 of 256 at the trunk
//      shape), merges their partials over all tiles in merge_tiles' order
//      (the same bits as the tiled route's finalize_stats / channel_gate)
//      and publishes mean, 1/std and max; a second barrier, and every block
//      reads the BN channels it normalizes (merge_sample, common.cuh). Tried
//      first and dropped: every block merging all of its BN channels itself,
//      without the second barrier, took 30 us a sample at the trunk shape
//      (128 dependent L2 reads a channel, 49 MB of L2 reads a sample);
//   4. K7: normalizes from the registers, ReLU, rounds once to the output
//      type or quantizes the fp32 value to the shifted int8 grid, stages the
//      tile in the freed ring and writes whole 16-byte chunks of each pixel's
//      channels to its place in the reflect-padded output and to the border
//      places it mirrors to;
//      K8 (C == BN: a block owns all channels of its pixels): the channel
//      gate from the merged max (each block computes it: 2 C R MACs), then
//      per pixel the channel mean and max of t = round(round(IN) * gate_c)
//      from the registers into a (n, h*w, 2) fp32 map in scratch (L2), a
//      third grid barrier, the map's rows within reach staged in shared
//      memory, the 7x7 zero-padded conv and the sigmoid for the tile's own
//      pixels, round(t * gate_s) staged, and the skip added from x's
//      interior as the chunks go out.
// Rounding points are the tiled route's (cbam_tail.cuh:5-10, conv_in.py:
// 176-219). With fewer blocks than the card holds, several samples are
// resident side by side: blockIdx.z is a group with a barrier word of its
// own that walks samples z, z + gridDim.z, ...
//
// What bounds it: the conv's operations, as before (0.313 ms at the trunk
// shape in bf16); beside them now only the bf16 reads and writes that the
// function itself needs. What it costs: all blocks of a sample end together,
// so 4 of 132 SMs idle at the trunk shape and each sample pays its two
// (K8: three) barriers and one serial merge of `tiles` partials per channel.
#pragma once

#include <limits.h>

#include "conv3x3.cuh"
#include "tail_resident.cuh"

namespace ducosy {

// Dynamic shared memory of the resident kernels: the ring (K8: or its
// epilogue where that is larger; the 64-channel int8 ring is 48 KB), then
// the (row, column) of the tile's 128 pixels, worked out once per block.
template <typename TIn, int ROWB, int BN>
constexpr int IN_SMEM = ConvGeom<TIn, ROWB, BN>::SMEM + PIX_BYTES;
template <typename TIn, int ROWB, int BN>
constexpr int TAIL_SMEM =
    (ConvGeom<TIn, ROWB, BN>::SMEM > ResidentSmem<BN>::TAIL_BYTES + RING_ALIGN
         ? ConvGeom<TIn, ROWB, BN>::SMEM
         : ResidentSmem<BN>::TAIL_BYTES + RING_ALIGN) + PIX_BYTES;

// K7, resident. xp (n, h+2, w+2, c) and wt (9, c, c) as (tap, cout, cin) in
// TIn (bf16 or int8_t); out (n, h+2 pad, w+2 pad, c) in TOut: bf16, or int8_t
// (shifted-grid codes at int8_k = 255 / S > 0; for an int8 input without a
// scale the normalized value cast to int8). pmean / pm2 (n, tiles, c) and
// gmean / grstd (n, c) scratch; bar one zeroed barrier word per group.
// Cooperative launch, grid (c / BN, tiles, groups), CONV_THREADS threads,
// IN_SMEM bytes.
template <typename TIn, typename TOut, int ROWB, int BN, int PARTS = RPART_ALL>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv3x3_in_resident(const TIn* __restrict__ xp, const TIn* __restrict__ wt,
                    TOut* __restrict__ out, float* pmean, float* pm2,
                    float* gmean, float* grstd, unsigned long long* bar,
                    int n, int h, int w, int c, int pad, int relu, float eps,
                    float int8_k) {
  using G = ConvGeom<TIn, ROWB, BN>;
  using S = ResidentSmem<BN>;
  using Acc = typename G::Acc;
  static_assert(S::template BYTES<sizeof(TOut)> <= G::SMEM - RING_ALIGN,
                "the epilogue's shared memory must fit in the ring");
  constexpr int LD = S::template LD<sizeof(TOut)>;
  extern __shared__ unsigned char ring_raw[];
  const uint32_t ring =
      (smem_u32(ring_raw) + RING_ALIGN - 1) & ~uint32_t(RING_ALIGN - 1);
  unsigned char* base = ring_raw + (ring - smem_u32(ring_raw));
  float* red = reinterpret_cast<float*>(base);
  float* smean = red + S::MEAN;
  float* srstd = red + S::RSTD;
  unsigned char* stage = base + S::STAGE_BYTE;
  int2* pix = reinterpret_cast<int2*>(
      base + IN_SMEM<TIn, ROWB, BN> - PIX_BYTES - RING_ALIGN);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int co0 = blockIdx.x * BN, tile = blockIdx.y, tiles = gridDim.y;
  const int hw = h * w, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);
  fill_pixels(pix, m0, w);
  const unsigned nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  unsigned long long target = 0;    // the barrier's, kept by thread 0
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;

  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    Acc d[BN / 2];
    if constexpr (PARTS & RPART_MMA) {
      conv_tile_mma<TIn, ROWB, BN>(xp, wt, d, ring, ni, m0, co0, h, w, c);
      const size_t pbase = ((size_t)ni * tiles + tile) * c + co0;
      tile_partials<BN>(d, red, rows, pmean + pbase, pm2 + pbase, nullptr);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = (Acc)(h + i);
    }
    if constexpr (PARTS & RPART_SYNC) {
      merge_sample(pmean, pm2, nullptr, gmean, grstd, nullptr,
                   bar + blockIdx.z, nblocks, target, bid, ni, co0, BN, tiles,
                   hw, c, eps, reinterpret_cast<float*>(stage), smean, srstd,
                   nullptr);
    } else {
      if (tid < BN) { smean[tid] = 0.f; srstd[tid] = 1.f; }
      __syncthreads();
    }
    if constexpr (PARTS & RPART_EPI) {
      unsigned char* s0 = stage + r0 * LD + cq * sizeof(TOut);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 mu = *reinterpret_cast<const float2*>(smean + 8 * j + cq);
        const float2 rs = *reinterpret_cast<const float2*>(srstd + 8 * j + cq);
        TOut v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float y = ((float)d[4 * j + e] - (e & 1 ? mu.y : mu.x)) *
                    (e & 1 ? rs.y : rs.x);
          if (relu || int8_k > 0.f) y = fmaxf(y, 0.f);
          if constexpr (sizeof(TOut) == 1) {
            v[e] = int8_k > 0.f ? quantize_shifted(y, int8_k)
                                : from_f32<int8_t>(y);
          } else {
            v[e] = from_f32<TOut>(y);
          }
        }
        stage_pair(s0 + j * 8 * sizeof(TOut), v[0], v[1]);
        stage_pair(s0 + 8 * LD + j * 8 * sizeof(TOut), v[2], v[3]);
      }
      __syncthreads();
      write_padded_tile<TOut, BN>(stage, pix, out, ni, rows, co0, h, w, c,
                                  pad, [](uint4 v, int, int) { return v; });
    }
    __syncthreads();   // the ring's space is free for the next sample
  }
}

// K8, resident, io bf16, c == BN. tp (n, h+2, w+2, c) and wt (9, c, c) as
// (tap, cout, cin) in TIn (bf16 or shifted-grid int8_t with int8 weights);
// x (n, h+2 x_pad, w+2 x_pad, c); w1 (c, r), w2 (r, c), wsa (2 x 49) fp32;
// out (n, h+2 pad, w+2 pad, c), w <= RESIDENT_TAIL_W. pmean / pm2 / pmax
// (n, tiles, c), gmean / grstd / gmax (n, c) and map (n, h*w, 2) scratch;
// bar one zeroed barrier word per group. Cooperative
// launch, grid (1, tiles, groups), CONV_THREADS threads, TAIL_SMEM bytes.
// After the MMAs, the tail (tail_resident.cuh) runs from the accumulator.
template <typename TIn, int ROWB, int BN, int PARTS = RPART_ALL>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv_tail_resident(const TIn* __restrict__ tp, const TIn* __restrict__ wt,
                   const bf16* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ w2, const float* __restrict__ wsa,
                   bf16* __restrict__ out, float* pmean, float* pm2,
                   float* pmax, float* gmean, float* grstd, float* gmax,
                   float* map, unsigned long long* bar, int n, int h, int w,
                   int r, int pad, int x_pad, float eps) {
  using G = ConvGeom<TIn, ROWB, BN>;
  using Acc = typename G::Acc;
  constexpr int c = BN;
  extern __shared__ unsigned char ring_raw[];
  const uint32_t ring =
      (smem_u32(ring_raw) + RING_ALIGN - 1) & ~uint32_t(RING_ALIGN - 1);
  unsigned char* base = ring_raw + (ring - smem_u32(ring_raw));
  int2* pix = reinterpret_cast<int2*>(
      base + TAIL_SMEM<TIn, ROWB, BN> - PIX_BYTES - RING_ALIGN);

  const int tile = blockIdx.y, tiles = gridDim.y;
  const int m0 = tile * TILE_M;
  const unsigned nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  unsigned long long target = 0;    // the barrier's, kept by thread 0
  fill_pixels(pix, m0, w);

  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    Acc d[BN / 2];
    if constexpr (PARTS & RPART_MMA) {
      conv_tile_mma<TIn, ROWB, BN>(tp, wt, d, ring, ni, m0, 0, h, w, c);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = (Acc)(h + i);
    }
    tail_epilogue<BN, PARTS>(d, base, pix, x, w1, w2, wsa, out, pmean, pm2,
                             pmax, gmean, grstd, gmax, map, bar + blockIdx.z,
                             nblocks, target, bid, ni, tile, tiles, h, w, r,
                             pad, x_pad, eps);
    __syncthreads();   // the ring's space is free for the next sample
  }
}

// ---- launches. static, with the once-flags inside: each library that
// includes this header has its own copy of the kernels (see launch_wgmma).
template <typename TIn, typename TOut, int ROWB, int BN, int PARTS = RPART_ALL>
static int launch_in_resident(const TIn* xp, const TIn* wt, TOut* out,
                              float* pmean, float* pm2, float* gmean,
                              float* grstd, unsigned long long* bar, int n,
                              int h, int w, int c, int pad, int relu, float eps,
                              float int8_k, int tiles, int groups,
                              cudaStream_t s) {
  constexpr int smem = IN_SMEM<TIn, ROWB, BN>;
  auto kernel = conv3x3_in_resident<TIn, TOut, ROWB, BN, PARTS>;
  static DeviceFlags raised;
  DUCOSY_TRY(once_per_device(raised, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }));
  void* args[] = {&xp, &wt, &out, &pmean, &pm2, &gmean, &grstd, &bar,
                  &n,  &h,  &w,   &c,     &pad, &relu,  &eps,   &int8_k};
  return launch_cooperative(kernel, dim3(c / BN, tiles, groups), smem, args, s);
}

template <typename TIn, int ROWB, int BN, int PARTS = RPART_ALL>
static int launch_tail_resident(const TIn* tp, const TIn* wt, const bf16* x,
                                const float* w1, const float* w2,
                                const float* wsa, bf16* out, float* pmean,
                                float* pm2, float* pmax, float* gmean,
                                float* grstd, float* gmax, float* map,
                                unsigned long long* bar, int n, int h, int w,
                                int r, int pad, int x_pad, float eps,
                                int tiles, int groups, cudaStream_t s) {
  constexpr int smem = TAIL_SMEM<TIn, ROWB, BN>;
  auto kernel = conv_tail_resident<TIn, ROWB, BN, PARTS>;
  static DeviceFlags raised;
  DUCOSY_TRY(once_per_device(raised, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }));
  void* args[] = {&tp,    &wt,    &x,    &w1,  &w2,  &wsa, &out, &pmean,
                  &pm2,   &pmax,  &gmean, &grstd, &gmax, &map, &bar, &n,
                  &h,     &w,     &r,    &pad, &x_pad, &eps};
  return launch_cooperative(kernel, dim3(1, tiles, groups), smem, args, s);
}

// The tile widths of the tiled launches (launch_conv, launch_conv_int8):
// BN = 256, 128 or 64, the widest that divides c; int8 rows of 64 bytes
// where c is not a multiple of 128.
#define DUCOSY_BY_WIDTH(CALL, TIn)                              \
  do {                                                          \
    if (c % 256 == 0) return CALL(128, 256);                    \
    if (c % 128 == 0) return CALL(128, 128);                    \
    return CALL((sizeof(TIn) == 1 ? 64 : 128), 64);             \
  } while (0)

// K7 on the resident route: TIn bf16 or int8_t, TOut bf16 or int8_t.
template <typename TIn, typename TOut>
static int conv3x3_in_resident_any(const TIn* xp, const TIn* wt, TOut* out,
                                   float* pmean, float* pm2, float* gmean,
                                   float* grstd, unsigned long long* bar,
                                   int n, int h, int w, int c, int pad,
                                   int relu, float eps,
                                   float int8_k, int groups, cudaStream_t s) {
  const int tiles = (h * w + TILE_M - 1) / TILE_M;
#define DUCOSY_IN(ROWB, BN)                                                  \
  launch_in_resident<TIn, TOut, ROWB, BN>(xp, wt, out, pmean, pm2, gmean,    \
                                          grstd, bar, n, h, w, c, pad, relu,  \
                                          eps, int8_k, tiles, groups, s)
  DUCOSY_BY_WIDTH(DUCOSY_IN, TIn);
#undef DUCOSY_IN
}

// K8 on the resident route: c is 64, 128 or 256 (one block holds every
// channel of its pixels); any other c returns cudaErrorInvalidValue.
template <typename TIn>
static int conv_tail_resident_any(const TIn* tp, const TIn* wt, const bf16* x,
                                  const float* w1, const float* w2,
                                  const float* wsa, bf16* out, float* pmean,
                                  float* pm2, float* pmax, float* gmean,
                                  float* grstd, float* gmax, float* map,
                                  unsigned long long* bar, int n, int h, int w,
                                  int c, int r, int pad, int x_pad, float eps,
                                  int groups, cudaStream_t s) {
  const int tiles = (h * w + TILE_M - 1) / TILE_M;
  if ((c != 64 && c != 128 && c != 256) || w > RESIDENT_TAIL_W)
    return (int)cudaErrorInvalidValue;
#define DUCOSY_TAILR(ROWB, BN)                                               \
  launch_tail_resident<TIn, ROWB, BN>(tp, wt, x, w1, w2, wsa, out, pmean,    \
                                      pm2, pmax, gmean, grstd, gmax, map,    \
                                      bar, n, h, w, r, pad, x_pad, eps,      \
                                      tiles, groups, s)
  DUCOSY_BY_WIDTH(DUCOSY_TAILR, TIn);
#undef DUCOSY_TAILR
}

// How many blocks of the resident kernels the current device holds at once:
// its SM count times the least occupancy the runtime reports for any of
// them; 0 where the device cannot launch cooperatively.
static int resident_blocks(int* blocks) {
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  int least = coop ? INT_MAX : 0;
#define DUCOSY_OCC(TIn, ROWB, BN)                                            \
  DUCOSY_TRY(least_occupancy(conv3x3_in_resident<TIn, int8_t, ROWB, BN>,     \
                             IN_SMEM<TIn, ROWB, BN>, &least));               \
  DUCOSY_TRY(least_occupancy(conv_tail_resident<TIn, ROWB, BN>,              \
                             TAIL_SMEM<TIn, ROWB, BN>, &least))
  DUCOSY_OCC(bf16, 128, 256);
  DUCOSY_OCC(bf16, 128, 128);
  DUCOSY_OCC(bf16, 128, 64);
  DUCOSY_OCC(int8_t, 128, 256);
  DUCOSY_OCC(int8_t, 128, 128);
  DUCOSY_OCC(int8_t, 64, 64);
#undef DUCOSY_OCC
#define DUCOSY_OCC16(ROWB, BN)                                               \
  DUCOSY_TRY(least_occupancy(conv3x3_in_resident<bf16, bf16, ROWB, BN>,      \
                             IN_SMEM<bf16, ROWB, BN>, &least))
  DUCOSY_OCC16(128, 256);
  DUCOSY_OCC16(128, 128);
  DUCOSY_OCC16(128, 64);
#undef DUCOSY_OCC16
  *blocks = sms * least;
  return 0;
}

#undef DUCOSY_BY_WIDTH

}  // namespace ducosy
