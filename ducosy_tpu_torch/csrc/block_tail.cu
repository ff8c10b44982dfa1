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
// written per element (h, x's interior and the output once each): memory.
// At (8, 128, 128, 256) bf16 that is 206 MB, 0.061 ms at 3.35 TB/s.
//
// Two routes, which the wrapper picks from shape, dtype and the device's
// co-resident block count (ops/kernels/block_tail.py, tail_route):
//   resident (block_tail_resident, bf16, C = 64, 128 or 256, W <= 256, a
//     sample's 128-pixel tiles all on the card at once): one cooperative
//     launch. A block owns 128 pixels x all C channels of a sample, copies
//     its tile of h with 16-byte cp.async into shared memory and from there
//     into the registers in the layout of K8's conv accumulator, and runs
//     K8's epilogue unchanged (tail_resident.cuh: tile partials, a grid
//     barrier, the channel-split merge, the channel gate in every block, the
//     (mean, max) map in L2, a grid barrier, the 7x7 gate over staged map
//     rows, the skip from x's interior and the reflect-padded 16-byte
//     write). h, x's interior and the output each cross device memory once;
//     x's tile is sent right behind h's, so it lands while the statistics
//     settle. The next sample's tile of h is prefetched into the L2 during
//     the epilogue: a second tile buffer (64 KB) does not fit beside the
//     epilogue's 173 KB of shared memory.
//   tiled (the original three launches, everything else: fp32, C = 192, ragged
//     widths, more tiles than the card holds): the kernels are K1's
//     (cbam_tail.cuh):
//     1. tile statistics of h: per 128-pixel x 64-channel tile, (mean, M2,
//        max) of the io-dtype values in fp32;
//     2. channel gate: Chan-merge -> mean, rstd; max pool of y = IN(max h)
//        exactly; MLP; sigmoid;
//     3. spatial tail: channel mean/max of t over a 16x32 tile plus a halo
//        of 3, the 7x7 conv, sigmoid, the skip from x's interior and the
//        reflect-padded write. h is read about 3.6 times.
// Rounding: y = bf16((h - mean) * rstd) with fp32 mean and rstd. The TPU
// kernel rounds mean and rstd to the io dtype first and normalizes in it,
// (h - bf16(mean)) * bf16(rstd) (cbam_block.py:44-58); the port rounds
// once instead, as the plain version (_xla_block_tail's composition) and
// K1 do, so the kernel, its plain version and K5's recompute of y agree
// and the max-pool tie masks of the backward see the forward's y. Its
// statistics are centred (Chan) where the TPU kernel's are E[h^2]-E[h]^2.
// The avg-pool path of the channel gate is zero, as in K1.
#include <limits.h>

#include "tail_resident.cuh"

namespace ducosy {
namespace {

template <typename T>
int block_tail(const T* h, const T* x, const float* w1, const float* w2,
               const float* wsa, T* out, float* pmean, float* pm2,
               float* pmax, float* mean, float* rstd, float* gate, int n,
               int hh, int ww, int c, int r, int pad, int x_pad, float eps,
               int parts, cudaStream_t s) {
  const int hw = hh * ww, tiles = (hw + TILE_M - 1) / TILE_M;
  if (parts & 1) {
    tile_stats_kernel<T><<<dim3(c / TILE_N, tiles, n), STATS_THREADS, 0, s>>>(
        h, pmean, pm2, pmax, hw, c);
    DUCOSY_CHECK_LAUNCH();
  }
  if (parts & 2) {
    channel_gate<T><<<n, c, (c + r) * sizeof(float), s>>>(
        pmean, pm2, pmax, w1, w2, mean, rstd, nullptr, gate, tiles, hw, c, r,
        eps);
    DUCOSY_CHECK_LAUNCH();
  }
  if (parts & 4) {
    const dim3 tgrid((ww + TAIL_TW - 1) / TAIL_TW,
                     (hh + TAIL_TH - 1) / TAIL_TH, n);
    spatial_tail<T, T><<<tgrid, TAIL_THREADS, 3 * c * sizeof(float), s>>>(
        h, mean, rstd, gate, x, wsa, out, hh, ww, c, pad, x_pad);
    DUCOSY_CHECK_LAUNCH();
  }
  return 0;
}

// The resident kernel's dynamic shared memory: K8's epilogue, then the
// tile's pixels. h's tile lands in the epilogue's stage for t first.
template <int BN>
constexpr int K4_SMEM = ResidentSmem<BN>::TAIL_BYTES + PIX_BYTES;

// K4, resident, bf16, c == BN. h (n, hh*ww, c), x (n, hh+2 x_pad, ww+2 x_pad,
// c), out (n, hh+2 pad, ww+2 pad, c); w1 (c, r), w2 (r, c), wsa (2 x 49)
// fp32. Scratch: pmean / pm2 / pmax (n, tiles, c), gmean / grstd / gmax
// (n, c), map (n, hh*ww, 2) fp32; bar one zeroed barrier word per group.
// Cooperative launch, grid (1, tiles, groups), CONV_THREADS threads,
// K4_SMEM bytes. PARTS as K8's probe: 1 the load of h and the tile
// partials, 2 the barriers, merges and gate, 4 the rest of the epilogue.
template <int BN, int PARTS = RPART_ALL>
__global__ void __launch_bounds__(CONV_THREADS, 1)
block_tail_resident(const bf16* __restrict__ h, const bf16* __restrict__ x,
                    const float* __restrict__ w1, const float* __restrict__ w2,
                    const float* __restrict__ wsa, bf16* __restrict__ out,
                    float* pmean, float* pm2, float* pmax, float* gmean,
                    float* grstd, float* gmax, float* map,
                    unsigned long long* bar, int n, int hh, int ww, int r,
                    int pad, int x_pad, float eps) {
  using S = ResidentSmem<BN>;
  constexpr int LD = S::template LD<sizeof(bf16)>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem + S::STAGE_BYTE;                 // x's tile
  unsigned char* hs = xs + TILE_M * LD;                     // the t stage
  int2* pix = reinterpret_cast<int2*>(smem + S::TAIL_BYTES);
  const int tile = blockIdx.y, tiles = gridDim.y;
  const int hw = hh * ww, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);
  const unsigned nblocks = gridDim.x * gridDim.y;
  const int bid = blockIdx.y * gridDim.x + blockIdx.x;
  unsigned long long target = 0;    // the barrier's, kept by thread 0
  fill_pixels(pix, m0, ww);

  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    float d[BN / 2];
    if constexpr (PARTS & RPART_MMA) {
      copy_tile_async<BN, LD>(hs, h + ((size_t)ni * hw + m0) * BN, rows);
      // x's tile behind h's: it lands while the statistics settle
      if constexpr (PARTS & RPART_EPI)
        copy_x_async<BN>(xs, x, pix, ni, rows, hh, ww, x_pad);
      if (ni + (int)gridDim.z < n)
        prefetch_l2(h + ((size_t)(ni + gridDim.z) * hw + m0) * BN,
                    (size_t)rows * BN * sizeof(bf16));
      if constexpr (PARTS & RPART_EPI) cp_async_wait<1>();   // h's tile
      else cp_async_wait<0>();
      __syncthreads();
      tile_to_regs<BN, LD>(hs, d);
      __syncthreads();   // the stage is the epilogue's again
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = (float)(hh + i);
      if constexpr (PARTS & RPART_EPI)
        copy_x_async<BN>(xs, x, pix, ni, rows, hh, ww, x_pad);
    }
    tail_epilogue<BN, PARTS, true>(d, smem, pix, x, w1, w2, wsa, out, pmean,
                                   pm2, pmax, gmean, grstd, gmax, map,
                                   bar + blockIdx.z, nblocks, target, bid, ni,
                                   tile, tiles, hh, ww, r, pad, x_pad, eps);
    __syncthreads();   // the shared memory is free for the next sample
  }
}

template <int BN, int PARTS = RPART_ALL>
static int launch_resident(const bf16* h, const bf16* x, const float* w1,
                           const float* w2, const float* wsa, bf16* out,
                           float* pmean, float* pm2, float* pmax, float* gmean,
                           float* grstd, float* gmax, float* map,
                           unsigned long long* bar, int n, int hh, int ww,
                           int r, int pad, int x_pad, float eps, int groups,
                           cudaStream_t s) {
  constexpr int smem = K4_SMEM<BN>;
  auto kernel = block_tail_resident<BN, PARTS>;
  static DeviceFlags raised;
  DUCOSY_TRY(once_per_device(raised, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }));
  const int tiles = (hh * ww + TILE_M - 1) / TILE_M;
  void* args[] = {&h,     &x,    &w1,  &w2,  &wsa, &out, &pmean, &pm2,
                  &pmax,  &gmean, &grstd, &gmax, &map, &bar, &n,    &hh,
                  &ww,    &r,    &pad, &x_pad, &eps};
  return launch_cooperative(kernel, dim3(1, tiles, groups), smem, args, s);
}

}  // namespace
}  // namespace ducosy

// The tiled route. h (n, hh, ww, c), x (n, hh+2x_pad, ww+2x_pad, c) -> out
// (n, hh+2pad, ww+2pad, c), all the io dtype; w1 (c, r), w2 (r, c), wsa
// (2*49: avg taps then max taps) fp32. Scratch: pmean/pm2/pmax
// (n, tiles, c), mean/rstd/gate (n, c), fp32. `parts` (7 for the tail)
// sums the launches to run: 1 tile statistics, 2 channel gate, 4 spatial
// tail (a part alone reads what the others would have left in scratch: for
// timing only). Returns cudaGetLastError() of the first failing launch, or
// 0. Launches on `stream`, no sync.
extern "C" int ducosy_block_tail(const void* h, const void* x, const float* w1,
                                 const float* w2, const float* wsa, void* out,
                                 float* pmean, float* pm2, float* pmax,
                                 float* mean, float* rstd, float* gate, int n,
                                 int hh, int ww, int c, int r, int pad,
                                 int x_pad, float eps, int is_bf16, int parts,
                                 void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return block_tail<bf16>(static_cast<const bf16*>(h),
                            static_cast<const bf16*>(x), w1, w2, wsa,
                            static_cast<bf16*>(out), pmean, pm2, pmax, mean,
                            rstd, gate, n, hh, ww, c, r, pad, x_pad, eps,
                            parts, s);
  return block_tail<float>(static_cast<const float*>(h),
                           static_cast<const float*>(x), w1, w2, wsa,
                           static_cast<float*>(out), pmean, pm2, pmax, mean,
                           rstd, gate, n, hh, ww, c, r, pad, x_pad, eps,
                           parts, s);
}

// The resident route: bf16 h, x, out as above, c 64, 128 or 256, ww <= 256;
// scratch pmean/pm2/pmax (n, tiles, c), gmean/grstd/gmax (n, c), map
// (n, hh*ww, 2) fp32 and bar, `groups` zeroed barrier words (one per group
// of blocks; a word serves one tile count for ever). groups * tiles blocks
// must be resident at once. `parts` 7, or at c = 256 any of 1-7 to time
// the kernel with parts compiled out (K8's probe bits). Returns the launch
// status (a refused cooperative launch is an error, never a fallback).
extern "C" int ducosy_block_tail_resident(
    const void* h, const void* x, const float* w1, const float* w2,
    const float* wsa, void* out, float* pmean, float* pm2, float* pmax,
    float* gmean, float* grstd, float* gmax, float* map,
    unsigned long long* bar, int n, int hh, int ww, int c, int r, int pad,
    int x_pad, float eps, int groups, int parts, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  if (ww > RESIDENT_TAIL_W || parts < 1 || parts > 7 ||
      (parts != RPART_ALL && c != 256))
    return (int)cudaErrorInvalidValue;
#define DUCOSY_K4R(BN, P)                                                     \
  launch_resident<BN, P>(hb, xb, w1, w2, wsa, ob, pmean, pm2, pmax, gmean,    \
                         grstd, gmax, map, bar, n, hh, ww, r, pad, x_pad, eps, \
                         groups, s)
  if (parts == RPART_ALL) {
    if (c == 256) return DUCOSY_K4R(256, RPART_ALL);
    if (c == 128) return DUCOSY_K4R(128, RPART_ALL);
    if (c == 64) return DUCOSY_K4R(64, RPART_ALL);
    return (int)cudaErrorInvalidValue;
  }
  switch (parts) {
    case 1: return DUCOSY_K4R(256, 1);
    case 2: return DUCOSY_K4R(256, 2);
    case 3: return DUCOSY_K4R(256, 3);
    case 4: return DUCOSY_K4R(256, 4);
    case 5: return DUCOSY_K4R(256, 5);
    default: return DUCOSY_K4R(256, 6);
  }
#undef DUCOSY_K4R
}

// How many blocks of the resident kernel the current device holds at once:
// its SM count times the least occupancy of the three widths; 0 where the
// device cannot launch cooperatively.
extern "C" int ducosy_block_tail_resident_blocks(int* blocks) {
  using namespace ducosy;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  int least = coop ? INT_MAX : 0;
  DUCOSY_TRY(least_occupancy(block_tail_resident<256>, K4_SMEM<256>, &least));
  DUCOSY_TRY(least_occupancy(block_tail_resident<128>, K4_SMEM<128>, &least));
  DUCOSY_TRY(least_occupancy(block_tail_resident<64>, K4_SMEM<64>, &least));
  *blocks = sms * least;
  return 0;
}
