// The 3x3 VALID conv tiles shared by K1/K1q/K6 (residual_chain.cu) and
// K7/K8 (conv_in.cu): an implicit GEMM over the nine shifted taps of a
// pre-padded NHWC input. The tiled kernels here write the fp32 accumulator
// to device memory with the tile's per-channel (mean, M2, max) partials,
// which finalize_stats or channel_gate later merge; the resident kernels
// (conv_resident.cuh) run the same ring and MMAs (conv_tile_mma) and the
// same partials (tile_partials) and keep the accumulator in registers.
//
// conv3x3_wgmma, the bf16 (fp32 accumulate) and int8 x int8 -> exact int32
// loop, designed for Hopper:
//   What bounds it. One conv at the trunk shape (16, 128, 128, 256 -> 256)
//   is 3.09e11 operations on ~0.3 GB: the tensor cores are the limit by far,
//   and only wgmma reaches their rate. Below them the limit is what the SMs
//   can pull from L2: a block that owns 128 pixels x BN output channels loads
//   (128 + BN) x 128 bytes per K step of 2 x 128 x BN x 64 operations, so
//   BN = 256 (one block per SM) does 85 operations per byte where 64-wide
//   tiles did 43, and the A tile is read once per tap, not once per channel
//   block.
//   Tile. TILE_M = 128 flat pixels (the partials' geometry, shared with
//   K2-K5, is unchanged) x BN = 256, 128 or 64 output channels, the widest
//   that divides C. Two warpgroups, one per 64 pixels, each holding its
//   m64 x BN accumulator in registers (128 a thread at BN = 256).
//   Operands. Both K-major in shared memory: A rows are pixels, B rows are
//   output channels (the wrappers lay bf16 weights out as (tap, cout, cin),
//   the int8 layout), each row one 128-byte swizzle atom: 64 bf16 or 128
//   int8 input channels per K step (64 int8 channels in 64-byte rows under
//   the 64-byte swizzle where C is not a multiple of 128). Four wgmma of 32
//   bytes of K per step and warpgroup, the descriptor advanced inside the
//   atom.
//   Ring. RING_STAGES = 4 stages of dynamic shared memory (48 KB each at
//   BN = 256, 192 KB in all), filled with 16-byte cp.async copies whose
//   destination carries the swizzle the descriptors name. cp.async and not
//   TMA: a tile is 128 consecutive pixels of the flattened image, which is a
//   TMA box only where the width divides 128; per-thread copies take any
//   h x w, zero-fill the rows past h*w (src-size 0), and keep the partials'
//   layout. Step kt first waits for its own stage, then one __syncthreads
//   makes every thread's copies visible and proves that all MMAs of step
//   kt - 2 have been waited for, so the stage they read is refilled with
//   step kt + 2 while the MMAs of kt - 1 and kt run: two loads and one MMA
//   group in flight, one barrier per step.
//   Epilogue. From the accumulator registers: float2 stores of full 32-byte
//   sectors, then the tile's statistics by a reduce-scatter over the eight
//   lanes that share a column (14 shuffles for 16 columns) and one pass
//   through shared memory across the eight warps: sum and max, then, with
//   the tile mean broadcast back, the centred M2. No serial row walk.
//   What is left. The ring with its MMAs runs at about two thirds of the
//   tensor cores' peak, and by count (no counter can be read on the card to
//   confirm it) shared memory is why: each warpgroup's m64n256k16
//   reads 2 KB of A and 8 KB of B in the 128 cycles it computes, 80 bytes a
//   cycle, and the copies write another 47, of the 128 bytes a cycle an SM's
//   shared memory moves. The rest of the kernel's time is its exposed ends:
//   the 128 KB fp32 store of a tile, the statistics, and filling the ring
//   (the probe below times them; PERF.md has the numbers). Tried on the card
//   and dropped: 128 x 128 tiles with two blocks an SM, so that one block's
//   epilogue overlaps the other's MMAs, ran slower (twice the B traffic from
//   L2 costs more than the overlap wins); a persistent grid that loads the
//   next tile's first stages during the epilogue ran no faster to speak of
//   and took the registers to the limit; three stages of lookahead, paid for
//   with a second barrier per step after the MMAs' wait, made the loads
//   alone faster and the loop with its MMAs slower; warp specialisation (a
//   producer warpgroup under setmaxnreg filling the ring through mbarriers,
//   up to four stages ahead, two consumer warpgroups with no block barrier
//   in the loop), with and without a persistent tile walk, ran 4-5% slower
//   at the trunk shape and up to 26% slower at narrow ragged ones: the loads
//   were not what the MMAs waited for. Not tried: TMA multicast of B over a
//   cluster, which would halve B's way from L2 but not its reads from shared
//   memory.
// conv3x3_f32 is the exact-FMA parity mode on the CUDA cores, 128 x 64 tiles
// with the epilogue staged in shared memory.
#pragma once

#include <type_traits>

#include "tile_regs.cuh"

namespace ducosy {

constexpr int BKF = 16;              // fp32 input channels per K step
constexpr int RING_STAGES = 4;
constexpr int RING_AHEAD = RING_STAGES - 2;   // stages loaded ahead of the MMAs
constexpr int RING_ALIGN = 1024;     // a swizzle atom repeats every 1024 B
// the parts of conv3x3_wgmma that the timing probe can leave out
constexpr int PART_STORE = 1, PART_STATS = 2, PART_MMA = 4, PART_ALL = 7;

// ---- PTX used by the ring and the MMAs
// orders the copies' shared-memory writes before the MMAs' reads of them
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins the accumulators between plain code and the asynchronous MMAs
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)::"memory"); }

// wgmma.mma_async m64 x BN, A and B from K-major shared-memory descriptors,
// d += a * b: bf16 (k16, fp32 accumulate) and s8 (k32, int32 accumulate).
// A thread holds BN / 2 accumulators: for each 8 columns j, d[4j + {0, 1}] is
// row 16 warp + lane / 4, columns 8j + 2 (lane % 4) + {0, 1}; d[4j + {2, 3}]
// the same columns of row + 8.
#define DUCOSY_P10(t) \
  "%" #t "0,%" #t "1,%" #t "2,%" #t "3,%" #t "4,%" #t "5,%" #t "6,%" #t "7,%" #t "8,%" #t "9"
#define DUCOSY_REGS64 DUCOSY_P10() "," DUCOSY_P10(1) "," DUCOSY_P10(2) ",%30,%31"
#define DUCOSY_REGS128                                                      \
  DUCOSY_P10() "," DUCOSY_P10(1) "," DUCOSY_P10(2) "," DUCOSY_P10(3) ","    \
  DUCOSY_P10(4) "," DUCOSY_P10(5) ",%60,%61,%62,%63"
#define DUCOSY_REGS256                                                      \
  DUCOSY_P10() "," DUCOSY_P10(1) "," DUCOSY_P10(2) "," DUCOSY_P10(3) ","    \
  DUCOSY_P10(4) "," DUCOSY_P10(5) "," DUCOSY_P10(6) "," DUCOSY_P10(7) ","   \
  DUCOSY_P10(8) "," DUCOSY_P10(9) "," DUCOSY_P10(10) "," DUCOSY_P10(11)     \
  ",%120,%121,%122,%123,%124,%125,%126,%127"
#define DUCOSY_D8(K, d, o)                                                  \
  K(d[(o)]), K(d[(o) + 1]), K(d[(o) + 2]), K(d[(o) + 3]), K(d[(o) + 4]),    \
  K(d[(o) + 5]), K(d[(o) + 6]), K(d[(o) + 7])
#define DUCOSY_D32(K, d, o)                                                 \
  DUCOSY_D8(K, d, (o)), DUCOSY_D8(K, d, (o) + 8), DUCOSY_D8(K, d, (o) + 16), \
  DUCOSY_D8(K, d, (o) + 24)
#define DUCOSY_ACC64(K, d) DUCOSY_D32(K, d, 0)
#define DUCOSY_ACC128(K, d) DUCOSY_D32(K, d, 0), DUCOSY_D32(K, d, 32)
#define DUCOSY_ACC256(K, d) \
  DUCOSY_ACC128(K, d), DUCOSY_D32(K, d, 64), DUCOSY_D32(K, d, 96)

template <int BN> struct Wgmma;
#define DUCOSY_WGMMA(BN, REGS, ACC, DA, DB, ONE)                              \
  template <> struct Wgmma<BN> {                                              \
    static __device__ __forceinline__ void mma(float (&d)[BN / 2],            \
                                               uint64_t a, uint64_t b) {      \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " ONE ", 0;\n"                     \
          "wgmma.mma_async.sync.aligned.m64n" #BN "k16.f32.bf16.bf16 {" REGS   \
          "}, " DA ", " DB ", p, 1, 1, 0, 0;\n}\n"                             \
          : ACC("+f", d)                                                      \
          : "l"(a), "l"(b), "r"(1));                                          \
    }                                                                         \
    static __device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t a,  \
                                               uint64_t b) {                  \
      asm volatile(                                                           \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " ONE ", 0;\n"                     \
          "wgmma.mma_async.sync.aligned.m64n" #BN "k32.s32.s8.s8 {" REGS       \
          "}, " DA ", " DB ", p;\n}\n"                                         \
          : ACC("+r", d)                                                      \
          : "l"(a), "l"(b), "r"(1));                                          \
    }                                                                         \
  };
DUCOSY_WGMMA(64, DUCOSY_REGS64, DUCOSY_ACC64, "%32", "%33", "%34")
DUCOSY_WGMMA(128, DUCOSY_REGS128, DUCOSY_ACC128, "%64", "%65", "%66")
DUCOSY_WGMMA(256, DUCOSY_REGS256, DUCOSY_ACC256, "%128", "%129", "%130")
#undef DUCOSY_WGMMA

// The geometry of one conv3x3_wgmma instantiation: TIn is bf16 or int8_t,
// ROWB the bytes of input channels per K step and operand row, BN the output
// channels of a block.
template <typename TIn, int ROWB, int BN> struct ConvGeom {
  using Acc = std::conditional_t<sizeof(TIn) == 1, int, float>;
  static constexpr int EPC = 16 / sizeof(TIn);   // elements per 16-byte chunk
  static constexpr int KB = ROWB / sizeof(TIn);  // input channels per K step
  static constexpr int CPR = ROWB / 16;          // chunks per operand row
  static constexpr int RPP = CONV_THREADS / CPR; // rows per load pass
  static constexpr int A_PASSES = TILE_M / RPP, B_PASSES = BN / RPP;
  static constexpr int A_BYTES = TILE_M * ROWB, STAGE = (TILE_M + BN) * ROWB;
  static constexpr int SMEM = RING_STAGES * STAGE + RING_ALIGN;
  // descriptor: start address >> 4 | LBO (unused under a swizzle) = 1 |
  // SBO = 8 rows | layout 1 = 128-byte, 2 = 64-byte swizzle
  static constexpr uint64_t DESC = (uint64_t(1) << 16) |
                                   (uint64_t(8 * ROWB / 16) << 32) |
                                   (uint64_t(ROWB == 128 ? 1 : 2) << 62);
};

// The ring and the MMAs of one tile: the 128 pixels from m0 of sample ni x
// the BN output channels from co0, summed over the nine taps into d (see the
// note at the top of the file; the accumulator layout is Wgmma's). `ring` is
// the RING_ALIGN-aligned shared address of ConvGeom::SMEM - RING_ALIGN bytes.
// Ends with every MMA waited for and a block barrier: the ring is free.
// MMA = false (the timing probes) runs the loads alone.
template <typename TIn, int ROWB, int BN, bool MMA = true>
__device__ __forceinline__ void conv_tile_mma(
    const TIn* __restrict__ xp, const TIn* __restrict__ wt,
    typename ConvGeom<TIn, ROWB, BN>::Acc (&d)[BN / 2], uint32_t ring, int ni,
    int m0, int co0, int h, int w, int c) {
  using G = ConvGeom<TIn, ROWB, BN>;
  constexpr int EPC = G::EPC, KB = G::KB, CPR = G::CPR, RPP = G::RPP;
  constexpr int A_PASSES = G::A_PASSES, B_PASSES = G::B_PASSES;
  constexpr int A_BYTES = G::A_BYTES, STAGE = G::STAGE;
  constexpr uint64_t DESC = G::DESC;
  const int tid = threadIdx.x, warp = tid / 32;
  const int hw = h * w, wp = w + 2;

  // loads: this thread copies chunk ld_chunk of rows ld_row + i RPP, to the
  // swizzled place: chunk ^ (row % 8) in 128-byte rows, chunk ^ (row / 2 % 4)
  // in 64-byte rows (RPP is a multiple of 8: the same for every pass)
  const int ld_row = tid / CPR, ld_chunk = tid % CPR;
  const int sw = ROWB == 128 ? ld_row & 7 : (ld_row >> 1) & 3;
  const uint32_t dst0 = ring + ld_row * ROWB + ((ld_chunk ^ sw) << 4);
  const TIn* xs = xp + (size_t)ni * (h + 2) * wp * c + ld_chunk * EPC;
  int a_off[A_PASSES];
  bool a_ok[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const int m = m0 + ld_row + i * RPP;
    a_ok[i] = m < hw;
    a_off[i] = a_ok[i] ? ((m / w) * wp + m % w) * c : 0;
  }
  const TIn* ws = wt + (size_t)(co0 + ld_row) * c + ld_chunk * EPC;

  int ld_tap = 0, ld_k0 = 0, ld_slot = 0;
  auto load_stage = [&]() {
    const uint32_t dst = dst0 + ld_slot * STAGE;
    const TIn* a = xs + ((ld_tap / 3) * wp + ld_tap % 3) * c + ld_k0;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i)
      cp_async16(dst + i * RPP * ROWB, a + a_off[i], a_ok[i]);
    const TIn* b = ws + (size_t)ld_tap * c * c + ld_k0;
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i)
      cp_async16(dst + A_BYTES + i * RPP * ROWB, b + (size_t)i * RPP * c, true);
    ld_k0 += KB;
    if (ld_k0 == c) { ld_k0 = 0; ++ld_tap; }
    ld_slot = ld_slot + 1 == RING_STAGES ? 0 : ld_slot + 1;
  };

#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;

  const int steps = 9 * (c / KB);                // >= 9 > RING_AHEAD
#pragma unroll
  for (int s = 0; s < RING_AHEAD; ++s) {
    load_stage();
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) pin(d[i]);
  // this warpgroup's 64 A rows, and the B rows, of stage 0
  const uint32_t a0 = ring + (warp / 4) * 64 * ROWB, b0 = ring + A_BYTES;
  int slot = 0;
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<RING_AHEAD - 1>();             // this thread's part of kt
    fence_async_proxy();
    __syncthreads();    // all of stage kt landed; MMAs of kt - 2 all waited for
    if (kt + RING_AHEAD < steps) load_stage();
    cp_async_commit();
    if constexpr (MMA) {
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < ROWB / 32; ++k)
        Wgmma<BN>::mma(d,
                       DESC | (((a0 + slot * STAGE + k * 32) & 0x3FFFF) >> 4),
                       DESC | (((b0 + slot * STAGE + k * 32) & 0x3FFFF) >> 4));
      wgmma_commit();
      wgmma_wait<1>();                           // the MMAs of kt - 1 are done
    }
    slot = slot + 1 == RING_STAGES ? 0 : slot + 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) pin(d[i]);
  __syncthreads();                               // the ring is free
}

// 3x3 VALID conv on the tensor cores, fp32 out. TIn is bf16 (fp32
// accumulate) or int8_t (shifted-grid activations x per-channel weights,
// exact int32). xp (n, h+2, w+2, c); wt (9, c, c) as (tap, cout, cin). ROWB:
// bytes of input channels per K step and operand row (128, or 64 for int8
// where c % 128 != 0). Grid (c / BN, tiles, n), CONV_THREADS threads,
// ConvGeom::SMEM bytes of dynamic shared memory. See the note at the top of
// the file. PARTS is PART_ALL everywhere but in the timing probe
// (ducosy_conv3x3_probe), which compiles parts out.
template <typename TIn, int ROWB, int BN, int PARTS = PART_ALL>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv3x3_wgmma(const TIn* __restrict__ xp, const TIn* __restrict__ wt,
              float* __restrict__ acc, float* __restrict__ pmean,
              float* __restrict__ pm2, float* __restrict__ pmax, int h, int w,
              int c) {
  using Acc = typename ConvGeom<TIn, ROWB, BN>::Acc;
  constexpr int NB = BN / 8;                     // 8-column groups
  extern __shared__ unsigned char ring_raw[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int co0 = blockIdx.x * BN, tile = blockIdx.y, ni = blockIdx.z;
  const int hw = h * w, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);
  const uint32_t ring =
      (smem_u32(ring_raw) + RING_ALIGN - 1) & ~uint32_t(RING_ALIGN - 1);

  Acc d[BN / 2];
  conv_tile_mma<TIn, ROWB, BN, (PARTS & PART_MMA) != 0>(xp, wt, d, ring, ni,
                                                        m0, co0, h, w, c);

  // ---- epilogue, from the registers. This thread's rows r0 and r0 + 8.
  float* red = reinterpret_cast<float*>(ring_raw + (ring - smem_u32(ring_raw)));
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;
  float* o0 = acc + ((size_t)ni * hw + m0 + r0) * c + co0 + cq;
  float* o1 = o0 + (size_t)8 * c;
  // (the probe without the store keeps the branch, never taken: h > 0; with
  // no reader of the accumulators the assembler drops the MMAs)
  if ((PARTS & PART_STORE) || h < 0) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (ok0)
        *reinterpret_cast<float2*>(o0 + j * 8) =
            make_float2((float)d[4 * j], (float)d[4 * j + 1]);
      if (ok1)
        *reinterpret_cast<float2*>(o1 + j * 8) =
            make_float2((float)d[4 * j + 2], (float)d[4 * j + 3]);
    }
  }
  if constexpr (PARTS & PART_STATS) {
    const size_t pbase = ((size_t)ni * gridDim.y + tile) * c + co0;
    tile_partials<BN>(d, red, rows, pmean + pbase, pm2 + pbase,
                      pmax ? pmax + pbase : nullptr);
  }
}

// Epilogue of conv3x3_f32: the accumulator tile is in cs (fp32, row = pixel,
// column = output channel). Write it to acc (n, h*w, c) and emit the tile's
// per-channel partials.
__device__ __forceinline__ void conv_epilogue(const float* cs, int rows,
                                              float* acc, float* pmean,
                                              float* pm2, float* pmax,
                                              int ni, int tile, int tiles,
                                              int m0, int co0, int hw, int c) {
  for (int i = threadIdx.x; i < TILE_M * (TILE_N / 4); i += CONV_THREADS) {
    const int r = i / (TILE_N / 4), v = i % (TILE_N / 4);
    if (r < rows) {
      const float4 val = *reinterpret_cast<const float4*>(cs + r * CS_LD + v * 4);
      *reinterpret_cast<float4*>(acc + ((size_t)ni * hw + m0 + r) * c + co0 +
                                 v * 4) = val;
    }
  }
  tile_stats(cs, rows, pmean, pm2, pmax, ((size_t)ni * tiles + tile) * c + co0);
}

// 3x3 VALID conv in exact fp32 (FMA on the CUDA cores): the parity mode.
// xp (n, h+2, w+2, c); wt (9*c, c) as (tap, cin, cout). Grid (c / TILE_N,
// tiles, n); a block owns 128 pixels x 64 channels, each thread 8 pixels x
// 4 channels.
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_f32(const float* __restrict__ xp, const float* __restrict__ wt,
            float* __restrict__ acc, float* __restrict__ pmean,
            float* __restrict__ pm2, float* __restrict__ pmax, int h, int w,
            int c) {
  __shared__ __align__(128) unsigned char smem[TILE_SMEM];
  float* as = reinterpret_cast<float*>(smem);         // BKF x TILE_M (k-major)
  float* bs = as + BKF * TILE_M;                       // BKF x TILE_N
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int co0 = blockIdx.x * TILE_N, tile = blockIdx.y, ni = blockIdx.z;
  const int hw = h * w, wp = w + 2, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);

  const int a_row = tid / 4, a_vec = tid % 4;         // rows a_row, a_row+64
  const float* a_src[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + a_row + 64 * i;
    a_ok[i] = m < hw;
    const int mm = a_ok[i] ? m : 0;
    a_src[i] = xp + (((size_t)ni * (h + 2) + mm / w) * wp + mm % w) * c +
               a_vec * 4;
  }
  const int b_row = tid / 16, b_vec = tid % 16;

  float r[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) r[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const size_t tap_off = ((size_t)(tap / 3) * wp + tap % 3) * c;
    for (int k0 = 0; k0 < c; k0 += BKF) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a_ok[i]) v = *reinterpret_cast<const float4*>(a_src[i] + tap_off + k0);
        const int m = a_row + 64 * i, k = a_vec * 4;
        as[(k + 0) * TILE_M + m] = v.x;
        as[(k + 1) * TILE_M + m] = v.y;
        as[(k + 2) * TILE_M + m] = v.z;
        as[(k + 3) * TILE_M + m] = v.w;
      }
      *reinterpret_cast<float4*>(bs + b_row * TILE_N + b_vec * 4) =
          *reinterpret_cast<const float4*>(
              wt + ((size_t)tap * c + k0 + b_row) * c + co0 + b_vec * 4);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BKF; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + k * TILE_M + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(as + k * TILE_M + ty * 8 + 4);
        const float4 b = *reinterpret_cast<const float4*>(bs + k * TILE_N + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) r[i][j] = fmaf(av[i], bv[j], r[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(cs + (ty * 8 + i) * CS_LD + tx * 4) =
        make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);
  __syncthreads();
  conv_epilogue(cs, rows, acc, pmean, pm2, pmax, ni, tile, gridDim.y, m0, co0,
                hw, c);
}

// Launch of one conv3x3_wgmma instantiation. The shared-memory limit of the
// kernel is raised once a device; its error, like a refused launch's, is
// returned.
// static: each library that includes this header has its own copy of the
// kernel and must raise its own limit, and the once-flag of a function with
// external linkage would be one symbol for all libraries of the process.
template <typename TIn, int ROWB, int BN, int PARTS = PART_ALL>
static int launch_wgmma(const TIn* xp, const TIn* wt, float* acc, float* pmean,
                 float* pm2, float* pmax, int n, int h, int w, int c,
                 int tiles, cudaStream_t s) {
  constexpr int smem = ConvGeom<TIn, ROWB, BN>::SMEM;
  static DeviceFlags raised;
  DUCOSY_TRY(once_per_device(raised, [&] {
    return cudaFuncSetAttribute(conv3x3_wgmma<TIn, ROWB, BN, PARTS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  }));
  conv3x3_wgmma<TIn, ROWB, BN, PARTS>
      <<<dim3(c / BN, tiles, n), CONV_THREADS, smem, s>>>(
          xp, wt, acc, pmean, pm2, pmax, h, w, c);
  return (int)cudaGetLastError();
}

// The conv of a float or bf16 input: wt (tap, cin, cout) for float,
// (tap, cout, cin) for bf16. c a multiple of 64. Returns the launch's
// error, or 0.
template <typename T>
int launch_conv(const T* xp, const T* wt, float* acc, float* pmean,
                float* pm2, float* pmax, int n, int h, int w, int c,
                int tiles, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (c % 256 == 0)
      return launch_wgmma<T, 128, 256>(xp, wt, acc, pmean, pm2, pmax, n, h, w,
                                       c, tiles, s);
    if (c % 128 == 0)
      return launch_wgmma<T, 128, 128>(xp, wt, acc, pmean, pm2, pmax, n, h, w,
                                       c, tiles, s);
    return launch_wgmma<T, 128, 64>(xp, wt, acc, pmean, pm2, pmax, n, h, w, c,
                                    tiles, s);
  } else {
    conv3x3_f32<<<dim3(c / TILE_N, tiles, n), CONV_THREADS, 0, s>>>(
        xp, wt, acc, pmean, pm2, pmax, h, w, c);
    return (int)cudaGetLastError();
  }
}

// The int8 conv: xp shifted-grid int8, wt int8 as (tap, cout, cin).
inline int launch_conv_int8(const int8_t* xp, const int8_t* wt, float* acc,
                            float* pmean, float* pm2, float* pmax, int n,
                            int h, int w, int c, int tiles, cudaStream_t s) {
  if (c % 256 == 0)
    return launch_wgmma<int8_t, 128, 256>(xp, wt, acc, pmean, pm2, pmax, n, h,
                                          w, c, tiles, s);
  if (c % 128 == 0)
    return launch_wgmma<int8_t, 128, 128>(xp, wt, acc, pmean, pm2, pmax, n, h,
                                          w, c, tiles, s);
  return launch_wgmma<int8_t, 64, 64>(xp, wt, acc, pmean, pm2, pmax, n, h, w,
                                      c, tiles, s);
}

}  // namespace ducosy
