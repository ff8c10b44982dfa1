// What the conv loop (conv3x3.cuh) and the sample-resident tails
// (tail_resident.cuh: K4, K5, K8) share without the loop itself: the block
// size, the cp.async copies, and the per-channel partials of a 128-pixel
// tile held in registers in the wgmma accumulator layout (a thread holds
// rows 16 warp + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0, 1}; see
// Wgmma in conv3x3.cuh). Kept apart so that a library with a resident tail
// and no conv (block_tail.cu, block_tail_bwd.cu) builds none of the loop.
#pragma once

#include "common.cuh"

namespace ducosy {

constexpr int CONV_THREADS = 256;    // two warpgroups

// ---- PTX of the shared-memory copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; zero-fills when !ok (src is
// still a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One reduce-scatter step over the lane bit BIT: the LEN values of s are
// halved, the lane with the bit clear keeping the lower half's sums (or
// maxima) over both lanes, its partner the upper half's.
template <int LEN, int BIT, bool MAX>
__device__ __forceinline__ void scatter_step(float (&s)[16], int lane) {
  const bool hi = lane & BIT;
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float send = hi ? s[i] : s[i + LEN / 2];
    const float keep = hi ? s[i + LEN / 2] : s[i];
    const float recv = __shfl_xor_sync(0xffffffffu, send, BIT);
    s[i] = MAX ? fmaxf(keep, recv) : keep + recv;
  }
}

// s holds, for this thread's two rows, 16 column values of one 64-column
// chunk (index 2 jj + e is column 8 jj + 2 (lane % 4) + e). Reduces over
// the warp's 16 rows; lane l ends with columns 2 l and 2 l + 1 of the chunk
// in s[0], s[1].
template <bool MAX>
__device__ __forceinline__ void warp_columns(float (&s)[16], int lane) {
  scatter_step<16, 16, MAX>(s, lane);
  scatter_step<8, 8, MAX>(s, lane);
  scatter_step<4, 4, MAX>(s, lane);
}

// The tile's per-channel partials from the accumulator registers: mean, M2
// and (if pmax) max over the tile's `rows` valid pixels, written at
// pmean[k], pm2[k], pmax[k] for the block's channels k < BN (the pointers
// already at the tile's first channel). `red` is 17 BN floats of shared
// memory that nothing else uses meanwhile; its last BN floats keep the tile
// means. A reduce-scatter over the eight lanes that share a column, then one
// pass through shared memory across the eight warps: sum and max, then, with
// the tile mean broadcast back, the centred M2.
template <int BN, typename Acc>
__device__ __forceinline__ void tile_partials(const Acc (&d)[BN / 2],
                                              float* red, int rows,
                                              float* pmean, float* pm2,
                                              float* pmax) {
  constexpr int CHUNKS = BN / 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* redx = red + 8 * BN;                    // [8 warps][BN] maxima
  float* tmean = redx + 8 * BN;                  // [BN] tile means
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    float s[16], mx[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int at = (8 * q + i / 2) * 4 + i % 2;
      const float v0 = (float)d[at], v1 = (float)d[at + 2];
      s[i] = (ok0 ? v0 : 0.f) + (ok1 ? v1 : 0.f);
      mx[i] = fmaxf(ok0 ? v0 : -INFINITY, ok1 ? v1 : -INFINITY);
    }
    warp_columns<false>(s, lane);
    *reinterpret_cast<float2*>(red + warp * BN + 64 * q + 2 * lane) =
        make_float2(s[0], s[1]);
    if (pmax) {
      warp_columns<true>(mx, lane);
      *reinterpret_cast<float2*>(redx + warp * BN + 64 * q + 2 * lane) =
          make_float2(mx[0], mx[1]);
    }
  }
  __syncthreads();
  if (tid < BN) {
    float t = 0.f, x = -INFINITY;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k * BN + tid];
    tmean[tid] = pmean[tid] = t / rows;
    if (pmax) {
#pragma unroll
      for (int k = 0; k < 8; ++k) x = fmaxf(x, redx[k * BN + tid]);
      pmax[tid] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int at = (8 * q + i / 2) * 4 + i % 2;
      const float m = tmean[64 * q + (i / 2) * 8 + cq + i % 2];
      const float e0 = (float)d[at] - m, e1 = (float)d[at + 2] - m;
      s[i] = (ok0 ? e0 * e0 : 0.f) + (ok1 ? e1 * e1 : 0.f);
    }
    warp_columns<false>(s, lane);
    *reinterpret_cast<float2*>(red + warp * BN + 64 * q + 2 * lane) =
        make_float2(s[0], s[1]);
  }
  __syncthreads();
  if (tid < BN) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k * BN + tid];
    pm2[tid] = t;
  }
}

}  // namespace ducosy
