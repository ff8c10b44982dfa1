// The 3x3 VALID conv tiles shared by K1/K1q/K6 (residual_chain.cu) and
// K7/K8 (conv_in.cu): an implicit GEMM of 128 pixels x 64 output channels
// over the nine shifted taps of a pre-padded NHWC input, in bf16 (WMMA,
// fp32 accumulate), exact fp32 (FMA on the CUDA cores) or int8 x int8 ->
// exact int32 (mma.sync s8). Every variant ends in conv_epilogue: the fp32
// accumulator goes to device memory with the tile's per-channel (mean, M2,
// max) partials, which finalize_stats or channel_gate later merge. See the
// design note in residual_chain.cu.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace ducosy {

using namespace nvcuda;

constexpr int CONV_THREADS = 256;
constexpr int BK = 32;               // bf16 input channels per K step
constexpr int AS_LD = BK + 8;        // bf16 row stride of the A tile (80 B)
constexpr int BS_LD = TILE_N + 8;    // bf16 row stride of the B tile (144 B)
constexpr int BKF = 16;              // fp32 input channels per K step

// Epilogue shared by both convs: the accumulator tile is in cs (fp32,
// row = pixel, column = output channel). Write it to acc (n, h*w, c) and
// emit the tile's per-channel partials.
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

// 3x3 VALID conv, bf16 in, fp32 out. xp (n, h+2, w+2, c); wt (9*c, c) as
// (tap, cin, cout). Grid (c / TILE_N, tiles, n); 8 warps as 4 (pixels) x
// 2 (channels), each warp a 32x32 block of 2x2 WMMA fragments.
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_bf16(const bf16* __restrict__ xp, const bf16* __restrict__ wt,
             float* __restrict__ acc, float* __restrict__ pmean,
             float* __restrict__ pm2, float* __restrict__ pmax, int h, int w,
             int c) {
  __shared__ __align__(128) unsigned char smem[TILE_SMEM];
  bf16* as = reinterpret_cast<bf16*>(smem);          // TILE_M x AS_LD
  bf16* bs = as + TILE_M * AS_LD;                     // BK x BS_LD
  float* cs = reinterpret_cast<float*>(smem);         // aliases as/bs after

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int co0 = blockIdx.x * TILE_N, tile = blockIdx.y, ni = blockIdx.z;
  const int hw = h * w, wp = w + 2, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);

  // A loads: rows tid/4 and tid/4 + 64 of the tile, 16-byte vector tid%4
  const int a_row = tid / 4, a_vec = tid % 4;
  const bf16* a_src[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + a_row + 64 * i;
    a_ok[i] = m < hw;
    const int mm = a_ok[i] ? m : 0;
    a_src[i] = xp + (((size_t)ni * (h + 2) + mm / w) * wp + mm % w) * c +
               a_vec * 8;
  }
  // B loads: row tid/8 of the K step, 16-byte vector tid%8
  const int b_row = tid / 8, b_vec = tid % 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(fc[i][j], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const size_t tap_off = ((size_t)(tap / 3) * wp + tap % 3) * c;
    for (int k0 = 0; k0 < c; k0 += BK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (a_ok[i]) v = *reinterpret_cast<const uint4*>(a_src[i] + tap_off + k0);
        *reinterpret_cast<uint4*>(as + (a_row + 64 * i) * AS_LD + a_vec * 8) = v;
      }
      *reinterpret_cast<uint4*>(bs + b_row * BS_LD + b_vec * 8) =
          *reinterpret_cast<const uint4*>(
              wt + ((size_t)tap * c + k0 + b_row) * c + co0 + b_vec * 8);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * AS_LD + kk,
                                 AS_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * BS_LD + wn * 32 + j * 16,
                                 BS_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(fc[i][j], fa[i], fb[j], fc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * CS_LD + wn * 32 + j * 16,
                              fc[i][j], CS_LD, wmma::mem_row_major);
  __syncthreads();
  conv_epilogue(cs, rows, acc, pmean, pm2, pmax, ni, tile, gridDim.y, m0, co0,
                hw, c);
}

// 3x3 VALID conv in exact fp32 (FMA on the CUDA cores): the parity mode.
// Same tiling as the bf16 kernel; each thread owns 8 pixels x 4 channels.
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

// K1q's conv2: 3x3 VALID conv, int8 x int8 -> exact int32 on the tensor
// cores, fp32 out. xp (n, h+2, w+2, c) shifted-grid int8; wt (9, c, c) as
// (tap, cout, cin): each output channel's input channels contiguous, the
// column-major B operand of mma.sync. Same tiling as conv3x3_bf16: grid
// (c / TILE_N, tiles, n), 8 warps as 4 (pixels) x 2 (channels), each warp
// 32 x 32 as 2 x 4 m16n8 tiles; K steps of 64 channels, one 16-byte load
// per thread and operand row segment.
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_int8(const int8_t* __restrict__ xp, const int8_t* __restrict__ wt,
             float* __restrict__ acc, float* __restrict__ pmean,
             float* __restrict__ pm2, float* __restrict__ pmax, int h, int w,
             int c) {
  __shared__ __align__(128) unsigned char smem[TILE_SMEM];
  int8_t* as = reinterpret_cast<int8_t*>(smem);       // TILE_M x LD8
  int8_t* bs = as + TILE_M * LD8;                      // TILE_N x LD8
  float* cs = reinterpret_cast<float*>(smem);          // aliases as/bs after

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane / 4, tg = lane % 4;               // fragment coordinates
  const int co0 = blockIdx.x * TILE_N, tile = blockIdx.y, ni = blockIdx.z;
  const int hw = h * w, wp = w + 2, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);

  // A loads: rows tid/4 and tid/4 + 64, 16-byte vector tid%4; B loads:
  // output channel tid/4, 16-byte vector tid%4
  const int a_row = tid / 4, a_vec = tid % 4;
  const int8_t* a_src[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + a_row + 64 * i;
    a_ok[i] = m < hw;
    const int mm = a_ok[i] ? m : 0;
    a_src[i] = xp + (((size_t)ni * (h + 2) + mm / w) * wp + mm % w) * c +
               a_vec * 16;
  }
  const int8_t* b_src = wt + (size_t)(co0 + a_row) * c + a_vec * 16;

  int d[2][4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const size_t tap_off = ((size_t)(tap / 3) * wp + tap % 3) * c;
    for (int k0 = 0; k0 < c; k0 += BK8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (a_ok[i]) v = *reinterpret_cast<const uint4*>(a_src[i] + tap_off + k0);
        *reinterpret_cast<uint4*>(as + (a_row + 64 * i) * LD8 + a_vec * 16) = v;
      }
      *reinterpret_cast<uint4*>(bs + a_row * LD8 + a_vec * 16) =
          *reinterpret_cast<const uint4*>(b_src + (size_t)tap * c * c + k0);
      __syncthreads();
      warp_mma_s8_step(as, bs, wm, wn, lane, d);
      __syncthreads();
    }
  }
  // the int32 accumulators to fp32, at their (pixel, channel) in cs
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 32 + i * 16 + g, col = wn * 32 + j * 8 + tg * 2;
      cs[r * CS_LD + col] = static_cast<float>(d[i][j][0]);
      cs[r * CS_LD + col + 1] = static_cast<float>(d[i][j][1]);
      cs[(r + 8) * CS_LD + col] = static_cast<float>(d[i][j][2]);
      cs[(r + 8) * CS_LD + col + 1] = static_cast<float>(d[i][j][3]);
    }
  __syncthreads();
  conv_epilogue(cs, rows, acc, pmean, pm2, pmax, ni, tile, gridDim.y, m0, co0,
                hw, c);
}

template <typename T>
void launch_conv(const T* xp, const T* wt, float* acc, float* pmean,
                 float* pm2, float* pmax, int n, int h, int w, int c,
                 int tiles, cudaStream_t s) {
  const dim3 grid(c / TILE_N, tiles, n);
  if constexpr (sizeof(T) == 2)
    conv3x3_bf16<<<grid, CONV_THREADS, 0, s>>>(xp, wt, acc, pmean, pm2, pmax,
                                               h, w, c);
  else
    conv3x3_f32<<<grid, CONV_THREADS, 0, s>>>(xp, wt, acc, pmean, pm2, pmax,
                                              h, w, c);
}

// conv3x3_int8's launch: xp shifted-grid int8, wt int8 as (tap, cout, cin).
inline void launch_conv_int8(const int8_t* xp, const int8_t* wt, float* acc,
                             float* pmean, float* pm2, float* pmax, int n,
                             int h, int w, int c, int tiles, cudaStream_t s) {
  conv3x3_int8<<<dim3(c / TILE_N, tiles, n), CONV_THREADS, 0, s>>>(
      xp, wt, acc, pmean, pm2, pmax, h, w, c);
}

}  // namespace ducosy
