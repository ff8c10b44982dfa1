// P3: the int8 tap-matmul probe, for Hopper (sm_90a).
//
// Replaces: run (scripts/probe_int8_mosaic.py:38, pallas_call at :48), the
// TPU probe that asked whether int8 x int8 -> int32 matmuls pay against
// bf16 -> fp32 at the trunk's tap shape. Both kernels here compute
// out = taps * (A @ B) by running the (M, K) x (K, N) product `taps` times
// into one accumulator, as the probe does; at (16384, 256) x (256, 256)
// with 9 taps that is the work of one 3x3 trunk conv of one sample.
//
// What bounds it: 2 * M * K * N * taps operations on 2 * (M + N) * K
// bytes read from L2 per repeat: compute-bound. The kernels are the main
// loops K1's convs first had, with the taps' shifted windows replaced by
// one matrix, so their rates tell what int8 gains over bf16 on the
// mma.sync path of this card:
//   int8  mma.sync m16n8k32 s8 x s8 -> s32 (warp_mma_s8_step, common.cuh):
//         128 x 64 tiles, K steps of 64 bytes;
//   bf16  WMMA m16n16k16 with fp32 accumulate, the same tiles.
// Neither pipelines its loads (no cp.async/TMA) nor uses wgmma; the conv
// kernels since do both (conv3x3.cuh), and the probe stays a probe of
// mma.sync.
#include <mma.h>

#include "common.cuh"

namespace ducosy {
namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int BK = 32, AS_LD = BK + 8, BS_LD = TILE_N + 8;   // bf16

// a (m, k) int8 row-major; bt (n, k) int8 (B transposed); out (m, n) int32.
// Grid (n / TILE_N, m / TILE_M).
__global__ void __launch_bounds__(THREADS)
tap_matmul_int8(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
                int* __restrict__ out, int k, int n, int taps) {
  __shared__ __align__(128) int8_t as[TILE_M * LD8];
  __shared__ __align__(128) int8_t bs[TILE_N * LD8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4, g = lane / 4, tg = lane % 4;
  const int n0 = blockIdx.x * TILE_N, m0 = blockIdx.y * TILE_M;
  const int row = tid / 4, vec = tid % 4;
  const int8_t* a_src = a + (size_t)(m0 + row) * k + vec * 16;
  const int8_t* b_src = bt + (size_t)(n0 + row) * k + vec * 16;

  int d[2][4][4] = {};
  for (int t = 0; t < taps; ++t) {
    for (int k0 = 0; k0 < k; k0 += BK8) {
      *reinterpret_cast<uint4*>(as + row * LD8 + vec * 16) =
          *reinterpret_cast<const uint4*>(a_src + k0);
      *reinterpret_cast<uint4*>(as + (row + 64) * LD8 + vec * 16) =
          *reinterpret_cast<const uint4*>(a_src + (size_t)64 * k + k0);
      *reinterpret_cast<uint4*>(bs + row * LD8 + vec * 16) =
          *reinterpret_cast<const uint4*>(b_src + k0);
      __syncthreads();
      warp_mma_s8_step(as, bs, wm, wn, lane, d);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wm * 32 + i * 16 + g;
      const int col = n0 + wn * 32 + j * 8 + tg * 2;
      *reinterpret_cast<int2*>(out + (size_t)r * n + col) =
          make_int2(d[i][j][0], d[i][j][1]);
      *reinterpret_cast<int2*>(out + (size_t)(r + 8) * n + col) =
          make_int2(d[i][j][2], d[i][j][3]);
    }
}

// a (m, k), b (k, n) bf16 row-major; out (m, n) fp32.
// Grid (n / TILE_N, m / TILE_M).
__global__ void __launch_bounds__(THREADS)
tap_matmul_bf16(const bf16* __restrict__ a, const bf16* __restrict__ b,
                float* __restrict__ out, int k, int n, int taps) {
  __shared__ __align__(128) bf16 as[TILE_M * AS_LD];
  __shared__ __align__(128) bf16 bs[BK * BS_LD];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int n0 = blockIdx.x * TILE_N, m0 = blockIdx.y * TILE_M;
  const int a_row = tid / 4, a_vec = tid % 4, b_row = tid / 8, b_vec = tid % 8;
  const bf16* a_src = a + (size_t)(m0 + a_row) * k + a_vec * 8;
  const bf16* b_src = b + (size_t)b_row * n + n0 + b_vec * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(fc[i][j], 0.f);

  for (int t = 0; t < taps; ++t) {
    for (int k0 = 0; k0 < k; k0 += BK) {
      *reinterpret_cast<uint4*>(as + a_row * AS_LD + a_vec * 8) =
          *reinterpret_cast<const uint4*>(a_src + k0);
      *reinterpret_cast<uint4*>(as + (a_row + 64) * AS_LD + a_vec * 8) =
          *reinterpret_cast<const uint4*>(a_src + (size_t)64 * k + k0);
      *reinterpret_cast<uint4*>(bs + b_row * BS_LD + b_vec * 8) =
          *reinterpret_cast<const uint4*>(b_src + (size_t)k0 * n);
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
      wmma::store_matrix_sync(
          out + (size_t)(m0 + wm * 32 + i * 16) * n + n0 + wn * 32 + j * 16,
          fc[i][j], n, wmma::mem_row_major);
}

}  // namespace
}  // namespace ducosy

// out (m, n) = taps * (a (m, k) @ b (k, n)). int8: b is given transposed,
// (n, k), and out is int32; bf16: b is (k, n) and out fp32. m a multiple
// of 128, n of 64, k of 64. Returns cudaGetLastError() after the launch.
extern "C" int ducosy_tap_probe(const void* a, const void* b, void* out,
                                int m, int k, int n, int taps, int is_int8,
                                void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / TILE_N, m / TILE_M);
  if (is_int8)
    tap_matmul_int8<<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<int*>(out), k, n, taps);
  else
    tap_matmul_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<float*>(out), k, n, taps);
  DUCOSY_CHECK_LAUNCH();
  return 0;
}
