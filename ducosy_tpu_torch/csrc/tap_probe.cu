// P3: the int8 / bf16 tap-matmul probe, for Hopper (sm_90a).
//
// Replaces: run (scripts/probe_int8_mosaic.py:38, pallas_call at :48), the
// TPU probe that asked whether int8 x int8 -> int32 tap matmuls pay against
// bf16 x bf16 -> fp32 at the trunk's tap shape. out = the sum over `taps`
// of a (M, K) @ b (K, N) in one accumulator, as the probe's kernels compute
// it (int8 exact, bf16 in fp32); at (16384, 256) x (256, 256) with 9 taps
// that is the work of one 3x3 trunk conv of one 128^2 sample.
//
// What bounds it. 2 M K N taps operations: 1.93e10 at 9 taps, 9.8 us of
// int8 or 19.5 us of bf16 at the data sheet's dense peaks. The bytes once
// (a, b, and the 4-byte (M, N) out) are 21-25 MB, 6.3-7.6 us at 3.35 TB/s,
// so the operations bound it; but the out alone is 16.8 MB, more than half
// the int8 x9 bound, and a one-wave grid exposes whatever store the MMAs do
// not hide.
//
// Design.
//   Tile. A block owns TAP_M = 128 rows of a, one warpgroup per 64, times
//   all TAP_N = 256 columns: 128 blocks on the 132 SMs at the probe shape,
//   one block an SM.
//   Operands resident. The block's A rows and all of B are loaded once into
//   dynamic shared memory (bf16 64 + 128 KB, int8 32 + 64 KB), K-major in
//   128-byte swizzle atoms: chunk c holds K elements [c KC, (c + 1) KC) of
//   every row (KC = 64 bf16 or 128 int8), 16-byte piece q of row r at
//   q ^ (r % 8): the layout of the conv loop's descriptors (ConvGeom in
//   conv3x3.cuh). A arrives by cp.async. B (K, N) is transposed on its way
//   in: a thread loads an E x E block (E elements = 16 bytes) with 16-byte
//   loads, transposes it in registers with byte permutes and writes E
//   16-byte pieces, eight lanes of a warp on the eight pieces of a row
//   (no bank conflict). No launch transposes B beforehand, for either
//   dtype: one launch a call.
//   MMAs. Wgmma<TAP_N> (conv3x3.cuh) on descriptors into the resident
//   chunks, KC bytes / 32 of them per chunk and tap, K chunk outermost, taps
//   inside, so all taps' MMAs on chunk 0 run while the other chunks land.
//   The sum is the same; only the bf16 case's fp32 order differs from the
//   TPU kernel's, which adds one whole product per tap.
//   Ping-pong. All 256 threads load chunk 0. Warpgroup 0 runs its MMAs on
//   chunk 0 while warpgroup 1 loads the other chunks (named barrier 1),
//   then the rest of its MMAs. As soon as they are all issued it lets
//   warpgroup 1 start its own (named barrier 2), then waits and stores its
//   64 x 256 accumulator from registers while warpgroup 1's MMAs run: the
//   m64n256 MMAs of one warpgroup keep the SM's four tensor cores busy, so
//   only the load of chunk 0 and warpgroup 1's store (half the out) are
//   exposed.
//   Store. 8-byte stores from the accumulator registers, a lane quad
//   writing one whole 32-byte sector.
//   By parts. PARTS (TAP_LOAD, TAP_MMA, TAP_STORE) compiles parts out for
//   the timing probe (ducosy_tap_probe_parts); the path runs TAP_ALL.
// What is left. On an H100 SXM (700 W) the MMAs alone run at the tensor
// cores' rate: from 9 to 36 taps they add 1.08 us a tap of int8 and 2.32 of
// bf16 on 128 SMs. At 9 taps the whole adds to them the loads, 3.0 us of
// int8 (chunk 0 before the first MMA) and 6.0 of bf16 (warpgroup 0 also
// waits for warpgroup 1 to land chunks 1-3, 144 KB), and warpgroup 1's
// store of half the out, 3.1-3.2 us. Untried: warpgroup 0 helping to load
// once its chunk-0 MMAs are issued, warpgroup 1's MMAs in two N halves with
// the first half's store under the second's, and a first chunk of half a
// row.
//
// The original kernels, tap_matmul_int8 and tap_matmul_bf16 below (the
// mma.sync / WMMA main loops that K1's convs first had: 128 x 64 tiles, a
// synchronous global -> shared copy every K step of every tap, B given
// transposed for int8), stay behind ducosy_tap_probe_original, for
// measurement only.
#include <mma.h>

#include <type_traits>

#include "conv3x3.cuh"

namespace ducosy {
namespace {

// ---- the wgmma kernel

constexpr int TAP_M = 128;            // rows of a a block owns
constexpr int TAP_N = 256;            // columns: all of b's
constexpr int TAP_ROWB = 128;         // bytes of K per operand row and chunk
constexpr int TAP_ALIGN = 1024;       // a swizzle atom repeats every 1024 B
constexpr int TAP_SMEM_MAX = 232448;  // dynamic shared memory of a block
constexpr int TAP_LOAD = 1, TAP_MMA = 2, TAP_STORE = 4, TAP_ALL = 7;

template <typename T> struct TapGeom {
  using Acc = typename ConvGeom<T, TAP_ROWB, TAP_N>::Acc;
  static constexpr int E = 16 / sizeof(T);          // elements of 16 bytes
  static constexpr int KC = TAP_ROWB / sizeof(T);   // K elements a chunk
  static constexpr int A_CHUNK = TAP_M * TAP_ROWB;  // bytes a chunk
  static constexpr int B_CHUNK = TAP_N * TAP_ROWB;
  static constexpr uint64_t DESC = ConvGeom<T, TAP_ROWB, TAP_N>::DESC;
};

// named barriers between the two warpgroups (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(CONV_THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(CONV_THREADS)
               : "memory");
}

// Chunk c of the block's TAP_M rows of a (M, k) from row m0, by thread t of
// nthr, into the swizzled chunk at shared address dst.
template <typename T>
__device__ __forceinline__ void load_a_chunk(const T* __restrict__ a,
                                             uint32_t dst, int m0, int k,
                                             int c, int t, int nthr) {
  using G = TapGeom<T>;
  for (int p = t; p < TAP_M * 8; p += nthr) {
    const int r = p / 8, q = p % 8;
    cp_async16(dst + r * TAP_ROWB + ((q ^ (r & 7)) << 4),
               a + (size_t)(m0 + r) * k + c * G::KC + q * G::E, true);
  }
}

// Chunk c of b (k, TAP_N), row-major, into the K-major chunk at dst: row n
// holds b[c KC + i][n], i < KC. Thread t of nthr takes E x E blocks, kb the
// 16-byte piece of K in the row and nb the block of E columns.
template <typename T>
__device__ __forceinline__ void load_b_chunk(const T* __restrict__ b,
                                             unsigned char* dst, int c,
                                             int t, int nthr) {
  using G = TapGeom<T>;
  constexpr int E = G::E;
  for (int i = t; i < 8 * (TAP_N / E); i += nthr) {
    const int kb = i % 8, nb = i / 8;
    const T* src = b + (size_t)(c * G::KC + kb * E) * TAP_N + nb * E;
    uint32_t w[E][4];                  // w[r]: row r, elements little-endian
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(src + (size_t)r * TAP_N);
      w[r][0] = v.x, w[r][1] = v.y, w[r][2] = v.z, w[r][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {      // column nb E + j, rows in K order
      uint32_t o[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if constexpr (E == 8) {        // bf16: half j % 2 of word j / 2
          o[p] = __byte_perm(w[2 * p][j / 2], w[2 * p + 1][j / 2],
                             (j & 1) ? 0x7632 : 0x5410);
        } else {                       // int8: byte j % 4 of word j / 4
          const uint32_t s = (j & 3) | ((4 + (j & 3)) << 4);
          o[p] = __byte_perm(
              __byte_perm(w[4 * p][j / 4], w[4 * p + 1][j / 4], s),
              __byte_perm(w[4 * p + 2][j / 4], w[4 * p + 3][j / 4], s),
              0x5410);
        }
      }
      const int n = nb * E + j;
      *reinterpret_cast<uint4*>(dst + n * TAP_ROWB + ((kb ^ (n & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// All taps' MMAs of one warpgroup on one resident chunk: a and b the shared
// addresses of its 64 A rows and of the chunk's TAP_N B rows.
template <typename T>
__device__ __forceinline__ void tap_chunk_mma(
    typename TapGeom<T>::Acc (&d)[TAP_N / 2], uint32_t a, uint32_t b,
    int taps) {
  constexpr uint64_t DESC = TapGeom<T>::DESC;
  for (int t = 0; t < taps; ++t) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TAP_ROWB / 32; ++s)
      Wgmma<TAP_N>::mma(d, DESC | (((a + s * 32) & 0x3FFFF) >> 4),
                        DESC | (((b + s * 32) & 0x3FFFF) >> 4));
    wgmma_commit();
    wgmma_wait<1>();
  }
}

__device__ __forceinline__ void store2(int* p, int x, int y) {
  *reinterpret_cast<int2*>(p) = make_int2(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// out (m, TAP_N) = sum over taps of a (m, k) @ b (k, TAP_N); m a multiple
// of TAP_M, k of KC. Grid m / TAP_M, CONV_THREADS threads, (k / KC)
// (A_CHUNK + B_CHUNK) + TAP_ALIGN bytes of dynamic shared memory. See the
// note at the top of the file.
template <typename T, int PARTS>
__global__ void __launch_bounds__(CONV_THREADS, 1)
tap_matmul_wgmma(const T* __restrict__ a, const T* __restrict__ b,
                 typename TapGeom<T>::Acc* __restrict__ out, int k,
                 int taps) {
  using G = TapGeom<T>;
  extern __shared__ unsigned char tap_raw[];
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32;
  const int lane = tid % 32, m0 = blockIdx.x * TAP_M, chunks = k / G::KC;
  const uint32_t raw = smem_u32(tap_raw);
  const uint32_t as = (raw + TAP_ALIGN - 1) & ~uint32_t(TAP_ALIGN - 1);
  const uint32_t bs = as + chunks * G::A_CHUNK;
  unsigned char* bs_ptr = tap_raw + (bs - raw);

  if constexpr (PARTS & TAP_LOAD) {           // chunk 0, by every thread
    load_a_chunk<T>(a, as, m0, k, 0, tid, CONV_THREADS);
    cp_async_commit();
    load_b_chunk<T>(b, bs_ptr, 0, tid, CONV_THREADS);
    cp_async_wait<0>();
  }
  fence_async_proxy();
  __syncthreads();
  if (wg == 1) {
    if constexpr (PARTS & TAP_LOAD) {         // the other chunks
      for (int c = 1; c < chunks; ++c)
        load_a_chunk<T>(a, as + c * G::A_CHUNK, m0, k, c, tid - 128, 128);
      cp_async_commit();
      for (int c = 1; c < chunks; ++c)
        load_b_chunk<T>(b, bs_ptr + c * G::B_CHUNK, c, tid - 128, 128);
      cp_async_wait<0>();
    }
    fence_async_proxy();
    bar_arrive(1);                            // the other chunks are in
    bar_sync(2);                              // warpgroup 0's MMAs issued
  }

  typename G::Acc d[TAP_N / 2];
#pragma unroll
  for (int i = 0; i < TAP_N / 2; ++i) d[i] = 0;
#pragma unroll
  for (int i = 0; i < TAP_N / 2; ++i) pin(d[i]);
  const uint32_t a0 = as + wg * 64 * TAP_ROWB;
  if constexpr (PARTS & TAP_MMA) tap_chunk_mma<T>(d, a0, bs, taps);
  if (wg == 0) bar_sync(1);
  if constexpr (PARTS & TAP_MMA)
    for (int c = 1; c < chunks; ++c)
      tap_chunk_mma<T>(d, a0 + c * G::A_CHUNK, bs + c * G::B_CHUNK, taps);
  if (wg == 0) bar_arrive(2);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < TAP_N / 2; ++i) pin(d[i]);

  // rows r and r + 8, columns 8 j + 2 (lane % 4) + {0, 1} (Wgmma's layout).
  // The probe without the store keeps the branch, never taken (taps > 0):
  // with no reader of the accumulators the assembler drops the MMAs.
  if ((PARTS & TAP_STORE) || taps < 0) {
    auto* o0 = out + (size_t)(m0 + warp * 16 + lane / 4) * TAP_N +
               (lane % 4) * 2;
    auto* o1 = o0 + 8 * TAP_N;
#pragma unroll
    for (int j = 0; j < TAP_N / 8; ++j) {
      store2(o0 + 8 * j, d[4 * j], d[4 * j + 1]);
      store2(o1 + 8 * j, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// One instantiation's launch. The shared-memory limit is raised once; its
// error, like a refused launch's, is returned. static: the once-flag of a
// function with external linkage would be one symbol for every library of
// the process.
template <typename T, int PARTS>
static int launch_tap(const void* a, const void* b, void* out, int m, int k,
                      int taps, cudaStream_t s) {
  using G = TapGeom<T>;
  static const cudaError_t raised = cudaFuncSetAttribute(
      tap_matmul_wgmma<T, PARTS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TAP_SMEM_MAX);
  if (raised != cudaSuccess) return (int)raised;
  const int smem = (k / G::KC) * (G::A_CHUNK + G::B_CHUNK) + TAP_ALIGN;
  tap_matmul_wgmma<T, PARTS><<<m / TAP_M, CONV_THREADS, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<typename G::Acc*>(out), k, taps);
  return (int)cudaGetLastError();
}

// The timing probe's parts: 1-4 and all of them (7).
template <typename T>
static int launch_parts(const void* a, const void* b, void* out, int m,
                        int k, int taps, int parts, cudaStream_t s) {
  switch (parts) {
    case 1: return launch_tap<T, 1>(a, b, out, m, k, taps, s);
    case 2: return launch_tap<T, 2>(a, b, out, m, k, taps, s);
    case 3: return launch_tap<T, 3>(a, b, out, m, k, taps, s);
    case 4: return launch_tap<T, 4>(a, b, out, m, k, taps, s);
    case TAP_ALL: return launch_tap<T, TAP_ALL>(a, b, out, m, k, taps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the original kernels (measurement only)

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

// out (m, 256) = the sum over taps of a (m, k) @ b (k, 256), both
// row-major: int8 -> int32 out, or bf16 -> fp32 out. m a multiple of 128, k
// of 128 bytes, (128 + 256) k bytes of operands at most 231,424 (the
// wrapper's tap_plan). Returns the launch's error, or 0.
extern "C" int ducosy_tap_probe(const void* a, const void* b, void* out,
                                int m, int k, int taps, int is_int8,
                                void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_int8 ? launch_tap<int8_t, TAP_ALL>(a, b, out, m, k, taps, s)
                 : launch_tap<bf16, TAP_ALL>(a, b, out, m, k, taps, s);
}

// The same by parts, for measurement: parts 7, or 1 (the operands' loads),
// 2 (the MMAs), 3 (both) or 4 (the store) alone.
extern "C" int ducosy_tap_probe_parts(const void* a, const void* b,
                                      void* out, int m, int k, int taps,
                                      int is_int8, int parts, void* stream) {
  using namespace ducosy;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_int8 ? launch_parts<int8_t>(a, b, out, m, k, taps, parts, s)
                 : launch_parts<bf16>(a, b, out, m, k, taps, parts, s);
}

// The original kernels, for measurement: int8 takes b transposed, (n, k).
// m a multiple of 128, n of 64, k of 64.
extern "C" int ducosy_tap_probe_original(const void* a, const void* b,
                                         void* out, int m, int k, int n,
                                         int taps, int is_int8,
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
