// The sample-resident CBAM tail shared by K8 (conv_resident.cuh: after
// conv2's MMAs, from the fp32 accumulator), K4 (block_tail.cu: from h as
// loaded) and K5 (block_tail_bwd.cu: the same forward, recomputed, and its
// adjoint), and the pieces the resident kernels share: the output tile's
// staging and its reflect-padded write, the cooperative launch and the
// occupancy query. Every block of a cooperative launch owns 128 flat pixels
// x all C channels of a sample, held in registers in the accumulator layout
// of tile_regs.cuh; the whole-image reductions go through grid barriers
// (common.cuh). See conv_resident.cuh for the design and its costs.
#pragma once

#include "cbam_tail.cuh"
#include "tile_regs.cuh"

namespace ducosy {

// the parts of a resident kernel that its timing probe can leave out: the
// ring, MMAs and partials; the barriers, merges and channel gate; the
// epilogue from the registers (K8: with the map and the spatial gate)
constexpr int RPART_MMA = 1, RPART_SYNC = 2, RPART_EPI = 4, RPART_ALL = 7;
// the widest image K8's resident kernel takes: the rows of the (mean, max)
// map that a tile's 7x7 windows reach are staged in shared memory
constexpr int RESIDENT_TAIL_W = 256;

// Shared memory after the loop (K4: of the kernel), in floats from the
// ring's aligned base:
// tile_partials' 17 BN, then per-channel mean, 1/std, gate, normalized max
// and the MLP's hidden units (BN each), the tile's spatial gates (TILE_M),
// the 7x7 taps (2 x 49 in 128), then the staged output tile, rows of BN
// outputs 16 bytes apart (the quads' stores then hit distinct banks).
template <int BN> struct ResidentSmem {
  static constexpr int MEAN = 17 * BN, RSTD = 18 * BN, GATE = 19 * BN;
  static constexpr int MAXY = 20 * BN, HID = 21 * BN, GS = 22 * BN;
  static constexpr int WSA = GS + TILE_M, STAGE_BYTE = (WSA + 128) * 4;
  // row stride and end of the staged tile, for outputs of ESIZE bytes
  template <int ESIZE> static constexpr int LD = BN * ESIZE + 16;
  template <int ESIZE>
  static constexpr int BYTES = STAGE_BYTE + TILE_M * (BN * ESIZE + 16);
  // K8 (bf16 io): x's tile, the staged t, and the rows of the (mean, max)
  // map that a tile's 7x7 windows reach at the widest image it takes
  static constexpr int TAIL_BYTES =
      STAGE_BYTE + 2 * TILE_M * (BN * 2 + 16) +
      (TILE_M + (2 * SA_R + 2) * RESIDENT_TAIL_W) * 8;
};

// Dynamic shared memory of the resident kernels: the ring (K8: or its
// epilogue where that is larger; the 64-channel int8 ring is 48 KB), then
// the (row, column) of the tile's 128 pixels, worked out once per block.
constexpr int PIX_BYTES = TILE_M * 8;

// pix[p] = (row, column) of pixel m0 + p in an image w wide
__device__ __forceinline__ void fill_pixels(int2* pix, int m0, int w) {
  if (threadIdx.x < TILE_M)
    pix[threadIdx.x] = make_int2((m0 + (int)threadIdx.x) / w,
                                 (m0 + (int)threadIdx.x) % w);
  __syncthreads();
}

__device__ __forceinline__ void stage_pair(unsigned char* at, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __halves2bfloat162(a, b);
}
__device__ __forceinline__ void stage_pair(unsigned char* at, int8_t a,
                                           int8_t b) {
  *reinterpret_cast<char2*>(at) = make_char2(a, b);
}

// Write the staged tile (`rows` pixels of sample ni at pix[], channels co0 ..
// co0 + BN) to out (n, h + 2 pad, w + 2 pad, c), reflect-padded: with pad 1
// the rows 1 and h - 2 and the columns 1 and w - 2 also fill the border. A
// thread moves 16 bytes of one pixel at a time, through xform(chunk, p, k)
// (p the pixel's row in the tile, k the chunk's index within its BN
// channels); thread t takes chunks t, t + CONV_THREADS, ... of rows * CPP.
template <typename TOut, int BN, typename F>
__device__ __forceinline__ void write_padded_tile(const unsigned char* stage,
                                                  const int2* pix, TOut* out,
                                                  int ni, int rows, int co0,
                                                  int h, int w, int c, int pad,
                                                  F&& xform) {
  constexpr int CPP = BN * sizeof(TOut) / 16;    // chunks per pixel
  constexpr int LD = ResidentSmem<BN>::template LD<sizeof(TOut)>;
  const int hp = h + 2 * pad, wpo = w + 2 * pad;
  unsigned char* dst = reinterpret_cast<unsigned char*>(out);
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * CPP; i += CONV_THREADS) {
    const int p = i / CPP, k = i % CPP;
    const int hh = pix[p].x, ww = pix[p].y;
    const uint4 v = xform(
        *reinterpret_cast<const uint4*>(stage + p * LD + k * 16), p, k);
    unsigned char* at = dst + k * 16;
    auto put = [&](int ho, int wo) {
      *reinterpret_cast<uint4*>(
          at + ((((size_t)ni * hp + ho) * wpo + wo) * c + co0) * sizeof(TOut)) =
          v;
    };
    put(hh + pad, ww + pad);
    // the border places that mirror this pixel (a warp shares its pixel
    // wherever a pixel is 32 chunks or a multiple: the branch is uniform)
    if (pad && (hh == 1 || hh == h - 2 || ww == 1 || ww == w - 2)) {
      const int ro[3] = {hh + 1, hh == 1 ? 0 : -1, hh == h - 2 ? h + 1 : -1};
      const int co[3] = {ww + 1, ww == 1 ? 0 : -1, ww == w - 2 ? w + 1 : -1};
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          if (a + b > 0 && ro[a] >= 0 && co[b] >= 0) put(ro[a], co[b]);
    }
  }
}

// x + round(t * gs) of eight bf16 values each, products and sums in fp32,
// each rounded to bf16
__device__ __forceinline__ uint4 add_gated_bf16x8(uint4 x, uint4 t, float gs) {
  uint4 o;
  const uint32_t* px = &x.x;
  const uint32_t* pt = &t.x;
  uint32_t* po = &o.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(px + i));
    const float2 ft = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(pt + i));
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        fx.x + round_io<bf16>(ft.x * gs), fx.y + round_io<bf16>(ft.y * gs));
    po[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return o;
}

// Copy the tile of `rows` pixels x BN bf16 channels at src (pixel-major,
// BN channels a pixel) to shared memory at dst, rows LD bytes apart, in
// 16-byte cp.async chunks; the rows past `rows` are zero-filled. Commits
// one group.
template <int BN, int LD>
__device__ __forceinline__ void copy_tile_async(unsigned char* dst,
                                                const bf16* src, int rows) {
  constexpr int CPP = BN / 8;                    // chunks per pixel
  for (int i = threadIdx.x; i < TILE_M * CPP; i += CONV_THREADS) {
    const int p = i / CPP, k = i % CPP;
    cp_async16(smem_u32(dst + p * LD + k * 16),
               src + (size_t)(p < rows ? p : 0) * BN + k * 8, p < rows);
  }
  cp_async_commit();
}

// The tile staged by copy_tile_async into the accumulator layout: d[4 j +
// {0, 1}] the thread's row r0 = 16 warp + lane / 4, channels 8 j + 2 (lane
// % 4) + {0, 1}; d[4 j + {2, 3}] row r0 + 8 (4-byte reads, 16 bytes apart in
// a quad and LD apart across its eight rows: distinct banks).
template <int BN, int LD>
__device__ __forceinline__ void tile_to_regs(const unsigned char* src,
                                             float (&d)[BN / 2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned char* s0 =
      src + (warp * 16 + lane / 4) * LD + (lane % 4) * 2 * sizeof(bf16);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(s0 + j * 16));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(s0 + 8 * LD + j * 16));
    d[4 * j] = a.x;
    d[4 * j + 1] = a.y;
    d[4 * j + 2] = b.x;
    d[4 * j + 3] = b.y;
  }
}

// Ask the L2 for `bytes` from p (a hint, no data returned), 128-byte lines
// shared out over the block: a later sample's tile is then read from the L2
// while the current one's barriers leave the memory idle.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = threadIdx.x * (size_t)128; off < bytes;
       off += (size_t)CONV_THREADS * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
}

// The skip's tile of x (n, h + 2 x_pad, w + 2 x_pad, BN channels), its
// interior at the tile's pixels, to xs in the layout of the staged output
// tile: each thread copies the chunks that write_padded_tile will have it
// add on the way out. Commits one cp.async group.
template <int BN>
__device__ __forceinline__ void copy_x_async(unsigned char* xs, const bf16* x,
                                             const int2* pix, int ni, int rows,
                                             int h, int w, int x_pad) {
  constexpr int LD = ResidentSmem<BN>::template LD<sizeof(bf16)>;
  const int hx = h + 2 * x_pad, wx = w + 2 * x_pad;
  for (int i = threadIdx.x; i < rows * (BN / 8); i += CONV_THREADS) {
    const int p = i / (BN / 8), k = i % (BN / 8);
    const int hh = pix[p].x, ww = pix[p].y;
    cp_async16(smem_u32(xs + p * LD + k * 16),
               x + (((size_t)ni * hx + hh + x_pad) * wx + ww + x_pad) * BN +
                   k * 8, true);
  }
  cp_async_commit();
}

// The channel gate of a sample in every block, once merge_sample has put
// the block's (all c == BN) channels' mean, 1/std and max of the source in
// smean / srstd / smaxy: smaxy becomes the io-rounded max of y (rstd > 0
// and rounding is monotone: max(IN(src)) = IN(max src) exactly), hid the
// MLP's hidden units relu(max y @ w1) (r floats), sgate the io-rounded
// sigmoid gate and, where given, sgate32 the fp32 one. The avg-pooled path
// is zero (cbam_tail.cuh). Ends with a block barrier.
template <int BN>
__device__ __forceinline__ void sample_gate(const float* __restrict__ w1,
                                            const float* __restrict__ w2,
                                            int r, const float* smean,
                                            const float* srstd, float* smaxy,
                                            float* hid, float* sgate,
                                            float* sgate32) {
  constexpr int c = BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < BN)
    smaxy[tid] = round_io<bf16>((smaxy[tid] - smean[tid]) * srstd[tid]);
  __syncthreads();
  for (int j = warp; j < r; j += CONV_THREADS / 32) {
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += smaxy[k] * w1[k * r + j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) hid[j] = fmaxf(s, 0.f);
  }
  __syncthreads();
  if (tid < BN) {
    float g = 0.f;
#pragma unroll 8
    for (int j = 0; j < r; ++j) g += hid[j] * w2[j * c + tid];
    const float gate = 1.f / (1.f + expf(-g));
    sgate[tid] = round_io<bf16>(gate);
    if (sgate32) sgate32[tid] = gate;
  }
  __syncthreads();
}

// The CBAM tail of sample ni from the tile's values in registers (d, the
// accumulator layout; K8: conv2's fp32 accumulator, K4: h as loaded), for
// bf16 io with one block holding all c == BN channels of its pixels:
//   tile partials (mean, M2, max) from the registers; a grid barrier and the
//   channel-split merge (merge_sample); the channel gate from the merged max
//   in every block (2 C R MACs); t = round(round(IN(d)) * gate_c), staged,
//   and its channel mean and max per pixel into map (n, h*w, 2) (L2); a
//   grid barrier; the map's rows within reach staged in shared memory, the
//   7x7 zero-padded conv and the sigmoid for the tile's own pixels; the skip
//   added from x's interior as the staged chunks go out, reflect-padded.
// `base` is the shared memory of ResidentSmem<BN>::TAIL_BYTES (16-byte
// aligned), pix the tile's (row, column) pairs. PARTS as the probes of K8
// take it: without RPART_MMA no tile partials, without RPART_SYNC no
// barriers, merge or gate, without RPART_EPI nothing from t on. X_SENT: the
// caller has already sent x's tile to xs (copy_x_async). Ends with every
// thread's shared-memory work done but no block barrier.
template <int BN, int PARTS, bool X_SENT = false, typename Acc>
__device__ __forceinline__ void tail_epilogue(
    const Acc (&d)[BN / 2], unsigned char* base, const int2* pix,
    const bf16* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ wsa,
    bf16* __restrict__ out, float* pmean, float* pm2, float* pmax,
    float* gmean, float* grstd, float* gmax, float* map,
    unsigned long long* bar, unsigned nblocks, unsigned long long& target,
    int bid, int ni, int tile, int tiles, int h, int w, int r, int pad,
    int x_pad, float eps) {
  using S = ResidentSmem<BN>;
  constexpr int LD = S::template LD<sizeof(bf16)>;
  constexpr int c = BN;
  float* red = reinterpret_cast<float*>(base);
  float* smean = red + S::MEAN;
  float* srstd = red + S::RSTD;
  float* sgate = red + S::GATE;
  float* smaxy = red + S::MAXY;
  float* hid = red + S::HID;
  float* sgs = red + S::GS;
  float* swsa = red + S::WSA;
  unsigned char* xs = base + S::STAGE_BYTE;      // x's interior, staged
  unsigned char* stage = xs + TILE_M * LD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hw = h * w, m0 = tile * TILE_M;
  const int rows = min(TILE_M, hw - m0);
  const int r0 = warp * 16 + lane / 4, cq = (lane % 4) * 2;
  const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;
  // the rows of the map that the tile's 7x7 windows reach: a flat span
  const int span0 = max((m0 / w - SA_R) * w, 0);
  const int span1 = min(((m0 + rows - 1) / w + SA_R + 1) * w, hw);

  if constexpr (PARTS & RPART_MMA) {
    const size_t pbase = ((size_t)ni * tiles + tile) * c;
    tile_partials<BN>(d, red, rows, pmean + pbase, pm2 + pbase, pmax + pbase);
  }
  // the skip's tile of x, on its way while the statistics settle (unless
  // the caller sent it earlier)
  if constexpr ((PARTS & RPART_EPI) && !X_SENT)
    copy_x_async<BN>(xs, x, pix, ni, rows, h, w, x_pad);
  if constexpr (PARTS & RPART_SYNC) {
    merge_sample(pmean, pm2, pmax, gmean, grstd, gmax, bar, nblocks, target,
                 bid, ni, 0, BN, tiles, hw, c, eps,
                 reinterpret_cast<float*>(stage), smean, srstd, smaxy);
    sample_gate<BN>(w1, w2, r, smean, srstd, smaxy, hid, sgate, nullptr);
  } else {
    if (tid < BN) { smean[tid] = 0.f; srstd[tid] = 1.f; sgate[tid] = 0.5f; }
    __syncthreads();
  }
  if constexpr (PARTS & RPART_EPI) {
    // ---- t = round(round(IN(acc)) * gate_c), staged, and its channel mean
    // and max at this thread's two pixels, over its 64 channels and then
    // its quad
    // the taps, read after the next barrier
    if (tid < 2 * SA_K * SA_K) swsa[tid] = wsa[tid];
    float sum0 = 0.f, sum1 = 0.f, mx0 = -INFINITY, mx1 = -INFINITY;
    unsigned char* s0 = stage + r0 * LD + cq * sizeof(bf16);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 mu = *reinterpret_cast<const float2*>(smean + 8 * j + cq);
      const float2 rs = *reinterpret_cast<const float2*>(srstd + 8 * j + cq);
      const float2 gc = *reinterpret_cast<const float2*>(sgate + 8 * j + cq);
      bf16 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = round_io<bf16>(
            ((float)d[4 * j + e] - (e & 1 ? mu.y : mu.x)) *
            (e & 1 ? rs.y : rs.x));
        const float t = round_io<bf16>(y * (e & 1 ? gc.y : gc.x));
        if (e < 2) { sum0 += t; mx0 = fmaxf(mx0, t); }
        else { sum1 += t; mx1 = fmaxf(mx1, t); }
        v[e] = from_f32<bf16>(t);             // exact: t is a bf16 value
      }
      stage_pair(s0 + j * 8 * sizeof(bf16), v[0], v[1]);
      stage_pair(s0 + 8 * LD + j * 8 * sizeof(bf16), v[2], v[3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (lane % 4 == 0) {
      float2* mp = reinterpret_cast<float2*>(map) + (size_t)ni * hw + m0 + r0;
      if (ok0) mp[0] = make_float2(sum0 / c, mx0);
      if (ok1) mp[8] = make_float2(sum1 / c, mx1);
    }
    if constexpr (PARTS & RPART_SYNC)
      grid_barrier(bar, nblocks, target);
    else __syncthreads();
    // ---- spatial gate of the tile's pixels: the map's rows within reach
    // staged from L2, then the
    // 7x7 conv, zeros outside the image; two threads a pixel (tap rows
    // 0-3 | 4-6)
    float2* smap = reinterpret_cast<float2*>(stage + TILE_M * LD);
    {
      const float2* mp = reinterpret_cast<const float2*>(map) +
                         (size_t)ni * hw + span0;
      for (int e0 = 0; e0 < span1 - span0; e0 += 4 * CONV_THREADS) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * CONV_THREADS + tid;
          if (e < span1 - span0) v[u] = __ldcg(mp + e);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * CONV_THREADS + tid;
          if (e < span1 - span0) smap[e] = v[u];
        }
      }
    }
    __syncthreads();
    {
      const int p = tid / 2, upper = tid % 2;
      float g = 0.f;
      if (p < rows) {
        const int hh = pix[p].x, ww = pix[p].y;
        const int d0 = upper ? 4 : 0, d1 = upper ? SA_K : 4;
        for (int di = d0; di < d1; ++di) {
          const int yy = hh + di - SA_R;
          if (yy < 0 || yy >= h) continue;
#pragma unroll
          for (int dj = 0; dj < SA_K; ++dj) {
            const int xx = ww + dj - SA_R;
            if (xx < 0 || xx >= w) continue;
            const float2 v = smap[yy * w + xx - span0];
            g += swsa[di * SA_K + dj] * v.x +
                 swsa[SA_K * SA_K + di * SA_K + dj] * v.y;
          }
        }
      }
      g += __shfl_xor_sync(0xffffffffu, g, 1);
      if (!upper) sgs[p] = round_io<bf16>(1.f / (1.f + expf(-g)));
    }
    __syncthreads();
    // ---- out = x + round(t * gate_s), as the staged t goes out
    cp_async_wait<0>();
    write_padded_tile<bf16, BN>(
        stage, pix, out, ni, rows, 0, h, w, c, pad,
        [&](uint4 v, int p, int k) {
          return add_gated_bf16x8(
              *reinterpret_cast<const uint4*>(xs + p * LD + k * 16), v,
              sgs[p]);
        });
  }
}

// ---- launches. static, with the once-flags inside: each library that
// includes this header has its own copy of the kernels (see launch_wgmma).
template <typename K>
static int launch_cooperative(K kernel, dim3 grid, int smem, void** args,
                              cudaStream_t s) {
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                          dim3(CONV_THREADS), args, smem, s);
}

// How many blocks of `kernel` an SM holds at once: lowers *least to it.
template <typename K>
static int least_occupancy(K kernel, int smem, int* least) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, CONV_THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (nb < *least) *least = nb;
  return 0;
}

}  // namespace ducosy
