// The CBAM residual-block tail shared by K1 (residual_chain.cu, whose
// source is conv2's fp32 accumulator), K4 (block_tail.cu, whose source is
// the conv2 output h in the io dtype) and K5's recompute
// (block_tail_bwd.cu):
//   y   = IN(src), rounded to the io dtype
//   t   = y * gate_c,  gate_c = sigmoid(MLP(avgpool y) + MLP(maxpool y))
//   out = ReflectPad_pad(x_interior + t * sigmoid(conv7x7([mean_c t, max_c t])))
// Reference: cbam_block.py:42-103 and conv_in.py:176-219. The io dtype is
// rounded to where the reference casts (after IN, after each gate, the
// product and the sum), with fp32 statistics and gates in between.
#pragma once

#include "common.cuh"

namespace ducosy {

// Channel gate, one block of c threads per sample: merge the per-tile
// (mean, M2, max) partials of the source, then the max-pooled normalized
// value, the C -> R -> C MLP and the sigmoid. Writes mean, rstd, the
// io-rounded max mx and the fp32 gate (consumers round it to the io dtype
// where they multiply). The avg-pooled path is zero: an instance-normalized
// channel has mean 0, so relu(avg @ w1) @ w2 vanishes (the reference
// computes it from the rounded y, where it is below 1e-6 of the max path).
// Dynamic shared memory: (c + r) floats.
template <typename T>
__global__ void channel_gate(const float* __restrict__ pmean,
                             const float* __restrict__ pm2,
                             const float* __restrict__ pmax,
                             const float* __restrict__ w1,
                             const float* __restrict__ w2,
                             float* __restrict__ mean, float* __restrict__ rstd,
                             float* __restrict__ maxy,
                             float* __restrict__ gate, int tiles, int hw,
                             int c, int r, float eps) {
  extern __shared__ float sh[];
  float* mx = sh;          // c
  float* hid = sh + c;     // r
  const int ni = blockIdx.x, ci = threadIdx.x;
  float m, q, x;
  merge_tiles(pmean, pm2, pmax, ni, ci, tiles, hw, c, &m, &q, &x);
  const float rs = inv_std(q, hw, eps);
  mean[ni * c + ci] = m;
  rstd[ni * c + ci] = rs;
  // rstd > 0 and rounding is monotone: max(IN(src)) = IN(max src) exactly
  mx[ci] = round_io<T>((x - m) * rs);
  if (maxy) maxy[ni * c + ci] = mx[ci];
  __syncthreads();
  if (ci < r) {
    float s = 0.f;
    for (int k = 0; k < c; ++k) s += mx[k] * w1[k * r + ci];
    hid[ci] = fmaxf(s, 0.f);
  }
  __syncthreads();
  float g = 0.f;
  for (int j = 0; j < r; ++j) g += hid[j] * w2[j * c + ci];
  gate[ni * c + ci] = 1.f / (1.f + expf(-g));
}

constexpr int TAIL_TH = 16, TAIL_TW = 32;   // interior pixel tile
constexpr int SA_K = 7, SA_R = 3;           // spatial-gate conv
constexpr int HALO_H = TAIL_TH + 2 * SA_R, HALO_W = TAIL_TW + 2 * SA_R;
constexpr int TAIL_THREADS = 256, TAIL_WARPS = TAIL_THREADS / 32;

// t = y * gate_c of channel k at one pixel, y = IN(src) rounded to the io
// dtype; gc holds the io-rounded gate.
template <typename T, typename TIn>
__device__ __forceinline__ float gated(const TIn* a, const float* mu,
                                       const float* rs, const float* gc,
                                       int k) {
  const float y = round_io<T>((to_f32(a[k]) - mu[k]) * rs[k]);
  return round_io<T>(y * gc[k]);
}

// Spatial gate + skip + reflect-padded write. src (n, h*w, c); x the skip
// input reflect-padded by x_pad (n, h+2x_pad, w+2x_pad, c); out
// (n, h+2pad, w+2pad, c). A block owns a 16x32 pixel tile with all
// channels and recomputes the channel mean/max of t over the tile plus a
// halo of 3 (the 7x7 conv pads with zeros outside the image). Grid
// (ceil(w/32), ceil(h/16), n); dynamic shared memory holds 3*c floats.
template <typename T, typename TIn>
__global__ void __launch_bounds__(TAIL_THREADS)
spatial_tail(const TIn* __restrict__ src, const float* __restrict__ mean,
             const float* __restrict__ rstd, const float* __restrict__ gate,
             const T* __restrict__ x, const float* __restrict__ wsa,
             T* __restrict__ out, int h, int w, int c, int pad, int x_pad) {
  __shared__ float s_avg[HALO_H * HALO_W], s_max[HALO_H * HALO_W];
  __shared__ float s_gs[TAIL_TH * TAIL_TW], s_w[2 * SA_K * SA_K];
  extern __shared__ float s_chan[];
  float* mu = s_chan;
  float* rs = s_chan + c;
  float* gc = s_chan + 2 * c;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int w0 = blockIdx.x * TAIL_TW, h0 = blockIdx.y * TAIL_TH;
  const int ni = blockIdx.z;
  for (int k = tid; k < c; k += TAIL_THREADS) {
    mu[k] = mean[ni * c + k];
    rs[k] = rstd[ni * c + k];
    gc[k] = round_io<T>(gate[ni * c + k]);
  }
  for (int k = tid; k < 2 * SA_K * SA_K; k += TAIL_THREADS) s_w[k] = wsa[k];
  __syncthreads();

  // channel mean / max of t over the tile and its halo; zero outside the
  // image (the 7x7 conv pads with zeros)
  for (int p = warp; p < HALO_H * HALO_W; p += TAIL_WARPS) {
    const int hh = h0 - SA_R + p / HALO_W, ww = w0 - SA_R + p % HALO_W;
    float s = 0.f, m = 0.f;
    if (hh >= 0 && hh < h && ww >= 0 && ww < w) {
      const TIn* a = src + (((size_t)ni * h + hh) * w + ww) * c;
      m = -INFINITY;
      for (int k = lane; k < c; k += 32) {
        const float t = gated<T>(a, mu, rs, gc, k);
        s += t;
        m = fmaxf(m, t);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      s /= c;
    }
    if (lane == 0) {
      s_avg[p] = s;
      s_max[p] = m;
    }
  }
  __syncthreads();

  for (int p = tid; p < TAIL_TH * TAIL_TW; p += TAIL_THREADS) {
    const int ph = p / TAIL_TW, pw = p % TAIL_TW;
    float g = 0.f;
    for (int di = 0; di < SA_K; ++di)
      for (int dj = 0; dj < SA_K; ++dj) {
        const int q = (ph + di) * HALO_W + pw + dj;
        g += s_w[di * SA_K + dj] * s_avg[q] +
             s_w[SA_K * SA_K + di * SA_K + dj] * s_max[q];
      }
    s_gs[p] = round_io<T>(1.f / (1.f + expf(-g)));
  }
  __syncthreads();

  // out = x_interior + t * gate_s, written at (hh+pad, ww+pad) and at the
  // reflected border positions it also fills when pad = 1
  const int hp = h + 2 * pad, wpo = w + 2 * pad;
  const int hx = h + 2 * x_pad, wx = w + 2 * x_pad;
  for (int p = warp; p < TAIL_TH * TAIL_TW; p += TAIL_WARPS) {
    const int hh = h0 + p / TAIL_TW, ww = w0 + p % TAIL_TW;
    if (hh >= h || ww >= w) continue;
    int rows_o[3], cols_o[3], nr = 0, nc = 0;
    rows_o[nr++] = hh + pad;
    cols_o[nc++] = ww + pad;
    if (pad) {
      if (hh == 1) rows_o[nr++] = 0;
      if (hh == h - 2) rows_o[nr++] = h + 1;
      if (ww == 1) cols_o[nc++] = 0;
      if (ww == w - 2) cols_o[nc++] = w + 1;
    }
    const float gs = s_gs[p];
    const TIn* a = src + (((size_t)ni * h + hh) * w + ww) * c;
    const T* xs = x + (((size_t)ni * hx + hh + x_pad) * wx + ww + x_pad) * c;
    for (int k = lane; k < c; k += 32) {
      const float t = gated<T>(a, mu, rs, gc, k);
      const T o = from_f32<T>(to_f32(xs[k]) + round_io<T>(t * gs));
      for (int i = 0; i < nr; ++i)
        for (int j = 0; j < nc; ++j)
          out[(((size_t)ni * hp + rows_o[i]) * wpo + cols_o[j]) * c + k] = o;
    }
  }
}

// Launch the channel gate and the spatial tail on per-tile partials of
// src that are already in pmean/pm2/pmax. Returns the first launch error.
template <typename T, typename TIn>
int launch_tail(const TIn* src, const T* x, const float* w1, const float* w2,
                const float* wsa, T* out, const float* pmean, const float* pm2,
                const float* pmax, float* mean, float* rstd, float* gate,
                int n, int h, int w, int c, int r, int tiles, int pad,
                int x_pad, float eps, cudaStream_t s) {
  channel_gate<T><<<n, c, (c + r) * sizeof(float), s>>>(
      pmean, pm2, pmax, w1, w2, mean, rstd, nullptr, gate, tiles, h * w, c,
      r, eps);
  DUCOSY_CHECK_LAUNCH();
  const dim3 tgrid((w + TAIL_TW - 1) / TAIL_TW, (h + TAIL_TH - 1) / TAIL_TH, n);
  spatial_tail<T, TIn><<<tgrid, TAIL_THREADS, 3 * c * sizeof(float), s>>>(
      src, mean, rstd, gate, x, wsa, out, h, w, c, pad, x_pad);
  DUCOSY_CHECK_LAUNCH();
  return 0;
}

}  // namespace ducosy
