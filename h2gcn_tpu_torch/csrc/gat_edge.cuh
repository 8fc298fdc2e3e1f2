// Per-edge updates of the fused GAT attention over a BSR mask
// (gat_attention.cu): the forward's online softmax and the row pass. The
// formulas are shared by every attention kernel of the port (the COO-chunk
// ones of gat_attention_coo.cu and the column pass of gat_attention_col.cu
// walk edge lists instead; gat_items.cuh).
//
// One warp owns one destination row i and keeps its running state in
// registers. Lanes take two roles: lane k holds head k's scalars (m, l, f1,
// the df1 sums; k = lane + 32 r < H) and lane c holds feature c of the
// concatenated H*F row (c = lane + 32 q < H*F). They trade per-edge values
// through a small per-warp shared-memory scratch. For head k, with F
// features a head:
//   e_ij   = LeakyReLU_slope(f1[i,k] + f2[j,k])
//   out_i  = sum_j alpha_ij h_j,  alpha_ij = exp(e_ij - m_i) / max(l_i, 1e-16)
//   df1_i  = sum_j alpha_ij (g_i . h_j - D_i) leaky'_ij
//   dh_j   = sum_i alpha_ij g_i,  df2_j = sum_i alpha_ij (g_i . h_j - D_i) leaky'_ij
// where m_i is the row max of e, l_i the row sum of exp(e - m_i) and
// D_i = g_i . out_i. A row without an entry keeps m = -1e30 (the JAX
// package's sentinel; with -inf, exp(m_old - m_new) would be NaN), l = 0
// and writes out = 0.
//
// The BSR kernels are f32 throughout. operand<Bf16> is the edge-list
// kernels' "default" precision: the operands of the head contractions
// (alpha or p with h or g, and g with h) are rounded to bf16, and every
// product and sum stays f32, as bf16 operands with f32 accumulation. The
// softmax statistics are f32 in both modes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gat {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;  // rows a thread block walks at once
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHF = 512;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

template <bool Bf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (Bf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// Forward: the online softmax of destination row i. Scratch: 2 H floats.
template <int Q, int R>
struct FwdRow {
  float m[R], l[R], f1r[R], acc[Q];
  int hk[Q];

  __device__ __forceinline__ void begin(const float* __restrict__ f1,
                                        int64_t i, int H, int F, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + 32 * r;
      m[r] = kNegInf;
      l[r] = 0.f;
      f1r[r] = k < H ? f1[i * H + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      acc[q] = 0.f;
      hk[q] = c < H * F ? c / F : 0;
    }
  }

  // edge (i, j): rescale the state by exp(m_old - m_new), add p h_j
  __device__ __forceinline__ void edge(int64_t j, const float* __restrict__ f2,
                                       const float* __restrict__ h, int H,
                                       int HF, float slope, float* scale_s,
                                       float* p_s, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + 32 * r;
      if (k < H) {
        const float e = leaky(f1r[r] + f2[j * H + k], slope);
        const float mn = fmaxf(m[r], e);
        const float sc = expf(m[r] - mn);
        const float p = expf(e - mn);
        l[r] = l[r] * sc + p;
        m[r] = mn;
        scale_s[k] = sc;
        p_s[k] = p;
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      if (c < HF) {
        acc[q] = fmaf(p_s[hk[q]], h[j * HF + c], acc[q] * scale_s[hk[q]]);
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void end(int64_t i, float* __restrict__ out,
                                      float* __restrict__ m_out,
                                      float* __restrict__ l_out, int H, int HF,
                                      float* scale_s, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + 32 * r;
      if (k < H) {
        m_out[i * H + k] = m[r];
        l_out[i * H + k] = l[r];
        scale_s[k] = fmaxf(l[r], 1e-16f);
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      if (c < HF) out[i * HF + c] = acc[q] / scale_s[hk[q]];
    }
    __syncwarp();  // the scratch is free for the warp's next row
  }
};

// Row backward: df1 of destination row i. Scratch: H F floats.
template <int Q, int R>
struct RowBwd {
  float f1r[R], mr[R], lr[R], dr[R], acc[R], gq[Q];

  __device__ __forceinline__ void begin(const float* __restrict__ f1,
                                        const float* __restrict__ g,
                                        const float* __restrict__ m_in,
                                        const float* __restrict__ l_in,
                                        const float* __restrict__ d_in,
                                        int64_t i, int H, int HF, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + 32 * r;
      const bool live = k < H;
      f1r[r] = live ? f1[i * H + k] : 0.f;
      mr[r] = live ? m_in[i * H + k] : 0.f;
      lr[r] = live ? fmaxf(l_in[i * H + k], 1e-16f) : 1.f;
      dr[r] = live ? d_in[i * H + k] : 0.f;
      acc[r] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      gq[q] = c < HF ? g[i * HF + c] : 0.f;
    }
  }

  __device__ __forceinline__ void edge(int64_t j, const float* __restrict__ f2,
                                       const float* __restrict__ h, int H,
                                       int F, int HF, float slope,
                                       float* prod_s, int lane) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c = lane + 32 * q;
      if (c < HF) prod_s[c] = gq[q] * h[j * HF + c];
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + 32 * r;
      if (k < H) {
        float gh = 0.f;
        for (int f = 0; f < F; ++f) gh += prod_s[k * F + f];
        const float pre = f1r[r] + f2[j * H + k];
        const float alpha = expf(leaky(pre, slope) - mr[r]) / lr[r];
        const float dl = pre >= 0.f ? 1.f : slope;
        acc[r] = fmaf(alpha * (gh - dr[r]), dl, acc[r]);
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void end(int64_t i, float* __restrict__ df1,
                                      int H, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = lane + 32 * r;
      if (k < H) df1[i * H + k] = acc[r];
    }
  }
};

template <int V>
using Int = std::integral_constant<int, V>;

// Calls launch(Int<Q>, Int<R>) with the smallest instantiation that holds
// H heads of F features: Q = 2 covers H*F <= 64 (GAT's two layers), Q = 16
// the limit; R = 1 covers H <= 32, R = 16 the limit.
template <typename Launch>
cudaError_t dispatch(int H, int F, Launch&& launch) {
  if (H * F <= 64 && H <= 32) {
    launch(Int<2>{}, Int<1>{});
  } else if (H <= 32) {
    launch(Int<16>{}, Int<1>{});
  } else {
    launch(Int<16>{}, Int<16>{});
  }
  return cudaGetLastError();
}

}  // namespace gat
