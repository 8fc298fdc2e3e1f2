// The formulas of the fused GAT attention, shared by every attention kernel
// of the port: the forward and row pass of gat_attention_coo.cu and the
// column pass of gat_attention_col.cu. Each walks edge lists in work items
// (gat_items.cuh), whether the lists come from the COO-chunk tables or from
// the BSR mask's own entries. For head k, with F features a head:
//   e_ij   = LeakyReLU_slope(f1[i,k] + f2[j,k])
//   out_i  = sum_j alpha_ij h_j,  alpha_ij = exp(e_ij - m_i) / max(l_i, 1e-16)
//   df1_i  = sum_j alpha_ij (g_i . h_j - D_i) leaky'_ij
//   dh_j   = sum_i alpha_ij g_i,  df2_j = sum_i alpha_ij (g_i . h_j - D_i) leaky'_ij
// where m_i is the row max of e, l_i the row sum of exp(e - m_i) and
// D_i = g_i . out_i. A row without an entry keeps m = -1e30 (the JAX
// package's sentinel; with -inf, exp(m_old - m_new) would be NaN), l = 0
// and writes out = 0.
//
// operand<Bf16> is the kernels' "default" precision: the operands of the
// head contractions (alpha or p with h or g, and g with h) are rounded to
// bf16, and every product and sum stays f32, as bf16 operands with f32
// accumulation. The softmax statistics are f32 in both modes; "highest",
// the only mode of the BSR mask's payload, is f32 throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gat {

constexpr float kNegInf = -1e30f;
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

}  // namespace gat
