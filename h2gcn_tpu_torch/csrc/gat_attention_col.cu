// The fused attention's column backward pass for Hopper: dh and df2 of each
// source column, over per-column edge lists in work items (gat_items.cuh).
// One kernel serves both payloads that hold such lists:
//   - the COO-chunk tables (sparse/attention_coo.py: coo_bwd_col), whose
//     lists the host sorts once from the transpose tables;
//   - the BSR mask (sparse/attention.py: gat_bwd_col), whose lists are built
//     once from the mask's own entries > 0.
//
// Replaces the TPU kernels
//   h2gcn_tpu/sparse/pallas_attention_coo.py  _make_bwd_col_kernel (_bwd_col_fn)
//   h2gcn_tpu/sparse/pallas_attention.py      _make_bwd_col_kernel (pass C)
// which compute, per head k, with the formulas of gat_edge.cuh:
//   dh_j  = sum_i alpha_ij g_i,  df2_j = sum_i alpha_ij (g_i . h_j - D_i) leaky'_ij.
//
// What bounds it on the H100 is latency, as for the forward
// (gat_attention_coo.cu): O(edges * H * F) flops on O(edges) gathered rows
// in the L2. The first designs walked a column serially (COO: one block a
// tile, re-sorted every launch; BSR: one warp a column, scanning each of its
// 256 KB mask blocks), so a hub column serialized. Now the pass needs no
// running state (m, l and D are inputs). Its df2 uses
// sum_i w_ij (g_i . h_j) = sum_c h_j[c] (sum_i w_ij g_i[c]), w = alpha *
// leaky': each lane accumulates dh and sum_i w g_i for its features, and the
// head sums over F run once a column, not once an edge. Lanes load the
// batch's f1, m, l and D side by side; the pieces of a split column write
// partial (df2, dh) and the merge sums them in piece order.
//
// Precision: Bf16 ("default", COO only) rounds alpha, g and h to bf16 where
// they meet in a head contraction and keeps every sum f32; "highest" is f32
// throughout.
//
// Limits: H * F <= 512, any H >= 1. The wrappers check them and raise; the
// launcher also refuses them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gat_edge.cuh"
#include "gat_items.cuh"

namespace {

using gat::leaky;
using gat::operand;

// Column pass over work items of the per-column lists (ptr, dst): dh and
// df2 of source column j. A piece of a split column writes (df2 [H],
// dh [H*F]) to ws at its slot. Shared memory: nh * F floats a warp.
template <class L, bool Bf16>
__global__ void __launch_bounds__(kMaxItemWarps * 32)
gat_coo_bwd_col_kernel(const int4* __restrict__ items,
                       const int* __restrict__ slot, int n_items,
                       const int* __restrict__ ptr,
                       const int* __restrict__ dst,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       const float* __restrict__ h,
                       const float* __restrict__ g,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ d_in,
                       float* __restrict__ dh, float* __restrict__ df2,
                       float* __restrict__ ws, int H, int F, float slope) {
  extern __shared__ float smem[];
  constexpr int KH = L::KH, G = L::G, V = L::V, Q = L::Q;
  constexpr int EPR = L::kEpr, NG = L::kNg, U = L::kU;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int k0 = blockIdx.y * KH;
  const int nh = min(KH, H - k0);
  const int HF = H * F;
  const int pk = lane % KH;
  const bool plive = pk < nh;
  const int grp = lane / G;
  const Slots<L> sl(lane, nh * F, F);
  float* prod_s = smem + (threadIdx.x >> 5) * min(KH, H) * F;
  const int4 it = items[item];
  const int piece = slot[item];
  const float* gk = g + (int64_t)k0 * F;
  const RowStarts rs(ptr, it, lane);

  for (int j = it.x; j < it.y; ++j) {
    int e_lo, e_hi;
    rs.edges(j, it, e_lo, e_hi);
    const float f2j = plive ? f2[(int64_t)j * H + k0 + pk] : 0.f;
    float hq[Q][V], dhq[Q][V] = {}, dw[Q][V] = {};
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      load_slot<V>(h + (int64_t)j * HF + (int64_t)k0 * F + sl.fc[q],
                   sl.fl[q], hq[q]);
#pragma unroll
      for (int v = 0; v < V; ++v) hq[q][v] = operand<Bf16>(hq[q][v]);
    }
    float sd = 0.f;  // head pk: this lane's share of sum_i w_ij D_i
    for (int b0 = e_lo; b0 < e_hi; b0 += 32) {
      const int nb = min(32, e_hi - b0);
      const int il = lane < nb ? dst[b0 + lane] : 0;
      // the first U edges' g rows are on their way while alpha is made
      float gv[U][Q][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = __shfl_sync(kAll, il, u * NG + grp);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          load_slot<V>(gk + (int64_t)i * HF + sl.fc[q], sl.fl[q], gv[u][q]);
        }
      }
      float a[KH], w[KH];  // operand alpha_ij and w_ij = alpha_ij leaky'_ij
#pragma unroll
      for (int t = 0; t < KH; ++t) {
        const int e = t * EPR + lane / KH;
        const int i = __shfl_sync(kAll, il, e);
        a[t] = w[t] = 0.f;
        if (e < nb && plive) {
          const int64_t x = (int64_t)i * H + k0 + pk;
          const float pre = f1[x] + f2j;
          const float alpha = expf(leaky(pre, slope) - m_in[x]) /
                              fmaxf(l_in[x], 1e-16f);
          w[t] = pre >= 0.f ? alpha : slope * alpha;
          sd = fmaf(w[t], d_in[x], sd);
          a[t] = operand<Bf16>(alpha);
        }
      }
#pragma unroll
      for (int t0 = 0; t0 < 32; t0 += U * NG) {
        if (t0 >= nb) break;
        float av[U][Q], wv[U][Q];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e0 = t0 + u * NG;
          const int e = e0 + grp;
          if (t0 > 0) {
            const int i = __shfl_sync(kAll, il, e);
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              load_slot<V>(gk + (int64_t)i * HF + sl.fc[q], sl.fl[q],
                           gv[u][q]);
            }
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int from = (e % EPR) * KH + sl.fh[q];
            av[u][q] = __shfl_sync(kAll, a[e0 / EPR], from);
            wv[u][q] = __shfl_sync(kAll, w[e0 / EPR], from);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float gr = operand<Bf16>(gv[u][q][v]);
              dhq[q][v] = fmaf(av[u][q], gr, dhq[q][v]);
              dw[q][v] = fmaf(wv[u][q], gr, dw[q][v]);
            }
          }
        }
      }
    }
    // the column's end: merge the groups' sums, then df2 per head:
    // sum_c h_j[c] (sum_i w_ij g_i[c]) - sum_i w_ij D_i
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        dhq[q][v] = xor_sum<G>(dhq[q][v]);
        dw[q][v] = xor_sum<G>(dw[q][v]);
      }
    }
    sd = xor_sum<KH>(sd);
    if (grp == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (!sl.fl[q]) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) prod_s[sl.fc[q] + v] = hq[q][v] * dw[q][v];
      }
    }
    __syncwarp();
    float d2 = 0.f;
    if (lane < nh) {
      for (int f = 0; f < F; ++f) d2 += prod_s[lane * F + f];
      d2 -= sd;
    }
    __syncwarp();  // prod_s is free for the next column
    float *o_dh, *o_df2;
    if (piece < 0) {
      o_dh = dh + (int64_t)j * HF + (int64_t)k0 * F;
      o_df2 = df2 + (int64_t)j * H + k0;
    } else {
      float* w = ws + (int64_t)piece * (H + HF);
      o_dh = w + H + k0 * F;
      o_df2 = w + k0;
    }
    if (lane < nh) o_df2[lane] = d2;
    if (grp == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (!sl.fl[q]) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) o_dh[sl.fc[q] + v] = dhq[q][v];
      }
    }
  }
}

}  // namespace

// Column backward over work items of the per-column lists (ptr [n_pad + 1],
// dst [E]): dh [n_pad, H*F] and df2 [n_pad, H]; ws: (H + H F) floats a
// slot of a split column's piece. items, slot, split_cols and split_ptr as
// h2gcn_gat_coo_fwd's (gat_attention_coo.cu) over the columns.
extern "C" int h2gcn_gat_coo_bwd_col(const int* items, const int* slot,
                                     const int* split_cols,
                                     const int* split_ptr, const int* ptr,
                                     const int* dst, const float* f1,
                                     const float* f2, const float* h,
                                     const float* g, const float* m,
                                     const float* l, const float* d,
                                     float* dh, float* df2, float* ws,
                                     int n_items, int n_split, int H, int F,
                                     float slope, int bf16, int warps,
                                     cudaStream_t stream) {
  if (bad_items(n_items, n_split, H, F, warps)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  dispatch_items(H, F, aligned16(h) && aligned16(g), [&](auto lanes) {
    using L = decltype(lanes);
    err = launch(bf16 ? gat_coo_bwd_col_kernel<L, true>
                      : gat_coo_bwd_col_kernel<L, false>,
                 item_grid(n_items, warps, H), warps * 32,
                 head_sum_smem(warps, H, F), stream,
                 reinterpret_cast<const int4*>(items), slot, n_items, ptr,
                 dst, f1, f2, h, g, m, l, d, dh, df2, ws, H, F, slope);
  });
  if (err != cudaSuccess) return err;
  return merge_pieces(split_cols, split_ptr, n_split, ws, df2, H, dh, H * F,
                      stream);
}
