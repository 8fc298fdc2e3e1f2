// Fused multi-head graph attention over per-row edge lists for Hopper: the
// forward with its softmax statistics and the row backward pass; the column
// backward pass is in gat_attention_col.cu. Both kernels serve the two
// payloads that hold such lists:
//   - the COO-chunk tables (sparse/attention_coo.py: coo_fwd_stats,
//     coo_bwd_row), whose lists the host sorts once from the chunk tables;
//   - the BSR mask (sparse/attention.py: gat_fwd_stats, gat_bwd_row), whose
//     lists are built once from the mask's own entries > 0.
//
// Replaces the TPU kernels
//   h2gcn_tpu/sparse/pallas_attention_coo.py
//     gat_coo_fwd      _make_fwd_kernel (_fwd_fn)
//     gat_coo_bwd_row  _make_bwd_row_kernel (_bwd_row_fn)
//   h2gcn_tpu/sparse/pallas_attention.py
//     gat_coo_fwd      _make_fwd_stats_kernel (_fwd_stats_call)
//     gat_coo_bwd_row  _make_bwd_row_kernel (pass R)
// (the formulas are in gat_edge.cuh). The TPU kernels densify a T x T mask
// per chunk with one-hot matrix products, or walk the BSR mask's dense
// blocks, both MXU shapes; here nothing is densified and the mask is never
// read.
//
// What bounds them on the H100 is latency, not bytes or flops: the least
// work is O(edges * H * F) flops on O(edges) gathered rows that sit in the
// L2 (the 10K graph's h is 2.6 MB), a few microseconds of the card's time.
// Their first design (one block an output tile, a counting sort of the
// tile's slots on every launch, each warp walking whole rows one edge at a
// time) left most SMs idle behind the hub tile and waited on a chain of
// dependent loads per edge (the BSR mask's first kernels, one warp a row,
// scanned every 256 KB mask block of the row's block row). Now both walk
// the per-row lists in the same work items, batched as gat_items.cuh says:
// - The forward rescales (m, l, acc) once a batch, not once an edge; the
//   pieces of a split row write (m, l, acc) and the merge rescales each by
//   exp(m_p - m).
// - The row pass needs no running state (m, l and D are inputs). Its df1
//   uses sum_j w_ij (g_i . h_j - D_i) = sum_c g_i[c] (sum_j w_ij h_j[c]) -
//   D_i sum_j w_ij, w = alpha * leaky': the row's constants (f1, m, l, D
//   and g_i) load once a row, each edge gathers only j, f2_j and h_j, lanes
//   accumulate sum_j w_ij h_j in the feature layout as the forward
//   accumulates sum_j p h_j, and the head sums over F run once a row, not
//   once an edge. df1 is linear in the edges, so the pieces of a split row
//   write partial df1 and the merge sums them.
//
// Precision: Bf16 ("default") rounds the head contractions' operands (p
// with h, g with h) to bf16 and keeps every sum, alpha and w and the
// softmax statistics f32; "highest" is f32 throughout. The forward rounds p
// at the batch's running max; sums run in another order than the plain
// version's index_add_, so results match it to a tolerance, not bitwise.
//
// Limits: H * F <= 512, any H >= 1. The wrapper (sparse/attention_coo.py)
// checks them and raises; the launchers also refuse them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gat_edge.cuh"
#include "gat_items.cuh"

namespace {

using gat::kNegInf;
using gat::leaky;
using gat::operand;

// Forward over work items of the per-row lists (ptr, src). A piece of a
// split row (slot >= 0) writes (m [H], l [H], acc [H*F]) to ws at its
// slot; every other row writes out, m and l.
template <class L, bool Bf16>
__global__ void __launch_bounds__(kMaxItemWarps * 32)
gat_coo_fwd_kernel(const int4* __restrict__ items,
                   const int* __restrict__ slot, int n_items,
                   const int* __restrict__ ptr, const int* __restrict__ src,
                   const float* __restrict__ f1, const float* __restrict__ f2,
                   const float* __restrict__ h, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   float* __restrict__ ws, int H, int F, float slope) {
  constexpr int KH = L::KH, G = L::G, V = L::V, Q = L::Q;
  constexpr int EPR = L::kEpr, NG = L::kNg, U = L::kU;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int k0 = blockIdx.y * KH;  // the pass's first head
  const int nh = min(KH, H - k0);
  const int HF = H * F;
  const int pk = lane % KH;  // head of the lane's pairs
  const bool plive = pk < nh;
  const int grp = lane / G;
  const Slots<L> sl(lane, nh * F, F);
  const int4 it = items[item];
  const int piece = slot[item];
  const float* hk = h + (int64_t)k0 * F;
  const RowStarts rs(ptr, it, lane);

  for (int r = it.x; r < it.y; ++r) {
    int e_lo, e_hi;
    rs.edges(r, it, e_lo, e_hi);
    const float f1r = plive ? f1[(int64_t)r * H + k0 + pk] : 0.f;
    float m = kNegInf, l = 0.f;  // head pk; l is this lane's share
    float acc[Q][V] = {};
    for (int b0 = e_lo; b0 < e_hi; b0 += 32) {
      const int nb = min(32, e_hi - b0);
      const int jl = lane < nb ? src[b0 + lane] : 0;
      // the first U edges' rows are on their way while the logits are made
      float hv[U][Q][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = __shfl_sync(kAll, jl, u * NG + grp);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          load_slot<V>(hk + (int64_t)j * HF + sl.fc[q], sl.fl[q], hv[u][q]);
        }
      }
      float p[KH];
      float bm = kNegInf;
#pragma unroll
      for (int t = 0; t < KH; ++t) {
        const int e = t * EPR + lane / KH;
        const int j = __shfl_sync(kAll, jl, e);
        p[t] = kNegInf;
        if (e < nb && plive) {
          p[t] = leaky(f1r + f2[(int64_t)j * H + k0 + pk], slope);
        }
        bm = fmaxf(bm, p[t]);
      }
#pragma unroll
      for (int o = KH; o < 32; o <<= 1) {
        bm = fmaxf(bm, __shfl_xor_sync(kAll, bm, o));
      }
      const float mn = fmaxf(m, bm);
      const float sc = expf(m - mn);
      m = mn;
      float ps = 0.f;
#pragma unroll
      for (int t = 0; t < KH; ++t) {
        const bool live = t * EPR + lane / KH < nb && plive;
        p[t] = live ? expf(p[t] - mn) : 0.f;
        ps += p[t];
        p[t] = operand<Bf16>(p[t]);
      }
      l = l * sc + ps;
#pragma unroll
      for (int q = 0; q < Q; ++q) {  // head fh's scale is in lane fh
        const float s = __shfl_sync(kAll, sc, sl.fh[q]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[q][v] *= s;
      }
#pragma unroll
      for (int t0 = 0; t0 < 32; t0 += U * NG) {
        if (t0 >= nb) break;
        float pv[U][Q];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e0 = t0 + u * NG;  // group 0's edge; e0 / EPR is static
          const int e = e0 + grp;
          if (t0 > 0) {
            const int j = __shfl_sync(kAll, jl, e);
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              load_slot<V>(hk + (int64_t)j * HF + sl.fc[q], sl.fl[q],
                           hv[u][q]);
            }
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            pv[u][q] = __shfl_sync(kAll, p[e0 / EPR],
                                   (e % EPR) * KH + sl.fh[q]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[q][v] = fmaf(pv[u][q], operand<Bf16>(hv[u][q][v]),
                               acc[q][v]);
            }
          }
        }
      }
    }
    // the row's end: merge the groups' sums and the lanes' shares of l
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = xor_sum<G>(acc[q][v]);
    }
    l = xor_sum<KH>(l);
    float lq[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      lq[q] = fmaxf(__shfl_sync(kAll, l, sl.fh[q]), 1e-16f);
    }
    float* o_row;
    if (piece < 0) {
      if (lane < nh) {
        m_out[(int64_t)r * H + k0 + lane] = m;
        l_out[(int64_t)r * H + k0 + lane] = l;
      }
      o_row = out + (int64_t)r * HF + (int64_t)k0 * F;
    } else {
      float* w = ws + (int64_t)piece * (2 * H + HF);
      if (lane < nh) {
        w[k0 + lane] = m;
        w[H + k0 + lane] = l;
      }
      o_row = w + 2 * H + k0 * F;
    }
    if (grp == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (!sl.fl[q]) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          o_row[sl.fc[q] + v] = piece < 0 ? acc[q][v] / lq[q] : acc[q][v];
        }
      }
    }
  }
}

// Merges the pieces of each split row: slots split_ptr[s] ..
// split_ptr[s + 1] of ws hold row split_rows[s]'s partial (m, l, acc).
// One warp a row.
__global__ void gat_coo_fwd_merge_kernel(const int* __restrict__ split_rows,
                                         const int* __restrict__ split_ptr,
                                         int n_split,
                                         const float* __restrict__ ws,
                                         float* __restrict__ out,
                                         float* __restrict__ m_out,
                                         float* __restrict__ l_out, int H,
                                         int F) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int HF = H * F;
  const int64_t stride = 2 * H + HF, r = split_rows[s];
  const float* w0 = ws + split_ptr[s] * stride;
  const float* w1 = ws + split_ptr[s + 1] * stride;
  for (int c = lane; c < HF + H; c += 32) {
    // c < HF: feature c of head c / F; then the heads' statistics
    const int k = c < HF ? c / F : c - HF;
    float mx = kNegInf;
    for (const float* w = w0; w < w1; w += stride) mx = fmaxf(mx, w[k]);
    float lsum = 0.f, a = 0.f;
    for (const float* w = w0; w < w1; w += stride) {
      const float sc = expf(w[k] - mx);
      lsum = fmaf(w[H + k], sc, lsum);
      if (c < HF) a = fmaf(w[2 * H + c], sc, a);
    }
    if (c < HF) {
      out[r * HF + c] = a / fmaxf(lsum, 1e-16f);
    } else {
      m_out[r * H + k] = mx;
      l_out[r * H + k] = lsum;
    }
  }
}

// Row pass over work items of the per-row lists (ptr, src): df1 of
// destination row r. A piece of a split row writes its partial df1 [H] to
// ws at its slot. Shared memory: nh * F floats a warp.
template <class L, bool Bf16>
__global__ void __launch_bounds__(kMaxItemWarps * 32)
gat_coo_bwd_row_kernel(const int4* __restrict__ items,
                       const int* __restrict__ slot, int n_items,
                       const int* __restrict__ ptr,
                       const int* __restrict__ src,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       const float* __restrict__ h,
                       const float* __restrict__ g,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ d_in,
                       float* __restrict__ df1, float* __restrict__ ws,
                       int H, int F, float slope) {
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
  const float* hk = h + (int64_t)k0 * F;
  const RowStarts rs(ptr, it, lane);

  for (int r = it.x; r < it.y; ++r) {
    int e_lo, e_hi;
    rs.edges(r, it, e_lo, e_hi);
    // the row's constants: head pk's f1, m, l; the lane's features of g_r
    const int64_t x = (int64_t)r * H + k0 + pk;
    const float f1r = plive ? f1[x] : 0.f;
    const float mr = plive ? m_in[x] : 0.f;
    const float lr = plive ? fmaxf(l_in[x], 1e-16f) : 1.f;
    float gq[Q][V], dw[Q][V] = {};
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      load_slot<V>(g + (int64_t)r * HF + (int64_t)k0 * F + sl.fc[q],
                   sl.fl[q], gq[q]);
#pragma unroll
      for (int v = 0; v < V; ++v) gq[q][v] = operand<Bf16>(gq[q][v]);
    }
    float sw = 0.f;  // head pk: this lane's share of sum_j w_ij
    for (int b0 = e_lo; b0 < e_hi; b0 += 32) {
      const int nb = min(32, e_hi - b0);
      const int jl = lane < nb ? src[b0 + lane] : 0;
      // the first U edges' h rows are on their way while w is made
      float hv[U][Q][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = __shfl_sync(kAll, jl, u * NG + grp);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          load_slot<V>(hk + (int64_t)j * HF + sl.fc[q], sl.fl[q], hv[u][q]);
        }
      }
      float w[KH];  // w_ij = alpha_ij leaky'_ij
#pragma unroll
      for (int t = 0; t < KH; ++t) {
        const int e = t * EPR + lane / KH;
        const int j = __shfl_sync(kAll, jl, e);
        w[t] = 0.f;
        if (e < nb && plive) {
          const float pre = f1r + f2[(int64_t)j * H + k0 + pk];
          const float alpha = expf(leaky(pre, slope) - mr) / lr;
          w[t] = pre >= 0.f ? alpha : slope * alpha;
          sw += w[t];
        }
      }
#pragma unroll
      for (int t0 = 0; t0 < 32; t0 += U * NG) {
        if (t0 >= nb) break;
        float wv[U][Q];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e0 = t0 + u * NG;  // group 0's edge; e0 / EPR is static
          const int e = e0 + grp;
          if (t0 > 0) {
            const int j = __shfl_sync(kAll, jl, e);
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              load_slot<V>(hk + (int64_t)j * HF + sl.fc[q], sl.fl[q],
                           hv[u][q]);
            }
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            wv[u][q] = __shfl_sync(kAll, w[e0 / EPR],
                                   (e % EPR) * KH + sl.fh[q]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              dw[q][v] = fmaf(wv[u][q], operand<Bf16>(hv[u][q][v]),
                              dw[q][v]);
            }
          }
        }
      }
    }
    // the row's end: merge the groups' sums, then df1 per head:
    // sum_c g_r[c] (sum_j w_rj h_j[c]) - D_r sum_j w_rj
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int v = 0; v < V; ++v) dw[q][v] = xor_sum<G>(dw[q][v]);
    }
    sw = xor_sum<KH>(sw);
    if (grp == 0) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (!sl.fl[q]) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) prod_s[sl.fc[q] + v] = gq[q][v] * dw[q][v];
      }
    }
    __syncwarp();
    if (lane < nh) {
      float d1 = 0.f;
      for (int f = 0; f < F; ++f) d1 += prod_s[lane * F + f];
      d1 -= d_in[(int64_t)r * H + k0 + lane] * sw;
      float* o = piece < 0 ? df1 + (int64_t)r * H : ws + (int64_t)piece * H;
      o[k0 + lane] = d1;
    }
    __syncwarp();  // prod_s is free for the next row
  }
}

}  // namespace

// Forward over work items: out [n_pad, H*F], m, l [n_pad, H]. items [n_items]
// (row_lo, row_hi, e_lo, e_hi) and slot [n_items] (workspace slot of a split
// row's piece, -1 for whole rows); split_rows [n_split] and split_ptr
// [n_split + 1] (each split row's slots); ptr [n_pad + 1] and src [E] the
// per-row lists; ws: (2 H + H F) floats a slot. warps: items a thread block.
// Returns the cudaError_t of the launches.
extern "C" int h2gcn_gat_coo_fwd(const int* items, const int* slot,
                                 const int* split_rows, const int* split_ptr,
                                 const int* ptr, const int* src,
                                 const float* f1, const float* f2,
                                 const float* h, float* out, float* m,
                                 float* l, float* ws, int n_items,
                                 int n_split, int H, int F, float slope,
                                 int bf16, int warps, cudaStream_t stream) {
  if (bad_items(n_items, n_split, H, F, warps)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  dispatch_items(H, F, aligned16(h), [&](auto lanes) {
    using L = decltype(lanes);
    err = launch(bf16 ? gat_coo_fwd_kernel<L, true>
                      : gat_coo_fwd_kernel<L, false>,
                 item_grid(n_items, warps, H), warps * 32, 0, stream,
                 reinterpret_cast<const int4*>(items), slot, n_items, ptr,
                 src, f1, f2, h, out, m, l, ws, H, F, slope);
  });
  if (err != cudaSuccess || n_split == 0) return err;
  return launch(gat_coo_fwd_merge_kernel, dim3((n_split + 7) / 8), 256, 0,
                stream, split_rows, split_ptr, n_split, (const float*)ws,
                out, m, l, H, F);
}

// Row backward over the forward's work items and per-row lists: df1
// [n_pad, H] from g [n_pad, H*F] and the forward's m, l and D = per-head
// g . out [n_pad, H]; ws: H floats a slot of a split row's piece. The
// other arguments as the forward's.
extern "C" int h2gcn_gat_coo_bwd_row(const int* items, const int* slot,
                                     const int* split_rows,
                                     const int* split_ptr, const int* ptr,
                                     const int* src, const float* f1,
                                     const float* f2, const float* h,
                                     const float* g, const float* m,
                                     const float* l, const float* d,
                                     float* df1, float* ws, int n_items,
                                     int n_split, int H, int F, float slope,
                                     int bf16, int warps,
                                     cudaStream_t stream) {
  if (bad_items(n_items, n_split, H, F, warps)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  dispatch_items(H, F, aligned16(h) && aligned16(g), [&](auto lanes) {
    using L = decltype(lanes);
    err = launch(bf16 ? gat_coo_bwd_row_kernel<L, true>
                      : gat_coo_bwd_row_kernel<L, false>,
                 item_grid(n_items, warps, H), warps * 32,
                 head_sum_smem(warps, H, F), stream,
                 reinterpret_cast<const int4*>(items), slot, n_items, ptr,
                 src, f1, f2, h, g, m, l, d, df1, ws, H, F, slope);
  });
  if (err != cudaSuccess) return err;
  return merge_pieces(split_rows, split_ptr, n_split, ws, df1, H, nullptr, 0,
                      stream);
}
