// Fused multi-head graph attention over the COO-chunk payload for Hopper:
// the forward with its softmax statistics, the row backward pass and the
// column backward pass.
//
// Replaces the TPU kernels of h2gcn_tpu/sparse/pallas_attention_coo.py:
//   gat_coo_fwd      _make_fwd_kernel (_fwd_fn)
//   gat_coo_bwd_row  _make_bwd_row_kernel (_bwd_row_fn)
//   gat_coo_bwd_col  _make_bwd_col_kernel (_bwd_col_fn)
// They compute what the BSR kernels of gat_attention.cu compute (the formulas
// are in gat_edge.cuh); only the edge source differs. The TPU kernels
// densify a T x T mask per chunk with one-hot matrix products, an MXU trick;
// here nothing is densified.
//
// gat_coo_fwd and gat_coo_bwd_col. What bounds them on the H100 is latency,
// not bytes or flops: the least work is O(edges * H * F) flops on O(edges)
// gathered rows that sit in the L2 (the 10K graph's h is 2.6 MB), a few
// microseconds of the card's time. Their first design (one block an output
// tile, a counting sort of the tile's slots on every launch, each warp
// walking whole rows one edge at a time) left most SMs idle behind the hub
// tile and waited on a chain of dependent loads per edge. Now:
// - The tables never change, so the host sorts their edges once
//   (sparse/attention_coo.py: build_attn_coo): ptr / other list each
//   destination row's sources (forward) or each source column's
//   destinations (column pass), read from the chunk tables themselves.
// - One warp takes one work item (build_edge_items): a run of at most 32
//   whole rows whose edges plus a fixed cost a row stay within `budget`
//   (a row's walk is a chain of dependent loads, so a long run of short
//   rows would be the slowest warp), or one of ceil(deg / budget)
//   near-equal pieces of a longer row, so a hub row is spread over many
//   warps and SMs. An item loads its rows' list starts at once, one a
//   lane. Every row 0 .. n_pad lies in some item, so rows without an edge
//   write their sentinel state (m = -1e30, l = 0, out = 0; dh = df2 = 0)
//   and the outputs need no zeroing. A piece writes its partial state to a
//   workspace slot; a second small launch over the split rows merges them
//   (forward: rescaling each piece's (m, l, acc) by exp(m_p - m); column
//   pass: a sum), in piece order, so the results do not vary run to run.
// - A warp walks its edges in batches of 32. Pair layout: register t of
//   lane holds edge t * (32 / KH) + lane / KH of the batch for head
//   lane % KH (KH = 1 or 8 heads a pass; more heads take more passes over
//   gridDim.y). Lanes load the batch's f2 (forward) or f1, m, l, D (column)
//   side by side, and a head's batch max needs log2(32 / KH) shuffles.
//   The forward rescales (m, l, acc) once a batch, not once an edge.
// - Feature layout: lane groups of G lanes, V contiguous features a lane
//   (vector loads where F allows), Q such slots. Each group takes its own
//   edges, loading U edges' rows (h or g) before using any, the batch's
//   first U while its logits (or alpha) are still being made; p (or
//   alpha) comes from its pair lane by shuffle. At layer 2 (H = 1, F = 7)
//   four groups of 8 lanes take four edges at once; the groups' sums merge
//   by shuffle at the row's end.
// - The column pass needs no running state (m, l and D are inputs). Its
//   df2 uses sum_i w_ij (g_i . h_j) = sum_c h_j[c] (sum_i w_ij g_i[c]),
//   w = alpha * leaky': each lane accumulates dh and sum_i w g_i for its
//   features, and the head sums over F run once a column, not once an edge.
//
// gat_coo_bwd_row keeps its first design: one block owns one output tile
// of T rows, buckets the tile's edges by tile-local row with a counting sort
// in shared memory (or in a workspace when the tile's slots do not fit) and
// each warp walks whole rows with gat_edge.cuh's RowBwd.
//
// Precision: Bf16 ("default") rounds the head contractions' operands (p or
// alpha with h or g, and g with h) to bf16 and keeps every sum and the
// softmax statistics f32; "highest" is f32 throughout. The forward rounds
// p at the batch's running max; sums run in another order than the plain
// version's index_add_, so results match it to a tolerance, not bitwise.
//
// Limits: H * F <= 512, any H >= 1; the row kernel also T a multiple of 32
// and at most 1024. The wrapper (sparse/attention_coo.py) checks them and
// raises; the launchers also refuse them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gat_edge.cuh"
#include "gather.cuh"

namespace {

using gat::kAll;
using gat::kNegInf;
using gat::kThreads;
using gat::kWarps;
using gat::leaky;
using gat::operand;

constexpr int kMaxTile = 1024;
constexpr int kMaxItemWarps = 16;  // warps (work items) of one thread block

// ---------------------------------------------------------------------------
// The row backward pass (its first design).
// ---------------------------------------------------------------------------

// Counting sort of one tile's live slots by their tile-local key (the
// destination row). Afterwards list[start[k] .. start[k + 1]) holds, for
// each edge of key k, the global index of its other end:
// oth[chunk] * T + other[slot]. cursor is scratch of T ints. Every thread of
// the block must call it.
__device__ void bucket_tile(const int* __restrict__ key,
                            const int* __restrict__ other,
                            const float* __restrict__ vals,
                            const int* __restrict__ oth, int c_lo, int c_hi,
                            int e_b, int T, int* start, int* cursor,
                            int* list) {
  const int tid = threadIdx.x;
  for (int k = tid; k < T; k += blockDim.x) cursor[k] = 0;
  __syncthreads();
  const int64_t s_lo = (int64_t)c_lo * e_b, s_hi = (int64_t)c_hi * e_b;
  for (int64_t s = s_lo + tid; s < s_hi; s += blockDim.x) {
    if (vals[s] > 0.f) atomicAdd(&cursor[key[s]], 1);
  }
  __syncthreads();
  if (tid < 32) {  // warp 0: exclusive scan of the counts, 32 keys a step
    int carry = 0;
    if (tid == 0) start[0] = 0;
    for (int base = 0; base < T; base += 32) {
      const int v = cursor[base + tid];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kAll, incl, o);
        if (tid >= o) incl += t;
      }
      start[base + tid + 1] = carry + incl;
      cursor[base + tid] = carry + incl - v;
      carry += __shfl_sync(kAll, incl, 31);
    }
  }
  __syncthreads();
  for (int64_t s = s_lo + tid; s < s_hi; s += blockDim.x) {
    if (vals[s] > 0.f) {
      const int pos = atomicAdd(&cursor[key[s]], 1);
      list[pos] = oth[s / e_b] * T + other[s];
    }
  }
  __syncthreads();
}

// Shared memory: the warps' edge scratch (`scratch` floats a warp), then
// start [T + 1] and cursor [T] ints, then the list when it is not in ws.
struct Layout {
  float* scratch;
  int* start;
  int* cursor;
  int* list;
};

__device__ __forceinline__ Layout layout(float* smem, int scratch, int T,
                                         int* ws, int c_lo, int e_b) {
  Layout s;
  s.scratch = smem + (threadIdx.x >> 5) * scratch;
  s.start = reinterpret_cast<int*>(smem + kWarps * scratch);
  s.cursor = s.start + T + 1;
  s.list = ws ? ws + (int64_t)c_lo * e_b : s.cursor + T;
  return s;
}

template <int Q, int R, bool Bf16>
__global__ void __launch_bounds__(kThreads)
gat_coo_bwd_row_kernel(const int* __restrict__ tile_ptr,
                       const int* __restrict__ oth,
                       const int* __restrict__ rows,
                       const int* __restrict__ cols,
                       const float* __restrict__ vals, int* __restrict__ ws,
                       const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       const float* __restrict__ h,
                       const float* __restrict__ g,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ d_in,
                       float* __restrict__ df1, int lo, int T, int e_b, int H,
                       int F, float slope) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HF = H * F;
  const int c_lo = tile_ptr[blockIdx.x], c_hi = tile_ptr[blockIdx.x + 1];
  const Layout s = layout(smem, HF, T, ws, c_lo, e_b);
  bucket_tile(rows, cols, vals, oth, c_lo, c_hi, e_b, T, s.start, s.cursor,
              s.list);
  const int64_t row0 = (int64_t)(lo + blockIdx.x) * T;
  for (int r = warp; r < T; r += kWarps) {
    const int64_t i = row0 + r;
    gat::RowBwd<Q, R, Bf16> row;
    row.begin(f1, g, m_in, l_in, d_in, i, H, HF, lane);
    const int e_end = s.start[r + 1];
    for (int e = s.start[r]; e < e_end; ++e) {
      row.edge(s.list[e], f2, h, H, F, HF, slope, s.scratch, lane);
    }
    row.end(i, df1, H, lane);
  }
}

// ---------------------------------------------------------------------------
// The forward and the column pass: batched walks of per-row edge lists.
// ---------------------------------------------------------------------------

// How a warp's lanes split the work (see the note at the top). KH heads a
// pass; G lanes a group, V contiguous features a lane, Q feature slots.
template <int KH_, int G_, int V_, int Q_>
struct Lanes {
  static constexpr int KH = KH_, G = G_, V = V_, Q = Q_;
  static constexpr int kEpr = 32 / KH;  // a batch's edges in one pair register
  static constexpr int kNg = 32 / G;    // lane groups, each on its own edge
  // rows a group loads before it uses any: ~16 floats of loads a lane
  static constexpr int kU = Q * V >= 16 ? 1 : (16 / (Q * V) > 8 ? 8
                                                 : 16 / (Q * V));
  // a group's edge e0 + grp shares its pair register with edge e0
  static_assert(kNg <= kEpr, "lane groups must not outnumber a register's "
                             "edges");
};

// The lane's feature slots in a pass of nh heads (FC = nh * F features):
// slot q covers features fc[q] .. fc[q] + V of head fh[q], live when fl[q].
template <class L>
struct Slots {
  int fc[L::Q], fh[L::Q];
  bool fl[L::Q];

  __device__ __forceinline__ Slots(int lane, int FC, int F) {
#pragma unroll
    for (int q = 0; q < L::Q; ++q) {
      fc[q] = ((lane % L::G) + L::G * q) * L::V;
      fl[q] = fc[q] < FC;
      fh[q] = fl[q] ? fc[q] / F : 0;
    }
  }
};

// V features at p when the slot is live, else zeros
template <int V>
__device__ __forceinline__ void load_slot(const float* p, bool live,
                                          float (&x)[V]) {
  if (live) {
    h2gcn::Gather<float, V>::load(p, V, true, x);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = 0.f;
  }
}

// Sum of x over the lanes lane ^ o, o = from, 2 from, ..., 16
template <int From>
__device__ __forceinline__ float xor_sum(float x) {
#pragma unroll
  for (int o = From; o < 32; o <<= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// An item's row starts, loaded once: lane t holds ptr[lo + t] (an item
// holds at most 32 rows); edges() clips row r's list to the item's range.
struct RowStarts {
  int mine, end;

  __device__ __forceinline__ RowStarts(const int* __restrict__ ptr,
                                       int4 it, int lane)
      : mine(lane < it.y - it.x ? ptr[it.x + lane] : 0), end(ptr[it.y]) {}

  __device__ __forceinline__ void edges(int r, int4 it, int& e_lo,
                                        int& e_hi) const {
    const int t = r - it.x;  // warp-uniform
    const int lo = __shfl_sync(kAll, mine, t);
    const int hi = __shfl_sync(kAll, mine, t + 1 < 32 ? t + 1 : 31);
    e_lo = max(lo, it.z);
    e_hi = min(t + 1 < it.y - it.x ? hi : end, it.w);
  }
};

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

// Sums the pieces of each split column: slots split_ptr[s] ..
// split_ptr[s + 1] of ws hold column split_cols[s]'s partial (df2, dh).
__global__ void gat_coo_col_merge_kernel(const int* __restrict__ split_cols,
                                         const int* __restrict__ split_ptr,
                                         int n_split,
                                         const float* __restrict__ ws,
                                         float* __restrict__ dh,
                                         float* __restrict__ df2, int H,
                                         int F) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int HF = H * F;
  const int64_t stride = H + HF, j = split_cols[s];
  const float* w0 = ws + split_ptr[s] * stride;
  const float* w1 = ws + split_ptr[s + 1] * stride;
  for (int c = lane; c < H + HF; c += 32) {
    float sum = 0.f;
    for (const float* w = w0; w < w1; w += stride) sum += w[c];
    if (c < H) {
      df2[j * H + c] = sum;
    } else {
      dh[j * HF + c - H] = sum;
    }
  }
}

bool bad_shape(int n_tiles, int T, int e_b, int H, int F) {
  return n_tiles <= 0 || T <= 0 || T % 32 != 0 || T > kMaxTile || e_b <= 0 ||
         H < 1 || F < 1 || H * F > gat::kMaxHF;
}

bool bad_items(int n_items, int n_split, int H, int F, int warps) {
  return n_items <= 0 || n_split < 0 || H < 1 || F < 1 ||
         H * F > gat::kMaxHF || warps < 1 || warps > kMaxItemWarps;
}

// Dynamic shared memory of a row-kernel launch: the warps' scratch, start
// and cursor, and list_slots ints of list (0 when the list is in ws).
size_t smem_bytes(int scratch, int T, int list_slots) {
  return (size_t)kWarps * scratch * sizeof(float) +
         (size_t)(2 * T + 1 + list_slots) * sizeof(int);
}

// Launches the kernel, first raising its shared-memory limit where smem
// is past the default 48 KB.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int KH, typename Launch>
void pick_layout(int F, int fc, bool aligned, Launch&& launch) {
  if (fc <= 8) {
    launch(Lanes<KH, 8, 1, 1>{});  // layer 2: 4 groups of 8 lanes
  } else if (fc <= 64 && F % 2 == 0 && aligned) {
    launch(Lanes<KH, 32, 2, 1>{});  // layer 1: 64 features, float2 a lane
  } else if (fc <= 64) {
    launch(Lanes<KH, 32, 1, 2>{});
  } else if (F % 4 == 0 && aligned) {
    launch(Lanes<KH, 32, 4, 4>{});
  } else {
    launch(Lanes<KH, 32, 1, 16>{});
  }
}

// Calls launch(Lanes<...>{}) with the layout that holds H heads of F
// features: one head a pass when H = 1, else 8 heads a pass. aligned: the
// gathered rows allow 16-byte loads.
template <typename Launch>
void dispatch_items(int H, int F, bool aligned, Launch&& launch) {
  if (H == 1) {
    pick_layout<1>(F, F, aligned, launch);
  } else {
    pick_layout<8>(F, (H < 8 ? H : 8) * F, aligned, launch);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

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
  const int KH = H == 1 ? 1 : 8;
  const dim3 grid((n_items + warps - 1) / warps, (H + KH - 1) / KH);
  dispatch_items(H, F, aligned16(h), [&](auto lanes) {
    using L = decltype(lanes);
    err = launch(bf16 ? gat_coo_fwd_kernel<L, true>
                      : gat_coo_fwd_kernel<L, false>,
                 grid, warps * 32, 0, stream,
                 reinterpret_cast<const int4*>(items), slot, n_items, ptr,
                 src, f1, f2, h, out, m, l, ws, H, F, slope);
  });
  if (err != cudaSuccess || n_split == 0) return err;
  return launch(gat_coo_fwd_merge_kernel, dim3((n_split + 7) / 8), 256, 0,
                stream, split_rows, split_ptr, n_split, (const float*)ws,
                out, m, l, H, F);
}

// Row backward: df1 [n_pad, H] from g [n_pad, H*F] and the forward's m, l
// and D = per-head g . out [n_pad, H], over one segment of the forward
// tables (output tiles lo .. lo + n_tiles - 1). ws: null, or an int
// workspace with a slot for every slot of the segment's tables, when the
// list of a tile does not fit in list_slots ints of shared memory.
extern "C" int h2gcn_gat_coo_bwd_row(const int* tile_ptr, const int* oth,
                                     const int* rows, const int* cols,
                                     const float* vals, int* ws,
                                     const float* f1, const float* f2,
                                     const float* h, const float* g,
                                     const float* m, const float* l,
                                     const float* d, float* df1, int lo,
                                     int n_tiles, int T, int e_b,
                                     int list_slots, int H, int F,
                                     float slope, int bf16,
                                     cudaStream_t stream) {
  if (bad_shape(n_tiles, T, e_b, H, F)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H * F, T, ws ? 0 : list_slots);
  cudaError_t err = cudaSuccess;
  gat::dispatch(H, F, [&](auto q, auto r) {
    constexpr int Q = decltype(q)::value, R = decltype(r)::value;
    err = launch(bf16 ? gat_coo_bwd_row_kernel<Q, R, true>
                      : gat_coo_bwd_row_kernel<Q, R, false>,
                 dim3(n_tiles), kThreads, smem, stream, tile_ptr, oth, rows,
                 cols, vals, ws, f1, f2, h, g, m, l, d, df1, lo, T, e_b, H, F,
                 slope);
  });
  return err;
}

// Column backward over work items of the per-column lists (ptr [n_pad + 1],
// dst [E]): dh [n_pad, H*F] and df2 [n_pad, H]; ws: (H + H F) floats a
// slot of a split column's piece. The other arguments as the forward's.
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
  const int KH = H == 1 ? 1 : 8;
  const dim3 grid((n_items + warps - 1) / warps, (H + KH - 1) / KH);
  const size_t smem = (size_t)warps * (H < KH ? H : KH) * F * sizeof(float);
  dispatch_items(H, F, aligned16(h) && aligned16(g), [&](auto lanes) {
    using L = decltype(lanes);
    err = launch(bf16 ? gat_coo_bwd_col_kernel<L, true>
                      : gat_coo_bwd_col_kernel<L, false>,
                 grid, warps * 32, smem, stream,
                 reinterpret_cast<const int4*>(items), slot, n_items, ptr,
                 dst, f1, f2, h, g, m, l, d, dh, df2, ws, H, F, slope);
  });
  if (err != cudaSuccess || n_split == 0) return err;
  return launch(gat_coo_col_merge_kernel, dim3((n_split + 7) / 8), 256, 0,
                stream, split_cols, split_ptr, n_split, (const float*)ws, dh,
                df2, H, F);
}
