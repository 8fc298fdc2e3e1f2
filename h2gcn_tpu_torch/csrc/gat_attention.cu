// Fused multi-head graph attention over a BSR mask for Hopper: the forward
// with its softmax statistics and the row backward pass. The column backward
// pass walks per-column lists built once from the mask
// (sparse/attention.py: mask_col_lists) with the kernel of
// gat_attention_col.cu.
//
// Replaces the TPU kernels of h2gcn_tpu/sparse/pallas_attention.py:
//   gat_fwd        _make_fwd_stats_kernel / _make_kernel (_fwd_stats_call)
//   gat_bwd_row    _make_bwd_row_kernel / _bwd_row_update (pass R)
// and reads the tables of h2gcn_tpu_torch/sparse/matrix.py:_build_bsr: dense
// B x B f32 mask blocks sorted by (block row, block column) and row_ptr over
// them. Every edge (i, j) of the mask is a block entry > 0. For each head k,
// with F features a head:
//   e_ij   = LeakyReLU_slope(f1[i,k] + f2[j,k])
//   out_i  = sum_j alpha_ij h_j,  alpha_ij = exp(e_ij - m_i) / max(l_i, 1e-16)
//   df1_i  = sum_j alpha_ij (g_i . h_j - D_i) leaky'_ij
// where m_i is the row max of e, l_i the row sum of exp(e - m_i), and
// D_i = g_i . out_i (computed by the caller).
//
// What bounds it on the H100: the mask. Each B x B f32 block is 256 KB at
// B = 256 and must be scanned for its few entries, while the attention
// itself is O(edges * H * F) flops on O(edges) gathered rows. So these
// kernels are bound by the bytes of the mask payload (31.7 MB for Cora's
// 121 blocks, which fits the 50 MB L2), far above the least work of the
// attention that chip_smoke.py reports as the bound.
//
// Design. Nothing is carried between thread blocks: one warp owns one
// destination row i and keeps that row's running state in registers for its
// whole walk. The warp reads 32 mask entries of its row at once (a row of a
// block is contiguous), takes their ballot and visits only the entries that
// are set. What a warp does with each edge (gat_edge.cuh): lane k holds head
// k's scalars (m, l, f1, the df1 sums) and lane c holds feature c of the
// concatenated H*F row (the output accumulator, or g). They trade per-edge
// values through a small per-warp shared-memory scratch (the per-head
// rescale and weight, the per-feature products summed per head). The
// online softmax rescales per edge, so a 256 KB block never has to sit in
// shared memory. Padded rows and filler blocks have no entries: they keep
// m = -1e30 (the JAX sentinel; with -inf, exp(m_old - m_new) would be NaN),
// l = 0 and write out = 0. No global atomics: every output row has one
// owner. Products run as f32 FMA, expf in full precision.
//
// Limits: H * F <= 512 (16 features a lane), any H >= 1, B a multiple of
// 32, n_rows a multiple of B. The wrapper (sparse/attention.py) checks them
// and raises; the launchers also refuse them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gat_edge.cuh"

namespace {

using gat::kAll;
using gat::kThreads;
using gat::kWarps;

// Q: features a lane holds (c = lane + 32 q < H*F); R: heads a lane holds
// (k = lane + 32 r < H).
template <int Q, int R>
__global__ void __launch_bounds__(kThreads)
gat_fwd_kernel(const int* __restrict__ row_ptr,
               const int* __restrict__ block_cols,
               const float* __restrict__ blocks, const float* __restrict__ f1,
               const float* __restrict__ f2, const float* __restrict__ h,
               float* __restrict__ out, float* __restrict__ m_out,
               float* __restrict__ l_out, int n_rows, int B, int H, int F,
               float slope) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HF = H * F;
  float* scale_s = smem + warp * 2 * H;  // per head: exp(m_old - m_new)
  float* p_s = scale_s + H;              // per head: exp(e - m_new)
  const int64_t i = (int64_t)blockIdx.x * kWarps + warp;
  if (i >= n_rows) return;
  const int br = (int)(i / B), il = (int)(i % B);

  gat::FwdRow<Q, R> row;
  row.begin(f1, i, H, F, lane);
  const int b_end = row_ptr[br + 1];
  for (int b = row_ptr[br]; b < b_end; ++b) {
    const float* arow = blocks + ((int64_t)b * B + il) * B;
    const int64_t col0 = (int64_t)block_cols[b] * B;
    for (int j0 = 0; j0 < B; j0 += 32) {
      unsigned bits = __ballot_sync(kAll, arow[j0 + lane] > 0.f);
      while (bits) {
        const int u = __ffs(bits) - 1;
        bits &= bits - 1;
        row.edge(col0 + j0 + u, f2, h, H, HF, slope, scale_s, p_s, lane);
      }
    }
  }
  row.end(i, out, m_out, l_out, H, HF, scale_s, lane);
}

template <int Q, int R>
__global__ void __launch_bounds__(kThreads)
gat_bwd_row_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ block_cols,
                   const float* __restrict__ blocks,
                   const float* __restrict__ f1, const float* __restrict__ f2,
                   const float* __restrict__ h, const float* __restrict__ g,
                   const float* __restrict__ m_in,
                   const float* __restrict__ l_in,
                   const float* __restrict__ d_in, float* __restrict__ df1,
                   int n_rows, int B, int H, int F, float slope) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HF = H * F;
  float* prod_s = smem + warp * HF;  // g_i[c] * h_j[c]
  const int64_t i = (int64_t)blockIdx.x * kWarps + warp;
  if (i >= n_rows) return;
  const int br = (int)(i / B), il = (int)(i % B);

  gat::RowBwd<Q, R> row;
  row.begin(f1, g, m_in, l_in, d_in, i, H, HF, lane);
  const int b_end = row_ptr[br + 1];
  for (int b = row_ptr[br]; b < b_end; ++b) {
    const float* arow = blocks + ((int64_t)b * B + il) * B;
    const int64_t col0 = (int64_t)block_cols[b] * B;
    for (int j0 = 0; j0 < B; j0 += 32) {
      unsigned bits = __ballot_sync(kAll, arow[j0 + lane] > 0.f);
      while (bits) {
        const int u = __ffs(bits) - 1;
        bits &= bits - 1;
        row.edge(col0 + j0 + u, f2, h, H, F, HF, slope, prod_s, lane);
      }
    }
  }
  row.end(i, df1, H, lane);
}

bool bad_shape(int n, int B, int H, int F) {
  return n <= 0 || B <= 0 || B % 32 != 0 || n % B != 0 || H < 1 || F < 1 ||
         H * F > gat::kMaxHF;
}

using gat::dispatch;

}  // namespace

// Forward with stats. blocks [nb, B, B] f32; f1, f2 [n_rows, H]; h
// [n_rows, H*F]; out [n_rows, H*F], m, l [n_rows, H], every row written.
// n_rows = n_row_blocks * B = n_col_blocks * B. Returns the cudaError_t of
// the launch.
extern "C" int h2gcn_gat_fwd(const int* row_ptr, const int* block_cols,
                             const float* blocks, const float* f1,
                             const float* f2, const float* h, float* out,
                             float* m, float* l, int n_rows, int B, int H,
                             int F, float slope, cudaStream_t stream) {
  if (bad_shape(n_rows, B, H, F)) return cudaErrorInvalidValue;
  const dim3 grid(n_rows / kWarps);
  const size_t smem = (size_t)kWarps * 2 * H * sizeof(float);
  return dispatch(H, F, [&](auto q, auto r) {
    gat_fwd_kernel<decltype(q)::value, decltype(r)::value>
        <<<grid, kThreads, smem, stream>>>(row_ptr, block_cols, blocks, f1,
                                           f2, h, out, m, l, n_rows, B, H, F,
                                           slope);
  });
}

// Row backward: df1 [n_rows, H] from g [n_rows, H*F] and the forward's m, l
// and D = per-head g . out [n_rows, H].
extern "C" int h2gcn_gat_bwd_row(const int* row_ptr, const int* block_cols,
                                 const float* blocks, const float* f1,
                                 const float* f2, const float* h,
                                 const float* g, const float* m,
                                 const float* l, const float* d, float* df1,
                                 int n_rows, int B, int H, int F, float slope,
                                 cudaStream_t stream) {
  if (bad_shape(n_rows, B, H, F)) return cudaErrorInvalidValue;
  const dim3 grid(n_rows / kWarps);
  const size_t smem = (size_t)kWarps * H * F * sizeof(float);
  return dispatch(H, F, [&](auto q, auto r) {
    gat_bwd_row_kernel<decltype(q)::value, decltype(r)::value>
        <<<grid, kThreads, smem, stream>>>(row_ptr, block_cols, blocks, f1,
                                           f2, h, g, m, l, d, df1, n_rows, B,
                                           H, F, slope);
  });
}
