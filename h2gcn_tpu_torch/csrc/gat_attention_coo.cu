// Fused multi-head graph attention over COO-chunk tables for Hopper: the
// forward with its softmax statistics, the row backward pass and the column
// backward pass.
//
// Replaces the TPU kernels of h2gcn_tpu/sparse/pallas_attention_coo.py:
//   gat_coo_fwd      _make_fwd_kernel (_fwd_fn)
//   gat_coo_bwd_row  _make_bwd_row_kernel (_bwd_row_fn)
//   gat_coo_bwd_col  _make_bwd_col_kernel (_bwd_col_fn)
// They compute what the BSR kernels of gat_attention.cu compute (the formulas
// and the per-edge updates are in gat_edge.cuh); only the edge source
// differs. The tables are those of h2gcn_tpu_torch/sparse/attention_coo.py:
// build_attn_coo: per chunk of e_b slots an output tile grp (the destination
// tile for the forward and row tables, the source tile for the transpose
// tables of the column pass) and the opposite tile oth; per slot the
// tile-local destination row, the tile-local source column and a value
// (> 0 marks an edge, 0 a padding slot). tile_ptr[t - lo] is the first chunk
// of output tile t in the segment.
//
// What bounds it on the H100: the serial walk of each row's edges. The least
// work is O(edges * H * F) flops on O(edges) gathered rows; the tables add
// 12 bytes a slot. The TPU kernels densify a T x T mask per chunk with
// one-hot matrix products, an MXU trick; here nothing is densified.
//
// Design. One thread block owns one output tile of T rows (column pass: T
// source columns). It first buckets the tile's edges by tile-local row
// (column) with a counting sort in shared memory: a histogram of the live
// slots, a scan into per-row starts, and a scatter of the global index of
// each edge's other end into a list. The list lives in shared memory when
// the tile's slots fit there and otherwise in a device workspace the wrapper
// allocates (the slots of each tile have their own range in it). Then each
// warp takes whole rows (r = warp, warp + 8, ...) and walks their edges as
// the BSR kernels walk a row's set mask entries, keeping (m, l, acc) or the
// gradient sums in registers. Every output row is written by its one owner,
// rows without an edge with the sentinel state, so no global atomics and no
// zeroing pass. The order of a row's edges in the list follows the
// shared-memory atomics, so sums match the plain version to a tolerance, not
// bitwise.
//
// Precision: Bf16 ("default") rounds the head contractions' operands to bf16
// and keeps every sum f32 (gat_edge.cuh); "highest" is f32 throughout.
//
// Limits: H * F <= 512, any H >= 1, T a multiple of 32 and at most 1024.
// The wrapper (sparse/attention_coo.py) checks them and raises; the
// launchers also refuse them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gat_edge.cuh"

namespace {

using gat::kAll;
using gat::kThreads;
using gat::kWarps;

constexpr int kMaxTile = 1024;

// Counting sort of one tile's live slots by their tile-local key (the
// destination row, or in the column pass the source column). Afterwards
// list[start[k] .. start[k + 1]) holds, for each edge of key k, the global
// index of its other end: oth[chunk] * T + other[slot]. cursor is scratch of
// T ints. Every thread of the block must call it.
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
gat_coo_fwd_kernel(const int* __restrict__ tile_ptr,
                   const int* __restrict__ oth, const int* __restrict__ rows,
                   const int* __restrict__ cols,
                   const float* __restrict__ vals, int* __restrict__ ws,
                   const float* __restrict__ f1, const float* __restrict__ f2,
                   const float* __restrict__ h, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int lo, int T, int e_b, int H, int F, float slope) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HF = H * F;
  const int c_lo = tile_ptr[blockIdx.x], c_hi = tile_ptr[blockIdx.x + 1];
  const Layout s = layout(smem, 2 * H, T, ws, c_lo, e_b);
  bucket_tile(rows, cols, vals, oth, c_lo, c_hi, e_b, T, s.start, s.cursor,
              s.list);
  float* scale_s = s.scratch;  // per head: exp(m_old - m_new)
  float* p_s = scale_s + H;    // per head: exp(e - m_new)
  const int64_t row0 = (int64_t)(lo + blockIdx.x) * T;
  for (int r = warp; r < T; r += kWarps) {
    const int64_t i = row0 + r;
    gat::FwdRow<Q, R, Bf16> row;
    row.begin(f1, i, H, F, lane);
    const int e_end = s.start[r + 1];
    for (int e = s.start[r]; e < e_end; ++e) {
      row.edge(s.list[e], f2, h, H, HF, slope, scale_s, p_s, lane);
    }
    row.end(i, out, m_out, l_out, H, HF, scale_s, lane);
  }
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

// Over the transpose tables: grp is the source tile, oth the destination
// tile, rows / cols the (destination, source) tile-local coordinates.
template <int Q, int R, bool Bf16>
__global__ void __launch_bounds__(kThreads)
gat_coo_bwd_col_kernel(const int* __restrict__ tile_ptr,
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
                       const float* __restrict__ d_in, float* __restrict__ dh,
                       float* __restrict__ df2, int lo, int T, int e_b, int H,
                       int F, float slope) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int HF = H * F;
  const int c_lo = tile_ptr[blockIdx.x], c_hi = tile_ptr[blockIdx.x + 1];
  const Layout s = layout(smem, H + HF, T, ws, c_lo, e_b);
  bucket_tile(cols, rows, vals, oth, c_lo, c_hi, e_b, T, s.start, s.cursor,
              s.list);
  float* alpha_s = s.scratch;  // per head: alpha_ij
  float* prod_s = alpha_s + H;  // g_i[c] * h_j[c]
  const int64_t col0 = (int64_t)(lo + blockIdx.x) * T;
  for (int c = warp; c < T; c += kWarps) {
    const int64_t j = col0 + c;
    gat::ColBwd<Q, R, Bf16> col;
    col.begin(f2, h, j, H, F, lane);
    const int e_end = s.start[c + 1];
    for (int e = s.start[c]; e < e_end; ++e) {
      col.edge(s.list[e], f1, g, m_in, l_in, d_in, H, F, HF, slope, alpha_s,
               prod_s, lane);
    }
    col.end(j, dh, df2, H, HF, lane);
  }
}

bool bad_shape(int n_tiles, int T, int e_b, int H, int F) {
  return n_tiles <= 0 || T <= 0 || T % 32 != 0 || T > kMaxTile || e_b <= 0 ||
         H < 1 || F < 1 || H * F > gat::kMaxHF;
}

// Dynamic shared memory of a launch: the warps' scratch, start and cursor,
// and list_slots ints of list (0 when the list is in ws).
size_t smem_bytes(int scratch, int T, int list_slots) {
  return (size_t)kWarps * scratch * sizeof(float) +
         (size_t)(2 * T + 1 + list_slots) * sizeof(int);
}

// Instantiates the kernel for (Q, R, bf16), sets its shared-memory limit
// and launches it with the given arguments.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int n_tiles, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// One segment of the forward tables: output tiles lo .. lo + n_tiles - 1.
// f1, f2 [n_pad, H]; h [n_pad, H*F]; out [n_pad, H*F] and m, l [n_pad, H]
// get every row of the segment's tiles. ws: null, or an int workspace with a
// slot for every slot of the segment's tables, when the list of a tile does
// not fit in list_slots ints of shared memory. Returns the cudaError_t of
// the launch.
extern "C" int h2gcn_gat_coo_fwd(const int* tile_ptr, const int* oth,
                                 const int* rows, const int* cols,
                                 const float* vals, int* ws, const float* f1,
                                 const float* f2, const float* h, float* out,
                                 float* m, float* l, int lo, int n_tiles,
                                 int T, int e_b, int list_slots, int H, int F,
                                 float slope, int bf16, cudaStream_t stream) {
  if (bad_shape(n_tiles, T, e_b, H, F)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(2 * H, T, ws ? 0 : list_slots);
  cudaError_t err = cudaSuccess;
  gat::dispatch(H, F, [&](auto q, auto r) {
    constexpr int Q = decltype(q)::value, R = decltype(r)::value;
    err = launch(bf16 ? gat_coo_fwd_kernel<Q, R, true>
                      : gat_coo_fwd_kernel<Q, R, false>,
                 n_tiles, smem, stream, tile_ptr, oth, rows, cols, vals, ws,
                 f1, f2, h, out, m, l, lo, T, e_b, H, F, slope);
  });
  return err;
}

// Row backward: df1 [n_pad, H] from g [n_pad, H*F] and the forward's m, l
// and D = per-head g . out [n_pad, H].
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
                 n_tiles, smem, stream, tile_ptr, oth, rows, cols, vals, ws,
                 f1, f2, h, g, m, l, d, df1, lo, T, e_b, H, F, slope);
  });
  return err;
}

// Column backward over one segment of the transpose tables (output tiles
// are source tiles): dh [n_pad, H*F] and df2 [n_pad, H].
extern "C" int h2gcn_gat_coo_bwd_col(const int* tile_ptr, const int* oth,
                                     const int* rows, const int* cols,
                                     const float* vals, int* ws,
                                     const float* f1, const float* f2,
                                     const float* h, const float* g,
                                     const float* m, const float* l,
                                     const float* d, float* dh, float* df2,
                                     int lo, int n_tiles, int T, int e_b,
                                     int list_slots, int H, int F,
                                     float slope, int bf16,
                                     cudaStream_t stream) {
  if (bad_shape(n_tiles, T, e_b, H, F)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H + H * F, T, ws ? 0 : list_slots);
  cudaError_t err = cudaSuccess;
  gat::dispatch(H, F, [&](auto q, auto r) {
    constexpr int Q = decltype(q)::value, R = decltype(r)::value;
    err = launch(bf16 ? gat_coo_bwd_col_kernel<Q, R, true>
                      : gat_coo_bwd_col_kernel<Q, R, false>,
                 n_tiles, smem, stream, tile_ptr, oth, rows, cols, vals, ws,
                 f1, f2, h, g, m, l, d, dh, df2, lo, T, e_b, H, F, slope);
  });
  return err;
}
