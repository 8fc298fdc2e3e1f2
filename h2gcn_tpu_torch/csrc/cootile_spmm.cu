// COO-tile SpMM for Hopper: y = A @ x over the COO-tile chunk tables.
//
// Replaces the TPU kernel h2gcn_tpu/sparse/pallas_cootile.py:_make_kernel
// (and its manual-DMA twin _make_kernel_manual; both launched from _seg_fn /
// cootile_spmm). It reads the tables that
// h2gcn_tpu_torch/sparse/cootile.py:build_cootile produces: chunks of e_b
// slots, each chunk one (tile row ctr, tile column ctc) pair of T x T tiles,
// each slot the tile-local destination row, tile-local source column and
// f32 weight of one edge (padding slots carry weight 0), chunks sorted by
// tile row, row_ptr[r] the first chunk of tile row r.
//
// What it computes is what the TPU kernel computes, not how: the TPU
// densifies every chunk with two one-hot matrix products on its MXU; here
// each edge is one gather of an x row and one add into a running row sum.
//
// What bounds it on the H100: bytes. Two flops per edge and feature against
// 12 bytes of table and one gathered x row, far below the ridge point at the
// widths H2GCN aggregates (64 and 128).
//
// The design avoids the trap of one thread block per tile row: a
// cluster-ordered graph packs its hubs into tile row 0, which can hold tens
// of thousands of chunks. Each block instead takes a fixed-size contiguous
// range of chunks (chunks_per_block) and all F features up to a width of
// 32 * V (V contiguous features a lane, gathered as one vector), so each
// table slot is loaded, balloted and broadcast once per launch. A block
// accumulates into a [tile, 32 * V] f32 buffer in shared memory while its
// chunks stay in one tile row, and flushes the buffer's nonzero entries with
// global atomics into the zeroed y when the tile row changes and at its end.
// The tile row's slots are dealt to the 32 warps in 32-slot groups: one
// contiguous piece a warp, or pieces of a few groups round-robin so the
// warps gather rows of neighbouring tile columns at once (the wrapper picks
// by x's size beside the L2, cootile.py:schedule). Every warp works
// whatever the chunks in the range. A warp loads a group's 32 slots at
// once (coalesced), skips the padding slots with one ballot, and keeps a
// few row gathers in flight before it adds them; the values two groups
// ahead and the rows and columns one group ahead are in flight meanwhile.
// The tables hold a chunk's edges in non-decreasing destination row
// (build_chunk_tables keeps the row-major order inside each tile pair), so
// a lane sums a run of edges of one row in registers and adds it to shared
// memory once, when the row changes and at the end of its slots: on sm_90 a
// shared-memory f32 atomicAdd is a compare-and-swap loop, and the runs cut
// those adds by the edges a run holds. Any slot order gives the same sums;
// the order only decides how often a lane adds. Staging the x tile in
// shared memory, TMA and wgmma are later work.
//
// Precision: "highest" gathers f32 x and adds the f32 product v * x;
// "default" gathers bf16 x and rounds the product v * x to bf16 before the
// f32 add, where the JAX kernel rounds it (its second one-hot contraction
// reads the weighted gather in bf16), two products to one conversion.
// Summation order depends on the atomics' order, so results match the
// plain PyTorch version to a tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

namespace {

using h2gcn::add_products;
using h2gcn::Gather;

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// add a lane's run sum of row `row` (tile-local; -1: none) into the shared
// accumulator, laid out [tile][V][32] so the 32 lanes' adds of one e hit 32
// banks, and clear it
template <int V>
__device__ __forceinline__ void flush_run(float* acc, int row, float (&run)[V],
                                          int lane, int avail) {
  if (row >= 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < avail) atomicAdd(&acc[(row * V + e) * 32 + lane], run[e]);
      run[e] = 0.f;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
cootile_kernel(const int* __restrict__ ctr, const int* __restrict__ ctc,
               const int* __restrict__ row_ptr, const int* __restrict__ rows,
               const int* __restrict__ cols, const float* __restrict__ vals,
               const T* __restrict__ x, float* __restrict__ y, int nchunks,
               int chunks_per_block, int tile, int e_b, int n_rows, int f,
               int vec, int piece) {
  constexpr int kWidth = 32 * V;  // features per thread block
  // gathers each warp issues before it adds: fewer at V = 4 keeps the
  // block within 64 registers a thread
  constexpr int kInFlight = V == 4 ? 4 : 8;
  extern __shared__ float acc[];  // [tile][V][32]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * kWidth;
  const int feat = f0 + lane * V;
  const int avail = f - feat;  // features of this lane in range (<= 0: none)
  const int c_lo = blockIdx.x * chunks_per_block;
  const int c_hi = min(nchunks, c_lo + chunks_per_block);

  for (int i = threadIdx.x; i < tile * kWidth; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  for (int c = c_lo; c < c_hi;) {
    const int r = ctr[c];
    const int run_hi = min(c_hi, row_ptr[r + 1]);
    // the tile row's slots in 32-slot groups, dealt to the warps in pieces
    // of p groups round-robin (piece 0: one contiguous piece a warp): every
    // warp works whatever the chunks in the range, and with small pieces
    // the warps of a block walk neighbouring chunks (of neighbouring tile
    // columns) at once, so their x rows share L2 lines
    const int64_t s_lo = (int64_t)c * e_b;
    const int64_t s_hi = (int64_t)run_hi * e_b;
    const int p = piece > 0 ? piece
                            : max(1, (int)((s_hi - s_lo + 32 * kWarps - 1) /
                                           (32 * kWarps)));
    int64_t front = s_lo + (int64_t)warp * p * 32;  // the warp's next group
    int front_j = 0;                                // ...its index in a piece
    auto advance = [&]() {
      front += 32;
      if (++front_j == p) {
        front_j = 0;
        front += (int64_t)(kWarps - 1) * p * 32;
      }
    };
    // a slot's value, and its tile-local row and global source column
    // where the value is live. place() walks the warp's groups in order and
    // keeps the chunk k of its group's first slot (k_end: the next chunk's
    // first slot); a group of 32 slots touches at most two chunks (e_b >=
    // 32), so a lane's chunk is k or k + 1
    auto value = [&](int64_t b) {
      const int64_t s = b + lane;
      return s < s_hi ? vals[s] : 0.f;
    };
    int k = c;
    int64_t k_end = (int64_t)(c + 1) * e_b;
    auto place = [&](int64_t b, float v, int& r_l, int& c_l) {
      if (b >= k_end) {  // warp-uniform
        k = c + (int)(b - s_lo) / e_b;
        k_end = (int64_t)(k + 1) * e_b;
      }
      r_l = 0;
      c_l = 0;
      if (v != 0.f) {
        const int64_t s = b + lane;
        r_l = rows[s];
        c_l = ctc[k + (s >= k_end)] * tile + cols[s];
      }
    };
    // a pipeline over the warp's groups: the values two groups ahead and
    // the rows and columns one group ahead are in flight while a group's
    // x rows are gathered and added
    int64_t b = front;
    advance();
    int64_t b1 = front;
    advance();
    int64_t b2 = front;
    float v_next = value(b);
    int r_next, c_next;
    place(b, v_next, r_next, c_next);
    float v_after = value(b1);
    int cur = -1;  // the row of the lane's running sum (warp-uniform)
    float run[V];
#pragma unroll
    for (int e = 0; e < V; ++e) run[e] = 0.f;
    for (; b < s_hi; b = b1, b1 = b2, advance(), b2 = front) {
      const float v_l = v_next;
      const int r_l = r_next, c_l = c_next;
      v_next = v_after;
      place(b1, v_next, r_next, c_next);
      v_after = value(b2);
      unsigned todo = __ballot_sync(kFull, v_l != 0.f);
      while (todo) {  // warp-uniform: the ballot's live slots, in order
        float xv[kInFlight][V], vv[kInFlight];
        int rr[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          vv[u] = 0.f;
          rr[u] = 0;
#pragma unroll
          for (int e = 0; e < V; ++e) xv[u][e] = 0.f;
          if (todo) {
            const int j = __ffs(todo) - 1;
            todo &= todo - 1;
            vv[u] = __shfl_sync(kFull, v_l, j);
            rr[u] = __shfl_sync(kFull, r_l, j);
            const int cj = __shfl_sync(kFull, c_l, j);
            if (avail > 0) {
              Gather<T, V>::load(x + (int64_t)cj * f + feat, avail, vec,
                                 xv[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (vv[u] != 0.f) {  // warp-uniform, as is the row test
            if (rr[u] != cur) {
              flush_run<V>(acc, cur, run, lane, avail);
              cur = rr[u];
            }
            add_products<T, V>(vv[u], xv[u], run);
          }
        }
      }
    }
    flush_run<V>(acc, cur, run, lane, avail);
    __syncthreads();
    // flush tile row r: only entries an edge reached can be nonzero;
    // neighbouring threads take neighbouring output columns
    const int64_t row0 = (int64_t)r * tile;
    for (int i = threadIdx.x; i < tile * kWidth; i += kThreads) {
      const int rl = i / kWidth;
      const int col = i % kWidth;
      const int a = (rl * V + col % V) * 32 + col / V;
      const float v = acc[a];
      if (v != 0.f) {
        const int64_t row = row0 + rl;
        if (row < n_rows && f0 + col < f) atomicAdd(&y[row * f + f0 + col], v);
        acc[a] = 0.f;
      }
    }
    __syncthreads();
    c = run_hi;
  }
}

template <typename T, int V>
cudaError_t launch(const int* ctr, const int* ctc, const int* row_ptr,
                   const int* rows, const int* cols, const float* vals,
                   const T* x, float* y, int nchunks, int chunks_per_block,
                   int tile, int e_b, int n_rows, int f, int piece,
                   cudaStream_t stream) {
  const int smem = tile * 32 * V * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cootile_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int vec = h2gcn::vector_gathers<T, V>(x, f);
  const dim3 grid((nchunks + chunks_per_block - 1) / chunks_per_block,
                  (f + 32 * V - 1) / (32 * V));
  cootile_kernel<T, V><<<grid, kThreads, smem, stream>>>(
      ctr, ctc, row_ptr, rows, cols, vals, x, y, nchunks, chunks_per_block,
      tile, e_b, n_rows, f, vec, piece);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int width, const int* ctr, const int* ctc,
                         const int* row_ptr, const int* rows, const int* cols,
                         const float* vals, const T* x, float* y, int nchunks,
                         int chunks_per_block, int tile, int e_b, int n_rows,
                         int f, int piece, cudaStream_t stream) {
  switch (width) {
    case 32:
      return launch<T, 1>(ctr, ctc, row_ptr, rows, cols, vals, x, y, nchunks,
                          chunks_per_block, tile, e_b, n_rows, f, piece,
                          stream);
    case 64:
      return launch<T, 2>(ctr, ctc, row_ptr, rows, cols, vals, x, y, nchunks,
                          chunks_per_block, tile, e_b, n_rows, f, piece,
                          stream);
    case 128:
      return launch<T, 4>(ctr, ctc, row_ptr, rows, cols, vals, x, y, nchunks,
                          chunks_per_block, tile, e_b, n_rows, f, piece,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (zeroed by the caller) += A @ x for one table set. width (32, 64 or
// 128) is the features of one thread block; tile * width f32 must fit in
// shared memory. x_bf16 selects the bfloat16 gather ("default" precision).
// Returns the cudaError_t of the launch.
extern "C" int h2gcn_cootile_spmm(const int* ctr, const int* ctc,
                                  const int* row_ptr, const int* rows,
                                  const int* cols, const float* vals,
                                  const void* x, int x_bf16, float* y,
                                  int nchunks, int chunks_per_block, int tile,
                                  int e_b, int n_rows, int f, int width,
                                  int piece, cudaStream_t stream) {
  if (x_bf16) {
    return launch_width(width, ctr, ctc, row_ptr, rows, cols, vals,
                        static_cast<const __nv_bfloat16*>(x), y, nchunks,
                        chunks_per_block, tile, e_b, n_rows, f, piece,
                          stream);
  }
  return launch_width(width, ctr, ctc, row_ptr, rows, cols, vals,
                      static_cast<const float*>(x), y, nchunks,
                      chunks_per_block, tile, e_b, n_rows, f, piece,
                          stream);
}
