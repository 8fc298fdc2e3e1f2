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
// each edge is one gather of an x row and one add into the output row.
//
// What bounds it on the H100: bytes. Two flops per edge and feature against
// 12 bytes of table and one gathered x row, far below the ridge point at the
// widths H2GCN aggregates (64 and 128).
//
// The design avoids the trap of one thread block per tile row: a
// cluster-ordered graph packs its hubs into tile row 0, which can hold tens
// of thousands of chunks. Each block instead takes a fixed-size contiguous
// range of chunks (chunks_per_block) and one 32-feature tile, so a heavy tile
// row is spread over many blocks. A block accumulates into a [tile, 32] f32
// buffer in shared memory with shared-memory atomics while its chunks stay in
// one tile row, and flushes the buffer's nonzero entries with global atomics
// into the zeroed y when the tile row changes and at its end. Each warp takes
// whole chunks, loads 32 slots at a time (coalesced), skips the padding
// slots with one ballot, and keeps 8 row gathers in flight before it adds
// them. Staging the x tile in shared memory, TMA and wgmma are later work.
//
// Precision: "highest" gathers f32 x and adds the f32 product v * x;
// "default" gathers bf16 x and rounds the product v * x to bf16 before the
// f32 add, where the JAX kernel rounds it (its second one-hot contraction
// reads the weighted gather in bf16). Summation order depends on the
// atomics' order, so results match the plain PyTorch version to a
// tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeatTile = 32;  // features per thread block, one per lane
constexpr int kWarps = 8;
constexpr int kInFlight = 8;   // gathers each warp issues before it adds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the weighted product as the precision rounds it
template <typename T>
__device__ __forceinline__ float product(float v, float x);
template <>
__device__ __forceinline__ float product<float>(float v, float x) {
  return v * x;
}
template <>
__device__ __forceinline__ float product<__nv_bfloat16>(float v, float x) {
  return __bfloat162float(__float2bfloat16(v * x));
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
cootile_kernel(const int* __restrict__ ctr, const int* __restrict__ ctc,
               const int* __restrict__ row_ptr, const int* __restrict__ rows,
               const int* __restrict__ cols, const float* __restrict__ vals,
               const T* __restrict__ x, float* __restrict__ y, int nchunks,
               int chunks_per_block, int tile, int e_b, int n_rows, int f) {
  extern __shared__ float acc[];  // [tile][kFeatTile]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * kFeatTile;
  const int feat = f0 + lane;
  const bool live = feat < f;
  const int c_lo = blockIdx.x * chunks_per_block;
  const int c_hi = min(nchunks, c_lo + chunks_per_block);

  for (int i = threadIdx.x; i < tile * kFeatTile; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  for (int c = c_lo; c < c_hi;) {
    const int r = ctr[c];
    const int run_hi = min(c_hi, row_ptr[r + 1]);
    for (int k = c + warp; k < run_hi; k += kWarps) {
      const int64_t base = (int64_t)k * e_b;
      const int col0 = ctc[k] * tile;
      for (int s0 = 0; s0 < e_b; s0 += 32) {
        const int s = s0 + lane;
        int r_l = 0, c_l = 0;
        float v_l = 0.f;
        if (s < e_b) {
          v_l = vals[base + s];
          if (v_l != 0.f) {
            r_l = rows[base + s];
            c_l = col0 + cols[base + s];
          }
        }
        unsigned todo = __ballot_sync(kFull, v_l != 0.f);
        while (todo) {  // warp-uniform: the ballot's live slots
          float xv[kInFlight], vv[kInFlight];
          int rr[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            vv[u] = 0.f;
            rr[u] = 0;
            xv[u] = 0.f;
            if (todo) {
              const int j = __ffs(todo) - 1;
              todo &= todo - 1;
              vv[u] = __shfl_sync(kFull, v_l, j);
              rr[u] = __shfl_sync(kFull, r_l, j);
              const int cj = __shfl_sync(kFull, c_l, j);
              if (live) xv[u] = to_float(x[(int64_t)cj * f + feat]);
            }
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            if (live && vv[u] != 0.f) {
              atomicAdd(&acc[rr[u] * kFeatTile + lane],
                        product<T>(vv[u], xv[u]));
            }
          }
        }
      }
    }
    __syncthreads();
    // flush tile row r: only entries an edge reached can be nonzero
    const int64_t row0 = (int64_t)r * tile;
    for (int i = threadIdx.x; i < tile * kFeatTile; i += blockDim.x) {
      const float v = acc[i];
      if (v != 0.f) {
        const int64_t row = row0 + i / kFeatTile;
        const int col = f0 + i % kFeatTile;
        if (row < n_rows && col < f) atomicAdd(&y[row * f + col], v);
        acc[i] = 0.f;
      }
    }
    __syncthreads();
    c = run_hi;
  }
}

template <typename T>
cudaError_t launch(const int* ctr, const int* ctc, const int* row_ptr,
                   const int* rows, const int* cols, const float* vals,
                   const T* x, float* y, int nchunks, int chunks_per_block,
                   int tile, int e_b, int n_rows, int f,
                   cudaStream_t stream) {
  const int smem = tile * kFeatTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cootile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nchunks + chunks_per_block - 1) / chunks_per_block,
                  (f + kFeatTile - 1) / kFeatTile);
  cootile_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      ctr, ctc, row_ptr, rows, cols, vals, x, y, nchunks, chunks_per_block,
      tile, e_b, n_rows, f);
  return cudaGetLastError();
}

}  // namespace

// y (zeroed by the caller) += A @ x for one table set. x_bf16 selects the
// bfloat16 gather ("default" precision). Returns the cudaError_t of the
// launch.
extern "C" int h2gcn_cootile_spmm(const int* ctr, const int* ctc,
                                  const int* row_ptr, const int* rows,
                                  const int* cols, const float* vals,
                                  const void* x, int x_bf16, float* y,
                                  int nchunks, int chunks_per_block, int tile,
                                  int e_b, int n_rows, int f,
                                  cudaStream_t stream) {
  if (x_bf16) {
    return launch(ctr, ctc, row_ptr, rows, cols, vals,
                  static_cast<const __nv_bfloat16*>(x), y, nchunks,
                  chunks_per_block, tile, e_b, n_rows, f, stream);
  }
  return launch(ctr, ctc, row_ptr, rows, cols, vals,
                static_cast<const float*>(x), y, nchunks, chunks_per_block,
                tile, e_b, n_rows, f, stream);
}
