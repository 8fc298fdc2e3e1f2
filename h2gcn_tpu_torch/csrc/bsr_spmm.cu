// Block-sparse-row SpMM for Hopper: out[br] = sum over the row's blocks of
// A_blk @ x[bc], with 128 x 128 dense blocks sorted by (block row, column).
//
// Replaces the TPU kernel h2gcn_tpu/sparse/pallas_spmm.py:_make_kernel
// (launched from bsr_spmm). It reads the tables that
// h2gcn_tpu_torch/sparse/matrix.py:_build_bsr produces; the zero filler
// blocks there guarantee that every block row has at least one block, and
// an empty row would still be written as zeros here.
//
// What bounds it on the H100: each block is 2 * 128 * 128 * F flops against
// 64 KB of f32 payload (32 KB in bf16), so in f32 on the CUDA cores
// (67 TFLOP/s) it is bound by operations from about F = 40 up, and by the
// payload bytes below that; chip_smoke.py computes which for each call. The
// design: one thread block per (block row, 64-feature tile) walks the row's
// blocks, stages a 128 x 32 slice of the block and the matching 32 x 64 x
// slice through shared memory, and accumulates the 128 x 64 output tile in
// registers (8 x 4 per thread), so the output is written once and never
// read back. No wgmma or TMA yet: the products run as f32 FMA.
//
// Precision: "highest" reads f32 payload and f32 x. "default" reads bf16
// payload and bf16 x (half the bytes) and upcasts both; the products of
// bf16 values are exact in f32 and the sum is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;       // block size
constexpr int kFeatTile = 64;  // output features per thread block
constexpr int kDepth = 32;    // block columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, each 8 rows x 4 features

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ block_cols,
           const T* __restrict__ blocks, const T* __restrict__ x,
           float* __restrict__ out, int m, int f, int n_out) {
  __shared__ float a_s[kB][kDepth + 1];  // +1: rows 16 apart hit other banks
  __shared__ float x_s[kDepth][kFeatTile];
  const int br = blockIdx.x;
  const int f0 = blockIdx.y * kFeatTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int b_end = row_ptr[br + 1];
  for (int b = row_ptr[br]; b < b_end; ++b) {
    const int64_t xrow0 = (int64_t)block_cols[b] * kB;
    const T* a = blocks + (int64_t)b * kB * kB;
    for (int k0 = 0; k0 < kB; k0 += kDepth) {
      for (int i = threadIdx.x; i < kB * kDepth; i += kThreads) {
        const int r = i / kDepth, c = i % kDepth;
        a_s[r][c] = to_float(a[r * kB + k0 + c]);
      }
      for (int i = threadIdx.x; i < kDepth * kFeatTile; i += kThreads) {
        const int k = i / kFeatTile, c = i % kFeatTile;
        const int64_t xr = xrow0 + k0 + k;
        const int xc = f0 + c;
        x_s[k][c] = (xr < m && xc < f) ? to_float(x[xr * f + xc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kDepth; ++k) {
        float av[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = a_s[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = x_s[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int64_t row0 = (int64_t)br * kB;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + tx + 16 * j;
      if (r < n_out && c < f) out[r * f + c] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const int* row_ptr, const int* block_cols, const T* blocks,
                   const T* x, float* out, int n_row_blocks, int m, int f,
                   int n_out, cudaStream_t stream) {
  const dim3 grid(n_row_blocks, (f + kFeatTile - 1) / kFeatTile);
  bsr_kernel<T><<<grid, kThreads, 0, stream>>>(row_ptr, block_cols, blocks, x,
                                                out, m, f, n_out);
  return cudaGetLastError();
}

}  // namespace

// blocks: [nb, 128, 128] and x: [m, f], both f32 or both bf16 (bf16 != 0).
// row_ptr[br]..row_ptr[br+1] are the sorted blocks of block row br. out:
// [n_out, f] f32, every row written. Returns the cudaError_t of the launch.
extern "C" int h2gcn_bsr_spmm(const int* row_ptr, const int* block_cols,
                              const void* blocks, const void* x, int bf16,
                              float* out, int n_row_blocks, int m, int f,
                              int n_out, cudaStream_t stream) {
  if (bf16) {
    return launch(row_ptr, block_cols,
                  static_cast<const __nv_bfloat16*>(blocks),
                  static_cast<const __nv_bfloat16*>(x), out, n_row_blocks, m,
                  f, n_out, stream);
  }
  return launch(row_ptr, block_cols, static_cast<const float*>(blocks),
                static_cast<const float*>(x), out, n_row_blocks, m, f, n_out,
                stream);
}
