// Gather-scatter SpMM for Hopper: y = A @ x over the gscatter chunk tables.
//
// Replaces the TPU kernel h2gcn_tpu/sparse/pallas_gscatter.py:_make_kernel
// (launched from _seg_fn / gscatter_spmm). It reads the same tables that
// h2gcn_tpu_torch/sparse/gscatter.py:build_gscatter_coo produces: for each
// 512-row destination stripe a run of e_b-slot chunks holding the
// stripe-local destination row, the global source column and the f32 weight
// of one edge each (padding slots carry weight 0).
//
// What bounds it on the H100: bytes. Each edge does two flops per feature
// against 12 bytes of table and one gathered x row, so at the widths H2GCN
// aggregates (64 and 128) it sits far below the ridge point. The design
// keeps the output stripe out of device memory: one thread block owns one
// (stripe, 32-feature tile), accumulates the stripe's 512 x 32 f32 rows in
// dynamic shared memory with shared-memory atomics, and writes the stripe
// once. No global atomics, so no output zeroing pass and no contention in
// device memory. Each warp loads 32 slots of the table at once (coalesced),
// broadcasts them lane to lane, and keeps 8 row gathers in flight before it
// adds them, so the gather latency overlaps. Weight-0 slots (padding) are
// skipped without a gather.
//
// Precision: "highest" gathers f32 x; "default" gathers bf16 x (half the
// gather bytes) and upcasts it. Both weight by the f32 value and sum in f32.
// Summation order depends on the atomics' order, so results match the plain
// PyTorch version to a tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFeatTile = 32;  // features per thread block, one per lane
constexpr int kWarps = 16;
constexpr int kInFlight = 8;   // gathers each warp issues before it adds

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
gscatter_kernel(const int* __restrict__ chunk_ptr, const int* __restrict__ rows,
                const int* __restrict__ cols, const float* __restrict__ vals,
                const T* __restrict__ x, float* __restrict__ out, int rb_lo,
                int tile, int e_b, int n_rows, int f, int accumulate) {
  extern __shared__ float acc[];  // [tile][kFeatTile]
  const int stripe = blockIdx.x;
  const int f0 = blockIdx.y * kFeatTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int feat = f0 + lane;
  const bool live = feat < f;

  for (int i = threadIdx.x; i < tile * kFeatTile; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int64_t s_lo = (int64_t)chunk_ptr[stripe] * e_b;
  const int64_t s_hi = (int64_t)chunk_ptr[stripe + 1] * e_b;
  for (int64_t base = s_lo + (int64_t)warp * 32; base < s_hi;
       base += (int64_t)kWarps * 32) {
    const int64_t s = base + lane;
    int r_l = 0, c_l = 0;
    float v_l = 0.f;
    if (s < s_hi) {
      r_l = rows[s];
      c_l = cols[s];
      v_l = vals[s];
    }
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kInFlight) {
      float xv[kInFlight], vv[kInFlight];
      int rr[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        vv[u] = __shfl_sync(0xffffffffu, v_l, j0 + u);
        rr[u] = __shfl_sync(0xffffffffu, r_l, j0 + u);
        const int c = __shfl_sync(0xffffffffu, c_l, j0 + u);
        xv[u] = (live && vv[u] != 0.f) ? to_float(x[(int64_t)c * f + feat]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (live && vv[u] != 0.f) {
          atomicAdd(&acc[rr[u] * kFeatTile + lane], vv[u] * xv[u]);
        }
      }
    }
  }
  __syncthreads();

  const int64_t row0 = (int64_t)(rb_lo + stripe) * tile;
  for (int i = threadIdx.x; i < tile * kFeatTile; i += blockDim.x) {
    const int64_t row = row0 + i / kFeatTile;
    const int col = f0 + i % kFeatTile;
    if (row < n_rows && col < f) {
      float* o = out + row * f + col;
      *o = accumulate ? *o + acc[i] : acc[i];
    }
  }
}

template <typename T>
cudaError_t launch(const int* chunk_ptr, const int* rows, const int* cols,
                   const float* vals, const T* x, float* out, int n_stripes,
                   int rb_lo, int tile, int e_b, int n_rows, int f,
                   int accumulate, cudaStream_t stream) {
  const int smem = tile * kFeatTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gscatter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_stripes, (f + kFeatTile - 1) / kFeatTile);
  gscatter_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      chunk_ptr, rows, cols, vals, x, out, rb_lo, tile, e_b, n_rows, f,
      accumulate);
  return cudaGetLastError();
}

}  // namespace

// One segment of one level. chunk_ptr[s]..chunk_ptr[s+1] are the chunks of
// the segment's stripe s (global stripe rb_lo + s). x_bf16 selects the
// bfloat16 gather. accumulate adds into out instead of overwriting it (the
// mega-hub overflow levels). Returns the cudaError_t of the launch.
extern "C" int h2gcn_gscatter_spmm(const int* chunk_ptr, const int* rows,
                                   const int* cols, const float* vals,
                                   const void* x, int x_bf16, float* out,
                                   int n_stripes, int rb_lo, int tile, int e_b,
                                   int n_rows, int f, int accumulate,
                                   cudaStream_t stream) {
  if (x_bf16) {
    return launch(chunk_ptr, rows, cols, vals,
                  static_cast<const __nv_bfloat16*>(x), out, n_stripes, rb_lo,
                  tile, e_b, n_rows, f, accumulate, stream);
  }
  return launch(chunk_ptr, rows, cols, vals, static_cast<const float*>(x), out,
                n_stripes, rb_lo, tile, e_b, n_rows, f, accumulate, stream);
}

extern "C" const char* h2gcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
