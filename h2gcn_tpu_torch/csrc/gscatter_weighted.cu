// Weighted gather-scatter combine for Hopper: y = A_w @ x over the gscatter
// chunk tables, where each edge's weight is taken per head from an [E, H]
// array. The combine of the gather-formulated GAT attention.
//
// Replaces the combine of h2gcn_tpu/sparse/pallas_attention_gather.py:
// _weighted_combine and _weighted_combine_aug, which fill a [slots, H]
// weight array through slot2edge, multiply the gathered rows by it in XLA
// and run the TPU kernel pallas_gscatter.py:_make_kernel (_seg_fn) on the
// product. Here the weight is fused into the kernel's gather: slot s of a
// segment is edge slot2edge[slot_lo + s] (E for a padding slot, weight 0),
// and feature column c of x belongs to head c / fw. In the augmented form
// (wl given) x carries fw = F + 1 columns a head and the last of them is
// weighted by wl instead of wf: with a ones column it yields the softmax
// denominator, with gl in it the df2 pass's second sum. The four combines
// of one GAT training step run through it: the forward (augmented), dh
// (plain, transpose tables), df1 (augmented, forward tables) and df2
// (augmented, transpose tables).
//
// What bounds it on the H100: bytes, as the SpMM of gscatter.cu whose
// stripe walk it shares: one thread block owns one (512-row destination
// stripe, 32-feature tile), accumulates the stripe in shared memory with
// shared-memory atomics and writes it once; each warp loads 32 slots of the
// tables at once and broadcasts them lane to lane, with 8 row gathers in
// flight. Slots of value 0 (padding) are skipped without a gather. A heavy
// stripe is walked by one block per feature tile, so the heaviest stripe
// sets the time.
//
// Precision: "highest" gathers f32 x; "default" gathers bf16 x and upcasts
// it. The weight is f32 and every product and sum f32.

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
gscatter_weighted_kernel(const int* __restrict__ chunk_ptr,
                         const int* __restrict__ rows,
                         const int* __restrict__ cols,
                         const float* __restrict__ vals,
                         const int* __restrict__ slot2edge, int64_t slot_lo,
                         int64_t n_slots, int n_edges,
                         const float* __restrict__ wf,
                         const float* __restrict__ wl, int H, int fw,
                         const T* __restrict__ x, float* __restrict__ out,
                         int rb_lo, int tile, int e_b, int n_rows, int f) {
  extern __shared__ float acc[];  // [tile][kFeatTile]
  const int stripe = blockIdx.x;
  const int f0 = blockIdx.y * kFeatTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int feat = f0 + lane;
  const bool live = feat < f;
  // this lane's head and weight array: the last column of an augmented
  // head block takes wl
  const int head = live ? feat / fw : 0;
  const float* __restrict__ w = (wl != nullptr && feat % fw == fw - 1) ? wl : wf;

  for (int i = threadIdx.x; i < tile * kFeatTile; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int64_t s_lo = (int64_t)chunk_ptr[stripe] * e_b;
  const int64_t s_hi = (int64_t)chunk_ptr[stripe + 1] * e_b;
  for (int64_t base = s_lo + (int64_t)warp * 32; base < s_hi;
       base += (int64_t)kWarps * 32) {
    const int64_t s = base + lane;
    int r_l = 0, c_l = 0, e_l = 0;
    float v_l = 0.f;
    if (s < s_hi) {
      r_l = rows[s];
      c_l = cols[s];
      v_l = vals[s];
      e_l = s < n_slots ? slot2edge[slot_lo + s] : n_edges;
      if (e_l >= n_edges) v_l = 0.f;
    }
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kInFlight) {
      float xv[kInFlight], wv[kInFlight];
      int rr[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const float v = __shfl_sync(0xffffffffu, v_l, j0 + u);
        const int e = __shfl_sync(0xffffffffu, e_l, j0 + u);
        rr[u] = __shfl_sync(0xffffffffu, r_l, j0 + u);
        const int c = __shfl_sync(0xffffffffu, c_l, j0 + u);
        wv[u] = (live && v != 0.f) ? v * w[(int64_t)e * H + head] : 0.f;
        xv[u] = wv[u] != 0.f ? to_float(x[(int64_t)c * f + feat]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (wv[u] != 0.f) atomicAdd(&acc[rr[u] * kFeatTile + lane], wv[u] * xv[u]);
      }
    }
  }
  __syncthreads();

  const int64_t row0 = (int64_t)(rb_lo + stripe) * tile;
  for (int i = threadIdx.x; i < tile * kFeatTile; i += blockDim.x) {
    const int64_t row = row0 + i / kFeatTile;
    const int col = f0 + i % kFeatTile;
    if (row < n_rows && col < f) out[row * f + col] = acc[i];
  }
}

template <typename T>
cudaError_t launch(const int* chunk_ptr, const int* rows, const int* cols,
                   const float* vals, const int* slot2edge, int64_t slot_lo,
                   int64_t n_slots, int n_edges, const float* wf,
                   const float* wl, int H, int fw, const T* x, float* out,
                   int n_stripes, int rb_lo, int tile, int e_b, int n_rows,
                   int f, cudaStream_t stream) {
  const int smem = tile * kFeatTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gscatter_weighted_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_stripes, (f + kFeatTile - 1) / kFeatTile);
  gscatter_weighted_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      chunk_ptr, rows, cols, vals, slot2edge, slot_lo, n_slots, n_edges, wf,
      wl, H, fw, x, out, rb_lo, tile, e_b, n_rows, f);
  return cudaGetLastError();
}

}  // namespace

// One segment of gscatter tables built with their edge -> slot map.
// slot2edge [total slots] int32 maps the global slot slot_lo + s of the
// segment's slot s (s < n_slots) to its edge (n_edges for padding). wf, wl
// [n_edges, H] f32; wl null for the plain combine. x [m, f] with f = H * fw
// columns (f32, or bf16 when x_bf16); out [n_rows, f] f32 gets the rows of
// the segment's stripes. Returns the cudaError_t of the launch.
extern "C" int h2gcn_gscatter_weighted(
    const int* chunk_ptr, const int* rows, const int* cols, const float* vals,
    const int* slot2edge, long long slot_lo, long long n_slots, int n_edges,
    const float* wf, const float* wl, int H, int fw, const void* x,
    int x_bf16, float* out, int n_stripes, int rb_lo, int tile, int e_b,
    int n_rows, int f, cudaStream_t stream) {
  if (H < 1 || fw < 1 || f != H * fw || tile <= 0 || e_b <= 0) {
    return cudaErrorInvalidValue;
  }
  if (x_bf16) {
    return launch(chunk_ptr, rows, cols, vals, slot2edge, slot_lo, n_slots,
                  n_edges, wf, wl, H, fw,
                  static_cast<const __nv_bfloat16*>(x), out, n_stripes, rb_lo,
                  tile, e_b, n_rows, f, stream);
  }
  return launch(chunk_ptr, rows, cols, vals, slot2edge, slot_lo, n_slots,
                n_edges, wf, wl, H, fw, static_cast<const float*>(x), out,
                n_stripes, rb_lo, tile, e_b, n_rows, f, stream);
}
