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
// stripe walk it shares. The design avoids the trap of one thread block per
// stripe (the 10K graph's heaviest 512-row stripe holds 27% of its edges):
// each block takes one work item of the schedule that
// attention_gather.py:build_gatherattn cuts beside the tables with
// gscatter.build_schedule (a contiguous range of chunks: whole small
// stripes packed together, a heavy stripe cut into near-equal parts) and up
// to 32 * V columns, column e * 32 + lane to lane `lane`, so a row's V
// gathers are coalesced whatever the width (72 = 8 heads of 8 + 1 takes
// V = 3). It accumulates into a [tile, 32 * V] f32 buffer in shared memory
// with shared-memory atomics while its chunks stay in one stripe, and
// flushes the buffer's nonzero entries with global atomics into the zeroed
// out when the stripe changes and at its end. Each warp loads 32 slots of
// the tables at once, skips the padding slots with one ballot and
// broadcasts the live ones lane to lane; each edge's x gather is issued
// beside its weight gather (both hang on the table value only), with a few
// edges in flight, so a group of edges costs one memory round trip. The
// gather tables are sorted by source column inside a stripe, so
// consecutive edges rarely share a destination row and are added one by
// one.
//
// Precision: "highest" gathers f32 x; "default" gathers bf16 x and upcasts
// it. The weight is f32 and every product and sum f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int V>
__global__ void __launch_bounds__(1024)
gscatter_weighted_kernel(const int* __restrict__ item_ptr,
                         const int* __restrict__ item_stripe,
                         const int* __restrict__ chunk_ptr,
                         const int* __restrict__ rows,
                         const int* __restrict__ cols,
                         const float* __restrict__ vals,
                         const int* __restrict__ slot2edge, int64_t slot_lo,
                         int64_t n_slots, int n_edges,
                         const float* __restrict__ wf,
                         const float* __restrict__ wl, int H, int fw,
                         const T* __restrict__ x, float* __restrict__ out,
                         int rb_lo, int tile, int e_b, int n_rows, int f) {
  constexpr int kWidth = 32 * V;  // columns per thread block
  // edges each warp has in flight before it adds (each with V x and V
  // weight gathers): fewer at V >= 2 keeps the block within 64 registers
  // a thread
  constexpr int kInFlight = V == 1 ? 8 : 4;
  extern __shared__ float acc[];  // [tile][kWidth]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int f0 = blockIdx.y * kWidth;
  // this lane's columns f0 + e * 32 + lane, their heads and weight arrays:
  // the last column of an augmented head block takes wl
  bool live[V];
  int head[V];
  const float* __restrict__ w[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int col = f0 + e * 32 + lane;
    live[e] = col < f;
    head[e] = live[e] ? col / fw : 0;
    w[e] = (wl != nullptr && col % fw == fw - 1) ? wl : wf;
  }
  const int c_lo = item_ptr[blockIdx.x];
  const int c_hi = item_ptr[blockIdx.x + 1];
  int stripe = item_stripe[blockIdx.x];

  for (int i = threadIdx.x; i < tile * kWidth; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  for (int c = c_lo; c < c_hi; ++stripe) {
    const int run_hi = min(c_hi, chunk_ptr[stripe + 1]);
    const int64_t s_lo = (int64_t)c * e_b;
    const int64_t s_hi = (int64_t)run_hi * e_b;
    for (int64_t base = s_lo + (int64_t)warp * 32; base < s_hi;
         base += (int64_t)n_warps * 32) {
      const int64_t s = base + lane;
      int r_l = 0, c_l = 0, e_l = 0;
      float v_l = 0.f;
      if (s < s_hi && s < n_slots) {
        v_l = vals[s];
        e_l = slot2edge[slot_lo + s];
        if (e_l >= n_edges) v_l = 0.f;
        if (v_l != 0.f) {
          r_l = rows[s];
          c_l = cols[s];
        }
      }
      unsigned todo = __ballot_sync(kFull, v_l != 0.f);
      while (todo) {  // warp-uniform: the ballot's live slots
        float xv[kInFlight][V], wv[kInFlight][V], vv[kInFlight];
        int rr[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          vv[u] = 0.f;
          rr[u] = 0;
#pragma unroll
          for (int e = 0; e < V; ++e) xv[u][e] = wv[u][e] = 0.f;
          if (todo) {
            const int j = __ffs(todo) - 1;
            todo &= todo - 1;
            vv[u] = __shfl_sync(kFull, v_l, j);
            rr[u] = __shfl_sync(kFull, r_l, j);
            const int ej = __shfl_sync(kFull, e_l, j);
            const int cj = __shfl_sync(kFull, c_l, j);
#pragma unroll
            for (int e = 0; e < V; ++e) {
              if (live[e]) {
                wv[u][e] = w[e][(int64_t)ej * H + head[e]];
                xv[u][e] = to_float(x[(int64_t)cj * f + f0 + e * 32 + lane]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float wt = vv[u] * wv[u][e];
            if (wt != 0.f) {
              atomicAdd(&acc[rr[u] * kWidth + e * 32 + lane], wt * xv[u][e]);
            }
          }
        }
      }
    }
    __syncthreads();
    // flush the stripe: only entries an edge reached can be nonzero;
    // neighbouring threads take neighbouring output columns
    const int64_t row0 = (int64_t)(rb_lo + stripe) * tile;
    for (int i = threadIdx.x; i < tile * kWidth; i += blockDim.x) {
      const float v = acc[i];
      if (v != 0.f) {
        const int64_t row = row0 + i / kWidth;
        const int col = f0 + i % kWidth;
        if (row < n_rows && col < f) atomicAdd(&out[row * f + col], v);
        acc[i] = 0.f;
      }
    }
    __syncthreads();
    c = run_hi;
  }
}

template <typename T, int V>
cudaError_t launch(const int* item_ptr, const int* item_stripe, int n_items,
                   const int* chunk_ptr, const int* rows, const int* cols,
                   const float* vals, const int* slot2edge, int64_t slot_lo,
                   int64_t n_slots, int n_edges, const float* wf,
                   const float* wl, int H, int fw, const T* x, float* out,
                   int rb_lo, int tile, int e_b, int n_rows, int f,
                   int warps, cudaStream_t stream) {
  const int smem = tile * 32 * V * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gscatter_weighted_kernel<T, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_items, (f + 32 * V - 1) / (32 * V));
  gscatter_weighted_kernel<T, V><<<grid, warps * 32, smem, stream>>>(
      item_ptr, item_stripe, chunk_ptr, rows, cols, vals, slot2edge, slot_lo,
      n_slots, n_edges, wf, wl, H, fw, x, out, rb_lo, tile, e_b, n_rows, f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int v, const int* item_ptr, const int* item_stripe,
                         int n_items, const int* chunk_ptr, const int* rows,
                         const int* cols, const float* vals,
                         const int* slot2edge, int64_t slot_lo,
                         int64_t n_slots, int n_edges, const float* wf,
                         const float* wl, int H, int fw, const T* x,
                         float* out, int rb_lo, int tile, int e_b, int n_rows,
                         int f, int warps, cudaStream_t stream) {
#define H2GCN_WEIGHTED_LAUNCH(V)                                              \
  launch<T, V>(item_ptr, item_stripe, n_items, chunk_ptr, rows, cols, vals,   \
               slot2edge, slot_lo, n_slots, n_edges, wf, wl, H, fw, x, out,   \
               rb_lo, tile, e_b, n_rows, f, warps, stream)
  switch (v) {
    case 1: return H2GCN_WEIGHTED_LAUNCH(1);
    case 2: return H2GCN_WEIGHTED_LAUNCH(2);
    case 3: return H2GCN_WEIGHTED_LAUNCH(3);
    case 4: return H2GCN_WEIGHTED_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef H2GCN_WEIGHTED_LAUNCH
}

}  // namespace

// One segment of gscatter tables built with their edge -> slot map. Work
// item i walks chunks item_ptr[i]..item_ptr[i+1], the first of them in
// stripe item_stripe[i] (relative to rb_lo); chunk_ptr[s] is the first chunk
// of the segment's stripe s. slot2edge [total slots] int32 maps the global
// slot slot_lo + s of the segment's slot s (s < n_slots) to its edge
// (n_edges for padding). wf, wl [n_edges, H] f32; wl null for the plain
// combine. x [m, f] with f = H * fw columns (f32, or bf16 when x_bf16); out
// [n_rows, f] f32, zeroed by the caller, gets the segment's sums added. v
// (1-4) is the columns a lane takes (32 * v a thread block; tile * 32 * v
// f32 must fit in shared memory), warps the warps of a block (1-32).
// Returns the cudaError_t of the launch.
extern "C" int h2gcn_gscatter_weighted(
    const int* item_ptr, const int* item_stripe, int n_items,
    const int* chunk_ptr, const int* rows, const int* cols, const float* vals,
    const int* slot2edge, long long slot_lo, long long n_slots, int n_edges,
    const float* wf, const float* wl, int H, int fw, const void* x,
    int x_bf16, float* out, int rb_lo, int tile, int e_b, int n_rows, int f,
    int v, int warps, cudaStream_t stream) {
  if (H < 1 || fw < 1 || f != H * fw || tile <= 0 || e_b <= 0 || warps < 1 ||
      warps > 32) {
    return cudaErrorInvalidValue;
  }
  if (x_bf16) {
    return launch_width(v, item_ptr, item_stripe, n_items, chunk_ptr, rows,
                        cols, vals, slot2edge, slot_lo, n_slots, n_edges, wf,
                        wl, H, fw, static_cast<const __nv_bfloat16*>(x), out,
                        rb_lo, tile, e_b, n_rows, f, warps, stream);
  }
  return launch_width(v, item_ptr, item_stripe, n_items, chunk_ptr, rows,
                      cols, vals, slot2edge, slot_lo, n_slots, n_edges, wf,
                      wl, H, fw, static_cast<const float*>(x), out, rb_lo,
                      tile, e_b, n_rows, f, warps, stream);
}
