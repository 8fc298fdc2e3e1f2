// Gather-scatter SpMM for Hopper: y = A @ x over the gscatter chunk tables.
//
// Replaces the TPU kernel h2gcn_tpu/sparse/pallas_gscatter.py:_make_kernel
// (launched from _seg_fn / gscatter_spmm). It reads the same tables that
// h2gcn_tpu_torch/sparse/gscatter.py:build_gscatter_coo produces: for each
// tile-row destination stripe a run of e_b-slot chunks holding the
// stripe-local destination row, the global source column and the f32 weight
// of one edge each (padding slots carry weight 0), chunks sorted by stripe,
// chunk_ptr[s] the first chunk of stripe s.
//
// What bounds it on the H100: bytes. Each edge does two flops per feature
// against 12 bytes of table and one gathered x row, far below the ridge
// point at the widths H2GCN aggregates (64 and 128); the gathers of x rows
// mostly hit L2.
//
// The design avoids the trap of one thread block per stripe: a hub stripe
// (stripe 0 of the 10K-node A2 holds 21% of its edges) would make the
// kernel's time that one block's time. Each thread block takes one work item
// of the schedule that gscatter.py builds from chunk_ptr beside the tables
// (a contiguous range of at most a budget of chunks: whole small stripes
// packed together, a heavy stripe cut into equal parts) and one tile of
// 32 * V features, V to a lane so a lane gathers V contiguous values at
// once. It accumulates into a [tile, 32 * V] f32 buffer in shared memory
// with shared-memory atomics while its chunks stay in one stripe, and
// flushes the buffer's nonzero entries with global atomics into the zeroed
// y when the stripe changes and at its end, so segments and overflow levels
// are further launches into the same y. Each warp takes 32 consecutive table
// slots at a time (coalesced), skips the padding slots with one ballot, and
// keeps 8 row gathers in flight before it adds them. Slot and x offsets are
// 64-bit. A block has 32 warps: on sm_90 a shared-memory f32 atomicAdd is a
// compare-and-swap loop (ATOMS.CAST.SPIN), and the gathers and those loops
// hide best behind many warps (the H100 sweep in PERF.md, section 6, chose
// 32 warps, tile 128 and 128 features a block).
//
// Precision: "highest" gathers f32 x and adds the f32 product v * x;
// "default" gathers bf16 x and rounds the product v * x to bf16 before the
// f32 add, where the JAX kernel rounds it (its one-hot contraction reads
// the weighted gather in bf16). Summation order depends on the atomics'
// order, so results match the plain PyTorch version to a tolerance, not
// bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;  // more warps in flight hide the gathers best
constexpr int kThreads = kWarps * 32;
constexpr int kInFlight = 8;  // gathers each warp issues before it adds
constexpr unsigned kFull = 0xffffffffu;

// V contiguous features of one x row; vec: f % V == 0 and x aligned, so
// a lane whose first feature is in range has all V in range
template <typename T, int V>
struct Gather;

template <int V>
struct Gather<float, V> {
  static __device__ __forceinline__ void load(const float* p, int avail,
                                              bool vec, float (&out)[V]) {
    if (vec && avail >= V) {
      if constexpr (V == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
      } else if constexpr (V == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        out[0] = t.x; out[1] = t.y;
      } else {
        out[0] = *p;
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = e < avail ? p[e] : 0.f;
  }
};

template <int V>
struct Gather<__nv_bfloat16, V> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              int avail, bool vec,
                                              float (&out)[V]) {
    if (vec && avail >= V) {
      if constexpr (V == 4) {
        const uint2 t = *reinterpret_cast<const uint2*>(p);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&t.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&t.y));
        out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
      } else if constexpr (V == 2) {
        const float2 a =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
        out[0] = a.x; out[1] = a.y;
      } else {
        out[0] = __bfloat162float(*p);
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      out[e] = e < avail ? __bfloat162float(p[e]) : 0.f;
    }
  }
};

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

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gscatter_kernel(const int* __restrict__ item_ptr,
                const int* __restrict__ item_stripe,
                const int* __restrict__ chunk_ptr, const int* __restrict__ rows,
                const int* __restrict__ cols, const float* __restrict__ vals,
                const T* __restrict__ x, float* __restrict__ y, int rb_lo,
                int tile, int e_b, int n_rows, int f, int vec) {
  constexpr int kWidth = 32 * V;  // features per thread block
  // [tile][V][32]: feature f0 + lane * V + e of a row at (row * V + e) * 32
  // + lane, so the 32 lanes' adds of one e hit 32 banks
  extern __shared__ float acc[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * kWidth;
  const int feat = f0 + lane * V;
  const int avail = f - feat;  // features of this lane in range (<= 0: none)
  const int c_lo = item_ptr[blockIdx.x];
  const int c_hi = item_ptr[blockIdx.x + 1];
  int stripe = item_stripe[blockIdx.x];

  for (int i = threadIdx.x; i < tile * kWidth; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  for (int c = c_lo; c < c_hi; ++stripe) {
    const int run_hi = min(c_hi, chunk_ptr[stripe + 1]);
    const int64_t s_lo = (int64_t)c * e_b;
    const int64_t s_hi = (int64_t)run_hi * e_b;
    for (int64_t base = s_lo + (int64_t)warp * 32; base < s_hi;
         base += (int64_t)kThreads) {
      const int64_t s = base + lane;
      int r_l = 0, c_l = 0;
      float v_l = 0.f;
      if (s < s_hi) {
        v_l = vals[s];
        if (v_l != 0.f) {
          r_l = rows[s];
          c_l = cols[s];
        }
      }
      unsigned todo = __ballot_sync(kFull, v_l != 0.f);
      while (todo) {  // warp-uniform: the ballot's live slots
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
          if (avail > 0 && vv[u] != 0.f) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
              atomicAdd(&acc[(rr[u] * V + e) * 32 + lane],
                        product<T>(vv[u], xv[u][e]));
            }
          }
        }
      }
    }
    __syncthreads();
    // flush the stripe: only entries an edge reached can be nonzero;
    // neighbouring threads take neighbouring output columns
    const int64_t row0 = (int64_t)(rb_lo + stripe) * tile;
    for (int i = threadIdx.x; i < tile * kWidth; i += kThreads) {
      const int r = i / kWidth;
      const int col = i % kWidth;
      const int a = (r * V + col % V) * 32 + col / V;
      const float v = acc[a];
      if (v != 0.f) {
        const int64_t row = row0 + r;
        if (row < n_rows && f0 + col < f) atomicAdd(&y[row * f + f0 + col], v);
        acc[a] = 0.f;
      }
    }
    __syncthreads();
    c = run_hi;
  }
}

template <typename T, int V>
cudaError_t launch(const int* item_ptr, const int* item_stripe, int n_items,
                   const int* chunk_ptr, const int* rows, const int* cols,
                   const float* vals, const T* x, float* y, int rb_lo,
                   int tile, int e_b, int n_rows, int f, cudaStream_t stream) {
  const int smem = tile * 32 * V * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gscatter_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int vec = f % V == 0 &&
                  reinterpret_cast<uintptr_t>(x) % (V * sizeof(T)) == 0;
  const dim3 grid(n_items, (f + 32 * V - 1) / (32 * V));
  gscatter_kernel<T, V><<<grid, kThreads, smem, stream>>>(
      item_ptr, item_stripe, chunk_ptr, rows, cols, vals, x, y, rb_lo, tile,
      e_b, n_rows, f, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int width, const int* item_ptr,
                         const int* item_stripe, int n_items,
                         const int* chunk_ptr, const int* rows,
                         const int* cols, const float* vals, const T* x,
                         float* y, int rb_lo, int tile, int e_b, int n_rows,
                         int f, cudaStream_t stream) {
  switch (width) {
    case 32:
      return launch<T, 1>(item_ptr, item_stripe, n_items, chunk_ptr, rows,
                          cols, vals, x, y, rb_lo, tile, e_b, n_rows, f,
                          stream);
    case 64:
      return launch<T, 2>(item_ptr, item_stripe, n_items, chunk_ptr, rows,
                          cols, vals, x, y, rb_lo, tile, e_b, n_rows, f,
                          stream);
    case 128:
      return launch<T, 4>(item_ptr, item_stripe, n_items, chunk_ptr, rows,
                          cols, vals, x, y, rb_lo, tile, e_b, n_rows, f,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (zeroed by the caller) += A @ x for one segment of one level. Work item
// i walks chunks item_ptr[i]..item_ptr[i+1], the first of them in stripe
// item_stripe[i] (relative to rb_lo); chunk_ptr[s] is the first chunk of the
// segment's stripe s. width (32, 64 or 128) is the features of one thread
// block; tile * width f32 must fit in shared memory. x_bf16 selects the
// bfloat16 gather ("default" precision). Returns the cudaError_t of the
// launch.
extern "C" int h2gcn_gscatter_spmm(const int* item_ptr, const int* item_stripe,
                                   int n_items, const int* chunk_ptr,
                                   const int* rows, const int* cols,
                                   const float* vals, const void* x,
                                   int x_bf16, float* y, int rb_lo, int tile,
                                   int e_b, int n_rows, int f, int width,
                                   cudaStream_t stream) {
  if (x_bf16) {
    return launch_width(width, item_ptr, item_stripe, n_items, chunk_ptr,
                        rows, cols, vals,
                        static_cast<const __nv_bfloat16*>(x), y, rb_lo, tile,
                        e_b, n_rows, f, stream);
  }
  return launch_width(width, item_ptr, item_stripe, n_items, chunk_ptr, rows,
                      cols, vals, static_cast<const float*>(x), y, rb_lo,
                      tile, e_b, n_rows, f, stream);
}

extern "C" const char* h2gcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
