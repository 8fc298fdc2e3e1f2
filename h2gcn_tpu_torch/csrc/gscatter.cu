// Gather-scatter SpMM for Hopper (#1): y = A @ x over the matrix's own
// row-major entries, each destination row summed in registers.
//
// Replaces the TPU kernel h2gcn_tpu/sparse/pallas_gscatter.py:_make_kernel
// (launched from _seg_fn / gscatter_spmm), which scatters the chunk tables'
// edges into a VMEM stripe with a one-hot contraction. It reads the payload
// of h2gcn_tpu_torch/sparse/gscatter.py:build_row_major: a canonical CSR's
// row pointer, column indices and values (the caller's own arrays, 8 bytes
// an entry), and the work items that row_schedule cuts from it once.
//
// What bounds it on the H100: the gathered x rows, served from L2. Each
// entry does two flops per feature against one gathered x row (512 B at
// F = 128 in f32) and 8 bytes of payload, far below the ridge point; the
// hop matrices' heaviest columns cover most of their entries, so the
// gathers mostly hit the 50 MB L2, and the payload and y stream past it
// once.
//
// The design: a group of G lanes owns one destination row at a time, each
// lane 4 features (16-byte loads in f32), so G follows F: 8 lanes up to
// F = 32, 16 up to 64, 32 for a tile of 128 (wider F: one tile of 128 per
// grid row). A warp thus sums 4, 2 or 1 rows at once, which suits short
// rows (arXiv-year's Ã: about 15 entries a row). The group loads G
// (column, value) pairs coalesced, hands them out by shuffle, keeps 8 row
// gathers in flight and adds the products into f32 registers; it writes its
// y row once with plain stores. No atomics on shared memory, and one launch
// a call: each group takes one work item of the schedule, a run of about
// `budget` entries (set from nnz and the SM count), so a hub row of 169K
// entries is spread over many groups and no SM waits on one. A row cut by
// an item boundary is summed piece by piece: each piece goes to a scratch
// slot, and the group that finishes a row's last piece (a counter per split
// row, reset by that group) adds the pieces in slot order and writes the
// row: y is deterministic. Every row is written, empty ones as zeros. The
// payload and y are streamed past the L2 (evict-first), so x keeps it.
//
// Precision: "highest" gathers f32 x and adds the f32 product v * x;
// "default" gathers bf16 x and rounds the product v * x to bf16 before the
// f32 add, where the JAX kernel rounds it (its one-hot contraction reads
// the weighted gather in bf16). The plain version sums in the same order;
// the kernel's fused multiply-adds round once where it rounds twice, so the
// two agree to a tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather.cuh"

namespace {

using h2gcn::Gather;

constexpr int kThreads = 256;
constexpr int kInFlight = 8;  // gathers each group issues before it adds
constexpr int V = 4;          // features a lane

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

// V features of y (or a scratch slot) at p from registers
__device__ __forceinline__ void store_row(float* p, const float (&v)[V],
                                          int avail, bool vec) {
  if (vec && avail >= V) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e < avail) __stcs(p + e, v[e]);
  }
}

__device__ __forceinline__ void load_slot(const float* p, int avail, bool vec,
                                          float (&v)[V]) {
  if (vec && avail >= V) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = e < avail ? __ldcg(p + e) : 0.f;
}

// acc += the products of entries [lo, hi) of one row, in entry order
template <typename T, int G>
__device__ __forceinline__ void sum_entries(
    int lo, int hi, const int* __restrict__ cols,
    const float* __restrict__ vals, const T* __restrict__ x, int f, int feat,
    int avail, bool vec_x, int gl, unsigned mask, float (&acc)[V]) {
  for (int base = lo; base < hi; base += G) {
    const int e = base + gl;
    int c_l = 0;
    float v_l = 0.f;
    if (e < hi) {
      c_l = __ldcs(cols + e);
      v_l = __ldcs(vals + e);
    }
    const int cnt = min(G, hi - base);
    for (int j = 0; j < cnt; j += kInFlight) {  // group-uniform
      float xv[kInFlight][V], vv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        vv[u] = __shfl_sync(mask, v_l, j + u, G);
        const int cj = __shfl_sync(mask, c_l, j + u, G);
#pragma unroll
        for (int q = 0; q < V; ++q) xv[u][q] = 0.f;
        if (j + u < cnt && avail > 0) {
          Gather<T, V>::load(x + (int64_t)cj * f + feat, avail, vec_x, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (j + u < cnt) h2gcn::add_products<T, V>(vv[u], xv[u], acc);
      }
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gscatter_rows_kernel(const int4* __restrict__ items,
                     const int2* __restrict__ splits,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ cols,
                     const float* __restrict__ vals, const T* __restrict__ x,
                     float* __restrict__ y, float* __restrict__ part,
                     int* __restrict__ counters, int n_items, int n_rows,
                     int f, int vec_x, int vec_y) {
  constexpr int kGroups = kThreads / G;
  const int gl = threadIdx.x & (G - 1);
  const int item = blockIdx.x * kGroups + threadIdx.x / G;
  if (item >= n_items) return;  // the whole group
  const unsigned mask = group_mask<G>();
  const int feat = blockIdx.y * (G * V) + gl * V;
  const int avail = f - feat;  // features of this lane in range (<= 0: none)
  const int4 it = items[item];
  const int2 nx = *reinterpret_cast<const int2*>(items + item + 1);
  const int e_lo = it.x, e_hi = nx.x;
  // rows [it.y, nx.y) end in this item; row nx.y may begin in it
  const int r_last = min(nx.y, n_rows - 1);

  for (int rb = it.y; rb <= r_last; rb += G - 1) {
    // the group's next G - 1 rows' bounds, one row pointer a lane
    const int rp = row_ptr[min(rb + gl, n_rows)];
    const int nrow = min(G - 1, r_last + 1 - rb);
    for (int k = 0; k < nrow; ++k) {  // group-uniform
      const int r = rb + k;
      const int start = __shfl_sync(mask, rp, k, G);
      const int end = __shfl_sync(mask, rp, k + 1, G);
      if (r == nx.y && start >= e_hi) break;  // it begins in a later item
      const bool began = start < e_lo;  // a piece: the row began before
      const bool goes_on = end > e_hi;  // ...or goes on past this item
      float acc[V] = {0.f, 0.f, 0.f, 0.f};
      sum_entries<T, G>(max(start, e_lo), min(end, e_hi), cols, vals, x, f,
                        feat, avail, vec_x, gl, mask, acc);
      float* yrow = y + (int64_t)r * f + feat;
      if (!began && !goes_on) {
        if (avail > 0) store_row(yrow, acc, avail, vec_y);
        continue;
      }
      // one piece of a split row: park it in its slot; the group that
      // parks the last piece adds them all in slot order
      const int s = began ? it.z : it.w;
      const int2 sp = splits[s];
      const int n_pieces = splits[s + 1].x - sp.x;
      const int mine = item - sp.y;
      if (avail > 0) {
        store_row(part + (int64_t)(sp.x + mine) * f + feat, acc, avail,
                  vec_y);
      }
      __threadfence();
      __syncwarp(mask);
      int* count = counters + (int64_t)s * gridDim.y + blockIdx.y;
      int done = 0;
      if (gl == 0) done = atomicAdd(count, 1);
      done = __shfl_sync(mask, done, 0, G);
      if (done != n_pieces - 1) continue;
      __threadfence();
      float sum[V] = {0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < n_pieces; ++p) {
        float t[V];
        if (p == mine) {
#pragma unroll
          for (int q = 0; q < V; ++q) t[q] = acc[q];
        } else if (avail > 0) {
          load_slot(part + (int64_t)(sp.x + p) * f + feat, avail, vec_y, t);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) t[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < V; ++q) sum[q] += t[q];
      }
      if (avail > 0) store_row(yrow, sum, avail, vec_y);
      if (gl == 0) *count = 0;  // for the next call
    }
  }
}

template <typename T, int G>
cudaError_t launch(const int* items, const int* splits, const int* row_ptr,
                   const int* cols, const float* vals, const T* x, float* y,
                   float* part, int* counters, int n_items, int n_rows, int f,
                   cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int vec_x = h2gcn::vector_gathers<T, V>(x, f);
  const int vec_y = f % V == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(part) % 16 == 0;
  const dim3 grid((n_items + kGroups - 1) / kGroups,
                  (f + G * V - 1) / (G * V));
  gscatter_rows_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(items),
      reinterpret_cast<const int2*>(splits), row_ptr, cols, vals, x, y, part,
      counters, n_items, n_rows, f, vec_x, vec_y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const int* items, const int* splits,
                         const int* row_ptr, const int* cols,
                         const float* vals, const T* x, float* y, float* part,
                         int* counters, int n_items, int n_rows, int f,
                         cudaStream_t stream) {
  if (f <= 8 * V) {
    return launch<T, 8>(items, splits, row_ptr, cols, vals, x, y, part,
                        counters, n_items, n_rows, f, stream);
  }
  if (f <= 16 * V) {
    return launch<T, 16>(items, splits, row_ptr, cols, vals, x, y, part,
                         counters, n_items, n_rows, f, stream);
  }
  return launch<T, 32>(items, splits, row_ptr, cols, vals, x, y, part,
                       counters, n_items, n_rows, f, stream);
}

}  // namespace

// y [n_rows, f] = A @ x, every row written. items [n_items + 1] int4 and
// splits [n_split + 1] int2 are gscatter.py:row_schedule's tables (int4- and
// int2-aligned); row_ptr, cols and vals the row-major entries; part holds
// a slot of f floats for each piece of a split row; counters
// [n_split * feature tiles] are zero and left zero. x_bf16 selects the
// bfloat16 gather ("default" precision). Returns the cudaError_t of the
// launch.
extern "C" int h2gcn_gscatter_spmm(const int* items, const int* splits,
                                   const int* row_ptr, const int* cols,
                                   const float* vals, const void* x,
                                   int x_bf16, float* y, float* part,
                                   int* counters, int n_items, int n_rows,
                                   int f, cudaStream_t stream) {
  if (x_bf16) {
    return launch_width(items, splits, row_ptr, cols, vals,
                        static_cast<const __nv_bfloat16*>(x), y, part,
                        counters, n_items, n_rows, f, stream);
  }
  return launch_width(items, splits, row_ptr, cols, vals,
                      static_cast<const float*>(x), y, part, counters,
                      n_items, n_rows, f, stream);
}

extern "C" const char* h2gcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
