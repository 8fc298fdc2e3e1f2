// Batched walks of per-row (or per-column) edge lists in work items, shared
// by every attention kernel: the forward and row pass (gat_attention_coo.cu)
// and the column pass (gat_attention_col.cu), each serving both the
// COO-chunk payload and the BSR mask's lists.
//
// - A list is ptr [n_pad + 1] / other [E]: the edges of row r have their
//   other ends at other[ptr[r] .. ptr[r + 1]). The host builds the lists
//   once (sparse/edge_items.py: build_edge_lists).
// - One warp takes one work item (build_edge_items): a run of at most 32
//   whole rows whose edges plus a fixed cost a row stay within `budget`
//   (a row's walk is a chain of dependent loads, so a long run of short
//   rows would be the slowest warp), or one of ceil(deg / budget)
//   near-equal pieces of a longer row, so a hub row is spread over many
//   warps and SMs. An item loads its rows' list starts at once, one a
//   lane. Every row 0 .. n_pad lies in some item, so rows without an edge
//   write their empty state and the outputs need no zeroing. A piece writes
//   its partial state to a workspace slot; a second small launch over the
//   split rows merges them in piece order, so the results do not vary run
//   to run.
// - A warp walks its edges in batches of 32. Pair layout: register t of
//   lane holds edge t * (32 / KH) + lane / KH of the batch for head
//   lane % KH (KH = 1 or 8 heads a pass; more heads take more passes over
//   gridDim.y). Lanes load the batch's per-edge scalars side by side, and a
//   head's batch max needs log2(32 / KH) shuffles.
// - Feature layout: lane groups of G lanes, V contiguous features a lane
//   (vector loads where F allows), Q such slots. Each group takes its own
//   edges, loading U edges' rows before using any, the batch's first U
//   while its per-edge weights are still being made; a weight comes from
//   its pair lane by shuffle. At layer 2 (H = 1, F = 7) four groups of 8
//   lanes take four edges at once; the groups' sums merge by shuffle at the
//   row's end.
//
// Everything here has internal linkage: each source takes its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gat_edge.cuh"
#include "gather.cuh"

namespace {

using gat::kAll;

constexpr int kMaxItemWarps = 16;  // warps (work items) of one thread block

// How a warp's lanes split the work (see the note at the top). KH heads a
// pass; G lanes a group, V contiguous features a lane, Q feature slots.
template <int KH_, int G_, int V_, int Q_>
struct Lanes {
  static constexpr int KH = KH_, G = G_, V = V_, Q = Q_;
  static constexpr int kEpr = 32 / KH;  // a batch's edges in one pair register
  static constexpr int kNg = 32 / G;    // lane groups, each on its own edge
  // rows a group loads before it uses any: ~16 floats of loads a lane
  static constexpr int kU = Q * V >= 16 ? 1 : (16 / (Q * V) > 8 ? 8
                                                 : 16 / (Q * V));
  // a group's edge e0 + grp shares its pair register with edge e0
  static_assert(kNg <= kEpr, "lane groups must not outnumber a register's "
                             "edges");
};

// The lane's feature slots in a pass of nh heads (FC = nh * F features):
// slot q covers features fc[q] .. fc[q] + V of head fh[q], live when fl[q].
template <class L>
struct Slots {
  int fc[L::Q], fh[L::Q];
  bool fl[L::Q];

  __device__ __forceinline__ Slots(int lane, int FC, int F) {
#pragma unroll
    for (int q = 0; q < L::Q; ++q) {
      fc[q] = ((lane % L::G) + L::G * q) * L::V;
      fl[q] = fc[q] < FC;
      fh[q] = fl[q] ? fc[q] / F : 0;
    }
  }
};

// V features at p when the slot is live, else zeros
template <int V>
__device__ __forceinline__ void load_slot(const float* p, bool live,
                                          float (&x)[V]) {
  if (live) {
    h2gcn::Gather<float, V>::load(p, V, true, x);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = 0.f;
  }
}

// Sum of x over the lanes lane ^ o, o = from, 2 from, ..., 16
template <int From>
__device__ __forceinline__ float xor_sum(float x) {
#pragma unroll
  for (int o = From; o < 32; o <<= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

// An item's row starts, loaded once: lane t holds ptr[lo + t] (an item
// holds at most 32 rows); edges() clips row r's list to the item's range.
struct RowStarts {
  int mine, end;

  __device__ __forceinline__ RowStarts(const int* __restrict__ ptr,
                                       int4 it, int lane)
      : mine(lane < it.y - it.x ? ptr[it.x + lane] : 0), end(ptr[it.y]) {}

  __device__ __forceinline__ void edges(int r, int4 it, int& e_lo,
                                        int& e_hi) const {
    const int t = r - it.x;  // warp-uniform
    const int lo = __shfl_sync(kAll, mine, t);
    const int hi = __shfl_sync(kAll, mine, t + 1 < 32 ? t + 1 : 31);
    e_lo = max(lo, it.z);
    e_hi = min(t + 1 < it.y - it.x ? hi : end, it.w);
  }
};

// Sums the pieces of each split row: slots split_ptr[s] .. split_ptr[s + 1]
// of ws hold row split_rows[s]'s partial (a [na], b [nb]), na + nb floats a
// slot, which go to a[r * na ...] and b[r * nb ...] (b may be null when nb
// is 0). One warp a row.
__global__ void gat_sum_merge_kernel(const int* __restrict__ split_rows,
                                     const int* __restrict__ split_ptr,
                                     int n_split,
                                     const float* __restrict__ ws,
                                     float* __restrict__ a, int na,
                                     float* __restrict__ b, int nb) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int64_t stride = na + nb, r = split_rows[s];
  const float* w0 = ws + split_ptr[s] * stride;
  const float* w1 = ws + split_ptr[s + 1] * stride;
  for (int c = lane; c < stride; c += 32) {
    float sum = 0.f;
    for (const float* w = w0; w < w1; w += stride) sum += w[c];
    if (c < na) {
      a[r * na + c] = sum;
    } else {
      b[r * nb + c - na] = sum;
    }
  }
}

bool bad_items(int n_items, int n_split, int H, int F, int warps) {
  return n_items <= 0 || n_split < 0 || H < 1 || F < 1 ||
         H * F > gat::kMaxHF || warps < 1 || warps > kMaxItemWarps;
}

// Launches the kernel, first raising its shared-memory limit where smem
// is past the default 48 KB.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The merge launch over n_split split rows, when there are any
cudaError_t merge_pieces(const int* split_rows, const int* split_ptr,
                         int n_split, const float* ws, float* a, int na,
                         float* b, int nb, cudaStream_t stream) {
  if (n_split == 0) return cudaSuccess;
  return launch(gat_sum_merge_kernel, dim3((n_split + 7) / 8), 256, 0,
                stream, split_rows, split_ptr, n_split, ws, a, na, b, nb);
}

template <int KH, typename Launch>
void pick_layout(int F, int fc, bool aligned, Launch&& launch) {
  if (fc <= 8) {
    launch(Lanes<KH, 8, 1, 1>{});  // layer 2: 4 groups of 8 lanes
  } else if (fc <= 64 && F % 2 == 0 && aligned) {
    launch(Lanes<KH, 32, 2, 1>{});  // layer 1: 64 features, float2 a lane
  } else if (fc <= 64) {
    launch(Lanes<KH, 32, 1, 2>{});
  } else if (F % 4 == 0 && aligned) {
    launch(Lanes<KH, 32, 4, 4>{});
  } else {
    launch(Lanes<KH, 32, 1, 16>{});
  }
}

// Calls launch(Lanes<...>{}) with the layout that holds H heads of F
// features: one head a pass when H = 1, else 8 heads a pass. aligned: the
// gathered rows allow 16-byte loads.
template <typename Launch>
void dispatch_items(int H, int F, bool aligned, Launch&& launch) {
  if (H == 1) {
    pick_layout<1>(F, F, aligned, launch);
  } else {
    pick_layout<8>(F, (H < 8 ? H : 8) * F, aligned, launch);
  }
}

// The grid of an item launch: items `warps` a block, head passes of KH
constexpr int heads_a_pass(int H) { return H == 1 ? 1 : 8; }

inline dim3 item_grid(int n_items, int warps, int H) {
  const int KH = heads_a_pass(H);
  return dim3((n_items + warps - 1) / warps, (H + KH - 1) / KH);
}

// Shared memory of a launch whose warps each sum a pass's nh * F products
inline size_t head_sum_smem(int warps, int H, int F) {
  const int KH = heads_a_pass(H);
  return (size_t)warps * (H < KH ? H : KH) * F * sizeof(float);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace
