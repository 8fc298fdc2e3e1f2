// Block-sparse-row SpMM for Hopper: out[br] = sum over the row's blocks of
// A_blk @ x[bc], with 128 x 128 dense blocks sorted by (block row, column).
//
// Replaces the TPU kernel h2gcn_tpu/sparse/pallas_spmm.py:_make_kernel
// (launched from bsr_spmm). It reads the tables that
// h2gcn_tpu_torch/sparse/matrix.py:_build_bsr produces; the zero filler
// blocks there guarantee that every block row has at least one block.
//
// What bounds it on the H100: each block is 2 * 128 * 128 * F flops against
// 64 KB of f32 payload (32 KB in bf16). In f32 on the CUDA cores (67
// TFLOP/s) the dense blocks are bound by operations; in bf16 on the tensor
// cores (989 TFLOP/s) by the payload's bytes. chip_smoke.py computes both
// bounds for each call.
//
// The design. Work items, not block rows: bsr_spmm.py cuts each block row's
// block list into items of at most a budget of blocks (build_items), so a
// full row of a dense-ish matrix (79 blocks at 10K nodes) spreads over
// several thread blocks. One thread block takes one item and one tile of
// FN = 64 or 128 output features; it flushes its 128 x FN partial sum with
// global atomics into the zeroed output. The atomics make the sum's order
// vary from run to run; a second pass over a workspace of partials would
// fix it at the cost of writing and reading every partial, and no other
// SpMM of the port sums in a fixed order either. The item's blocks are
// walked as a sequence of depth slices (stages), each the slice of the
// block and the matching rows of x, loaded by cp.async into a ring of
// shared-memory stages a few slices ahead of the math, so loads overlap the
// products.
// Rows of x past m and features past f are zero-filled in shared memory
// (never in x).
//
// Precision. "highest" reads f32 payload and f32 x and multiplies with f32
// FMA on the CUDA cores (TF32 would break the precision contract): 256
// threads, each an 8-row x FN/16 register tile, 16-deep slices.
// "default" reads bf16 payload and bf16 x and multiplies on the tensor
// cores with wgmma (m64nFNk16, both operands from shared memory, f32
// accumulators): each of two warpgroups owns 64 rows, 64-deep slices. The
// slices are stored in the no-swizzle core-matrix layout wgmma reads (8 x
// 16-byte rows per core matrix): the block K-major, x MN-major. Products of
// bf16 values are exact in f32 and the sums are f32, the arithmetic of the
// JAX kernel's DEFAULT-precision dot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 128;        // block size
constexpr int kThreads = 256;  // f32: 16 x 16 threads; bf16: two warpgroups

// wgmma descriptor strides (bytes) of the core-matrix layouts below: the
// leading offset steps between core matrices along K, the stride offset
// between core matrices along M (the block) or N (x)
constexpr uint32_t kALbo = 128, kASbo = 1024;
constexpr uint32_t kBLbo = 128, kBSbo = 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread block's work item: blocks b_lo..b_hi of block row br
struct Item {
  int br, b_lo, b_hi;
};

__device__ __forceinline__ Item load_item(const int* items) {
  return {items[3 * blockIdx.x], items[3 * blockIdx.x + 1],
          items[3 * blockIdx.x + 2]};
}

// ---------------------------------------------------------------------------
// "highest": f32 FMA
// ---------------------------------------------------------------------------

template <int FN>
struct F32Tile {
  static constexpr int BK = 16;           // depth of a stage
  static constexpr int kSteps = kB / BK;  // stages a block
  static constexpr int kStages = 4;       // the ring
  static constexpr int kA = kB * BK;      // floats of a stage's block slice
  static constexpr int kX = BK * FN;      // floats of its x slice
  static constexpr int kStage = kA + kX;
  static constexpr int kSmem = kStages * kStage * 4;
  static constexpr int JN = FN / 64;      // float4 column groups a thread
};

template <int FN>
__global__ void __launch_bounds__(kThreads, 2)
bsr_f32_kernel(const int* __restrict__ items,
               const int* __restrict__ block_cols,
               const float* __restrict__ blocks, const float* __restrict__ x,
               float* __restrict__ out, int m, int f, int n_out, int vec) {
  using G = F32Tile<FN>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Item it = load_item(items);
  const int f0 = blockIdx.y * FN;
  const int n_stages = (it.b_hi - it.b_lo) * G::kSteps;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // stage s: block b_lo + s / kSteps, depth k0 = (s % kSteps) * BK; the
  // block slice [128][BK] and the x slice [BK][FN], both row-major
  auto load = [&](int s) {
    float* a_s = smem + (s % G::kStages) * G::kStage;
    float* x_s = a_s + G::kA;
    const int b = it.b_lo + s / G::kSteps;
    const int k0 = (s % G::kSteps) * G::BK;
    const float* a = blocks + (int64_t)b * kB * kB + k0;
#pragma unroll
    for (int q = tid; q < G::kA / 4; q += kThreads) {
      const int r = q / (G::BK / 4), c = q % (G::BK / 4);
      cp_async16(a_s + r * G::BK + c * 4, a + r * kB + c * 4, true);
    }
    const int64_t xr0 = (int64_t)block_cols[b] * kB + k0;
#pragma unroll
    for (int q = tid; q < G::kX / 4; q += kThreads) {
      const int r = q / (FN / 4), c = q % (FN / 4);
      const int64_t xr = xr0 + r;
      const int col = f0 + c * 4;
      float* dst = x_s + r * FN + c * 4;
      if (vec) {
        const bool ok = xr < m && col < f;
        cp_async16(dst, ok ? x + xr * f + col : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dst[e] = (xr < m && col + e < f) ? x[xr * f + col + e] : 0.f;
        }
      }
    }
  };

  float acc[8][4 * G::JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * G::JN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // stage s arrived; stage s - 1 is read by all
    if (s + G::kStages - 1 < n_stages) load(s + G::kStages - 1);
    cp_async_commit();
    const float* a_s = smem + (s % G::kStages) * G::kStage;
    const float* x_s = a_s + G::kA;
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * G::BK +
                                                 kk);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 xv[G::JN];
#pragma unroll
        for (int j = 0; j < G::JN; ++j) {
          xv[j] = *reinterpret_cast<const float4*>(x_s + (kk + u) * FN +
                                                   tx * 4 + 64 * j);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = u == 0 ? av[i].x
                        : u == 1 ? av[i].y
                        : u == 2 ? av[i].z
                                 : av[i].w;
#pragma unroll
          for (int j = 0; j < G::JN; ++j) {
            acc[i][4 * j + 0] = fmaf(a, xv[j].x, acc[i][4 * j + 0]);
            acc[i][4 * j + 1] = fmaf(a, xv[j].y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(a, xv[j].z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(a, xv[j].w, acc[i][4 * j + 3]);
          }
        }
      }
    }
  }

  const int64_t row0 = (int64_t)it.br * kB;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    if (r >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4 * G::JN; ++j) {
      const int c = f0 + tx * 4 + 64 * (j / 4) + j % 4;
      if (c < f) atomicAdd(&out[r * f + c], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// "default": bf16 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo,
                                         uint32_t sbo) {
  // no swizzle (layout type 0), base offset 0; fields in 16-byte units
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int FN>
struct Bf16Tile {
  static constexpr int BK = 64;           // depth of a stage
  static constexpr int kSteps = kB / BK;  // stages a block
  static constexpr int kStages = 3;       // the ring
  static constexpr int kA = kB * BK * 2;  // bytes of a stage's block slice
  static constexpr int kX = BK * FN * 2;  // bytes of its x slice
  static constexpr int kStage = kA + kX;
  static constexpr int kSmem = kStages * kStage;
};

template <int FN>
__device__ __forceinline__ void wgmma_tile(float (&d)[FN / 2], uint64_t da,
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  wgmma_m64n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  wgmma_m64n128(d, da, db);
}

// pins the accumulators in place around wgmma, which writes them
// asynchronously: no read or copy of them moves across this point
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int FN>
__global__ void __launch_bounds__(kThreads)
bsr_bf16_kernel(const int* __restrict__ items,
                const int* __restrict__ block_cols,
                const __nv_bfloat16* __restrict__ blocks,
                const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                int m, int f, int n_out, int vec) {
  using G = Bf16Tile<FN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Item it = load_item(items);
  const int f0 = blockIdx.y * FN;
  const int n_stages = (it.b_hi - it.b_lo) * G::kSteps;
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  // stage s: the block slice [128 rows][64 deep] K-major, element (r, k) at
  // byte (r / 8) * 1024 + (k / 8) * 128 + (r % 8) * 16 + (k % 8) * 2; the x
  // slice [64 deep][FN] MN-major, element (k, n) at byte (n / 8) * 1024 +
  // (k / 8) * 128 + (k % 8) * 16 + (n % 8) * 2. Eight neighbouring threads
  // fill one 128-byte core matrix, from 16-byte runs of global memory.
  auto load = [&](int s) {
    unsigned char* a_s = smem + (s % G::kStages) * G::kStage;
    unsigned char* x_s = a_s + G::kA;
    const int b = it.b_lo + s / G::kSteps;
    const int k0 = (s % G::kSteps) * G::BK;
    const __nv_bfloat16* a = blocks + (int64_t)b * kB * kB + k0;
#pragma unroll
    for (int q = tid; q < G::kA / 16; q += kThreads) {
      const int r = (q / 64) * 8 + q % 8, kc = (q / 8) % 8;
      cp_async16(a_s + q * 16, a + r * kB + kc * 8, true);
    }
    const int64_t xr0 = (int64_t)block_cols[b] * kB + k0;
#pragma unroll
    for (int q = tid; q < G::kX / 16; q += kThreads) {
      const int k = (q / FN) * 8 + q % 8, nc = (q / 8) % (FN / 8);
      const int64_t xr = xr0 + k;
      const int col = f0 + nc * 8;
      unsigned char* dst = x_s + nc * 1024 + k * 16;
      if (vec) {
        const bool ok = xr < m && col < f;
        cp_async16(dst, ok ? x + xr * f + col : x, ok);
      } else {
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          d[e] = (xr < m && col + e < f) ? x[xr * f + col + e]
                                         : __float2bfloat16(0.f);
        }
      }
    }
  };

  float d[FN / 2];
#pragma unroll
  for (int i = 0; i < FN / 2; ++i) d[i] = 0.f;

#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) {
    if (s < n_stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<G::kStages - 2>();
    // the stage's writes (cp.async and plain stores) become visible to
    // wgmma, which reads shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage s arrived; every wgmma on stage s - 1 is done
    if (s + G::kStages - 1 < n_stages) load(s + G::kStages - 1);
    cp_async_commit();
    const uint32_t a_base =
        smem_addr(smem + (s % G::kStages) * G::kStage) + wg * 8 * 1024;
    const uint32_t b_base = smem_addr(smem + (s % G::kStages) * G::kStage +
                                      G::kA);
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < G::BK / 16; ++kk) {
      wgmma_tile<FN>(d, desc(a_base + kk * 256, kALbo, kASbo),
                     desc(b_base + kk * 256, kBLbo, kBSbo));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(d);
  }

  // the accumulator fragment: register i of thread t holds row 16 * warp +
  // lane / 4 + 8 * ((i / 2) % 2) of the warpgroup's 64, feature
  // 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t row0 = (int64_t)it.br * kB + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < FN / 2; ++i) {
    const int64_t r = row0 + 8 * ((i / 2) % 2);
    const int c = f0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    if (r < n_out && c < f) atomicAdd(&out[r * f + c], d[i]);
  }
}

template <int FN>
cudaError_t launch_tile(const int* items, int n_items,
                        const int* block_cols, const float* blocks,
                        const float* x, float* out, int m, int f, int n_out,
                        cudaStream_t stream) {
  constexpr int smem = F32Tile<FN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_f32_kernel<FN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(n_items, (f + FN - 1) / FN);
  bsr_f32_kernel<FN><<<grid, kThreads, smem, stream>>>(
      items, block_cols, blocks, x, out, m, f, n_out, vec);
  return cudaGetLastError();
}

template <int FN>
cudaError_t launch_tile(const int* items, int n_items,
                        const int* block_cols, const __nv_bfloat16* blocks,
                        const __nv_bfloat16* x, float* out, int m, int f,
                        int n_out, cudaStream_t stream) {
  constexpr int smem = Bf16Tile<FN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_bf16_kernel<FN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = f % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(n_items, (f + FN - 1) / FN);
  bsr_bf16_kernel<FN><<<grid, kThreads, smem, stream>>>(
      items, block_cols, blocks, x, out, m, f, n_out, vec);
  return cudaGetLastError();
}

// a 64-feature tile where f fits it, else 128-feature tiles
template <typename T>
cudaError_t launch(const int* items, int n_items, const int* block_cols,
                   const T* blocks, const T* x, float* out, int m, int f,
                   int n_out, cudaStream_t stream) {
  if (f <= 64) {
    return launch_tile<64>(items, n_items, block_cols, blocks, x, out, m, f,
                           n_out, stream);
  }
  return launch_tile<128>(items, n_items, block_cols, blocks, x, out, m, f,
                          n_out, stream);
}

}  // namespace

// out (zeroed by the caller) += A @ x over the work items: item i is the
// blocks items[3i+1]..items[3i+2] of block row items[3i], in the payload's
// (block row, column) order. blocks: [nb, 128, 128] and x: [m, f], both f32
// or both bf16 (bf16 != 0), the payload 16-byte aligned; block_cols[b] is
// block b's column. out: [n_out, f] f32. Returns the cudaError_t of the
// launch.
extern "C" int h2gcn_bsr_spmm(const int* items, int n_items,
                              const int* block_cols, const void* blocks,
                              const void* x, int bf16, float* out, int m,
                              int f, int n_out, cudaStream_t stream) {
  if (bf16) {
    return launch(items, n_items, block_cols,
                  static_cast<const __nv_bfloat16*>(blocks),
                  static_cast<const __nv_bfloat16*>(x), out, m, f, n_out,
                  stream);
  }
  return launch(items, n_items, block_cols, static_cast<const float*>(blocks),
                static_cast<const float*>(x), out, m, f, n_out, stream);
}
