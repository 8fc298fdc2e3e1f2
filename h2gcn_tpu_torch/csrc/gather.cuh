// Row gathers and the weighted product of the SpMM kernels (gscatter.cu,
// cootile_spmm.cu): a lane gathers V contiguous features of one x row at
// once, and "default" precision rounds each product v * x to bf16 before
// the f32 sum, where the JAX kernels round it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace h2gcn {

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

// out[e] += the product v * x[e] as the precision rounds it; "default"
// rounds two products with one bf16x2 conversion
template <typename T, int V>
__device__ __forceinline__ void add_products(float v, const float (&x)[V],
                                             float (&out)[V]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && V % 2 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      const float2 p =
          __bfloat1622float2(__floats2bfloat162_rn(v * x[e], v * x[e + 1]));
      out[e] += p.x;
      out[e + 1] += p.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] += product<T>(v, x[e]);
  }
}

// whether x (of f features a row) takes the V-wide vector gathers
template <typename T, int V>
inline bool vector_gathers(const T* x, int f) {
  return f % V == 0 &&
         reinterpret_cast<uintptr_t>(x) % (V * sizeof(T)) == 0;
}

}  // namespace h2gcn
