// Element access and reductions of the general kernels: flash_attn_general.cu,
// flash_attn_general_bwd.cu, adaln_general.cu and gated_residual.cu's f32
// instance. Each kernel is a template on its element type T (float or
// __nv_bfloat16) and computes in f32; Elem<T> converts on the way in and
// rounds once on the way out.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace general {
namespace {  // internal linkage: each library keeps its own copies

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  // four consecutive elements as f32; p 16-byte aligned
  static __device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void st4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  // four consecutive elements as f32; p 8-byte aligned
  static __device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                              *reinterpret_cast<const uint32_t*>(&b));
  }
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// element i of a bf16 or f32 vector, as f32
__device__ __forceinline__ float ld_param(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// a + b . c over four lanes, in lane order
__device__ __forceinline__ float dot4(float a, float4 b, float4 c) {
  return fmaf(b.w, c.w, fmaf(b.z, c.z, fmaf(b.y, c.y, fmaf(b.x, c.x, a))));
}

// acc + s * v, lane by lane
__device__ __forceinline__ float4 axpy4(float4 acc, float s, float4 v) {
  return make_float4(fmaf(s, v.x, acc.x), fmaf(s, v.y, acc.y), fmaf(s, v.z, acc.z),
                     fmaf(s, v.w, acc.w));
}

// the sum over the four consecutive lanes of a quad (lanes 4i .. 4i + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
}  // namespace general
