// Element access and reductions of the general kernels: flash_attn_general.cu,
// flash_attn_general_bwd.cu and adaln_general.cu. Each kernel is a template
// on its element type T (float or __nv_bfloat16) and computes in f32; Elem<T>
// converts on the way in and rounds once on the way out. The attention kernels' register tiling (an
// SGEMM's: a lane's 8 x 8 tile of a product, f32 FMAs, each element summed
// in a fixed order) shares its copies and loops below.

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

// ---- the attention kernels' register tiling ----

// 2^x by the multiprocessor's exponential unit alone (ex2.approx, 2 ulp, as
// exp2f's), results below 2^-126 flushed to 0: exp2f spends three more
// instructions a call on them, 7% of dq's time at the training shape
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, kN) x dims [0, kDh) of a [rows, dh] array from src into dst (f32,
// rows of kS floats), zeros past its n rows and dh dims, by a block of
// kThreads: f32 by cp.async (the caller commits), bf16 widened by the threads.
template <typename T, int kDh, int kN, int kS, int kThreads>
__device__ __forceinline__ void stage(float* dst, const T* src, int n, int dh) {
  constexpr int kChunks = kDh / 4;
  static_assert(kN * kChunks % kThreads == 0, "whole rounds of the block's threads");
#pragma unroll
  for (int round = 0; round < kN * kChunks / kThreads; ++round) {
    const int i = round * kThreads + threadIdx.x;
    const int r = i / kChunks, d = (i % kChunks) * 4;
    const bool ok = r < n && d < dh;
    const T* from = ok ? src + (long)r * dh + d : src;
    float* to = dst + r * kS + d;
    if constexpr (sizeof(T) == 4)
      cp_async16(to, from, ok ? 16 : 0);
    else
      *reinterpret_cast<float4*>(to) = ok ? Elem<T>::ld4(from) : zero4();
  }
}

// A product's scores: acc[i][j] += a[kAStep i] . b[kBStep j] (rows of kS
// floats), each summed over the capacity's kDh dims in order of d.
template <int kDh, int kS, int kMJ, int kAStep, int kBStep>
__device__ __forceinline__ void scores(float (&acc)[8][kMJ], const float* a, const float* b) {
#pragma unroll 4
  for (int d = 0; d < kDh; d += 4) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = *reinterpret_cast<const float4*>(a + i * kAStep * kS + d);
#pragma unroll
    for (int j = 0; j < kMJ; ++j) {  // d, d + 1, d + 2, d + 3 in turn, 8 sums apart
      const float4 y = *reinterpret_cast<const float4*>(b + j * kBStep * kS + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(x[i].x, y.x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(x[i].y, y.y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(x[i].z, y.z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(x[i].w, y.w, acc[i][j]);
    }
  }
}

// A lane's kMD dims of a row from p: float4 chunks p[kE 4 c .. kE 4 c + 3]
// (kMD >= 4), else a float2.
template <int kMD, int kE>
__device__ __forceinline__ void load_dims(const float* p, float (&x)[kMD]) {
  if constexpr (kMD >= 4) {
#pragma unroll
    for (int c = 0; c < kMD / 4; ++c) {
      const float4 y = *reinterpret_cast<const float4*>(p + kE * 4 * c);
      x[4 * c] = y.x;
      x[4 * c + 1] = y.y;
      x[4 * c + 2] = y.z;
      x[4 * c + 3] = y.w;
    }
  } else {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x;
    x[1] = y.y;
  }
}

// A product's outputs: acc[i][m] += sum over rows c in [0, kN), in order, of
// a[c kPS + i] * b[c kS + dim m] (the dims of load_dims<kMD, kE>).
template <int kN, int kPS, int kS, int kMD, int kE>
__device__ __forceinline__ void products(float (&acc)[8][kMD], const float* a, const float* b) {
#pragma unroll 4
  for (int c = 0; c < kN; ++c) {
    const float4 x0 = *reinterpret_cast<const float4*>(a + c * kPS);
    const float4 x1 = *reinterpret_cast<const float4*>(a + c * kPS + 4);
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float y[kMD];
    load_dims<kMD, kE>(b + c * kS, y);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int m = 0; m < kMD; ++m) acc[i][m] = fmaf(x[i], y[m], acc[i][m]);
  }
}

// A lane's 8 rows x kMD dims of acc into out ([rows, dh], row stride dh):
// rows g0 + i < n, the dims (load_dims's from dd0) below dh.
template <typename T, int kMD, int kE>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[8][kMD], int g0, int dd0,
                                           int n, int dh) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (g0 + i >= n) continue;
    T* row = out + (long)(g0 + i) * dh + dd0;
    if constexpr (kMD >= 4) {
#pragma unroll
      for (int c = 0; c < kMD / 4; ++c)
        if (dd0 + kE * 4 * c < dh)
          Elem<T>::st4(row + kE * 4 * c, make_float4(acc[i][4 * c], acc[i][4 * c + 1],
                                                     acc[i][4 * c + 2], acc[i][4 * c + 3]));
    } else if (dd0 < dh) {
      Elem<T>::st(row, acc[i][0]);
      Elem<T>::st(row + 1, acc[i][1]);
    }
  }
}

}  // namespace
}  // namespace general
