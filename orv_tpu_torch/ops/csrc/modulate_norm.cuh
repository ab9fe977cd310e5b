// Helpers of the adaLN kernels: four bf16 values as f32 and a warp sum,
// shared by adaln_fwd_sm90.cuh (the two forwards) and adaln_bwd_sm90.cuh
// (the two backwards).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float4 ld_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
