// Helpers of the adaLN kernels: a load of a bf16 or f32 parameter and a
// warp sum, shared by adaln_fwd_sm90.cuh (the two forwards) and
// modulate_norm_bwd.cu, whose warp holds a whole row of up to
// kMaxVec * 128 = 2048 columns in registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxVec = 16;  // up to D = 16 * 128 = 2048 (the backward)

__device__ __forceinline__ float ld(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
