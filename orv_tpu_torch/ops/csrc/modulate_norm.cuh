// The fused adaLN row, shared by modulate_norm.cu (bf16 out) and
// modulate_norm_q8.cu (int8 + per-token scale out).
//
// One warp owns one token row of x [R, S, D] bf16 and leaves, in registers,
//   y = ((x - mean) * rsqrt(var + eps) * ns + nb) * (1 + scale[r]) + shift[r]
// in f32 (two-pass variance over the registers, so x is read once). Lane l
// holds columns (i * 32 + l) * 4 .. + 3 of the row in y[i][0..3], for
// i < d / 128. scale/shift are [R, D] with row stride ss_stride (bf16 or
// f32); ns/nb are [D] (bf16 or f32).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxVec = 16;  // up to D = 16 * 128 = 2048
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float ld(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void modulated_row(const bf16* __restrict__ xr, const void* scale,
                                              const void* shift, long ss_off, const void* ns,
                                              const void* nb, int d, float eps, int ss_bf16,
                                              int n_bf16, int lane, float (&y)[kMaxVec][4]) {
  const int nv = d / 128;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < nv) {
      const int c = (i * 32 + lane) * 4;
      const uint2 raw = *reinterpret_cast<const uint2*>(xr + c);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      y[i][0] = __low2float(a);
      y[i][1] = __high2float(a);
      y[i][2] = __low2float(b);
      y[i][3] = __high2float(b);
      sum += (y[i][0] + y[i][1]) + (y[i][2] + y[i][3]);
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < nv) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = y[i][j] - mean;
        sq += c * c;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < nv) {
      const int c = (i * 32 + lane) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = (y[i][j] - mean) * inv * ld(ns, c + j, n_bf16) + ld(nb, c + j, n_bf16);
        y[i][j] = t * (1.0f + ld(scale, ss_off + c + j, ss_bf16)) +
                  ld(shift, ss_off + c + j, ss_bf16);
      }
    }
  }
}

}  // namespace
