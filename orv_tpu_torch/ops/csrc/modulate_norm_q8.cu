// Fused adaLN modulate emitting the W8A8 activation quantization, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_kernel_q8 (pallas_call at
// adaln.py:219, `modulate_norm_q8`). Every token row of x [R, S, D] computes
// the modulated f32 row y exactly as modulate_norm.cu does, then quantizes it
// per token for the int8 projections that follow:
//   amax = max(max|y|, 1e-6)
//   xq = int8(round_half_even(y * (127 / amax)))      [R, S, D]
//   xscale = amax * (1/127)                            [R, S] f32
//
// Bound on the H100: bytes. At the flagship shape ([13, 600, 1920]) the
// kernel reads x (30 MB bf16) and writes xq (15 MB) and xscale once, for a
// few tens of flops per element. Design: one warp per token row, the row in
// registers (`modulated_row` in modulate_norm.cuh); a warp max-reduce of |y|
// gives amax without a second pass over memory; each lane stores its four
// int8 values of a vector as one 4-byte word, so a warp writes 128
// consecutive bytes per store. Rounding is __float2int_rn (half to even, as
// jnp.round), and 127/amax is a true division, as in the reference.

#include <cuda_runtime.h>

#include "modulate_norm.cuh"

namespace {

constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
modulate_norm_q8_kernel(const bf16* __restrict__ x, const void* scale, const void* shift,
                        long ss_stride, const void* ns, const void* nb,
                        int8_t* __restrict__ xq, float* __restrict__ xscale, long n_rows, int s,
                        int d, float eps, int ss_bf16, int n_bf16) {
  const long row = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  float y[kMaxVec][4];
  modulated_row(x + row * d, scale, shift, (row / s) * ss_stride, ns, nb, d, eps, ss_bf16,
                n_bf16, lane, y);

  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < d / 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(y[i][j]));
    }
  }
  amax = fmaxf(warp_max(amax), 1e-6f);
  const float q = 127.0f / amax;

  int8_t* orow = xq + row * d;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < d / 128) {
      const int c = (i * 32 + lane) * 4;
      char4 packed;
      packed.x = (signed char)__float2int_rn(y[i][0] * q);
      packed.y = (signed char)__float2int_rn(y[i][1] * q);
      packed.z = (signed char)__float2int_rn(y[i][2] * q);
      packed.w = (signed char)__float2int_rn(y[i][3] * q);
      *reinterpret_cast<char4*>(orow + c) = packed;
    }
  }
  if (lane == 0) xscale[row] = amax * kInv127;
}

}  // namespace

// x: [r, s, d] bf16 contiguous, d % 128 == 0 and d <= 2048; xq: [r, s, d]
// int8 contiguous; xscale: [r, s] f32 contiguous. scale, shift, ns, nb as in
// orv_modulate_norm. Returns the launch's CUDA error.
extern "C" int orv_modulate_norm_q8(const void* x, const void* scale, const void* shift,
                                    long ss_stride, const void* ns, const void* nb, void* xq,
                                    void* xscale, int r, int s, int d, float eps, int ss_bf16,
                                    int n_bf16, void* stream) {
  const long n_rows = (long)r * s;
  const unsigned blocks = (unsigned)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  modulate_norm_q8_kernel<<<blocks, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, scale, shift, ss_stride, ns, nb, (int8_t*)xq, (float*)xscale, n_rows, s,
      d, eps, ss_bf16, n_bf16);
  return (int)cudaGetLastError();
}
