// Fused adaLN modulate (LayerNorm + norm affine + per-row modulation) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_kernel (pallas_call at
// adaln.py:85, `modulate_norm`). For x [R, S, D] and per-row scale/shift
// [R, D] (row r = batch*frame), every token row computes in f32:
//   mean = sum(x)/D,  var = sum((x - mean)^2)/D        (two passes)
//   y = (x - mean) * rsqrt(var + eps) * ns + nb
//   out = bf16(y * (1 + scale[r]) + shift[r])
//
// Bound on the H100: bytes. At the flagship shape ([13, 600, 1920] bf16) the
// kernel must read x and write out once (~60 MB) for ~10 flops per element.
// Design: one warp per token row; the row (1920 values) stays in registers
// (15 four-element vectors a lane, `modulated_row` in modulate_norm.cuh), so
// x is read from device memory once and both variance passes run on
// registers. Loads and stores are 8-byte vectors, consecutive lanes on
// consecutive addresses. scale/shift/ns/nb are small and come from L2; they
// may be bf16 or f32, and scale/shift may be row-strided views (the chunks
// of the modulation linear's output).

#include <cuda_runtime.h>

#include "modulate_norm.cuh"

namespace {

__global__ void __launch_bounds__(32 * kRowsPerBlock)
modulate_norm_kernel(const bf16* __restrict__ x, const void* scale, const void* shift,
                     long ss_stride, const void* ns, const void* nb, bf16* __restrict__ out,
                     long n_rows, int s, int d, float eps, int ss_bf16, int n_bf16) {
  const long row = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  float y[kMaxVec][4];
  modulated_row(x + row * d, scale, shift, (row / s) * ss_stride, ns, nb, d, eps, ss_bf16,
                n_bf16, lane, y);

  bf16* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < d / 128) {
      const int c = (i * 32 + lane) * 4;
      uint2 raw;
      *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(y[i][0], y[i][1]);
      *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(y[i][2], y[i][3]);
      *reinterpret_cast<uint2*>(orow + c) = raw;
    }
  }
}

}  // namespace

// x, out: [r, s, d] bf16 contiguous, d % 128 == 0 and d <= 2048.
// scale, shift: [r, d] with row stride ss_stride (bf16 if ss_bf16 else f32);
// ns, nb: [d] (bf16 if n_bf16 else f32). Returns the launch's CUDA error.
extern "C" int orv_modulate_norm(const void* x, const void* scale, const void* shift,
                                 long ss_stride, const void* ns, const void* nb, void* out,
                                 int r, int s, int d, float eps, int ss_bf16, int n_bf16,
                                 void* stream) {
  const long n_rows = (long)r * s;
  const unsigned blocks = (unsigned)((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  modulate_norm_kernel<<<blocks, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, scale, shift, ss_stride, ns, nb, (bf16*)out, n_rows, s, d, eps, ss_bf16,
      n_bf16);
  return (int)cudaGetLastError();
}
