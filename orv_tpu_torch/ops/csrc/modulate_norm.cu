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
// (15 four-element vectors a lane), so x is read from device memory once and
// both variance passes run on registers. Loads and stores are 8-byte vectors,
// consecutive lanes on consecutive addresses. scale/shift/ns/nb are small and
// come from L2; they may be bf16 or f32, and scale/shift may be row-strided
// views (the chunks of the modulation linear's output).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

__global__ void __launch_bounds__(32 * kRowsPerBlock)
modulate_norm_kernel(const bf16* __restrict__ x, const void* scale, const void* shift,
                     long ss_stride, const void* ns, const void* nb, bf16* __restrict__ out,
                     long n_rows, int s, int d, float eps, int ss_bf16, int n_bf16) {
  const long row = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int nv = d / 128;
  const long r = row / s;
  const bf16* xr = x + row * d;

  float v[kMaxVec][4];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < nv) {
      const int c = (i * 32 + lane) * 4;
      const uint2 raw = *reinterpret_cast<const uint2*>(xr + c);
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      v[i][0] = __low2float(a);
      v[i][1] = __high2float(a);
      v[i][2] = __low2float(b);
      v[i][3] = __high2float(b);
      sum += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < nv) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = v[i][j] - mean;
        sq += c * c;
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / d + eps);

  bf16* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i < nv) {
      const int c = (i * 32 + lane) * 4;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = (v[i][j] - mean) * inv * ld(ns, c + j, n_bf16) + ld(nb, c + j, n_bf16);
        y[j] = t * (1.0f + ld(scale, r * ss_stride + c + j, ss_bf16)) +
               ld(shift, r * ss_stride + c + j, ss_bf16);
      }
      uint2 raw;
      *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(y[0], y[1]);
      *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(y[2], y[3]);
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
