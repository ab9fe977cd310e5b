// Fused adaLN modulate backward for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_mn_bwd_kernel (:105,
// pallas_call at :152). The forward is out = xhat * w + const(x) with
// w = ns * (1 + scale[r]) and xhat = (x - mean) * rsqrt(var + eps), so for
// x [R, S, D] bf16 and dout [R, S, D] bf16 every token row computes in f32
//   g  = dout * w,  dx = inv * (g - mean(g) - xhat * mean(g * xhat))
// and each row group r the sums over its S rows
//   A[r] = sum_S dout,  B[r] = sum_S dout * xhat        (f32 [R, D])
// from which the caller derives dscale, dshift, dns and dnb ([R, D] algebra,
// plain PyTorch, as the JAX package leaves it to XLA).
//
// Bound on the H100: bytes. At the training shape ([5, 600, 1920]) the
// kernel must read x and dout and write dx once (~35 MB) for ~15 flops per
// element. Design: one warp per token row, the row's x and dout (1920 values
// each) in registers (15 four-element vectors a lane of each), so x is read
// once and both LayerNorm passes and both reductions run on registers. A
// block of 4 warps owns a chunk of rows of one row group r: w[r] is built
// once in shared memory, and each warp adds its rows' dout and dout * xhat
// into its own shared [2, D] slice (each lane owns its columns, so no
// atomics). The block then adds its four slices in order and writes the
// chunk's partial sums; `sum_chunks_kernel` (chunk_sums.cuh) adds the chunks
// in order. No atomics anywhere, so A and B are the same from run to run.

#include <cuda_runtime.h>

#include "chunk_sums.cuh"
#include "modulate_norm.cuh"

namespace {

constexpr int kBwdWarps = 4;

__global__ void __launch_bounds__(32 * kBwdWarps)
modulate_norm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                         const void* scale, long sc_stride, const void* ns,
                         bf16* __restrict__ dx, float* __restrict__ part, int s, int d,
                         int chunk_rows, float eps, int sc_bf16, int n_bf16) {
  extern __shared__ __align__(16) float smem[];  // w [d], then per warp (A [d], B [d])
  const int r = blockIdx.y;
  const int chunk = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nv = d / 128;
  float* w = smem;
  float4* acc4 = reinterpret_cast<float4*>(smem + d + warp * 2 * d);
  const float4* w4 = reinterpret_cast<const float4*>(w);

  for (int c = threadIdx.x; c < d; c += blockDim.x)
    w[c] = ld(ns, c, n_bf16) * (1.0f + ld(scale, (long)r * sc_stride + c, sc_bf16));
  for (int c = lane; c < 2 * d / 4; c += 32) acc4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int row_end = min((chunk + 1) * chunk_rows, s);
  for (int i = chunk * chunk_rows + warp; i < row_end; i += kBwdWarps) {
    const long row = (long)r * s + i;
    float xv[kMaxVec][4], gv[kMaxVec][4];
    float sum = 0.0f;
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      if (v < nv) {
        const int c = (v * 32 + lane) * 4;
        const uint2 xr = *reinterpret_cast<const uint2*>(x + row * d + c);
        const uint2 dr = *reinterpret_cast<const uint2*>(dout + row * d + c);
        const __nv_bfloat162 x01 = *reinterpret_cast<const __nv_bfloat162*>(&xr.x);
        const __nv_bfloat162 x23 = *reinterpret_cast<const __nv_bfloat162*>(&xr.y);
        const __nv_bfloat162 d01 = *reinterpret_cast<const __nv_bfloat162*>(&dr.x);
        const __nv_bfloat162 d23 = *reinterpret_cast<const __nv_bfloat162*>(&dr.y);
        xv[v][0] = __low2float(x01);
        xv[v][1] = __high2float(x01);
        xv[v][2] = __low2float(x23);
        xv[v][3] = __high2float(x23);
        gv[v][0] = __low2float(d01);
        gv[v][1] = __high2float(d01);
        gv[v][2] = __low2float(d23);
        gv[v][3] = __high2float(d23);
        sum += (xv[v][0] + xv[v][1]) + (xv[v][2] + xv[v][3]);
      }
    }
    const float mean = warp_sum(sum) / d;
    float sq = 0.0f;
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      if (v < nv) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = xv[v][j] - mean;
          sq += c * c;
        }
      }
    }
    const float inv = rsqrtf(warp_sum(sq) / d + eps);

    // xhat; A += dout, B += dout * xhat; g = dout * w
    float gsum = 0.0f, gxsum = 0.0f;
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      if (v < nv) {
        const int vi = v * 32 + lane;
        float4 a = acc4[vi], b = acc4[d / 4 + vi];
        const float4 wv = w4[vi];
        const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
        float* av = &a.x;
        float* bv = &b.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xh = (xv[v][j] - mean) * inv;
          const float g = gv[v][j];
          xv[v][j] = xh;
          av[j] += g;
          bv[j] += g * xh;
          const float gw = g * wj[j];
          gv[v][j] = gw;
          gsum += gw;
          gxsum += gw * xh;
        }
        acc4[vi] = a;
        acc4[d / 4 + vi] = b;
      }
    }
    const float gm = warp_sum(gsum) / d;
    const float gxm = warp_sum(gxsum) / d;

    bf16* dxrow = dx + row * d;
#pragma unroll
    for (int v = 0; v < kMaxVec; ++v) {
      if (v < nv) {
        const int c = (v * 32 + lane) * 4;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = inv * (gv[v][j] - gm - xv[v][j] * gxm);
        uint2 raw;
        *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(o[0], o[1]);
        *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(o[2], o[3]);
        *reinterpret_cast<uint2*>(dxrow + c) = raw;
      }
    }
  }
  __syncthreads();

  // the chunk's partial (A, B): the warps' slices added in order
  float* out = part + ((size_t)r * gridDim.x + chunk) * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
    float t = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kBwdWarps; ++wp) t += smem[d + wp * 2 * d + c];
    out[c] = t;
  }
}

}  // namespace

// x, dout, dx: [r, s, d] bf16 contiguous, d % 128 == 0 and d <= 2048;
// scale: [r, d] with row stride sc_stride (bf16 if sc_bf16 else f32); ns:
// [d] (bf16 if n_bf16 else f32). part: [r, n_chunks, 2, d] f32 scratch with
// n_chunks = ceil(s / chunk_rows); ab: [r, 2, d] f32 out (A, then B).
// Runs the row pass and the chunk sum; returns the first CUDA error.
extern "C" int orv_modulate_norm_bwd(const void* x, const void* dout, const void* scale,
                                     long sc_stride, const void* ns, void* dx, void* part,
                                     void* ab, int r, int s, int d, int chunk_rows, float eps,
                                     int sc_bf16, int n_bf16, void* stream) {
  const int n_chunks = (s + chunk_rows - 1) / chunk_rows;
  const int smem = (int)((1 + 2 * kBwdWarps) * d * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(modulate_norm_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_chunks, r);
  modulate_norm_bwd_kernel<<<grid, 32 * kBwdWarps, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dout, scale, sc_stride, ns, (bf16*)dx, (float*)part, s, d,
      chunk_rows, eps, sc_bf16, n_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_chunks((const float*)part, (float*)ab, r, n_chunks, 2 * d,
                                (cudaStream_t)stream);
}
