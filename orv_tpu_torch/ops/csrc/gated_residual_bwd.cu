// Fused adaLN-Zero gated residual backward for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_gr_bwd_kernel (:298,
// pallas_call at :328). For the forward out = x + gate[r] * y over
// [R, S, D], given dout [R, S, D] bf16 and y [R, S, D] bf16:
//   dy = bf16(gate[r] * dout)                (f32 product, one rounding)
//   dgate[r] = sum_S dout * y                (f32 [R, D])
// and dx = dout, which the caller passes on without a kernel.
//
// Bound on the H100: bytes (read dout and y, write dy: ~35 MB at the video
// stream's [5, 600, 1920], 2.6 MB at the text stream's [1, 226, 1920]).
// Design: a block owns a chunk of rows of one row group r; each thread owns
// 8 adjacent columns (one 16-byte vector, consecutive threads on
// consecutive addresses), walks the chunk's rows, writes dy and keeps its 8
// partial sums of dout * y in registers. The chunk's partial sums go to
// part [R, n_chunks, D], and `sum_chunks_kernel` (chunk_sums.cuh) adds the
// chunks in order: no atomics, the same dgate from run to run. The gate may
// be bf16 or f32 and a row-strided view.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_sums.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float ld_gate(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(256)
gated_residual_bwd_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ y,
                          const void* gate, long g_stride, bf16* __restrict__ dy,
                          float* __restrict__ part, int s, int d, int chunk_rows, int g_bf16) {
  const int r = blockIdx.y;
  const int chunk = blockIdx.x;
  const int row0 = chunk * chunk_rows;
  const int row_end = min(row0 + chunk_rows, s);
  float* out = part + ((size_t)r * gridDim.x + chunk) * d;
  for (int cv = threadIdx.x; cv < d / 8; cv += blockDim.x) {
    const int c = cv * 8;
    float g[8], acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[j] = ld_gate(gate, (long)r * g_stride + c + j, g_bf16);
      acc[j] = 0.0f;
    }
    for (int i = row0; i < row_end; ++i) {
      const size_t e = ((size_t)r * s + i) * d + c;
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + e);
      const uint4 yv = *reinterpret_cast<const uint4*>(y + e);
      const bf16* ds = reinterpret_cast<const bf16*>(&dv);
      const bf16* ys = reinterpret_cast<const bf16*>(&yv);
      uint4 ov;
      bf16* os = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dj = __bfloat162float(ds[j]);
        acc[j] += dj * __bfloat162float(ys[j]);
        os[j] = __float2bfloat16(dj * g[j]);
      }
      *reinterpret_cast<uint4*>(dy + e) = ov;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) out[c + j] = acc[j];
  }
}

}  // namespace

// dout, y, dy: [r, s, d] bf16 contiguous, d % 8 == 0; gate: [r, d] with row
// stride g_stride (bf16 if g_bf16 else f32). part: [r, n_chunks, d] f32
// scratch with n_chunks = ceil(s / chunk_rows); dgate: [r, d] f32 out. Runs
// the row pass and the chunk sum; returns the first CUDA error.
extern "C" int orv_gated_residual_bwd(const void* dout, const void* y, const void* gate,
                                      long g_stride, void* dy, void* part, void* dgate, int r,
                                      int s, int d, int chunk_rows, int g_bf16, void* stream) {
  const int n_chunks = (s + chunk_rows - 1) / chunk_rows;
  dim3 grid(n_chunks, r);
  gated_residual_bwd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)dout, (const bf16*)y, gate, g_stride, (bf16*)dy, (float*)part, s, d,
      chunk_rows, g_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_chunks((const float*)part, (float*)dgate, r, n_chunks, d,
                                (cudaStream_t)stream);
}
