// Fused adaLN-Zero gated residual for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_gate_kernel (pallas_call at
// adaln.py:280, `gated_residual`): out = bf16(x + gate[r] * y) for x, y
// [R, S, D] and a per-row gate [R, D], f32 math with one rounding, the gate
// never broadcast to [R, S, D] in memory.
//
// Bound on the H100: bytes (read x and y, write out: ~90 MB at the flagship
// video shape [13, 600, 1920], one multiply-add per element). Design: a
// grid-stride loop over 16-byte vectors (8 bf16), consecutive threads on
// consecutive addresses; the gate row comes from L2 (it is re-read by all S
// rows of its frame). The gate may be bf16 or f32 and a row-strided view.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float ld(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(256)
gated_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const void* gate,
                      long g_stride, bf16* __restrict__ out, long n_vec, long row_elems, int d,
                      int g_bf16) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long)gridDim.x * blockDim.x) {
    const long e = i * 8;
    const long r = e / row_elems;
    const int c = (int)(e % d);
    const uint4 xv = *reinterpret_cast<const uint4*>(x + e);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + e);
    const bf16* xs = reinterpret_cast<const bf16*>(&xv);
    const bf16* ys = reinterpret_cast<const bf16*>(&yv);
    uint4 ov;
    bf16* os = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // separate rounding of the product, as the plain version computes it
      const float gy = __fmul_rn(ld(gate, r * g_stride + c + j, g_bf16), __bfloat162float(ys[j]));
      os[j] = __float2bfloat16(__fadd_rn(__bfloat162float(xs[j]), gy));
    }
    *reinterpret_cast<uint4*>(out + e) = ov;
  }
}

}  // namespace

// x, y, out: [r, s, d] bf16 contiguous, d % 8 == 0; gate: [r, d] with row
// stride g_stride (bf16 if g_bf16 else f32). Returns the launch's CUDA error.
extern "C" int orv_gated_residual(const void* x, const void* y, const void* gate, long g_stride,
                                  void* out, int r, int s, int d, int g_bf16, void* stream) {
  const long n_vec = (long)r * s * d / 8;
  long blocks = (n_vec + 255) / 256;
  if (blocks > 132L * 16) blocks = 132L * 16;  // grid-stride: 16 blocks per SM
  if (blocks < 1) blocks = 1;
  gated_residual_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)y, gate, g_stride, (bf16*)out, n_vec, (long)s * d, d, g_bf16);
  return (int)cudaGetLastError();
}
