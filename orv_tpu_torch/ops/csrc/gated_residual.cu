// Fused adaLN-Zero gated residual for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_gate_kernel (pallas_call at
// adaln.py:280, `gated_residual`): out = bf16(x + gate[r] * y) for x, y
// [R, S, D] and a per-row gate [R, D], f32 math with one rounding, the gate
// never broadcast to [R, S, D] in memory.
//
// The same kernel, templated on its element type, is also the general route's
// f32 instance (orv_gated_residual_f32): an f32 model (train.mixed_precision=
// no) calls the gate there, which the JAX kernel takes in any dtype.
//
// Bound on the H100: bytes (read x and y, write out: ~90 MB at the flagship
// video shape [13, 600, 1920], one multiply-add per element). Design: a
// grid-stride loop over 16-byte vectors (8 bf16), consecutive threads on
// consecutive addresses; the gate row comes from L2 (it is re-read by all S
// rows of its frame). The gate may be bf16 or f32 and a row-strided view.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "general.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float ld(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// eight consecutive elements (one 16-byte vector of bf16, two of f32) as f32,
// and back with one rounding each
template <typename T>
struct Vec8;

template <>
struct Vec8<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
    const float4 a = general::Elem<float>::ld4(p), b = general::Elem<float>::ld4(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    general::Elem<float>::st4(p, make_float4(v[0], v[1], v[2], v[3]));
    general::Elem<float>::st4(p + 4, make_float4(v[4], v[5], v[6], v[7]));
  }
};

template <typename T>
__global__ void __launch_bounds__(256)
gated_residual_kernel(const T* __restrict__ x, const T* __restrict__ y, const void* gate,
                      long g_stride, T* __restrict__ out, long n_vec, long row_elems, int d,
                      int g_bf16) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long)gridDim.x * blockDim.x) {
    const long e = i * 8;
    const long r = e / row_elems;
    const int c = (int)(e % d);
    float xs[8], ys[8], os[8];
    Vec8<T>::load(x + e, xs);
    Vec8<T>::load(y + e, ys);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // separate rounding of the product, as the plain version computes it
      const float gy = __fmul_rn(ld(gate, r * g_stride + c + j, g_bf16), ys[j]);
      os[j] = __fadd_rn(xs[j], gy);
    }
    Vec8<T>::store(out + e, os);
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* gate, long g_stride, void* out, int r, int s,
           int d, int g_bf16, void* stream) {
  const long n_vec = (long)r * s * d / 8;
  long blocks = (n_vec + 255) / 256;
  if (blocks > 132L * 16) blocks = 132L * 16;  // grid-stride: 16 blocks per SM
  if (blocks < 1) blocks = 1;
  gated_residual_kernel<T><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)y, gate, g_stride, (T*)out, n_vec, (long)s * d, d, g_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y, out: [r, s, d] bf16 contiguous, d % 8 == 0; gate: [r, d] with row
// stride g_stride (bf16 if g_bf16 else f32). Returns the launch's CUDA error.
extern "C" int orv_gated_residual(const void* x, const void* y, const void* gate, long g_stride,
                                  void* out, int r, int s, int d, int g_bf16, void* stream) {
  return launch<bf16>(x, y, gate, g_stride, out, r, s, d, g_bf16, stream);
}

// The f32 instance: x, y, out [r, s, d] f32 contiguous, 16-byte aligned,
// d % 8 == 0; gate as orv_gated_residual's. Returns the launch's CUDA error.
extern "C" int orv_gated_residual_f32(const void* x, const void* y, const void* gate,
                                      long g_stride, void* out, int r, int s, int d, int g_bf16,
                                      void* stream) {
  return launch<float>(x, y, gate, g_stride, out, r, s, d, g_bf16, stream);
}
