// General flash attention backward for Hopper (sm_90a): f32 or bf16, any head
// dim that is a multiple of 8 up to 128, any Sq and Skv, with an optional lse
// cotangent.
//
// Replaces the TPU kernels orv_tpu/ops/attention.py:_bwd_dq_kernel (:389) and
// _bwd_dkv_kernel (:432) wherever the Hopper backward (flash_attn_bwd.cu:
// bf16 at head dim 64) does not take the operands, as
// flash_attn_general.cu does for the forwards. Arithmetic, as
// flash_attention_bwd_plain (ops/attention.py): p = exp(f32(q . k) * scale -
// lse); delta = rowsum(f32(out * dout)) - dlse (as _bwd_impl, :492, folds
// the lse cotangent); dp = f32(dout . v); ds = p * (dp - delta) * scale; dq
// and dk take ds rounded to T, dv the f32 p.
//
// Bound on the H100: operations, f32 FMAs on the CUDA cores (no TF32): dq
// 6 Sq Skv Dh and dk/dv 8 Sq Skv Dh a head at 67 TFLOP/s. Design: the
// forward's (general.cuh, a quad of threads a row, float4 chunks 16 c + 4 j
// of the row's dims in registers, the other side's tiles in f32 shared
// memory). The dq kernel walks key tiles for 64 query rows a block and also
// writes each row's delta; the dk/dv kernel walks query tiles (q, dout, lse,
// delta) for 64 key rows a block. Each output element is summed by one
// thread in a fixed order: no atomics, the same bits from run to run.

#include "general.cuh"

namespace {

using general::Elem;

constexpr int kRows = 64;            // rows a block: queries (dq) or keys (dk/dv)
constexpr int kThreads = 4 * kRows;  // a quad of threads a row
constexpr float kLog2e = 1.4426950408889634f;

// rows of the other side's shared-memory tiles: 32 KB of two f32 tiles
template <int kDh>
__host__ __device__ constexpr int tile_rows() {
  return kDh <= 64 ? 64 : 32;
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
flash_general_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dlse, T* __restrict__ dq,
                        float* __restrict__ delta, int sq, int skv, int dh, float scale) {
  constexpr int kKeys = tile_rows<kDh>();
  constexpr int kC = kDh / 16;
  __shared__ __align__(16) float ks[kKeys * kDh];
  __shared__ __align__(16) float vs[kKeys * kDh];
  const long bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / 4, j = threadIdx.x % 4;
  const long q_off = bh * sq * dh, kv_off = bh * skv * dh;

  float4 qv[kC], dov[kC], acc[kC];
  float od = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int d = 16 * c + 4 * j;
    qv[c] = dov[c] = general::zero4();
    if (row < sq && d < dh) {
      const long at = q_off + (long)row * dh + d;
      qv[c] = Elem<T>::ld4(q + at);
      dov[c] = Elem<T>::ld4(dout + at);
      od = general::dot4(od, Elem<T>::ld4(out + at), dov[c]);
    }
    acc[c] = general::zero4();
  }
  float dl = general::quad_sum(od);
  float row_lse = 0.0f;
  if (row < sq) {
    if (dlse != nullptr) dl -= dlse[bh * sq + row];
    row_lse = lse[bh * sq + row];
  }
  const int chunks = dh / 4;

  for (int k0 = 0; k0 < skv; k0 += kKeys) {
    const int nk = min(kKeys, skv - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < nk * chunks; i += kThreads) {
      const int key = i / chunks, d = (i - key * chunks) * 4;
      const long at = kv_off + (long)(k0 + key) * dh + d;
      *reinterpret_cast<float4*>(ks + key * kDh + d) = Elem<T>::ld4(k + at);
      *reinterpret_cast<float4*>(vs + key * kDh + d) = Elem<T>::ld4(v + at);
    }
    __syncthreads();
#pragma unroll 4
    for (int key = 0; key < nk; ++key) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = 16 * c + 4 * j;
        if (d < dh) {
          s = general::dot4(s, qv[c], *reinterpret_cast<const float4*>(ks + key * kDh + d));
          dp = general::dot4(dp, dov[c], *reinterpret_cast<const float4*>(vs + key * kDh + d));
        }
      }
      s = general::quad_sum(s);
      dp = general::quad_sum(dp);
      const float p = exp2f((s * scale - row_lse) * kLog2e);
      const float ds = Elem<T>::round(p * (dp - dl) * scale);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = 16 * c + 4 * j;
        if (d < dh)
          acc[c] = general::axpy4(acc[c], ds, *reinterpret_cast<const float4*>(ks + key * kDh + d));
      }
    }
  }

  if (row < sq) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 16 * c + 4 * j;
      if (d < dh) Elem<T>::st4(dq + q_off + (long)row * dh + d, acc[c]);
    }
    if (j == 0) delta[bh * sq + row] = dl;
  }
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
flash_general_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int dh,
                         float scale) {
  constexpr int kQueries = tile_rows<kDh>();
  constexpr int kC = kDh / 16;
  __shared__ __align__(16) float qs[kQueries * kDh];
  __shared__ __align__(16) float dos[kQueries * kDh];
  __shared__ float lses[kQueries], deltas[kQueries];
  const long bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / 4, j = threadIdx.x % 4;
  const long q_off = bh * sq * dh, kv_off = bh * skv * dh;

  float4 kv[kC], vv[kC], dka[kC], dva[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int d = 16 * c + 4 * j;
    kv[c] = vv[c] = general::zero4();
    if (row < skv && d < dh) {
      kv[c] = Elem<T>::ld4(k + kv_off + (long)row * dh + d);
      vv[c] = Elem<T>::ld4(v + kv_off + (long)row * dh + d);
    }
    dka[c] = dva[c] = general::zero4();
  }
  const int chunks = dh / 4;

  for (int q0 = 0; q0 < sq; q0 += kQueries) {
    const int nq = min(kQueries, sq - q0);
    __syncthreads();
    for (int i = threadIdx.x; i < nq * chunks; i += kThreads) {
      const int qi = i / chunks, d = (i - qi * chunks) * 4;
      const long at = q_off + (long)(q0 + qi) * dh + d;
      *reinterpret_cast<float4*>(qs + qi * kDh + d) = Elem<T>::ld4(q + at);
      *reinterpret_cast<float4*>(dos + qi * kDh + d) = Elem<T>::ld4(dout + at);
    }
    for (int i = threadIdx.x; i < nq; i += kThreads) {
      lses[i] = lse[bh * sq + q0 + i];
      deltas[i] = delta[bh * sq + q0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int qi = 0; qi < nq; ++qi) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = 16 * c + 4 * j;
        if (d < dh) {
          s = general::dot4(s, kv[c], *reinterpret_cast<const float4*>(qs + qi * kDh + d));
          dp = general::dot4(dp, vv[c], *reinterpret_cast<const float4*>(dos + qi * kDh + d));
        }
      }
      s = general::quad_sum(s);
      dp = general::quad_sum(dp);
      const float p = exp2f((s * scale - lses[qi]) * kLog2e);
      const float ds = Elem<T>::round(p * (dp - deltas[qi]) * scale);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int d = 16 * c + 4 * j;
        if (d < dh) {
          dva[c] = general::axpy4(dva[c], p, *reinterpret_cast<const float4*>(dos + qi * kDh + d));
          dka[c] = general::axpy4(dka[c], ds, *reinterpret_cast<const float4*>(qs + qi * kDh + d));
        }
      }
    }
  }

  if (row < skv) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 16 * c + 4 * j;
      if (d < dh) {
        Elem<T>::st4(dk + kv_off + (long)row * dh + d, dka[c]);
        Elem<T>::st4(dv + kv_off + (long)row * dh + d, dva[c]);
      }
    }
  }
}

bool takes(int bh, int sq, int skv, int dh) {
  return dh >= 8 && dh <= 128 && dh % 8 == 0 && bh >= 1 && bh <= 65535 && sq >= 1 && skv >= 1;
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const void* lse, const void* dlse, void* dq, void* delta, int bh, int sq, int skv,
              int dh, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kRows - 1) / kRows, bh);
#define ORV_DQ(CAP)                                                                            \
  flash_general_dq_kernel<T, CAP><<<grid, kThreads, 0, stream>>>(                              \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),            \
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const float*>(lse), \
      static_cast<const float*>(dlse), static_cast<T*>(dq), static_cast<float*>(delta), sq,    \
      skv, dh, scale)
  if (dh <= 16)
    ORV_DQ(16);
  else if (dh <= 32)
    ORV_DQ(32);
  else if (dh <= 64)
    ORV_DQ(64);
  else
    ORV_DQ(128);
#undef ORV_DQ
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int sq, int skv, int dh,
               float scale, cudaStream_t stream) {
  const dim3 grid((skv + kRows - 1) / kRows, bh);
#define ORV_DKV(CAP)                                                                           \
  flash_general_dkv_kernel<T, CAP><<<grid, kThreads, 0, stream>>>(                             \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),            \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                             \
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, dh, \
      scale)
  if (dh <= 16)
    ORV_DKV(16);
  else if (dh <= 32)
    ORV_DKV(32);
  else if (dh <= 64)
    ORV_DKV(64);
  else
    ORV_DKV(128);
#undef ORV_DKV
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: [bh, sq, dh]; k, v: [bh, skv, dh], contiguous, 16-byte
// aligned, f32 if is_f32 else bf16; lse and dlse (or null): [bh, sq] f32;
// delta: [bh, sq] f32 out, rowsum(out * dout) - dlse, for the dk/dv kernel.
// dh % 8 == 0, 8 <= dh <= 128, 1 <= bh <= 65535, sq, skv >= 1 (else
// cudaErrorInvalidValue). Returns the launch's CUDA error.
extern "C" int orv_flash_attn_general_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             const void* dlse, void* dq, void* delta, int bh,
                                             int sq, int skv, int dh, float scale, int is_f32,
                                             void* stream) {
  if (!takes(bh, sq, skv, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? launch_dq<float>(q, k, v, out, dout, lse, dlse, dq, delta, bh, sq, skv, dh,
                                   scale, st)
                : launch_dq<__nv_bfloat16>(q, k, v, out, dout, lse, dlse, dq, delta, bh, sq, skv,
                                           dh, scale, st);
}

// q, dout: [bh, sq, dh]; k, v, dk, dv: [bh, skv, dh], as the dq kernel's;
// lse and delta (the dq kernel's): [bh, sq] f32. Returns the launch's CUDA
// error.
extern "C" int orv_flash_attn_general_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int bh,
                                              int sq, int skv, int dh, float scale, int is_f32,
                                              void* stream) {
  if (!takes(bh, sq, skv, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, skv, dh, scale, st)
                : launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, skv, dh,
                                            scale, st);
}
