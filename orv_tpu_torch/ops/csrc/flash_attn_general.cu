// General flash attention forward for Hopper (sm_90a): f32 or bf16, any head
// dim that is a multiple of 8 up to 128, any Sq and Skv.
//
// Replaces the TPU kernels orv_tpu/ops/attention.py:_fwd_kernel (:62, the
// online softmax) and _fwd_kernel_static_max (:124) wherever the Hopper
// kernel (flash_fwd_sm90.cuh: bf16 at head dim 64) does not take the
// operands: the JAX kernels take any dtype and any lane-tileable head dim,
// and an f32 model (train.mixed_precision=no) or a narrow one (the PAB
// harness's heads of 16) calls them there. One template, its mode a flag
// (kOnline), instantiated for T in {float, bf16} and for head-dim
// capacities 16, 32, 64 and 128; a launch takes the smallest capacity that
// holds its head dim, the dims past it masked.
//
// Arithmetic, as flash_attention_plain (ops/attention.py): q pre-scaled in T
// (q * T(scale), rounded to T); s = f32 q . k; the static mode takes
// p = exp(s - static_max), the online mode a running row max m with the
// accumulator rescaled by exp(m_old - m_new) once a key tile; the
// denominator sums the f32 p, the PV product takes p rounded to T; out =
// acc / l (l = 0 -> 1) rounded to T, lse = m + log(l), exact in f32.
//
// Bound on the H100: operations. An f32 product has no tensor-core path that
// keeps f32's 24-bit mantissa (TF32 keeps 10 and cannot meet the f32
// tolerance), so both products run as f32 FMAs on the CUDA cores: 4 Sq Skv
// Dh operations a head at 67 TFLOP/s. Design, simple first: a block takes
// 64 query rows of one (batch, head) with four threads a row; a thread holds
// four of every sixteen dims of its row's scaled q and accumulator in
// registers (float4 chunks 16 c + 4 j), so a shared-memory read of a key
// chunk is one 16-byte load shared by the warp's eight rows. K and V tiles
// (64 keys, 32 at capacity 128) are converted to f32 into shared memory by
// the whole block; a score is the quad's four partial dots summed by two
// shuffles. No tensor cores, no TMA, no pipelining: later work.

#include "general.cuh"

namespace {

using general::Elem;

constexpr int kRows = 64;            // query rows a block
constexpr int kThreads = 4 * kRows;  // a quad of threads a row
constexpr float kLog2e = 1.4426950408889634f;

// keys of a shared-memory tile: 32 KB of K and V in f32 at every capacity
template <int kDh>
__host__ __device__ constexpr int tile_keys() {
  return kDh <= 64 ? 64 : 32;
}

template <typename T, int kDh, bool kOnline>
__global__ void __launch_bounds__(kThreads)
flash_general_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                         int sq, int skv, int dh, float scale, float static_max) {
  constexpr int kKeys = tile_keys<kDh>();
  constexpr int kC = kDh / 16;  // float4 chunks a thread owns
  __shared__ __align__(16) float ks[kKeys * kDh];
  __shared__ __align__(16) float vs[kKeys * kDh];
  const long bh = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / 4, j = threadIdx.x % 4;
  q += bh * sq * dh;
  k += bh * skv * dh;
  v += bh * skv * dh;
  out += bh * sq * dh;
  lse += bh * sq;

  const float qscale = Elem<T>::round(scale);
  float4 qv[kC], acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int d = 16 * c + 4 * j;
    float4 x = general::zero4();
    if (row < sq && d < dh) x = Elem<T>::ld4(q + (long)row * dh + d);
    qv[c] = make_float4(Elem<T>::round(x.x * qscale), Elem<T>::round(x.y * qscale),
                        Elem<T>::round(x.z * qscale), Elem<T>::round(x.w * qscale));
    acc[c] = general::zero4();
  }
  float m = kOnline ? -INFINITY : static_max, l = 0.0f;
  const int chunks = dh / 4;  // float4 chunks a key row

  for (int k0 = 0; k0 < skv; k0 += kKeys) {
    const int nk = min(kKeys, skv - k0);
    __syncthreads();  // every thread is done with the last tile
    for (int i = threadIdx.x; i < nk * chunks; i += kThreads) {
      const int key = i / chunks, d = (i - key * chunks) * 4;
      const long at = (long)(k0 + key) * dh + d;
      *reinterpret_cast<float4*>(ks + key * kDh + d) = Elem<T>::ld4(k + at);
      *reinterpret_cast<float4*>(vs + key * kDh + d) = Elem<T>::ld4(v + at);
    }
    __syncthreads();

    float s[kKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int key = 0; key < kKeys; ++key) {
      float part = 0.0f;
      if (key < nk) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = 16 * c + 4 * j;
          if (d < dh)
            part = general::dot4(part, qv[c], *reinterpret_cast<const float4*>(ks + key * kDh + d));
        }
      }
      s[key] = general::quad_sum(part);
      if (key < nk) tile_max = fmaxf(tile_max, s[key]);
    }
    if (kOnline) {
      const float m_new = fmaxf(m, tile_max);
      const float alpha = exp2f((m - m_new) * kLog2e);  // 0 on the first tile
      l *= alpha;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = general::scale4(acc[c], alpha);
      m = m_new;
    }
#pragma unroll
    for (int key = 0; key < kKeys; ++key) {
      if (key < nk) {
        const float p = exp2f((s[key] - m) * kLog2e);
        l += p;
        const float pr = Elem<T>::round(p);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int d = 16 * c + 4 * j;
          if (d < dh)
            acc[c] = general::axpy4(acc[c], pr, *reinterpret_cast<const float4*>(vs + key * kDh + d));
        }
      }
    }
  }

  if (row < sq) {
    const float l_safe = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = 16 * c + 4 * j;
      if (d < dh)
        Elem<T>::st4(out + (long)row * dh + d,
                     make_float4(acc[c].x / l_safe, acc[c].y / l_safe, acc[c].z / l_safe,
                                 acc[c].w / l_safe));
    }
    if (j == 0) lse[row] = m + logf(l_safe);
  }
}

template <typename T, bool kOnline>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq,
           int skv, int dh, float scale, float static_max, cudaStream_t stream) {
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  float* lt = static_cast<float*>(lse);
  if (dh <= 16)
    flash_general_fwd_kernel<T, 16, kOnline><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, lt, sq, skv, dh, scale, static_max);
  else if (dh <= 32)
    flash_general_fwd_kernel<T, 32, kOnline><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, lt, sq, skv, dh, scale, static_max);
  else if (dh <= 64)
    flash_general_fwd_kernel<T, 64, kOnline><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, lt, sq, skv, dh, scale, static_max);
  else
    flash_general_fwd_kernel<T, 128, kOnline><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, lt, sq, skv, dh, scale, static_max);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [bh, sq, dh]; k, v: [bh, skv, dh], contiguous, 16-byte aligned, f32
// if is_f32 else bf16; lse: [bh, sq] f32 out. dh % 8 == 0 and 8 <= dh <= 128,
// 1 <= bh <= 65535, sq >= 1, skv >= 1 (else cudaErrorInvalidValue). online:
// the running-max softmax, else exp(s - static_max). Returns the launch's
// CUDA error.
extern "C" int orv_flash_attn_general(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int bh, int sq, int skv, int dh, float scale,
                                      float static_max, int online, int is_f32, void* stream) {
  if (dh < 8 || dh > 128 || dh % 8 || bh < 1 || bh > 65535 || sq < 1 || skv < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    return online ? launch<float, true>(q, k, v, out, lse, bh, sq, skv, dh, scale, static_max, st)
                  : launch<float, false>(q, k, v, out, lse, bh, sq, skv, dh, scale, static_max, st);
  return online
             ? launch<__nv_bfloat16, true>(q, k, v, out, lse, bh, sq, skv, dh, scale, static_max, st)
             : launch<__nv_bfloat16, false>(q, k, v, out, lse, bh, sq, skv, dh, scale, static_max,
                                            st);
}
