// Static-max flash attention forward with an int8 QK^T product, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/attention.py:_fwd_kernel_q8
// (pallas_call at attention.py:267), the W8A8 serving model's joint
// text+video attention. The host (`prepare_k_q8` in ops/attention.py, as
// `_fwd_q8` does in XLA) mean-smooths k and quantizes it to int8 with one
// scale per (batch*head, block_k keys); this kernel computes, per query row
// i of one (batch, head):
//   q_i   = bf16(q_i * scale)                      (pre-scaled in q's dtype)
//   sq_i  = max(max|q_i|, 1e-6);  q8_i = round_half_even(q_i * (127/sq_i))
//   s_ij  = f32(q8_i . k8_j  in int32) * ((sq_i * (1/127)) * sk_r[j / block_k])
//   p_ij  = exp(s_ij - static_max)                 (f32; j >= kv_len -> 0)
//   l_i   = sum_j p_ij                             (f32 p, before rounding)
//   o_i   = (sum_j bf16(p_ij) * v_j) / l_i         (f32 accumulate, one rounding)
// with l_i == 0 -> 1. There is no lse output: nothing consumes it on this
// path (the smoothing would shift it per query by q . mean(k) anyway).
//
// Bound on the H100: operations. At the flagship shape ([1,30,8026,64]) QK^T
// is 2*S^2*D*H = 2.47e11 int8 ops and PV as many bf16 FLOP, against ~108 MB
// of q/k8/v/o. Design: the wmma design the bf16 forwards had before they
// moved to TMA + wgmma (flash_fwd_sm90.cuh), with the score product in
// int8. One block of four warps per (b*h, 64-query tile). The block
// quantizes its q tile once into shared memory (two threads a row, a
// shuffle for the row max) and keeps each warp's 16 rows as int8 wmma
// fragments in registers. It then walks 64-key tiles: int8 K and bf16 V
// through shared memory; QK^T on the tensor cores as nvcuda::wmma
// signed-char 16x16x16 fragments with int32 accumulators; the scale, exp
// and bf16(p) in shared memory; PV as bf16 16x16x16 fragments with f32
// accumulators. A 64-key tile never straddles two scale blocks (block_k is
// a multiple of 128), and its scale is looked up by key / block_k. The int8
// tiles keep each 16-column chunk at a 32-byte boundary (row stride 144
// bytes, chunk c at byte 32*c), as wmma's loads require. No TMA, wgmma or
// pipelining yet: loads are synchronous 16-byte vector copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLdi = 144;       // byte row stride of the int8 q/k tiles
constexpr int kLdh = kD + 8;    // bf16 row stride of the v tile (144 B)
constexpr int kLds = kBK + 4;   // 32-bit row stride of a warp's score tile (272 B)
constexpr int kLdp = kBK + 8;   // bf16 row stride of a warp's p tile (144 B)
constexpr float kInv127 = (float)(1.0 / 127.0);

struct Smem {
  int8_t q[kBQ * kLdi];
  int8_t k[kBK * kLdi];
  bf16 v[kBK * kLdh];
  float sq[kBQ];                // per-query sq * (1/127)
  float s[kWarps][16 * kLds];   // int32 scores, then the f32 output tile
  bf16 p[kWarps][16 * kLdp];
};

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(a) |
         ((uint32_t)(uint8_t)(int8_t)__float2int_rn(b) << 8) |
         ((uint32_t)(uint8_t)(int8_t)__float2int_rn(c) << 16) |
         ((uint32_t)(uint8_t)(int8_t)__float2int_rn(d) << 24);
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_q8_kernel(const bf16* __restrict__ q, const int8_t* __restrict__ k8,
                    const float* __restrict__ sk_r, const bf16* __restrict__ v,
                    bf16* __restrict__ o, int sq_len, int skv, int skv_pad, int block_k,
                    int n_kblocks, float scale, float static_max) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  q += (size_t)bh * sq_len * kD;
  k8 += (size_t)bh * skv_pad * kD;
  v += (size_t)bh * skv * kD;
  o += (size_t)bh * sq_len * kD;
  sk_r += (size_t)bh * n_kblocks;

  // q tile: scale in bf16, then quantize per token into shared memory. Two
  // threads own a row, 32 values each; padded rows quantize zeros.
  {
    const int r = threadIdx.x / 2;
    const int half = threadIdx.x % 2;
    const float scale_b = __bfloat162float(__float2bfloat16(scale));
    float qv[32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (q0 + r < sq_len)
        raw = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * kD + half * 32 + j * 8);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        qv[j * 8 + t] = __bfloat162float(__float2bfloat16(__bfloat162float(e[t]) * scale_b));
    }
    float amax = 0.0f;
#pragma unroll
    for (int t = 0; t < 32; ++t) amax = fmaxf(amax, fabsf(qv[t]));
    amax = fmaxf(fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1)), 1e-6f);
    const float inv = 127.0f / amax;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint4 packed;
      packed.x = pack4(qv[c * 16 + 0] * inv, qv[c * 16 + 1] * inv, qv[c * 16 + 2] * inv,
                       qv[c * 16 + 3] * inv);
      packed.y = pack4(qv[c * 16 + 4] * inv, qv[c * 16 + 5] * inv, qv[c * 16 + 6] * inv,
                       qv[c * 16 + 7] * inv);
      packed.z = pack4(qv[c * 16 + 8] * inv, qv[c * 16 + 9] * inv, qv[c * 16 + 10] * inv,
                       qv[c * 16 + 11] * inv);
      packed.w = pack4(qv[c * 16 + 12] * inv, qv[c * 16 + 13] * inv, qv[c * 16 + 14] * inv,
                       qv[c * 16 + 15] * inv);
      *reinterpret_cast<uint4*>(sm.q + r * kLdi + (half * 2 + c) * 32) = packed;
    }
    if (half == 0) sm.sq[r] = amax * kInv127;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> qf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], reinterpret_cast<const signed char*>(sm.q) +
                                       warp * 16 * kLdi + kk * 32, kLdi);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(of[n], 0.0f);

  float* s_w = sm.s[warp];
  int* s_i = reinterpret_cast<int*>(s_w);
  bf16* p_w = sm.p[warp];
  // each lane owns half of one of the warp's 16 rows for the softmax pass
  const int prow = lane / 2;
  const int pcol0 = (lane % 2) * (kBK / 2);
  const float sq_row = sm.sq[warp * 16 + prow];
  float l_part = 0.0f;

  const int n_tiles = (skv + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = threadIdx.x; i < kBK * kD / 16; i += kThreads) {  // int8 K: 4 x 16 B a row
      const int r = i / (kD / 16);
      const int c = i % (kD / 16);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kv0 + r < skv_pad)
        val = *reinterpret_cast<const uint4*>(k8 + (size_t)(kv0 + r) * kD + c * 16);
      *reinterpret_cast<uint4*>(sm.k + r * kLdi + c * 32) = val;
    }
    for (int i = threadIdx.x; i < kBK * kD / 8; i += kThreads) {  // bf16 V: 8 x 16 B a row
      const int r = i / (kD / 8);
      const int c = (i % (kD / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kv0 + r < skv) val = *reinterpret_cast<const uint4*>(v + (size_t)(kv0 + r) * kD + c);
      *reinterpret_cast<uint4*>(sm.v + r * kLdh + c) = val;
    }
    __syncthreads();

    // s32 = q8 k8^T for this warp's 16 rows and the tile's 64 keys
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> sf;
      wmma::fill_fragment(sf, 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, reinterpret_cast<const signed char*>(sm.k) +
                                       n * 16 * kLdi + kk * 32, kLdi);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(s_i + n * 16, sf, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // s = f32(s32) * (sq * sk); p = exp(s - static_max); l sums the f32 p,
    // PV takes bf16(p). The tile lies inside one scale block.
    const float comb = sq_row * sk_r[kv0 / block_k];
    const bool ragged = kv0 + kBK > skv;
#pragma unroll 8
    for (int c = 0; c < kBK / 2; ++c) {
      const int col = pcol0 + c;
      // __fmul_rn: s is rounded before the shift, as the reference computes it
      float p = __expf(__fmul_rn((float)s_i[prow * kLds + col], comb) - static_max);
      if (ragged && kv0 + col >= skv) p = 0.0f;
      l_part += p;
      p_w[prow * kLdp + col] = __float2bfloat16(p);
    }
    __syncwarp();

    // o += p v
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, p_w + kk * 16, kLdp);
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(of[n], pf, vf, of[n]);
      }
    }
  }

  // epilogue: o / l for the rows this warp owns
  const float l = l_part + __shfl_xor_sync(0xffffffffu, l_part, 1);
  const float l_safe = l == 0.0f ? 1.0f : l;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kD / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, of[n], kLds, wmma::mem_row_major);
  __syncwarp();
  const int row = q0 + warp * 16 + prow;
  if (row < sq_len) {
    const int d0 = (lane % 2) * (kD / 2);
#pragma unroll
    for (int d = 0; d < kD / 2; d += 2) {
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16(s_w[prow * kLds + d0 + d] / l_safe);
      pair.y = __float2bfloat16(s_w[prow * kLds + d0 + d + 1] / l_safe);
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * kD + d0 + d) = pair;
    }
  }
}

}  // namespace

// q, o: [bh, sq, 64] bf16; k8: [bh, skv_pad, 64] int8 (mean-smoothed keys,
// zero past skv); sk_r: [bh, n_kblocks] f32, the scale of keys
// [j*block_k, (j+1)*block_k) over 127; v: [bh, skv, 64] bf16. All
// contiguous; block_k % 64 == 0. Returns the CUDA error of the launch.
extern "C" int orv_flash_attn_q8(const void* q, const void* k8, const void* sk_r, const void* v,
                                 void* o, int bh, int sq, int skv, int skv_pad, int block_k,
                                 int n_kblocks, float scale, float static_max, void* stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_q8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_q8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const int8_t*)k8, (const float*)sk_r, (const bf16*)v, (bf16*)o, sq, skv,
      skv_pad, block_k, n_kblocks, scale, static_max);
  return (int)cudaGetLastError();
}
