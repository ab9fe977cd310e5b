// Online-softmax flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/attention.py:_fwd_kernel (pallas_call
// at attention.py:353 with static_max=None): the forward of every attention
// op whose logits have no known bound (flash_attention's default, ring
// attention without qk-norm, JointAttention(qk_norm=False)). It computes,
// per query row i of one (batch, head), walking the keys in 64-key tiles t:
//   q_i   = bf16(q_i * scale)                     (pre-scaled in q's dtype)
//   s_ij  = f32(q_i . k_j)                        (keys j >= kv_len masked)
//   m_new = max(m, max_j s_ij)                    (masked keys never enter)
//   alpha = exp(m - m_new)
//   p_ij  = exp(s_ij - m_new)                     (f32; masked -> 0)
//   l     = l * alpha + sum_j p_ij                (f32 p, before rounding)
//   o     = o * alpha + sum_j bf16(p_ij) * v_j    (f32 accumulate)
// and at the end out_i = o / l_safe, lse_i = m + log(l_safe) (l == 0 -> 1),
// with m starting at -1e30 as in the TPU kernel. Sq and Skv may differ.
//
// Bound on the H100: operations. At [1,30,8026,64] the two products are
// 4*S^2*D*H = 4.95e11 FLOP against ~62 MB of q/k/v/o, far above the bf16
// ridge. Design: that of flash_attn_static_max.cu (one block of four warps
// per (b*h, 64-query tile), K/V tiles through shared memory, nvcuda::wmma
// bf16 16x16x16 fragments with f32 accumulators, synchronous 16-byte loads),
// plus what the running max needs. A wmma accumulator's element-to-row map
// is unspecified, so O cannot be rescaled row by row inside fragments.
// Instead each tile's P.V goes into freshly zeroed fragments, is stored to
// the warp's score scratch (free once p is written), and O lives in
// registers in the softmax pass's layout: each lane owns half of one row
// (32 keys of the score tile, 32 columns of O), so m, alpha and l are
// per-lane scalars and the row max is one __shfl_xor_sync with the lane's
// partner. No TMA, wgmma or pipelining yet.

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
constexpr int kLdh = kD + 8;    // bf16 row stride of the q/k/v tiles (144 B)
constexpr int kLds = kBK + 4;   // f32 row stride of a warp's score / PV tile (272 B)
constexpr int kLdp = kBK + 8;   // bf16 row stride of a warp's p tile (144 B)
constexpr float kNegInf = -1e30f;  // the TPU kernel's initial running max

struct Smem {
  bf16 q[kBQ * kLdh];
  bf16 k[kBK * kLdh];
  bf16 v[kBK * kLdh];
  float s[kWarps][16 * kLds];
  bf16 p[kWarps][16 * kLdp];
};

// Copies rows [row0, row0 + 64) of a [n, 64] bf16 matrix into a padded
// shared tile, zero-filling rows past n. 16-byte vectors, 4 per thread.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n) {
  for (int i = threadIdx.x; i < 64 * kD / 8; i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kD + c);
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_online_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int sq, int skv, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  q += (size_t)bh * sq * kD;
  k += (size_t)bh * skv * kD;
  v += (size_t)bh * skv * kD;
  o += (size_t)bh * sq * kD;
  lse += (size_t)bh * sq;

  // Q tile, scaled in bf16 (one rounding, like the reference's bf16 multiply)
  const bf16 scale_b = __float2bfloat16(scale);
  for (int i = threadIdx.x; i < kBQ * kD / 8; i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < sq) val = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * kD + c);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * __bfloat162float(scale_b));
    *reinterpret_cast<uint4*>(sm.q + r * kLdh + c) = val;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * kLdh + kk * 16, kLdh);

  float* s_w = sm.s[warp];
  bf16* p_w = sm.p[warp];
  // each lane owns half of one of the warp's 16 rows: 32 keys of the score
  // tile in the softmax pass and the same 32 columns of O
  const int prow = lane / 2;
  const int pcol0 = (lane % 2) * (kBK / 2);
  const int d0 = (lane % 2) * (kD / 2);
  float o_acc[kD / 2];
#pragma unroll
  for (int d = 0; d < kD / 2; ++d) o_acc[d] = 0.0f;
  float m = kNegInf;
  float l_part = 0.0f;

  const int n_tiles = (skv + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.k, k, kv0, skv);
    load_tile(sm.v, v, kv0, skv);
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(s_w + n * 16, sf, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // the running max over this row's valid keys; both lanes of a row pair
    // end with the same m_new
    const int valid = min(kBK, skv - kv0);  // keys of this tile below kv_len
    float mx = kNegInf;
#pragma unroll 8
    for (int c = 0; c < kBK / 2; ++c) {
      const int col = pcol0 + c;
      if (col < valid) mx = fmaxf(mx, s_w[prow * kLds + col]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);
    m = m_new;

    // p = exp(s - m_new); l sums the f32 p, PV takes bf16(p)
    float p_sum = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kBK / 2; ++c) {
      const int col = pcol0 + c;
      const float p = col < valid ? __expf(s_w[prow * kLds + col] - m_new) : 0.0f;
      p_sum += p;
      p_w[prow * kLdp + col] = __float2bfloat16(p);
    }
    l_part = l_part * alpha + p_sum;
    __syncwarp();  // p_w written and s_w read by every lane of the warp

    // pv = p v into fresh fragments, through s_w into the register layout
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pvf;
      wmma::fill_fragment(pvf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p_w + kk * 16, kLdp);
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(pvf, pf, vf, pvf);
      }
      wmma::store_matrix_sync(s_w + n * 16, pvf, kLds, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < kD / 2; ++d) o_acc[d] = o_acc[d] * alpha + s_w[prow * kLds + d0 + d];
    __syncwarp();  // s_w is read before the next tile's scores overwrite it
  }

  // epilogue: o / l and lse for the rows this warp owns
  const float l = l_part + __shfl_xor_sync(0xffffffffu, l_part, 1);
  const float l_safe = l == 0.0f ? 1.0f : l;
  const int row = q0 + warp * 16 + prow;
  if (row < sq) {
#pragma unroll
    for (int d = 0; d < kD / 2; d += 2) {
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16(o_acc[d] / l_safe);
      pair.y = __float2bfloat16(o_acc[d + 1] / l_safe);
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * kD + d0 + d) = pair;
    }
    if (lane % 2 == 0) lse[row] = m + logf(l_safe);
  }
}

}  // namespace

// q: [bh, sq, 64], k, v: [bh, skv, 64], o: [bh, sq, 64], all bf16 contiguous;
// lse: [bh, sq] f32. Returns the CUDA error of the launch (0 on success).
extern "C" int orv_flash_attn_online(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int bh, int sq, int skv, float scale,
                                     void* stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_online_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_fwd_online_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, sq, skv, scale);
  return (int)cudaGetLastError();
}
