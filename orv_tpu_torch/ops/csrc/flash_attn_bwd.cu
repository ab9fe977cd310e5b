// Flash attention backward for Hopper (sm_90a): dq, and dk/dv.
//
// Replaces the TPU kernels orv_tpu/ops/attention.py:_bwd_dq_kernel (:389,
// pallas_call at :528) and _bwd_dkv_kernel (:432, pallas_call at :548),
// driven by _bwd_impl (:492). For one (batch, head), with p recomputed from
// the forward's logsumexp:
//   s_ij   = (q_i . k_j) * scale                 (f32; j >= kv_len -> p = 0)
//   p_ij   = exp(s_ij - lse_i)
//   delta_i = sum_d o_id * dO_id  (- dlse_i)     (f32, recomputed here)
//   dp_ij  = dO_i . v_j
//   ds_ij  = bf16(p_ij * (dp_ij - delta_i) * scale)
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i
// dlse (optional, may be null) is the cotangent of the forward's lse; it
// shifts delta, which is the exact joint VJP of (out, lse).
//
// Rounding. dO, v, q and k arrive in bf16, so the bf16 tensor-core products
// for s and dp are exact products summed in f32, as the TPU kernel's f32
// dot of the same values. ds is rounded to bf16 before dq and dk, as there.
// One deviation: dv takes p rounded to bf16 (the TPU kernel multiplies the
// f32 p by the f32 dO); the tensor cores take no f32 operand.
//
// Bound on the H100: operations. At the training shape ([1,30,3226,64])
// the dq kernel does 3 products of 2*S^2*64 per head (s, dp, dq) and the
// dk/dv kernel 4 (s, dp, dv, dk), 120 and 160 GFLOP against ~60 MB of
// inputs. Design: the wmma design the bf16 forwards had before they moved
// to TMA + wgmma (flash_fwd_sm90.cuh): nvcuda::wmma
// bf16 16x16x16 fragments with f32 accumulators, four warps a block, 16-byte
// synchronous tile loads, score tiles staged through shared memory for the
// elementwise pass. No cross-block reduction is needed: a dq block owns 64
// queries and walks every key tile; a dk/dv block owns 64 keys and walks
// every query tile, with its 16 keys a warp kept as A fragments. Query rows
// past S are loaded as zeros and their p is forced to 0 (lse is [bh, S],
// never read past S); keys past Skv get p = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kD = 64;          // head dim
constexpr int kB = 64;          // rows of a query or key tile
constexpr int kWarps = kB / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLdh = kD + 8;    // bf16 row stride of the q/k/v/dO tiles (144 B)
constexpr int kLds = kB + 4;    // f32 row stride of a warp's score tiles (272 B)
constexpr int kLdp = kB + 8;    // bf16 row stride of a warp's p/ds tiles (144 B)

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;  // X^T of a row-major X
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct SmemDq {
  bf16 k[kB * kLdh];
  bf16 v[kB * kLdh];
  bf16 q[kB * kLdh];
  bf16 dout[kB * kLdh];
  float s[kWarps][16 * kLds];
  float dp[kWarps][16 * kLds];
  bf16 ds[kWarps][16 * kLdp];
  float lse[kB];
  float delta[kB];
};

struct SmemDkv {
  bf16 k[kB * kLdh];
  bf16 v[kB * kLdh];
  bf16 q[kB * kLdh];
  bf16 dout[kB * kLdh];
  float s[kWarps][16 * kLds];   // s^T: row = key, column = query
  float dp[kWarps][16 * kLds];  // dp^T
  bf16 p[kWarps][16 * kLdp];    // bf16(p^T)
  bf16 ds[kWarps][16 * kLdp];   // ds^T
  float lse[kB];
  float delta[kB];
};

// Copies rows [row0, row0 + 64) of a [n, 64] bf16 matrix into a padded
// shared tile, zero-filling rows past n. 16-byte vectors, 4 per thread.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n) {
  for (int i = threadIdx.x; i < kB * kD / 8; i += kThreads) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kD + c);
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = val;
  }
}

// lse and delta = rowsum(o * dO) - dlse of the 64 query rows from row0 into
// shared memory, two threads a row; rows past sq get 0 in both.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s, const bf16* o,
                                               const bf16* dout, const float* lse,
                                               const float* dlse, int row0, int sq) {
  const int r = threadIdx.x / 2;
  const int half = threadIdx.x % 2;
  const bool valid = row0 + r < sq;
  float part = 0.0f;
  if (valid) {
    const size_t base = (size_t)(row0 + r) * kD + half * (kD / 2);
#pragma unroll
    for (int c = 0; c < kD / 2; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + base + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + base + c);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
      const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int j = 0; j < 8; ++j) part += __bfloat162float(oe[j]) * __bfloat162float(de[j]);
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if (half == 0) {
    delta_s[r] = valid ? part - (dlse != nullptr ? dlse[row0 + r] : 0.0f) : 0.0f;
    lse_s[r] = valid ? lse[row0 + r] : 0.0f;
  }
}

// Writes a warp's 16 x 64 f32 tile (staged at `tile`) as bf16 rows
// row0 + 0..15 of a [n, 64] matrix, skipping rows past n.
__device__ __forceinline__ void store_rows(bf16* dst, const float* tile, int row0, int n,
                                           int lane) {
  const int r = lane / 2;
  const int d0 = (lane % 2) * (kD / 2);
  if (row0 + r >= n) return;
#pragma unroll
  for (int d = 0; d < kD / 2; d += 2) {
    __nv_bfloat162 pair;
    pair.x = __float2bfloat16(tile[r * kLds + d0 + d]);
    pair.y = __float2bfloat16(tile[r * kLds + d0 + d + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row0 + r) * kD + d0 + d) = pair;
  }
}

// One block per (64-query tile, b*h); each warp owns 16 query rows and
// keeps its q and dO rows as A fragments and its dq rows as accumulators.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dlse, bf16* __restrict__ dq, int sq, int skv,
                    float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(smem_raw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qoff = (size_t)bh * sq * kD;
  const size_t koff = (size_t)bh * skv * kD;
  q += qoff;
  o += qoff;
  dout += qoff;
  dq += qoff;
  k += koff;
  v += koff;
  lse += (size_t)bh * sq;
  if (dlse != nullptr) dlse += (size_t)bh * sq;

  load_tile(sm.q, q, q0, sq);
  load_tile(sm.dout, dout, q0, sq);
  load_row_stats(sm.lse, sm.delta, o, dout, lse, dlse, q0, sq);
  __syncthreads();

  FragA qf[kD / 16], dof[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * kLdh + kk * 16, kLdh);
    wmma::load_matrix_sync(dof[kk], sm.dout + warp * 16 * kLdh + kk * 16, kLdh);
  }
  FragC dqf[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(dqf[n], 0.0f);

  float* s_w = sm.s[warp];
  float* dp_w = sm.dp[warp];
  bf16* ds_w = sm.ds[warp];
  // each lane owns half of one of the warp's 16 rows for the elementwise pass
  const int prow = lane / 2;
  const int pcol0 = (lane % 2) * (kB / 2);
  const float lse_r = sm.lse[warp * 16 + prow];
  const float delta_r = sm.delta[warp * 16 + prow];

  const int n_tiles = (skv + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kB;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.k, k, kv0, skv);
    load_tile(sm.v, v, kv0, skv);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows and the tile's 64 keys
#pragma unroll
    for (int n = 0; n < kB / 16; ++n) {
      FragC sf, pf;
      wmma::fill_fragment(sf, 0.0f);
      wmma::fill_fragment(pf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBt kb, vb;
        wmma::load_matrix_sync(kb, sm.k + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(sf, qf[kk], kb, sf);
        wmma::load_matrix_sync(vb, sm.v + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(pf, dof[kk], vb, pf);
      }
      wmma::store_matrix_sync(s_w + n * 16, sf, kLds, wmma::mem_row_major);
      wmma::store_matrix_sync(dp_w + n * 16, pf, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    const bool ragged = kv0 + kB > skv;
#pragma unroll 8
    for (int c = 0; c < kB / 2; ++c) {
      const int col = pcol0 + c;
      float p = __expf(s_w[prow * kLds + col] * scale - lse_r);
      if (ragged && kv0 + col >= skv) p = 0.0f;
      ds_w[prow * kLdp + col] = __float2bfloat16(p * (dp_w[prow * kLds + col] - delta_r) * scale);
    }
    __syncwarp();

    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      FragA dsf;
      wmma::load_matrix_sync(dsf, ds_w + kk * 16, kLdp);
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        FragB kb;
        wmma::load_matrix_sync(kb, sm.k + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dqf[n], dsf, kb, dqf[n]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kD / 16; ++n)
    wmma::store_matrix_sync(s_w + n * 16, dqf[n], kLds, wmma::mem_row_major);
  __syncwarp();
  store_rows(dq, s_w, q0 + warp * 16, sq, lane);
}

// One block per (64-key tile, b*h); each warp owns 16 keys, keeps its k and
// v rows as A fragments and its dk and dv rows as accumulators, and works
// in the transposed orientation (rows = keys, columns = queries).
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dlse, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int sq, int skv, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDkv& sm = *reinterpret_cast<SmemDkv*>(smem_raw);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qoff = (size_t)bh * sq * kD;
  const size_t koff = (size_t)bh * skv * kD;
  q += qoff;
  o += qoff;
  dout += qoff;
  k += koff;
  v += koff;
  dk += koff;
  dv += koff;
  lse += (size_t)bh * sq;
  if (dlse != nullptr) dlse += (size_t)bh * sq;

  load_tile(sm.k, k, k0, skv);
  load_tile(sm.v, v, k0, skv);
  __syncthreads();
  FragA kf[kD / 16], vf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], sm.k + warp * 16 * kLdh + kk * 16, kLdh);
    wmma::load_matrix_sync(vf[kk], sm.v + warp * 16 * kLdh + kk * 16, kLdh);
  }
  FragC dkf[kD / 16], dvf[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::fill_fragment(dkf[n], 0.0f);
    wmma::fill_fragment(dvf[n], 0.0f);
  }

  float* s_w = sm.s[warp];
  float* dp_w = sm.dp[warp];
  bf16* p_w = sm.p[warp];
  bf16* ds_w = sm.ds[warp];
  const int prow = lane / 2;  // the key this lane works on
  const int pcol0 = (lane % 2) * (kB / 2);
  const bool key_valid = k0 + warp * 16 + prow < skv;

  const int n_tiles = (sq + kB - 1) / kB;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kB;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile(sm.q, q, q0, sq);
    load_tile(sm.dout, dout, q0, sq);
    load_row_stats(sm.lse, sm.delta, o, dout, lse, dlse, q0, sq);
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys and 64 queries
#pragma unroll
    for (int n = 0; n < kB / 16; ++n) {
      FragC sf, pf;
      wmma::fill_fragment(sf, 0.0f);
      wmma::fill_fragment(pf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBt qb, db;
        wmma::load_matrix_sync(qb, sm.q + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(sf, kf[kk], qb, sf);
        wmma::load_matrix_sync(db, sm.dout + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(pf, vf[kk], db, pf);
      }
      wmma::store_matrix_sync(s_w + n * 16, sf, kLds, wmma::mem_row_major);
      wmma::store_matrix_sync(dp_w + n * 16, pf, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // p^T (0 for keys past skv and queries past sq) and ds^T, both in bf16
#pragma unroll 8
    for (int c = 0; c < kB / 2; ++c) {
      const int col = pcol0 + c;
      float p = __expf(s_w[prow * kLds + col] * scale - sm.lse[col]);
      if (!key_valid || q0 + col >= sq) p = 0.0f;
      p_w[prow * kLdp + col] = __float2bfloat16(p);
      ds_w[prow * kLdp + col] =
          __float2bfloat16(p * (dp_w[prow * kLds + col] - sm.delta[col]) * scale);
    }
    __syncwarp();

    // dv += p^T dO, dk += ds^T q
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      FragA pa, da;
      wmma::load_matrix_sync(pa, p_w + kk * 16, kLdp);
      wmma::load_matrix_sync(da, ds_w + kk * 16, kLdp);
#pragma unroll
      for (int n = 0; n < kD / 16; ++n) {
        FragB db, qb;
        wmma::load_matrix_sync(db, sm.dout + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dvf[n], pa, db, dvf[n]);
        wmma::load_matrix_sync(qb, sm.q + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(dkf[n], da, qb, dkf[n]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::store_matrix_sync(s_w + n * 16, dkf[n], kLds, wmma::mem_row_major);
    wmma::store_matrix_sync(dp_w + n * 16, dvf[n], kLds, wmma::mem_row_major);
  }
  __syncwarp();
  store_rows(dk, s_w, k0 + warp * 16, skv, lane);
  store_rows(dv, dp_w, k0 + warp * 16, skv, lane);
}

}  // namespace

// q, o, dout, dq: [bh, sq, 64] bf16 contiguous; k, v: [bh, skv, 64] bf16;
// lse (and dlse, or null): [bh, sq] f32. Returns the launch's CUDA error.
extern "C" int orv_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, const void* dlse,
                                     void* dq, int bh, int sq, int skv, float scale,
                                     void* stream) {
  const int smem = (int)sizeof(SmemDq);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kB - 1) / kB, bh);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (const float*)dlse, (bf16*)dq, sq, skv, scale);
  return (int)cudaGetLastError();
}

// As above; dk, dv: [bh, skv, 64] bf16. Returns the launch's CUDA error.
extern "C" int orv_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, const void* dlse,
                                      void* dk, void* dv, int bh, int sq, int skv, float scale,
                                      void* stream) {
  const int smem = (int)sizeof(SmemDkv);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((skv + kB - 1) / kB, bh);
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (const float*)dlse, (bf16*)dk, (bf16*)dv, sq, skv, scale);
  return (int)cudaGetLastError();
}
