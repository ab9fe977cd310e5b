// The flash attention forward for Hopper (sm_90a), shared by three entry
// points: flash_attn_static_max.cu (Mode::kStaticMax), flash_attn_online.cu
// (Mode::kOnline) and flash_attn_q8.cu (Mode::kQ8). The bf16 modes differ
// only in the row max: a given bound, or a running max with an accumulator
// rescale. The int8 mode is the static-max one with an int8 Q.K^T.
//
// Per query row i of one (batch, head), walking the keys in 128-key tiles:
//   q_i   = bf16(q_i * scale)                     (pre-scaled in q's dtype)
//   s_ij  = f32(q_i . k_j)                        (keys j >= kv_len masked)
//   m     = static_max, or the running max over the valid keys (from -1e30)
//   p_ij  = exp(s_ij - m)                         (f32; masked keys -> 0)
//   l     = l * alpha + sum_j p_ij                (f32 p, before rounding)
//   o     = o * alpha + sum_j bf16(p_ij) * v_j    (f32 accumulate)
// with alpha = exp(m_old - m_new) (1 for the static max), and at the end
// out_i = bf16(o / l_safe), lse_i = m + log(l_safe), l == 0 counted as 1.
// exp(x) is ex2(x * log2(e)) of the difference x = s - m, as __expf computes
// it: folding log2(e) into one FMA (s * log2(e) - m * log2(e)) errs by about
// |m| * 2^-24 in the exponent, which at logits past 150 flips the bf16
// rounding of p and of the output against the plain version.
// Mode::kQ8 (see flash_attn_q8.cu) quantizes each pre-scaled q row to int8
// with its own scale sq_i = max(max|q_i|, 1e-6), takes k as int8 with one
// scale per key block, and computes s_ij = f32(q8_i . k8_j in int32) *
// ((sq_i / 127) * sk_r[j / block_k]), rounded before the shift; it writes
// no lse.
//
// Bound on the H100: operations. At [1,30,8026,64] the two products are
// 4*S^2*D*H = 4.95e11 FLOP against ~62 MB of q/k/v/o, far above the bf16
// ridge (in Mode::kQ8 half of them are int8 operations, at twice the rate);
// the 1.9e9 exponentials take another ~0.5 ms of the SMs' special function
// units, about as long as the products at the tensor-core peak.
//
// Design. One block per (b*h, 128-query tile): two consumer warpgroups of
// 64 query rows each (wgmma's M) and one producer warp.
// - The producer's one thread loads with TMA through 3-D tensor maps over
//   [B*H, S, 64]: the Q tile once (bf16 modes), then every 128-key K and V
//   tile into a ring of kStages stages, each signalled by a full mbarrier
//   (transaction bytes) and handed back by an empty mbarrier that all 256
//   consumer threads arrive on. A bf16 row of 64 is 128 bytes (128-byte
//   swizzle), an int8 K row 64 bytes (64-byte swizzle). The map is 3-D so a
//   ragged last tile reads zeros, never the next head's rows; keys past Skv
//   are masked in the scores.
// - bf16 modes: each consumer warpgroup scales its 64 Q rows in place (an
//   elementwise pass: the swizzle does not matter); S = Q.K^T is 4 wgmma
//   m64n128k16 per key tile, A and B from shared memory, both K-major.
//   Mode::kQ8: each consumer thread reads, straight from global memory, the
//   elements of q that its A fragments hold (rows r and r + 8, 16 columns
//   each), scales them in bf16, takes the row absmax over the 4 threads of
//   a row and keeps the int8 values as the register A fragments of 2 wgmma
//   m64n128k32 s8 per key tile (k8 K-major in shared memory), with s32
//   accumulators in the f32 accumulator's layout, converted to f32 in place
//   (exact: |s| <= 64 * 127^2 < 2^24) and scaled by the row's sq/127 times
//   the tile's key-block scale, one per 128-key tile (block_k is a multiple
//   of 128, so no tile straddles two blocks). The producer stores that
//   scale in shared memory beside the K tile before it arms the tile's
//   barrier; loaded from global memory by the consumers instead, as each
//   product started, it made the kernel 14% slower on an H100
//   (scripts/time_flash_q8_variants.py).
// - Per key tile, all modes: the softmax in registers, in the accumulator
//   layout (a thread holds 2 rows x 32 columns; row max and sum are
//   per-thread, then __shfl_xor_sync over the 4 threads of a row); O
//   rescaled by alpha in registers (online); P rounded to bf16 in registers,
//   where the S accumulator's layout is already wgmma's A-fragment layout,
//   so O += P.V is 8 wgmma m64n64k16 with A from registers and V from
//   shared memory (MN-major for B: the transpose bit).
// - Overlap within a warpgroup: tile t's P.V and tile t+1's S = Q.K^T are
//   in flight together, and the softmax of tile t+1 runs in place in the S
//   registers as soon as its S lands, while P.V still runs; then O is
//   rescaled and P packed. The two warpgroups run unsynchronised, so one's
//   softmax also overlaps the other's products. (Taking turns through
//   named barriers, as FlashAttention-3's ping-pong does, was slower here.)
// - Epilogue: o / l_safe to bf16 (and lse in the bf16 modes), straight from
//   registers; rows past Sq are never written.
// Registers: S 64, O 32, P 32 per thread, + 8 for the int8 Q fragments
// (154 in all in the bf16 modes, 168 in Mode::kQ8; no spills). The
// mbarrier, TMA and wgmma helpers live in sm90_common.cuh, shared with the
// backward (flash_attn_bwd.cu).

#pragma once

#include <type_traits>

#include "sm90_common.cuh"

namespace flash_sm90 {

using namespace sm90;

enum class Mode { kOnline, kStaticMax, kQ8 };

constexpr int kBM = 64;                            // query rows per consumer warpgroup
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kBQ = kBM * kConsumers;              // query rows per block
constexpr int kBK = 128;                           // keys per tile
constexpr int kStages = 4;                         // K/V ring depth
constexpr int kThreads = kConsumers * 128 + 32;    // + one producer warp
constexpr uint32_t kTileBytes = kBK * kRowBytes;   // one bf16 K or V tile
constexpr uint32_t kQBytes = kBQ * kRowBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kNegInf = -1e30f;                  // the TPU kernel's initial running max

// Tiles first, each 1024-byte aligned (the 128-byte swizzle repeats every
// 8 rows of 128 bytes, the 64-byte one every 8 rows of 64 bytes, and TMA
// and wgmma both address it from there).
template <bool kQ8>
struct Smem {  // bf16 modes: the Q tile and bf16 K tiles
  bf16 q[kBQ * kD];
  bf16 k[kStages][kBK * kD];
  bf16 v[kStages][kBK * kD];
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};
template <>
struct Smem<true> {  // Mode::kQ8: Q stays in registers, K tiles are int8
  int8_t k[kStages][kBK * kD];
  bf16 v[kStages][kBK * kD];
  float k_scale[kStages];  // each K tile's key-block scale over 127
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t empty[kStages];
};
template <bool kQ8>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<kQ8>) + 1024;  // + room to align the base
}

// What a launch passes besides the tensor maps.
struct Params {
  bf16* o;             // [bh, sq, 64]
  float* lse;          // [bh, sq]; bf16 modes only
  const bf16* q;       // [bh, sq, 64]; read by Mode::kQ8's consumers (the bf16 modes use tq)
  const float* sk_r;   // Mode::kQ8: [bh, n_kblocks], each key block's k scale over 127
  int sq, skv;
  int n_kblocks;       // Mode::kQ8: key blocks per head,
  int tiles_per_kblock;  // and 128-key tiles per block (block_k / 128)
  float scale, static_max;
};

// A score register as f32: the bf16 modes hold f32; Mode::kQ8 holds the s32
// product, then its f32 bits (converted in place by the softmax).
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ void put(float& r, float x) { r = x; }
__device__ __forceinline__ void put(uint32_t& r, float x) { r = __float_as_uint(x); }

// Mode::kQ8: quantizes this thread's A-fragment elements of q rows `row0`
// and row0 + 8 of one head (q [sq, 64]): columns 16m + 4*(lane%4) + j for
// m, j < 4, zeros past sq. Scaled in bf16 as the bf16 modes scale q, then
// sq = max(max|q|, 1e-6) over the row's 64 columns (4 threads hold a row),
// q8 = round_half_even(q * (127/sq)) with a true division. qa[kk] is the
// A fragment of the k-step of columns [32kk, 32kk + 32); sqr0 and sqr1 get
// sq / 127 of the two rows.
__device__ __forceinline__ void quantize_q(const bf16* __restrict__ q, int sq, int row0, int lane,
                                           float scale, uint32_t (&qa)[2][4], float& sqr0,
                                           float& sqr1) {
  const float sc = __bfloat162float(__float2bfloat16(scale));
  const int c0 = 4 * (lane % 4);
  float x[2][16];  // [row r, r + 8][4m + j]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint2 raw = make_uint2(0, 0);
      if (row < sq) raw = *reinterpret_cast<const uint2*>(q + (size_t)row * kD + 16 * m + c0);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[h][4 * m + j] = __bfloat162float(__float2bfloat16(__bfloat162float(e[j]) * sc));
    }
  }
  float inv[2], sqr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(x[h][i]));
    amax = fmaxf(quad_max(amax), 1e-6f);
    inv[h] = 127.0f / amax;
    sqr[h] = amax * kInv127;
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    qa[kk][0] = pack_s8(&x[0][8 * kk], inv[0]);
    qa[kk][1] = pack_s8(&x[1][8 * kk], inv[1]);
    qa[kk][2] = pack_s8(&x[0][8 * kk + 4], inv[0]);
    qa[kk][3] = pack_s8(&x[1][8 * kk + 4], inv[1]);
  }
  sqr0 = sqr[0];
  sqr1 = sqr[1];
}

// The kernel body. tq, tk, tv: tensor maps of q [bh, sq, 64] (bf16 modes;
// null in Mode::kQ8), k [bh, skv, 64] (bf16) or k8 [bh, skv_pad, 64] (int8,
// Mode::kQ8) and v [bh, skv, 64].
template <Mode kMode>
__device__ __forceinline__ void flash_fwd(const CUtensorMap* tq, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const Params prm) {
  constexpr bool kOnline = kMode == Mode::kOnline;
  constexpr bool kQ8 = kMode == Mode::kQ8;
  constexpr uint32_t kKTileBytes = kQ8 ? kBK * kRowBytes8 : kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  Smem<kQ8>& sm =
      *reinterpret_cast<Smem<kQ8>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sq = prm.sq, skv = prm.skv;
  const int n_tiles = (skv + kBK - 1) / kBK;
  const float* sk_r = prm.sk_r + (size_t)bh * prm.n_kblocks;  // Mode::kQ8

  if (threadIdx.x == 0) {
    if constexpr (!kQ8) mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread starts every load
    if (lane == 0) {
      if constexpr (!kQ8) {
        mbar_expect_tx(&sm.q_full, kQBytes);
        tma_load(sm.q, tq, &sm.q_full, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        mbar_wait(&sm.empty[st], ((t / kStages) & 1) ^ 1);  // the first round passes at once
        // the arrive below releases this store to the consumers that wait on k_full
        if constexpr (kQ8) sm.k_scale[st] = sk_r[t / prm.tiles_per_kblock];
        mbar_expect_tx(&sm.k_full[st], kKTileBytes);
        tma_load(sm.k[st], tk, &sm.k_full[st], t * kBK, bh);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
        tma_load(sm.v[st], tv, &sm.v_full[st], t * kBK, bh);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64*wg + [0, 64) ----
  const int wg = warp / 4;
  const int row0 = q0 + wg * kBM + 16 * (warp % 4) + lane / 4;  // this thread's rows: row0, + 8
  const int row1 = row0 + 8;

  uint64_t dq = 0;             // bf16 modes: Q's descriptor
  uint32_t qa[2][4];           // Mode::kQ8: the int8 Q fragments of the two k-steps
  float sqr0 = 0.0f, sqr1 = 0.0f;  // Mode::kQ8: sq / 127 of rows row0 and row1
  if constexpr (kQ8) {
    quantize_q(prm.q + (size_t)bh * sq * kD, sq, row0, lane, prm.scale, qa, sqr0, sqr1);
  } else {
    // scale Q in place in bf16 (one rounding: the product of two bf16 values
    // is exact in f32), then hand it to the async proxy that wgmma reads through
    const int tid = threadIdx.x % 128;
    bf16* q_wg = sm.q + wg * kBM * kD;
    mbar_wait(&sm.q_full, 0);
    const float sc = __bfloat162float(__float2bfloat16(prm.scale));
    uint4* qv = reinterpret_cast<uint4*>(q_wg);
#pragma unroll
    for (int i = tid; i < kBM * kD / 8; i += 128) {
      uint4 val = qv[i];
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * sc);
      qv[i] = val;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // this warpgroup's threads
    dq = smem_desc(q_wg, 16, 8 * kRowBytes);
  }
  float sk_t = 0.0f;  // Mode::kQ8: the k scale of the tile whose S is in flight

  // Accumulator layout: s[4j + e] is row r + 8*(e >= 2), column 8j + 2*(lane%4) + e%2,
  // with r = 16*(warp%4) + lane/4; o_acc likewise over 64 columns.
  typename std::conditional<kQ8, uint32_t, float>::type s[64];
  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.0f;
  float m0 = kOnline ? kNegInf : prm.static_max, m1 = m0;  // rows r and r + 8
  float l0 = 0.0f, l1 = 0.0f;                              // this thread's partial row sums
  const int col0 = 2 * (lane % 4);

  uint32_t p[32];  // bf16(p) pairs: p[4kk..4kk+3] is the A fragment of keys [16kk, 16kk + 16)
  float a0 = 1.0f, a1 = 1.0f;  // alpha of rows r and r + 8

  // S = Q.K^T of tile t in flight: bf16, 4 k-steps of 16; int8, 2 k-steps
  // of 32. Either way a k-step is 32 bytes further along the rows.
  auto start_qk = [&](int t) {
    mbar_wait(&sm.k_full[t % kStages], (t / kStages) & 1);
    if constexpr (kQ8) sk_t = sm.k_scale[t % kStages];
    wgmma_fence();
    if constexpr (kQ8) {
      const uint64_t dk = smem_desc(sm.k[t % kStages], 16, 8 * kRowBytes8, kSwizzle64B);
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) wgmma_m64n128k32_s8_rs(s, qa[kk], dk + 2 * kk, kk > 0);
    } else {
      const uint64_t dk = smem_desc(sm.k[t % kStages], 16, 8 * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    }
    wgmma_commit();
  };
  // O += P.V of tile t in flight: 8 k-steps of 16 keys, 16 rows of 128 bytes
  // each. V [keys, 64] is MN-major for B: 8 keys x 64 columns make one
  // 1024-byte swizzle atom, SBO steps to the next 8 keys, and the atom spans
  // all 64 columns, so LBO (the step to the next atom along N) is never used.
  auto start_pv = [&](int t) {
    mbar_wait(&sm.v_full[t % kStages], (t / kStages) & 1);
    fence_regs(o_acc);
    wgmma_fence();
    const uint64_t dv = smem_desc(sm.v[t % kStages], 8 * kRowBytes, 8 * kRowBytes);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n64k16_rs(o_acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                         dv + ((16 * kRowBytes * kk) >> 4));
    wgmma_commit();
  };
  // The softmax of tile t in place: s becomes the f32 p, l and (online) m
  // and alpha are updated. Mode::kQ8 first turns the s32 product into the
  // f32 score (__fmul_rn: rounded before the shift, as the reference). Keys
  // of the ragged last tile from kv_len on are masked next, so they never
  // enter the max.
  auto softmax = [&](int t) {
    if constexpr (kQ8) {
      const float c0 = sqr0 * sk_t, c1 = sqr1 * sk_t;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        put(s[i], __fmul_rn(__int2float_rn((int)s[i]), (i & 2) ? c1 : c0));
    }
    const int valid = skv - t * kBK;
    if (valid < kBK) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + col0 + (i % 2) >= valid) put(s[i], __int_as_float(0xff800000));  // -inf
    }
    if constexpr (kOnline) {
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(f32(s[4 * j]), f32(s[4 * j + 1])));
        mx1 = fmaxf(mx1, fmaxf(f32(s[4 * j + 2]), f32(s[4 * j + 3])));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      a0 = ex2((m0 - mn0) * kLog2e);
      a1 = ex2((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      put(s[4 * j], ex2((f32(s[4 * j]) - m0) * kLog2e));
      put(s[4 * j + 1], ex2((f32(s[4 * j + 1]) - m0) * kLog2e));
      put(s[4 * j + 2], ex2((f32(s[4 * j + 2]) - m1) * kLog2e));
      put(s[4 * j + 3], ex2((f32(s[4 * j + 3]) - m1) * kLog2e));
      l0 += f32(s[4 * j]) + f32(s[4 * j + 1]);  // l sums the f32 p
      l1 += f32(s[4 * j + 2]) + f32(s[4 * j + 3]);
    }
  };
  // After the previous tile's P.V has landed: O *= alpha, and the f32 p in
  // s rounded to the bf16 A fragments of the next P.V.
  auto rescale_and_pack = [&] {
    if constexpr (kOnline) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o_acc[4 * j] *= a0;
        o_acc[4 * j + 1] *= a0;
        o_acc[4 * j + 2] *= a1;
        o_acc[4 * j + 3] *= a1;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(f32(s[2 * i]), f32(s[2 * i + 1]));
  };

  // Tile t's P.V and tile t + 1's S = Q.K^T are in flight together; the
  // softmax of tile t + 1 runs as soon as its S lands, while P.V still runs
  // on the tensor cores. Both products are started unconditionally in the
  // loop (the last P.V after it): a conditional start would merge their
  // registers at a join inside the wgmma pipeline, and ptxas then
  // serializes the kernel's wgmma instructions.
  start_qk(0);  // skv >= 1: there is at least one tile
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  rescale_and_pack();  // O is still 0
  for (int t = 0; t + 1 < n_tiles; ++t) {
    start_qk(t + 1);
    start_pv(t);
    wgmma_wait<1>();  // S of tile t + 1 has landed
    fence_regs(s);
    softmax(t + 1);
    wgmma_wait<0>();  // P.V of tile t has landed
    fence_regs(o_acc);
    fence_regs(p);
    mbar_arrive(&sm.empty[t % kStages]);  // this thread is done with the stage's K and V
    rescale_and_pack();
  }
  start_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(o_acc);
  fence_regs(p);

  // epilogue: o / l_safe (and lse) for rows r and r + 8
  const float lt0 = quad_sum(l0), lt1 = quad_sum(l1);
  const float ls0 = lt0 == 0.0f ? 1.0f : lt0, ls1 = lt1 == 0.0f ? 1.0f : lt1;
  if (row0 < sq) {
    bf16* orow = prm.o + ((size_t)bh * sq + row0) * kD + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o_acc[4 * j] / ls0, o_acc[4 * j + 1] / ls0);
    if (!kQ8 && lane % 4 == 0) prm.lse[(size_t)bh * sq + row0] = m0 + logf(ls0);
  }
  if (row1 < sq) {
    bf16* orow = prm.o + ((size_t)bh * sq + row1) * kD + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o_acc[4 * j + 2] / ls1, o_acc[4 * j + 3] / ls1);
    if (!kQ8 && lane % 4 == 0) prm.lse[(size_t)bh * sq + row1] = m1 + logf(ls1);
  }
}

// ---- host side ----

// Encodes the maps and launches `kernel` (a __global__ wrapper of
// flash_fwd<kMode>: (tq, tk, tv, prm), or (tk, tv, prm) in Mode::kQ8) on one
// (b*h, 128-query tile) grid; k has k_rows rows a head (skv, or Mode::kQ8's
// skv_pad). Returns the CUDA error of the launch, or kErrTensorMap + the
// CUresult of a failed encoding (an empty tensor, bh, sq or skv of 0, has no
// map).
template <Mode kMode, typename Kernel>
int launch(Kernel kernel, const void* k, int k_rows, const void* v, int bh, const Params& prm,
           void* stream) {
  constexpr bool kQ8 = kMode == Mode::kQ8;
  CUtensorMap tq, tk, tv;
  int err = kQ8 ? 0 : make_map(&tq, prm.q, bh, prm.sq, kBQ);
  if (err == 0) err = make_map(&tk, k, bh, k_rows, kBK, kQ8);
  if (err == 0) err = make_map(&tv, v, bh, prm.skv, kBK);
  if (err != 0) return err;
  constexpr int smem = smem_bytes<kQ8>();
  cudaError_t cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  dim3 grid((prm.sq + kBQ - 1) / kBQ, bh);
  if constexpr (kQ8)
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(tk, tv, prm);
  else
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(tq, tk, tv, prm);
  return (int)cudaGetLastError();
}

}  // namespace flash_sm90
