// Flash attention backward for Hopper (sm_90a): dq (and delta), then dk/dv.
//
// Replaces the TPU kernels orv_tpu/ops/attention.py:_bwd_dq_kernel (:389,
// pallas_call at :528) and _bwd_dkv_kernel (:432, pallas_call at :548),
// driven by _bwd_impl (:492). For one (batch, head), with p recomputed from
// the forward's logsumexp:
//   s_ij    = f32(q_i . k_j) * scale               (q not pre-scaled)
//   p_ij    = exp(s_ij - lse_i)                     (f32; keys j >= Skv and
//                                                    queries i >= Sq -> 0)
//   delta_i = sum_d f32(o_id * dO_id)  (- dlse_i)   (f32)
//   dp_ij   = f32(dO_i . v_j)
//   ds_ij   = bf16(p_ij * (dp_ij - delta_i) * scale)
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i bf16(p_ij) dO_i
// dlse (optional, may be null) is the cotangent of the forward's lse; it
// shifts delta, which is the exact joint VJP of (out, lse).
//
// Rounding. dO, v, q and k arrive in bf16, so the bf16 tensor-core products
// for s and dp are exact products summed in f32, as the TPU kernel's f32
// dot of the same values. ds is rounded to bf16 before dq and dk, as there.
// One deviation: dv takes p rounded to bf16 (the TPU kernel multiplies the
// f32 p by the f32 dO); the tensor cores take no f32 operand. exp(x) is
// ex2(x * log2(e)) of the difference x = s - lse, subtracted first.
//
// Bound on the H100: operations. At the training shape ([1,30,3226,64]) the
// dq kernel does 3 products of 2*S^2*64 per head (s, dp, dq) and the dk/dv
// kernel 4 (s^T, dp^T, dv, dk): 120 and 160 GFLOP, 0.121 and 0.162 ms at
// the bf16 peak, against 75 MB of operands and outputs a kernel (0.022 ms);
// each kernel recomputes p, 3.1e8 exponentials, about 0.08 ms of the
// special function units.
//
// Design: flash_fwd_sm90.cuh's pipeline (helpers in sm90_common.cuh). Each
// block owns 128 rows, 64 for each of two consumer warpgroups (wgmma's M),
// and a producer warp streams 64-row tiles of the other operand:
// - dq kernel, one block per (128 queries, b*h). The producer's one thread
//   loads the block's Q and dO once by TMA (3-D maps over [B*H, S, 64], the
//   128-byte swizzle), then K and V tiles of 64 keys into a ring of kStages
//   stages, each armed by a full mbarrier (transaction bytes) and handed
//   back by an empty mbarrier that all 256 consumer threads arrive on. Each
//   consumer thread first computes delta of its two accumulator rows r and
//   r + 8 from o and dO in global memory (16 columns a thread, then the sum
//   over the row's 4 threads: a fixed order) and writes it to a [B*H, Sq]
//   f32 output, one writer a row, for the dk/dv kernel. Per key tile:
//   S = Q.K^T and dP = dO.V^T as wgmma m64n64k16 with both operands in
//   shared memory (K-major); p and ds in registers in the accumulator
//   layout; ds packed to bf16 is already wgmma's A-fragment layout, so
//   dQ += dS.K is an rs wgmma with K MN-major (the transpose bit), as the
//   forward's P.V reads V.
// - dk/dv kernel, one block per (128 keys, b*h), in the transposed
//   orientation (rows are keys, columns queries). K and V are loaded once;
//   Q and dO tiles of 64 queries stream through the ring, and so do those
//   queries' lse and delta: a [B*H, S] f32 row is S*4 bytes, not a multiple
//   of 16 for every S, so TMA cannot take it; the producer warp's 32 lanes
//   copy 2 values each into the stage with plain loads and each arrive on
//   the stage's full barrier (count 32, lane 0's arrival with the TMA
//   bytes). Per query tile: S^T = K.Q^T and dP^T = V.dO^T; p^T with lse and
//   delta read by column from the staged copy; dV += bf16(P^T).dO and
//   dK += dS^T.Q, A from registers, dO and Q MN-major. Its consumers hold
//   S^T 32 + dP^T 32 + dK 32 + dV 32 + P 16 + dS 16 registers of data:
//   more than the 168 ptxas grants at 288 threads (three warps on one of
//   the SM's four register partitions). There it spilled and ptxas
//   serialized its wgmma (C7512), so the kernel runs 384 threads, a whole
//   producer warpgroup of which one warp works, and setmaxnreg moves the
//   registers: 40 a producer thread, 232 a consumer thread. The dq
//   kernel's S 32 + dP 32 + dQ 32 + dS 16 fit in 288 threads (138 used).
// - Overlap within a warpgroup: tile t's dQ (or dK and dV) products run
//   while tile t + 1's S and dP are issued and land; the elementwise pass
//   of tile t + 1 runs in place in the f32 S and dP registers before the
//   bf16 fragments of tile t are overwritten. The last tile is peeled, so
//   every product is issued unconditionally (ptxas serializes the wgmma
//   pipeline, C7515, when a product is issued under a condition).
// - Masks: TMA fills rows past S with zeros, which are no zeros in p (a zero
//   k row gives p = exp(-lse), a zero lse p = 1), so s is set to -inf for
//   keys past Skv (both kernels) and queries past Sq (dk/dv) before the
//   exponential, as the TPU kernels mask them.
// - No atomics: every output row is written by one block, and every sum is
//   taken in a fixed order, so the backward gives the same bits run after
//   run (FlashAttention-3's one kernel with f32 atomics into dq does 5
//   products instead of 7, but its dq changes from run to run).
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): dq 0.32 ms and
// dk/dv 0.42-0.43 ms at [1,30,3226,64], 38% of their bounds each, together
// 0.5-0.7x the time of SDPA's flash backward on the same inputs.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 64;                  // rows per consumer warpgroup
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kBR = kBM * kConsumers;    // rows a block owns: queries (dq), keys (dk/dv)
constexpr int kBN = 64;                  // rows of a streamed tile: keys (dq), queries (dk/dv)
constexpr int kStages = 4;               // ring depth
constexpr int kThreads = kConsumers * 128 + 32;      // dq kernel: + one producer warp
constexpr int kThreadsDkv = kConsumers * 128 + 128;  // dk/dv kernel: + a producer warpgroup
// The dk/dv kernel's registers a thread after setmaxnreg: 128 * 40 + 256 * 232
// is what its launch gives 384 threads (168 each).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kOwnBytes = kBR * kRowBytes;    // one of the block's own tiles
constexpr uint32_t kTileBytes = kBN * kRowBytes;   // one streamed tile
constexpr float kLog2e = 1.4426950408889634f;

// Tiles first, each 1024-byte aligned (the 128-byte swizzle repeats every
// 8 rows of 128 bytes, and TMA and wgmma both address it from there).
struct SmemDq {
  bf16 q[kBR * kD];
  bf16 dout[kBR * kD];
  bf16 k[kStages][kBN * kD];
  bf16 v[kStages][kBN * kD];
  uint64_t own_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

struct SmemDkv {
  bf16 k[kBR * kD];
  bf16 v[kBR * kD];
  bf16 q[kStages][kBN * kD];
  bf16 dout[kStages][kBN * kD];
  float lse[kStages][kBN];    // the tile's queries' lse and delta, 0 past sq
  float delta[kStages][kBN];
  uint64_t own_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// What a launch passes besides the tensor maps.
struct Params {
  const bf16* o;       // dq kernel: [bh, sq, 64], for delta
  const bf16* dout;    // dq kernel: [bh, sq, 64], for delta (the dO tiles come by TMA)
  const float* lse;    // [bh, sq]
  const float* dlse;   // dq kernel: [bh, sq] or null
  float* delta;        // [bh, sq]: written by the dq kernel, read by the dk/dv kernel
  bf16* dq;            // [bh, sq, 64]
  bf16* dk;            // [bh, skv, 64]
  bf16* dv;            // [bh, skv, 64]
  int sq, skv;
  float scale;
};

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// sum_d f32(o_d * dO_d) over row `row` (< sq) of one head's o and dO: this
// thread adds columns [16 * (lane % 4), + 16) in order, then the row's 4
// threads add their sums. Rows past sq give 0. All lanes must call it.
__device__ __forceinline__ float row_dot(const bf16* o, const bf16* dout, int row, int sq,
                                         int lane) {
  float acc = 0.0f;
  if (row < sq) {
    const size_t base = (size_t)row * kD + 16 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + base + 8 * h);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + base + 8 * h);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
      const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += __bfloat162float(oe[j]) * __bfloat162float(de[j]);
    }
  }
  return quad_sum(acc);
}

// Stores this thread's two accumulator rows of a 64-wide f32 tile as bf16
// rows row0 and row0 + 8 of a [n, 64] matrix, skipping rows past n.
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[32], int row0, int n,
                                           int col0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row0 + 8 * h >= n) continue;
    bf16* row = dst + (size_t)(row0 + 8 * h) * kD + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// Accumulator layout (both kernels): a[4j + e] is row r + 8*(e >= 2), column
// 8j + 2*(lane%4) + e%2 of the warpgroup's 64 x 64 tile, r = 16*(warp%4) +
// lane/4. Packing pairs a[2i], a[2i + 1] gives the A fragments of the next
// product: pk[4kk..4kk+3] covers columns [16kk, 16kk + 16).
__device__ __forceinline__ void pack(uint32_t (&pk)[16], const float (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pk[i] = pack_bf16(a[2 * i], a[2 * i + 1]);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const Params prm) {
  extern __shared__ unsigned char smem_raw[];
  SmemDq& sm = aligned_smem<SmemDq>(smem_raw);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sq = prm.sq, skv = prm.skv;
  const int n_tiles = (skv + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread starts every load
    if (lane == 0) {
      mbar_expect_tx(&sm.own_full, 2 * kOwnBytes);
      tma_load(sm.q, &tq, &sm.own_full, q0, bh);
      tma_load(sm.dout, &tdo, &sm.own_full, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        mbar_wait(&sm.empty[st], ((t / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load(sm.k[st], &tk, &sm.full[st], t * kBN, bh);
        tma_load(sm.v[st], &tv, &sm.full[st], t * kBN, bh);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64*wg + [0, 64) ----
  const int wg = warp / 4;
  const int row0 = q0 + wg * kBM + 16 * (warp % 4) + lane / 4;  // this thread's rows: row0, + 8
  const int row1 = row0 + 8;
  const int col0 = 2 * (lane % 4);
  const size_t head = (size_t)bh * sq;
  const float scale = prm.scale;

  // lse and delta of rows row0 and row1 (0 past sq); delta written once a row
  float lse0 = 0.0f, lse1 = 0.0f;
  float dl0 = row_dot(prm.o + head * kD, prm.dout + head * kD, row0, sq, lane);
  float dl1 = row_dot(prm.o + head * kD, prm.dout + head * kD, row1, sq, lane);
  if (row0 < sq) {
    lse0 = prm.lse[head + row0];
    if (prm.dlse != nullptr) dl0 -= prm.dlse[head + row0];
    if (lane % 4 == 0) prm.delta[head + row0] = dl0;
  }
  if (row1 < sq) {
    lse1 = prm.lse[head + row1];
    if (prm.dlse != nullptr) dl1 -= prm.dlse[head + row1];
    if (lane % 4 == 0) prm.delta[head + row1] = dl1;
  }

  mbar_wait(&sm.own_full, 0);
  const uint64_t dq_desc = smem_desc(sm.q + wg * kBM * kD, 16, 8 * kRowBytes);
  const uint64_t ddo_desc = smem_desc(sm.dout + wg * kBM * kD, 16, 8 * kRowBytes);

  float s[32], dp[32], dq_acc[32];
  uint32_t ds[16];  // bf16(ds) pairs: the A fragments of dQ += dS.K
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.0f;

  // S = Q.K^T and dP = dO.V^T of tile t in flight: 4 k-steps of 16 columns
  // each, a k-step 32 bytes further along the rows.
  auto start_sdp = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&sm.full[st], (t / kStages) & 1);
    wgmma_fence();
    const uint64_t dk = smem_desc(sm.k[st], 16, 8 * kRowBytes);
    const uint64_t dv = smem_desc(sm.v[st], 16, 8 * kRowBytes);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss(s, dq_desc + 2 * kk, dk + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss(dp, ddo_desc + 2 * kk, dv + 2 * kk, kk > 0);
    wgmma_commit();
  };
  // dQ += dS.K of tile t in flight: 4 k-steps of 16 keys, 16 rows of 128
  // bytes each; K [keys, 64] is MN-major for B, as V in the forward's P.V.
  auto start_dq = [&](int t) {
    fence_regs(dq_acc);
    wgmma_fence();
    const uint64_t dk = smem_desc(sm.k[t % kStages], 8 * kRowBytes, 8 * kRowBytes);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_m64n64k16_rs(dq_acc, ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3],
                         dk + ((16 * kRowBytes * kk) >> 4));
    wgmma_commit();
  };
  // In place: dp becomes the f32 ds of tile t (s the f32 p on the way).
  auto grad_scores = [&](int t) {
    const int valid = skv - t * kBN;
    if (valid < kBN) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + col0 + (i % 2) >= valid) s[i] = __int_as_float(0xff800000);  // -inf
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool lo = (i & 2) == 0;  // row0, else row1
      const float p = ex2((s[i] * scale - (lo ? lse0 : lse1)) * kLog2e);
      dp[i] = (p * (dp[i] - (lo ? dl0 : dl1))) * scale;
    }
  };

  // Tile t's dQ product and tile t + 1's S and dP are in flight together;
  // the elementwise pass of tile t + 1 runs as soon as its S and dP land.
  start_sdp(0);  // skv >= 1: there is at least one tile
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grad_scores(0);
  pack(ds, dp);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    start_sdp(t + 1);
    start_dq(t);
    wgmma_wait<1>();  // S and dP of tile t + 1 have landed
    fence_regs(s);
    fence_regs(dp);
    grad_scores(t + 1);
    wgmma_wait<0>();  // dQ of tile t has landed
    fence_regs(dq_acc);
    fence_regs(ds);
    mbar_arrive(&sm.empty[t % kStages]);  // this thread is done with the stage's K and V
    pack(ds, dp);
  }
  start_dq(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(dq_acc);
  fence_regs(ds);

  store_rows(prm.dq + head * kD, dq_acc, row0, sq, col0);
}

__global__ void __launch_bounds__(kThreadsDkv, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params prm) {
  extern __shared__ unsigned char smem_raw[];
  SmemDkv& sm = aligned_smem<SmemDkv>(smem_raw);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sq = prm.sq, skv = prm.skv;
  const int n_tiles = (sq + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // every producer lane, after staging its lse and delta
      mbar_init(&sm.empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One if/else whose paths never meet again, so that ptxas honours
  // setmaxnreg: the producer warpgroup gives registers up (only its first
  // warp has work), the two consumer warpgroups take them.
  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumers * 4) {
      if (lane == 0) {
        mbar_expect_tx(&sm.own_full, 2 * kOwnBytes);
        tma_load(sm.k, &tk, &sm.own_full, k0, bh);
        tma_load(sm.v, &tv, &sm.own_full, k0, bh);
      }
      const float* lse = prm.lse + (size_t)bh * sq;
      const float* delta = prm.delta + (size_t)bh * sq;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        mbar_wait(&sm.empty[st], ((t / kStages) & 1) ^ 1);  // the first round passes at once
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h, qi = t * kBN + c;
          sm.lse[st][c] = qi < sq ? lse[qi] : 0.0f;
          sm.delta[st][c] = qi < sq ? delta[qi] : 0.0f;
        }
        // each lane's arrival releases its stores to the consumers that wait on full
        if (lane == 0) {
          mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
          tma_load(sm.q[st], &tq, &sm.full[st], t * kBN, bh);
          tma_load(sm.dout[st], &tdo, &sm.full[st], t * kBN, bh);
        } else {
          mbar_arrive(&sm.full[st]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // ---- consumer warpgroup wg: keys k0 + 64*wg + [0, 64) ----
    const int wg = warp / 4;
    const int key0 = k0 + wg * kBM + 16 * (warp % 4) + lane / 4;  // this thread's keys: key0, + 8
    const int key1 = key0 + 8;
    const int col0 = 2 * (lane % 4);
    const float scale = prm.scale;

    mbar_wait(&sm.own_full, 0);
    const uint64_t dk_desc = smem_desc(sm.k + wg * kBM * kD, 16, 8 * kRowBytes);
    const uint64_t dv_desc = smem_desc(sm.v + wg * kBM * kD, 16, 8 * kRowBytes);

    float s[32], dp[32], dk_acc[32], dv_acc[32];
    uint32_t pa[16], dsa[16];  // bf16(p^T) and bf16(ds^T) pairs: the A fragments of dV and dK
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk_acc[i] = 0.0f;
      dv_acc[i] = 0.0f;
    }

    // S^T = K.Q^T and dP^T = V.dO^T of query tile t in flight.
    auto start_sdp = [&](int t) {
      const int st = t % kStages;
      mbar_wait(&sm.full[st], (t / kStages) & 1);
      wgmma_fence();
      const uint64_t dq = smem_desc(sm.q[st], 16, 8 * kRowBytes);
      const uint64_t ddo = smem_desc(sm.dout[st], 16, 8 * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(s, dk_desc + 2 * kk, dq + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(dp, dv_desc + 2 * kk, ddo + 2 * kk, kk > 0);
      wgmma_commit();
    };
    // dV += bf16(P^T).dO and dK += dS^T.Q of tile t in flight: 4 k-steps of
    // 16 queries each, dO and Q MN-major for B.
    auto start_dkv = [&](int t) {
      const int st = t % kStages;
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wgmma_fence();
      const uint64_t dq = smem_desc(sm.q[st], 8 * kRowBytes, 8 * kRowBytes);
      const uint64_t ddo = smem_desc(sm.dout[st], 8 * kRowBytes, 8 * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_m64n64k16_rs(dv_acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                           ddo + ((16 * kRowBytes * kk) >> 4));
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_m64n64k16_rs(dk_acc, dsa[4 * kk], dsa[4 * kk + 1], dsa[4 * kk + 2], dsa[4 * kk + 3],
                           dq + ((16 * kRowBytes * kk) >> 4));
      wgmma_commit();
    };
    // In place: s becomes the f32 p^T of tile t, dp the f32 ds^T. Column c of
    // the tile is query t*64 + c, whose lse and delta the stage holds.
    auto grad_scores = [&](int t) {
      const int st = t % kStages;
      const int valid = sq - t * kBN;
      if (valid < kBN || key1 >= skv) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (8 * (i / 4) + col0 + (i % 2) >= valid || ((i & 2) ? key1 : key0) >= skv)
            s[i] = __int_as_float(0xff800000);  // -inf
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(&sm.lse[st][8 * j + col0]);
        const float2 d = *reinterpret_cast<const float2*>(&sm.delta[st][8 * j + col0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float p = ex2((s[i] * scale - ((e & 1) ? l.y : l.x)) * kLog2e);
          s[i] = p;
          dp[i] = (p * (dp[i] - ((e & 1) ? d.y : d.x))) * scale;
        }
      }
    };

    start_sdp(0);  // sq >= 1: there is at least one tile
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grad_scores(0);
    pack(pa, s);
    pack(dsa, dp);
    for (int t = 0; t + 1 < n_tiles; ++t) {
      start_sdp(t + 1);
      start_dkv(t);
      wgmma_wait<1>();  // S^T and dP^T of tile t + 1 have landed
      fence_regs(s);
      fence_regs(dp);
      grad_scores(t + 1);
      wgmma_wait<0>();  // dV and dK of tile t have landed
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(&sm.empty[t % kStages]);  // this thread is done with the stage
      pack(pa, s);
      pack(dsa, dp);
    }
    start_dkv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);

    const size_t head = (size_t)bh * skv * kD;
    store_rows(prm.dk + head, dk_acc, key0, skv, col0);
    store_rows(prm.dv + head, dv_acc, key0, skv, col0);
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, dim3 grid, const void* q, const void* dout,
           int q_box, const void* k, const void* v, int k_box, const Params& prm, int bh,
           void* stream) {
  CUtensorMap tq, tdo, tk, tv;
  int err = make_map(&tq, q, bh, prm.sq, q_box);
  if (err == 0) err = make_map(&tdo, dout, bh, prm.sq, q_box);
  if (err == 0) err = make_map(&tk, k, bh, prm.skv, k_box);
  if (err == 0) err = make_map(&tv, v, bh, prm.skv, k_box);
  if (err != 0) return err;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(tq, tdo, tk, tv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: [bh, sq, 64] bf16; k, v: [bh, skv, 64] bf16; lse (and
// dlse, or null), delta: [bh, sq] f32. All contiguous, 16-byte aligned.
// Writes dq and delta = rowsum(o * dout) - dlse, which the dk/dv kernel
// takes. Returns the CUDA error of the launch, or sm90::kErrTensorMap + the
// CUresult of a failed tensor-map encoding (an empty tensor has no map).
extern "C" int orv_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, const void* dlse,
                                     void* dq, void* delta, int bh, int sq, int skv, float scale,
                                     void* stream) {
  const Params prm{(const bf16*)o, (const bf16*)dout, (const float*)lse, (const float*)dlse,
                   (float*)delta, (bf16*)dq, nullptr, nullptr, sq, skv, scale};
  return launch(flash_bwd_dq_kernel, kThreads, (int)sizeof(SmemDq) + 1024,
                dim3((sq + kBR - 1) / kBR, bh), q, dout, kBR, k, v, kBN, prm, bh, stream);
}

// q, dout: [bh, sq, 64] bf16; k, v, dk, dv: [bh, skv, 64] bf16; lse and
// delta (the dq kernel's): [bh, sq] f32. All contiguous, 16-byte aligned.
// Returns as orv_flash_attn_bwd_dq.
extern "C" int orv_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int sq, int skv, float scale,
                                      void* stream) {
  const Params prm{nullptr, nullptr, (const float*)lse, nullptr, (float*)delta, nullptr,
                   (bf16*)dk, (bf16*)dv, sq, skv, scale};
  return launch(flash_bwd_dkv_kernel, kThreadsDkv, (int)sizeof(SmemDkv) + 1024,
                dim3((skv + kBR - 1) / kBR, bh), q, dout, kBN, k, v, kBR, prm, bh, stream);
}
