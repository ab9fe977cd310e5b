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
// (154 in all in the bf16 modes, 168 in Mode::kQ8; no spills).

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (declarations only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled, fetched at run time: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash_sm90 {

typedef __nv_bfloat16 bf16;

enum class Mode { kOnline, kStaticMax, kQ8 };

constexpr int kD = 64;                             // head dim
constexpr int kBM = 64;                            // query rows per consumer warpgroup
constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kBQ = kBM * kConsumers;              // query rows per block
constexpr int kBK = 128;                           // keys per tile
constexpr int kStages = 4;                         // K/V ring depth
constexpr int kThreads = kConsumers * 128 + 32;    // + one producer warp
constexpr uint32_t kRowBytes = kD * 2;             // 128: one bf16 row, one swizzle row
constexpr uint32_t kTileBytes = kBK * kRowBytes;   // one bf16 K or V tile
constexpr uint32_t kQBytes = kBQ * kRowBytes;
constexpr uint32_t kRowBytes8 = kD;                // 64: one int8 K row, one swizzle row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kNegInf = -1e30f;                  // the TPU kernel's initial running max
constexpr int kErrTensorMap = 100000;              // + CUresult: encoding a tensor map failed

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One [1, rows, 64] box of a 3-D tensor map at (0, row, bh) into shared
// memory; completion adds its bytes to `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// ---- wgmma ----

constexpr uint64_t kSwizzle128B = 1;  // descriptor layout types
constexpr uint64_t kSwizzle64B = 2;

// Shared-memory matrix descriptor of a swizzled tile: start address, leading
// and stride byte offsets (16-byte units), layout type (the swizzle).
__device__ __forceinline__ uint64_t smem_desc(const void* tile, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = kSwizzle128B) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of wgmma are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A . B for a 64x128 f32 tile, k = 16: A [64 x 16] and B [128 x 16],
// both K-major in swizzled shared memory. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B for a 64x128 s32 tile, k = 32: A [64 x 32] int8 from
// registers (4 x 4 bytes a thread: rows r and r + 8, columns 4*(lane%4) and
// 16 + 4*(lane%4), each register 4 columns from its low byte up), B
// [128 x 32] int8 K-major in swizzled shared memory. The integer form takes
// no scale or transpose immediates. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(uint32_t (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d += A . B for a 64x64 f32 tile, k = 16: A [64 x 16] bf16 from registers
// (4 x bf16x2 a thread), B [16 x 64] MN-major in swizzled shared memory
// (transposed: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// round_half_even(x[j] * inv) for j = 0..3 as int8, x[0] in the low byte
__device__ __forceinline__ uint32_t pack_s8(const float* x, float inv) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) r |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(x[j] * inv) << (8 * j);
  return r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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

inline PFN_cuTensorMapEncodeTiled encode_fn() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous [bh, rows, 64] tensor of bf16 (128-byte rows,
// 128-byte swizzle) or, `int8`, of bytes (64-byte rows, 64-byte swizzle);
// boxes of [1, box_rows, 64], out-of-range rows read as zeros. Returns 0 or
// kErrTensorMap + the CUresult.
inline int make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int box_rows,
                    bool int8 = false) {
  const PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return kErrTensorMap + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t row_bytes = int8 ? kRowBytes8 : kRowBytes;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {row_bytes, (cuuint64_t)rows * row_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r =
      encode(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

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
