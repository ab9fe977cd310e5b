// The two adaLN backwards for Hopper (sm_90a), shared by
// modulate_norm_bwd.cu (Mode::kModulateNorm) and gated_residual_bwd.cu
// (Mode::kGatedResidual).
//
// kModulateNorm replaces orv_tpu/ops/adaln.py:_mn_bwd_kernel. The forward
// is out = xhat * w + const(x) with w = ns * (1 + scale[r]) and
// xhat = (x - mean) * rsqrt(var + eps), so for x and dout [R, S, D] bf16
// every token row computes in f32
//   g = dout * w,  dx = bf16(inv * (g - mean(g) - xhat * mean(g * xhat)))
// and each row group r the sums over its S rows
//   A[r] = sum_S dout,  B[r] = sum_S dout * xhat          (f32 [R, 2, D])
// from which the caller derives dscale, dshift, dns and dnb. The row
// arithmetic and its order are the first design's: a lane owns 4
// contiguous columns of each 128-column chunk, sums pairs before the warp
// sum, takes the variance in two passes, and each rounding is written out
// (__fmul_rn, __fmaf_rn) so that the compiler contracts nothing.
// kGatedResidual replaces orv_tpu/ops/adaln.py:_gr_bwd_kernel: for dout and
// y [R, S, D] bf16 and a gate [R, D],
//   dy = bf16(gate[r] * dout),  dgate[r] = sum_S dout * y   (f32 [R, D]).
//
// Bound on the H100: bytes. Both read two [R, S, D] bf16 operands and write
// one (34.6 MB at the training shape [5, 600, 1920]) for a few tens of f32
// operations an element.
//
// Design. A tile is up to kRows (adaLN) or kGrRows (gated residual)
// consecutive rows of one row group. The grid is persistent and launched
// cooperatively: as many blocks as fit on the SMs at once (at D = 1920 one
// an SM: its ring of two tiles takes 184 or 123 KB), each walking a
// contiguous range of tiles, so that it enters a new row group at most once
// or twice. The wrapper's plan (orv_tpu_torch/ops/adaln.py:bwd_plan) sizes
// the grid from the C side's limits. On an NVIDIA H100 80GB HBM3 at 700 W,
// tiles of 12 rows (a consumer warp each) timed 15% faster than 8 for the
// adaLN backward (more rows in flight for its issue-bound row work); the
// gated residual's, a thread a column vector, ran as fast at 8 rows as at
// 12 and slower at 4.
// - One thread of the producer warp copies each tile's two operands, rows*D*2
//   contiguous bytes each, with two 1-D bulk copies (cp.async.bulk) into a
//   ring of kStages stages, 128-byte aligned (at a 16- but not 32-byte
//   offset the gated residual ran 15% slower on that card); a full mbarrier
//   counts their bytes, an empty one the consumer warps that are done with
//   the stage. The consumers write the tile's output (dx or dy) back into
//   the first operand's place in the stage, and the producer sends it out
//   with one bulk store and waits for the store's reads before it refills
//   the stage.
// - kModulateNorm: one consumer warp a row, in three phases with a named
//   barrier between them. (1) The row's mean, inv, mean(g) and mean(g*xhat)
//   in three passes, w read from shared memory (converted to f32 once a row
//   group, all loads issued before any conversion); x of the first chunks
//   of 128 columns stays in registers as f32 and leaves phase 1 as xhat,
//   with compile-time trip counts (one kernel instance per chunk count; the
//   widest, kCache, takes D 2048-4096, holds kWideHeld chunks and re-reads
//   the rest from the stage, 4 at a time). (2) The column pass: consumer
//   thread t owns 4 columns of every 4 * 32 * kRows and adds the tile's
//   rows' dout and dout * xhat, in row order, into its columns of A and B,
//   a [2, D] f32 slice in shared memory that no other thread touches. (3) dx
//   over x in the stage, from the held xhat and dout read again.
// - kGatedResidual: consumer thread t owns 8 columns (one 16-byte vector)
//   of every 2048, holds their gate and their sums of dout * y in registers
//   (one instance per count of vectors a thread owns), and writes dy back
//   over dout.
// - The sums over S. A block keeps its sums across its rows of one row
//   group and writes them once, as the partial of that row-group segment,
//   when it leaves the group (block b's segment of group r goes to slot
//   b + r, so each group's slots are consecutive). Then the grid syncs
//   (cooperative groups: the barrier orders every block's partials before
//   any read of them) and each block adds a share of the groups' columns
//   over their slots in a fixed order, 8 loads in flight a thread: no
//   atomics, the same bits from run to run for one card model, shape and
//   grid, and no second launch (two launches timed no faster).
//
// scripts/time_adaln_bwd_variants.py times these choices against each other
// and cuts of the kernel (launch, ring, row work, phases, sync, finish) on
// the card, as text substitutions of this header.

#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "modulate_norm.cuh"
#include "sm90_common.cuh"

namespace adaln_bwd {
namespace {  // internal linkage: each library keeps its own kernels

enum class Mode { kModulateNorm, kGatedResidual };

constexpr int kStages = 2;                  // the ring's depth
constexpr int kBarBytes = 2 * kStages * 8;  // full and empty mbarriers
constexpr int kSmemLimit = 232448;          // dynamic shared memory a block may take
// kModulateNorm: tiles of up to kRows rows, a consumer warp each
constexpr int kRows = 12;
constexpr int kMaxNV = 32;  // chunks of 128 columns: D <= 4096
// instances 1 .. 15 hold a row's chunks in registers; the 16th (kCache)
// takes D 2048-4096, holds kWideHeld of them and re-reads the rest: at 13
// warps a thread has 152 registers, and holding 16 spilled
constexpr int kCache = 16;
constexpr int kWideHeld = 12;
// kGatedResidual: tiles of up to kGrRows rows; 8 consumer warps, a thread 8
// columns of each 2048
constexpr int kGrRows = 8;
constexpr int kGrWarps = 8;
constexpr int kMaxVecs = 8;  // D <= kMaxVecs * 2048 = 16384

__host__ __device__ constexpr int consumer_warps(Mode m) {
  return m == Mode::kModulateNorm ? kRows : kGrWarps;
}
__host__ __device__ constexpr int block_threads(Mode m) { return (consumer_warps(m) + 1) * 32; }
__host__ __device__ constexpr int n_sums(Mode m) { return m == Mode::kModulateNorm ? 2 : 1; }
__host__ __device__ constexpr int max_d(Mode m) {
  return m == Mode::kModulateNorm ? kMaxNV * 128 : kMaxVecs * 8 * kGrWarps * 32;
}

struct Params {
  const bf16* a;    // x (kModulateNorm) or dout (kGatedResidual), [R, S, D]
  const bf16* b;    // dout or y, [R, S, D]
  bf16* out;        // dx or dy, [R, S, D]
  float* part;      // [grid + R - 1, n_sums, D]: one partial a row-group segment
  float* sums;      // [R, n_sums, D]: (A, B) or dgate
  const void* vec;  // scale (kModulateNorm) or gate, [R, D], row stride vec_stride
  long vec_stride;
  const void* ns;  // kModulateNorm: [D]
  float eps;
  int vec_bf16, ns_bf16;
  int r, s, d;
  int rows;             // rows a tile
  int tiles_per_group;  // ceil(s / rows)
  int n_tiles;          // r * tiles_per_group
};

// barriers, kModulateNorm's row statistics, w and sums, then the ring at width
// d, 128-byte aligned
__host__ __device__ constexpr int fixed_bytes(Mode m, int d) {
  return (kBarBytes + (m == Mode::kModulateNorm ? (2 * kRows + 3 * d) * 4 : 0) + 127) / 128 * 128;
}
__host__ __device__ constexpr int smem_bytes(Mode m, int d, int rows) {
  return fixed_bytes(m, d) + kStages * 2 * rows * d * 2;
}
// the most rows a tile of width d may have
__host__ __device__ constexpr int max_rows(Mode m, int d) {
  const int fit = (kSmemLimit - fixed_bytes(m, d)) / (kStages * 4 * d);
  const int most = m == Mode::kModulateNorm ? kRows : kGrRows;
  return fit < most ? fit : most;
}
static_assert(max_rows(Mode::kModulateNorm, max_d(Mode::kModulateNorm)) >= 1 &&
                  max_rows(Mode::kGatedResidual, max_d(Mode::kGatedResidual)) >= 1,
              "the widest rows overflow shared memory");

__device__ __forceinline__ float bits_f32(uint32_t raw, int is_bf16) {
  return __uint_as_float(is_bf16 ? raw << 16 : raw);
}

// element i of a bf16 or f32 array, as raw bits
__device__ __forceinline__ uint32_t raw_at(const void* p, long i, int is_bf16) {
  return is_bf16 ? static_cast<const uint16_t*>(p)[i] : static_cast<const uint32_t*>(p)[i];
}

template <Mode kMode>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(consumer_warps(kMode) * 32) : "memory");
}

// The block holding tile t: block b walks tiles [b * n / G, (b + 1) * n / G).
// In 32 bits where the product fits (a 64-bit division takes a subroutine).
__device__ __forceinline__ int block_of(const Params& p, int t) {
  const unsigned long long x = (unsigned long long)(t + 1) * gridDim.x - 1;
  return (int)(x >> 32 ? x / (unsigned)p.n_tiles : (unsigned)x / (unsigned)p.n_tiles);
}

// w = ns * (1 + scale[group]) as f32 into shared memory, columns i, i + kN,
// ... of d <= kDMax. Each thread issues all its loads (raw bits) before it
// converts any, so a call costs one round trip to memory.
template <int kDMax, int kN>
__device__ __forceinline__ void load_w(float* w, const Params& p, int group, int i) {
  constexpr int kPer = (kDMax + kN - 1) / kN;
  const long off = (long)group * p.vec_stride;
  uint32_t ns[kPer], sc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = i + j * kN;
    ns[j] = c < p.d ? raw_at(p.ns, c, p.ns_bf16) : 0u;
    sc[j] = c < p.d ? raw_at(p.vec, off + c, p.vec_bf16) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = i + j * kN;
    if (c < p.d) w[c] = bits_f32(ns[j], p.ns_bf16) * (1.0f + bits_f32(sc[j], p.vec_bf16));
  }
}

// ---- kModulateNorm: the row phases ----

// chunks of 128 columns a row has: kHeld for an exact instance, the launch's
// count for the widest
template <int kHeld, bool kExact>
__device__ __forceinline__ int row_chunks(const Params& p) {
  return kExact ? kHeld : p.d / 128;
}

struct RowStats {
  float mean, inv, gm, gxm;
};

__device__ __forceinline__ float sq_dev4(float sq, float4 v, float mean) {
  const float c0 = __fsub_rn(v.x, mean), c1 = __fsub_rn(v.y, mean);
  const float c2 = __fsub_rn(v.z, mean), c3 = __fsub_rn(v.w, mean);
  return __fmaf_rn(c3, c3, __fmaf_rn(c2, c2, __fmaf_rn(c1, c1, __fmaf_rn(c0, c0, sq))));
}

__device__ __forceinline__ float xhat(float x, float mean, float inv) {
  return __fmul_rn(__fsub_rn(x, mean), inv);
}

__device__ __forceinline__ float4 xhat4(float4 x, float mean, float inv) {
  return make_float4(xhat(x.x, mean, inv), xhat(x.y, mean, inv), xhat(x.z, mean, inv),
                     xhat(x.w, mean, inv));
}

// sum of g = dout * w and of g * xhat over 4 columns, in column order
__device__ __forceinline__ void g_sums4(float& gsum, float& gxsum, float4 xh, float4 g,
                                        float4 w) {
  const float xs[4] = {xh.x, xh.y, xh.z, xh.w}, gs[4] = {g.x, g.y, g.z, g.w};
  const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float gw = __fmul_rn(gs[j], ws[j]);
    gsum = __fadd_rn(gsum, gw);
    gxsum = __fmaf_rn(gw, xs[j], gxsum);
  }
}

__device__ __forceinline__ uint2 dx4(float4 xh, float4 g, float4 w, const RowStats& st) {
  const float xs[4] = {xh.x, xh.y, xh.z, xh.w}, gs[4] = {g.x, g.y, g.z, g.w};
  const float ws[4] = {w.x, w.y, w.z, w.w};
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float gw = __fmul_rn(gs[j], ws[j]);
    o[j] = __fmul_rn(st.inv, __fmaf_rn(-xs[j], st.gxm, __fsub_rn(gw, st.gm)));
  }
  return make_uint2(sm90::pack_bf16(o[0], o[1]), sm90::pack_bf16(o[2], o[3]));
}

// Phase 1 of a row: xr, dr its x and dout in the ring, w in shared memory.
// The first kHeld chunks of x stay in xh as f32, and leave it as xhat for
// phase 3; the chunks past them are re-read from the ring in each pass.
template <int kHeld, bool kExact>
__device__ __forceinline__ RowStats row_stats(const bf16* __restrict__ xr,
                                              const bf16* __restrict__ dr,
                                              const float* __restrict__ w, const Params& p,
                                              int lane, float4 (&xh)[kHeld]) {
  const int nv = row_chunks<kHeld, kExact>(p), d = nv * 128;
  const auto col = [&](int i) { return (i * 32 + lane) * 4; };
  const auto w4 = [&](int i) { return *reinterpret_cast<const float4*>(w + col(i)); };
  RowStats st;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    xh[i] = ld_bf16x4(xr + col(i));
    sum += (xh[i].x + xh[i].y) + (xh[i].z + xh[i].w);
  }
#pragma unroll 4
  for (int i = kHeld; i < nv; ++i) {
    const float4 v = ld_bf16x4(xr + col(i));
    sum += (v.x + v.y) + (v.z + v.w);
  }
  st.mean = warp_sum(sum) / d;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) sq = sq_dev4(sq, xh[i], st.mean);
#pragma unroll 4
  for (int i = kHeld; i < nv; ++i) sq = sq_dev4(sq, ld_bf16x4(xr + col(i)), st.mean);
  st.inv = rsqrtf(warp_sum(sq) / d + p.eps);
  float gsum = 0.0f, gxsum = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    xh[i] = xhat4(xh[i], st.mean, st.inv);
    g_sums4(gsum, gxsum, xh[i], ld_bf16x4(dr + col(i)), w4(i));
  }
#pragma unroll 4
  for (int i = kHeld; i < nv; ++i)
    g_sums4(gsum, gxsum, xhat4(ld_bf16x4(xr + col(i)), st.mean, st.inv),
            ld_bf16x4(dr + col(i)), w4(i));
  st.gm = warp_sum(gsum) / d;
  st.gxm = warp_sum(gxsum) / d;
  return st;
}

// Phase 3 of a row: dx over x's place in the ring, from xhat held in
// registers (or recomputed from x past the held chunks) and dout read again.
template <int kHeld, bool kExact>
__device__ __forceinline__ void row_dx(bf16* __restrict__ xr, const bf16* __restrict__ dr,
                                       const float* __restrict__ w, const Params& p, int lane,
                                       const float4 (&xh)[kHeld], const RowStats& st) {
  const int nv = row_chunks<kHeld, kExact>(p);
  const auto col = [&](int i) { return (i * 32 + lane) * 4; };
  const auto w4 = [&](int i) { return *reinterpret_cast<const float4*>(w + col(i)); };
#pragma unroll
  for (int i = 0; i < kHeld; ++i)
    *reinterpret_cast<uint2*>(xr + col(i)) = dx4(xh[i], ld_bf16x4(dr + col(i)), w4(i), st);
#pragma unroll 4
  for (int i = kHeld; i < nv; ++i)
    *reinterpret_cast<uint2*>(xr + col(i)) =
        dx4(xhat4(ld_bf16x4(xr + col(i)), st.mean, st.inv), ld_bf16x4(dr + col(i)), w4(i), st);
}

// Phase 2 of a tile's kN rows (of xt and dt, their mean and inv in stat): A
// and B of the float4 column q, in row order.
template <int kN>
__device__ __forceinline__ void column_sums(float4& a, float4& b, const bf16* __restrict__ xt,
                                            const bf16* __restrict__ dt,
                                            const float* __restrict__ stat, int d, int q, int n) {
#pragma unroll
  for (int i = 0; i < (kN > 0 ? kN : n); ++i) {
    const float4 xh = xhat4(ld_bf16x4(xt + i * d + 4 * q), stat[2 * i], stat[2 * i + 1]);
    const float4 g = ld_bf16x4(dt + i * d + 4 * q);
    a = make_float4(a.x + g.x, a.y + g.y, a.z + g.z, a.w + g.w);
    b = make_float4(__fmaf_rn(g.x, xh.x, b.x), __fmaf_rn(g.y, xh.y, b.y),
                    __fmaf_rn(g.z, xh.z, b.z), __fmaf_rn(g.w, xh.w, b.w));
  }
}

// ---- the grid's finish: the partials of each row group added in order ----

// sums[r, k, :] = part[lo_r, k, :] + ... + part[hi_r, k, :] with group r's
// slots lo_r .. hi_r, over float4 units; block b takes units [b U / G,
// (b + 1) U / G). s threads (a power of two, up to 32, as many as the block
// has for its units) share a unit: thread j adds slots lo + j, lo + j + s,
// ... in order (their loads issued 8 at a time), then the s partial sums meet
// in a fixed butterfly.
template <Mode kMode>
__device__ __forceinline__ void finish(const Params& p) {
  constexpr int kThreads = block_threads(kMode), kSums = n_sums(kMode), kBatch = 8;
  const int d4 = p.d / 4, units = p.r * kSums * d4;
  const int u0 = (int)((long)units * blockIdx.x / gridDim.x);
  const int nu = (int)((long)units * (blockIdx.x + 1) / gridDim.x) - u0;
  int s = 1;
  while (s < 32 && 2 * s * nu <= kThreads) s *= 2;
  const int j = threadIdx.x % s;
  const float4* __restrict__ part = reinterpret_cast<const float4*>(p.part);
  for (int base = 0; base < nu; base += kThreads / s) {
    const int ui = base + (int)threadIdx.x / s, u = u0 + ui;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ui < nu) {
      const int r = u / (kSums * d4), within = u - r * kSums * d4;
      const int lo = block_of(p, r * p.tiles_per_group) + r;
      const int hi = block_of(p, (r + 1) * p.tiles_per_group - 1) + r;
      for (int k0 = lo + j; k0 <= hi; k0 += kBatch * s) {  // kBatch loads in flight
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (k0 + b * s <= hi) v[b] = __ldcg(part + (long)(k0 + b * s) * kSums * d4 + within);
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (k0 + b * s <= hi)
            acc = make_float4(acc.x + v[b].x, acc.y + v[b].y, acc.z + v[b].z, acc.w + v[b].w);
      }
    }
    for (int o = s / 2; o > 0; o >>= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (ui < nu && j == 0) reinterpret_cast<float4*>(p.sums)[u] = acc;
  }
}

// ---- the consumers ----

// The partial of row group `group`: the block's slot blockIdx.x + group.
template <Mode kMode>
__device__ __forceinline__ float* partial(const Params& p, int group) {
  return p.part + (long)(blockIdx.x + group) * n_sums(kMode) * p.d;
}

// Tile t0 + n of the block: its first row's index in [R * S], its rows and
// its row group.
struct Tile {
  long row0;
  int valid, group;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  const int r = t / p.tiles_per_group, s0 = (t - r * p.tiles_per_group) * p.rows;
  return {(long)r * p.s + s0, min(p.rows, p.s - s0), r};
}

// kModulateNorm: a row a warp in phases 1 and 3; in phase 2 consumer thread
// tid owns the float4 columns tid + 32 kRows k, and their sums over S in acc
// (A, then B, [2, D] f32 in shared memory).
template <int kInst>
__device__ __forceinline__ void consume_mn(const Params& p, bf16* ring, long stage,
                                           uint64_t* full, uint64_t* empty, float* stat,
                                           float* w, float* acc, int t0, int nt, int group) {
  constexpr Mode kMode = Mode::kModulateNorm;
  constexpr bool kExact = kInst < kCache;
  constexpr int kHeld = kExact ? kInst : kWideHeld, kDMax = (kExact ? kInst : kMaxNV) * 128;
  constexpr int kVecs = (kDMax + kRows * 128 - 1) / (kRows * 128);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, d = p.d, d4 = d / 4;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  const auto zero = [&] {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int q = tid + k * kRows * 32;
      if (q < d4) acc4[q] = acc4[d4 + q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  const auto flush = [&](int g) {  // each thread its own columns: no barrier
    float4* out = reinterpret_cast<float4*>(partial<kMode>(p, g));
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int q = tid + k * kRows * 32;
      if (q < d4) {
        out[q] = acc4[q];
        out[d4 + q] = acc4[d4 + q];
      }
    }
    zero();
  };
  zero();
  for (int n = 0; n < nt; ++n) {
    const Tile tl = tile_at(p, t0 + n);
    if (tl.group != group) {  // the block enters the next row group
      flush(group);
      consumer_sync<kMode>();  // every consumer is done with the last group's w
      load_w<kDMax, kRows * 32>(w, p, tl.group, tid);
      consumer_sync<kMode>();
      group = tl.group;
    }
    sm90::mbar_wait(&full[n % kStages], (n / kStages) & 1);
    bf16* xt = ring + (n % kStages) * stage;
    const bf16* dt = xt + (long)p.rows * d;
    float4 xh[kHeld];
    RowStats st;
    if (warp < tl.valid) {
      st = row_stats<kHeld, kExact>(xt + warp * d, dt + warp * d, w, p, lane, xh);
      if (lane == 0) {
        stat[2 * warp] = st.mean;
        stat[2 * warp + 1] = st.inv;
      }
    }
    consumer_sync<kMode>();
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int q = tid + k * kRows * 32;
      if (q < d4) {
        float4 a = acc4[q], b = acc4[d4 + q];
        if (tl.valid == kRows)
          column_sums<kRows>(a, b, xt, dt, stat, d, q, kRows);
        else
          column_sums<0>(a, b, xt, dt, stat, d, q, tl.valid);
        acc4[q] = a;
        acc4[d4 + q] = b;
      }
    }
    consumer_sync<kMode>();  // the column pass has read x before dx replaces it
    if (warp < tl.valid)
      row_dx<kHeld, kExact>(xt + warp * d, dt + warp * d, w, p, lane, xh, st);
    sm90::fence_proxy_async();  // the stage's new bytes, to the bulk store
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[n % kStages]);
  }
  flush(group);
}

// kGatedResidual: consumer thread tid owns the 8-column vectors tid + 256 k.
template <int kVecs>
__device__ __forceinline__ void consume_gr(const Params& p, bf16* ring, long stage,
                                           uint64_t* full, uint64_t* empty, int t0, int nt,
                                           int group) {
  const int tid = threadIdx.x, lane = tid % 32, d = p.d;
  const auto col = [&](int k) { return (tid + k * kGrWarps * 32) * 8; };
  float acc[kVecs][8], gate[kVecs][8];
  const auto load_gate = [&](int g) {  // all loads first, then the conversions
    uint32_t raw[kVecs][8];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        raw[k][j] = col(k) < d ? raw_at(p.vec, (long)g * p.vec_stride + col(k) + j, p.vec_bf16)
                               : 0u;
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        gate[k][j] = bits_f32(raw[k][j], p.vec_bf16);
        acc[k][j] = 0.0f;
      }
  };
  const auto flush = [&](int g) {
    float* out = partial<Mode::kGatedResidual>(p, g);
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      if (col(k) < d) {
        *reinterpret_cast<float4*>(out + col(k)) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        *reinterpret_cast<float4*>(out + col(k) + 4) =
            make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
      }
  };
  load_gate(group);
  for (int n = 0; n < nt; ++n) {
    const Tile tl = tile_at(p, t0 + n);
    if (tl.group != group) {  // the block enters the next row group
      flush(group);
      load_gate(tl.group);
      group = tl.group;
    }
    sm90::mbar_wait(&full[n % kStages], (n / kStages) & 1);
    bf16* dt = ring + (n % kStages) * stage;
    const bf16* yt = dt + (long)p.rows * d;
    for (int i = 0; i < tl.valid; ++i) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        if (col(k) < d) {
          const uint4 dv = *reinterpret_cast<const uint4*>(dt + i * d + col(k));
          const uint4 yv = *reinterpret_cast<const uint4*>(yt + i * d + col(k));
          const uint32_t* dw = &dv.x;
          const uint32_t* yw = &yv.x;
          uint32_t out[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            // columns 2h and 2h + 1: the low and the high bf16 of a word
            const float d0 = __uint_as_float(dw[h] << 16);
            const float d1 = __uint_as_float(dw[h] & 0xffff0000u);
            const float y0 = __uint_as_float(yw[h] << 16);
            const float y1 = __uint_as_float(yw[h] & 0xffff0000u);
            acc[k][2 * h] = __fmaf_rn(d0, y0, acc[k][2 * h]);
            acc[k][2 * h + 1] = __fmaf_rn(d1, y1, acc[k][2 * h + 1]);
            out[h] = sm90::pack_bf16(__fmul_rn(d0, gate[k][2 * h]),
                                     __fmul_rn(d1, gate[k][2 * h + 1]));
          }
          *reinterpret_cast<uint4*>(dt + i * d + col(k)) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
    }
    sm90::fence_proxy_async();  // the stage's new bytes, to the bulk store
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[n % kStages]);
  }
  flush(group);
}

// ---- the kernel ----

// kInst: kModulateNorm, chunks of 128 columns held in registers (1 ..
// kCache); kGatedResidual, 16-byte vectors a consumer thread owns (1 ..
// kMaxVecs).
template <Mode kMode, int kInst>
__device__ __forceinline__ void run(const Params& p) {
  constexpr bool kMN = kMode == Mode::kModulateNorm;
  constexpr int kWarps = consumer_warps(kMode);
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* stat = reinterpret_cast<float*>(smem + kBarBytes);  // kMN: mean, inv of each row
  float* w = stat + 2 * kRows;                                // kMN: ns * (1 + scale[group])
  float* acc = w + p.d;                                       // kMN: A and B, [2, D]
  bf16* ring = reinterpret_cast<bf16*>(smem + fixed_bytes(kMode, p.d));
  const int d = p.d;
  const long stage = 2L * p.rows * d;  // a stage: the tile's rows of a, then of b
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = (int)((long)blockIdx.x * p.n_tiles / gridDim.x);
  const int nt = (int)((long)(blockIdx.x + 1) * p.n_tiles / gridDim.x) - t0;
  const int group = t0 / p.tiles_per_group;

  // tile t0 + n into stage n % kStages (its stage is free)
  const auto load = [&](int n) {
    const Tile tl = tile_at(p, t0 + n);
    const uint32_t bytes = (uint32_t)(tl.valid * d * 2);
    bf16* st = ring + (n % kStages) * stage;
    sm90::mbar_expect_tx(&full[n % kStages], 2 * bytes);
    sm90::bulk_load(st, p.a + tl.row0 * d, bytes, &full[n % kStages]);
    sm90::bulk_load(st + (long)p.rows * d, p.b + tl.row0 * d, bytes, &full[n % kStages]);
  };
  if (warp == kWarps && lane == 0) {  // the first tiles are in flight while w loads
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int n = 0; n < kStages && n < nt; ++n) load(n);
  }
  if constexpr (kMN)
    load_w<(kInst < kCache ? kInst : kMaxNV) * 128, block_threads(kMode)>(w, p, group,
                                                                           threadIdx.x);
  __syncthreads();

  if (warp == kWarps) {
    if (lane == 0) {  // the producer: tile m's output out of its stage, then tile m + kStages in
      for (int m = 0; m < nt; ++m) {
        sm90::mbar_wait(&empty[m % kStages], (m / kStages) & 1);
        const Tile tl = tile_at(p, t0 + m);
        sm90::bulk_store(p.out + tl.row0 * d, ring + (m % kStages) * stage,
                         (uint32_t)(tl.valid * d * 2));
        sm90::bulk_commit();
        sm90::bulk_wait_read<0>();  // the stage may be refilled after this
        if (m + kStages < nt) load(m + kStages);
      }
    }
  } else if constexpr (kMN) {
    consume_mn<kInst>(p, ring, stage, full, empty, stat, w, acc, t0, nt, group);
  } else {
    consume_gr<kInst>(p, ring, stage, full, empty, t0, nt, group);
  }
  cooperative_groups::this_grid().sync();  // the partials, to the blocks that add them
  finish<kMode>(p);
}

// ---- the host side ----

using Kernel = void (*)(Params);

__host__ __device__ constexpr bool takes_width(Mode m, int d) {
  return d > 0 && d <= max_d(m) && d % (m == Mode::kModulateNorm ? 128 : 8) == 0;
}

// out[0]: the most rows a tile of width d (one takes_width accepts) may have;
// out[1]: the blocks of `kernel` (the instance for d) that fit on the
// device's SMs at once with tiles that wide. Also lifts the kernel's
// shared-memory limit. Returns the CUDA error.
int limits(Mode m, Kernel kernel, int d, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block_threads(m),
                                                        smem_bytes(m, d, max_rows(m, d)));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = max_rows(m, d);
  out[1] = per_sm * sms;
  return (int)cudaSuccess;
}

// Launches `kernel` (the instance for p.d, a width takes_width accepts)
// cooperatively on grid blocks over tiles of `rows` rows (both from the
// wrapper's plan: rows <= out[0] and grid <= out[1] of `limits`, which must
// have run on this device for this width). Returns the CUDA error
// (cudaErrorInvalidValue for an empty shape, or rows or grid out of range).
int launch(Mode m, Kernel kernel, Params p, int rows, int grid, void* stream) {
  if (p.r < 1 || p.s < 1 || rows < 1 || rows > max_rows(m, p.d)) return (int)cudaErrorInvalidValue;
  p.rows = rows;
  p.tiles_per_group = (p.s + rows - 1) / rows;
  p.n_tiles = p.r * p.tiles_per_group;
  if (grid < 1 || grid > p.n_tiles) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                          dim3(block_threads(m)), args,
                                          smem_bytes(m, p.d, rows), (cudaStream_t)stream);
}

}  // namespace
}  // namespace adaln_bwd
