// General adaLN kernels for Hopper (sm_90a): the modulated LayerNorm, its
// backward and the gated residual's backward, for x in f32 or bf16 at any
// width D % 8 == 0.
//
// Replace the TPU kernels orv_tpu/ops/adaln.py:_kernel (:52, modulate_norm),
// _mn_bwd_kernel (:105) and _gr_bwd_kernel (:298) wherever the Hopper kernels
// (adaln_fwd_sm90.cuh, adaln_bwd_sm90.cuh: bf16 rows, D % 128 == 0 up to
// 4096 for the adaLN pair, D up to 16384 for the gated residual's backward)
// do not take the operands: the JAX kernels write out_shape in x.dtype at any
// D, and an f32 model (train.mixed_precision=no) or a narrow one (the PAB
// harness's D = 32) calls them there. Each is a template on T in {float,
// bf16}, f32 arithmetic, one rounding to T on the way out; the per-row
// vectors (scale, shift, gate: [R, D], row-strided) and the norm parameters
// ([D]) may each be bf16 or f32.
//
//   modulate_norm:  out = ((x - mean) * rsqrt(var + eps) * ns + nb) * (1 + scale[r])
//                         + shift[r], the variance in two passes, as _modulated
//                         (ops/adaln.py);
//   its backward:   with w = ns * (1 + scale[r]), g = dout * w and xhat the
//                   normalized row, dx = inv * (g - mean(g) - xhat * mean(g xhat)),
//                   A[r] = sum_S dout, B[r] = sum_S dout * xhat (f32 [R, 2, D]);
//   gated residual's backward: dy = T(gate[r] * dout), dgate[r] = sum_S dout * y.
//
// Bound on the H100: bytes (a few f32 operations an element). The forward
// reads each row from device memory once (up to 4096 columns):
// - a lane holds its 16-byte chunks of the row (4 f32 or 8 bf16, chunk q at
//   lane q % 32) in registers, one instance a count of chunks a lane (1, 2,
//   4, ... up to 4096 columns), all the row's loads issued before the first
//   reduction; mean and variance in two passes over the registers, in the
//   order of the first design (a lane's chunks in order, then the warp's
//   butterfly), so that f32 rows give its bits; rows of up to 16 chunks
//   take 4, 8 or 16 lanes each, several rows a warp (the PAB harness's
//   D = 32); the widest instance re-reads the chunks past its registers in
//   each pass;
// - a block of kFwdWarps warps takes kFwdWarps rows (32 / lanes a warp in
//   the narrow instances) of one row group: it stages ns, nb, scale[r] and
//   shift[r] of the group once as f32 in shared memory (f32 and 16-byte
//   aligned, as an f32 model's are: cp.async copies in flight beside the
//   rows' loads, holding no registers; else one round trip of coalesced
//   scalar loads before the rows', the dtype branch outside them), so that
//   the output pass reads four 16-byte coefficient vectors a chunk and no
//   parameter by a scalar load. Blocks of 4 warps timed as fast as blocks
//   of 8, and faster than warps that walk two or more rows of a tile sized
//   to fill the card in one wave (scripts/time_general_variants.py, PERF.md);
// - x by streaming loads, out by streaming stores.
// The gated residual's backward sums over S in two more launches, a thread a
// column summing a chunk of rows in order into a partial, then each column's
// partials added in chunk order. The adaLN backward is one cooperative
// launch that reads x and dout once from device memory:
// - a persistent grid (at most kBwdBlocksPerSm blocks a multiprocessor, all
//   resident) over tiles of up to kTileRows rows of one row group r, block b
//   walking tiles [b T / G, (b + 1) T / G) in order (the wrapper's plan,
//   adaln.py:bwd_plan, sizes tiles and grid from the limits query);
// - a tile in three passes of the block's threads over the columns, a thread
//   loading kChunks float4 chunks of each of the tile's rows at once (16
//   loads in flight; the first pass from device memory, the next two from
//   L1): (1) each row's sum of x and of g = dout w, (2) of (x - mean)^2 and
//   of g (x - mean), each summed over the block in a fixed order (warp sums,
//   then the warps' in order: `block_sums`), (3) dx, and dout and dout xhat
//   of the tile's rows in order into the thread's columns of the block's
//   [2, D] sums of the row group. w = ns (1 + scale[r]) and the sums are held
//   in shared memory (read from and kept in the partial's slot in device
//   memory where 12 D bytes do not fit);
// - a block leaving a row group writes its sums as the group's partial in
//   slot b + r (each group's slots consecutive); after a grid sync the
//   partials of each group are added in slot order, a float4 column by up to
//   32 lanes that each add every s-th slot (8 loads in flight) and meet in a
//   fixed butterfly.
// No atomics: the same bits from run to run for one card model, shape and
// grid. Scratch comes from the wrapper.

#include <cooperative_groups.h>
#include <limits.h>

#include "general.cuh"

namespace {

using general::Elem;
using general::ld_param;

constexpr int kColThreads = 256;   // columns a block in the column passes
constexpr int kSumThreads = 256;   // outputs a block in the chunk sums
// the adaLN backward: a block of kBwdThreads over tiles of up to kTileRows
// rows, a thread loading kChunks float4 chunks of each at once, at most
// kBwdBlocksPerSm blocks a multiprocessor
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kTileRows = 2;
constexpr int kChunks = 4;
constexpr int kBwdBlocksPerSm = 2;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take

// ---- the adaLN forward ----

// 16 bytes of a row (4 f32 or 8 bf16 elements) as f32 and back, and their
// sum in a fixed order
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kE = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x), v[1] = __uint_as_float(r.y), v[2] = __uint_as_float(r.z),
    v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float sum(const float (&v)[4]) {
    return (v[0] + v[1]) + (v[2] + v[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kE = 8;
  static __device__ __forceinline__ void unpack(uint4 r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float sum(const float (&v)[8]) {
    return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
  }
};

constexpr int kFwdWarps = 4;  // a block: warps over rows of one row group
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kCoefCols = 4096;  // columns whose coefficients a block holds in shared memory
// chunks of a row a lane holds in registers in the largest instance: 4096 columns
template <typename T>
constexpr int kMaxHeld = kCoefCols / (32 * Chunk<T>::kE);

// The forward's launch: block b takes the rows of tile b % tiles_per_group
// of row group b / tiles_per_group, a tile the rows of one step of the block
// (kFwdWarps 32 / lanes).
struct MnFwd {
  const void* x;
  const void* scale;
  const void* shift;
  long v_stride;
  const void* ns;
  const void* nb;
  void* out;
  int s, d, tiles_per_group;
  float eps;
  int v_bf16, n_bf16;
  int coef_async;  // the four coefficients f32 and 16-byte aligned: staged by cp.async
};

// ns, nb, scale[r] and shift[r] of columns [0, dc) as f32 into coef [4][dc]
// by the block's threads. With p.coef_async, 16-byte cp.async copies that
// hold no registers (the caller waits for them); else kPer columns of each
// a thread a round, a round's loads (raw bits; the dtype branch outside
// them) all issued before any is converted, so that it costs one round trip
// to memory.
template <int kPer>
__device__ __forceinline__ void stage_coef(float* coef, const MnFwd& p, long vrow, int dc) {
  const void* src[4] = {p.ns, p.nb, p.scale, p.shift};
  const long off[4] = {0, 0, vrow, vrow};
  const int bf[4] = {p.n_bf16, p.n_bf16, p.v_bf16, p.v_bf16};
  if (p.coef_async) {
    for (int c = 4 * threadIdx.x; c < dc; c += 4 * kFwdThreads)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        general::cp_async16(coef + k * dc + c, static_cast<const float*>(src[k]) + off[k] + c, 16);
    general::cp_async_commit();
    return;
  }
  for (int c0 = threadIdx.x; c0 < dc; c0 += kFwdThreads * kPer) {
    uint32_t raw[4][kPer];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (bf[k]) {
        const uint16_t* a = static_cast<const uint16_t*>(src[k]) + off[k];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = c0 + j * kFwdThreads;
          raw[k][j] = c < dc ? (uint32_t)a[c] << 16 : 0u;
        }
      } else {
        const uint32_t* a = static_cast<const uint32_t*>(src[k]) + off[k];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = c0 + j * kFwdThreads;
          raw[k][j] = c < dc ? a[c] : 0u;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = c0 + j * kFwdThreads;
        if (c < dc) coef[k * dc + c] = __uint_as_float(raw[k][j]);
      }
  }
}

// the sum over the kLanes lanes of a row (lanes kLanes i .. kLanes i + kLanes - 1)
template <int kLanes>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y of one element: the plain version's order (`* ns + nb`, then `* (1 + scale) + shift`)
__device__ __forceinline__ float modulated(float x, float mean, float inv, float ns, float nb,
                                           float scale, float shift) {
  float y = (x - mean) * inv;
  y = y * ns + nb;
  return y * (1.0f + scale) + shift;
}

// kLanes lanes a row (32 / kLanes rows a warp), a lane holding kHeld 16-byte
// chunks of its row in registers: chunk q = lane % kLanes + kLanes i
// (columns kE q .. kE q + kE - 1). The instance with kMaxHeld chunks also
// takes rows wider than 4096 columns, re-reading the chunks past its
// registers in each pass (their coefficients from device memory).
template <typename T, int kLanes, int kHeld>
__global__ void __launch_bounds__(kFwdThreads, kHeld <= 16 ? 4 : 2)
mn_general_fwd_kernel(const __grid_constant__ MnFwd p) {
  using C = Chunk<T>;
  constexpr int kE = C::kE, kStep = kFwdWarps * 32 / kLanes;
  constexpr bool kWide = kLanes == 32 && kHeld == kMaxHeld<T>;
  // columns a thread stages of each coefficient a round through registers:
  // the widest row's share of the block's threads, at most 8
  constexpr int kCols = kLanes * kHeld * kE < kCoefCols ? kLanes * kHeld * kE : kCoefCols;
  constexpr int kShare = (kCols + kFwdThreads - 1) / kFwdThreads;
  constexpr int kPer = kShare < 8 ? kShare : 8;
  extern __shared__ __align__(16) float coef[];  // [4][dc]: ns, nb, scale[r], shift[r]
  const int d = p.d, n = d / kE, dc = min(d, kCoefCols);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, sub = lane % kLanes;
  const int r = blockIdx.x / p.tiles_per_group;
  const int s0 = (blockIdx.x - r * p.tiles_per_group) * kStep, s1 = min(p.s, s0 + kStep);
  const T* __restrict__ x = static_cast<const T*>(p.x) + (long)r * p.s * d;
  T* __restrict__ out = static_cast<T*>(p.out) + (long)r * p.s * d;
  const long vrow = (long)r * p.v_stride;
  const int row = s0 + warp * (32 / kLanes) + lane / kLanes;  // the lane's row
  const bool live = row < s1;
  const T* xr = x + (long)row * d;

  // the coefficients' copies and the row's loads in flight at once (the
  // register route stages first: its registers and the row's never meet)
  stage_coef<kPer>(coef, p, vrow, dc);
  uint4 v[kHeld];
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int q = sub + kLanes * i;
    v[i] = live && q < n ? __ldcs(reinterpret_cast<const uint4*>(xr + q * kE))
                         : make_uint4(0u, 0u, 0u, 0u);
  }
  if (p.coef_async) general::cp_async_wait_all();
  // f(q, e) over the lane's chunks past its registers (the wide instance's), read again
  const auto past = [&](auto&& f) {
    if (live)
      for (int q = kWide ? sub + 32 * kHeld : n; q < n; q += 32) {
        float e[kE];
        C::unpack(*reinterpret_cast<const uint4*>(xr + q * kE), e);
        f(q, e);
      }
  };

  // mean and inv: two passes over the registers, as _modulated
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i)
    if (sub + kLanes * i < n) {
      float e[kE];
      C::unpack(v[i], e);
      sum += C::sum(e);
    }
  past([&](int, const float(&e)[kE]) { sum += C::sum(e); });
  const float mean = lanes_sum<kLanes>(sum) / d;
  float sq = 0.0f;
  const auto dev = [&](int, const float(&e)[kE]) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const float a = e[j] - mean;
      sq = fmaf(a, a, sq);
    }
  };
#pragma unroll
  for (int i = 0; i < kHeld; ++i)
    if (sub + kLanes * i < n) {
      float e[kE];
      C::unpack(v[i], e);
      dev(0, e);
    }
  past(dev);
  const float inv = rsqrtf(lanes_sum<kLanes>(sq) / d + p.eps);
  __syncthreads();  // the staged coefficients, to every thread
  if (!live) return;

  // the row's output, by streaming stores
  T* orow = out + (long)row * d;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int q = sub + kLanes * i, c = q * kE;
    if (q >= n) continue;
    float e[kE], o[kE];
    C::unpack(v[i], e);
#pragma unroll
    for (int h = 0; h < kE; h += 4) {
      const float4 a = *reinterpret_cast<const float4*>(coef + c + h);
      const float4 b = *reinterpret_cast<const float4*>(coef + dc + c + h);
      const float4 s = *reinterpret_cast<const float4*>(coef + 2 * dc + c + h);
      const float4 t = *reinterpret_cast<const float4*>(coef + 3 * dc + c + h);
      o[h] = modulated(e[h], mean, inv, a.x, b.x, s.x, t.x);
      o[h + 1] = modulated(e[h + 1], mean, inv, a.y, b.y, s.y, t.y);
      o[h + 2] = modulated(e[h + 2], mean, inv, a.z, b.z, s.z, t.z);
      o[h + 3] = modulated(e[h + 3], mean, inv, a.w, b.w, s.w, t.w);
    }
    __stcs(reinterpret_cast<uint4*>(orow + c), C::pack(o));
  }
  past([&](int q, const float(&e)[kE]) {
    const int c = q * kE;
    float o[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j)
      o[j] = modulated(e[j], mean, inv, ld_param(p.ns, c + j, p.n_bf16),
                       ld_param(p.nb, c + j, p.n_bf16), ld_param(p.scale, vrow + c + j, p.v_bf16),
                       ld_param(p.shift, vrow + c + j, p.v_bf16));
    __stcs(reinterpret_cast<uint4*>(orow + c), C::pack(o));
  });
}

// The adaLN backward's launch: tiles of `rows` rows of one row group, block b
// taking tiles [b n_tiles / G, (b + 1) n_tiles / G).
struct MnBwd {
  const void* x;
  const void* dout;
  const void* scale;
  long v_stride;
  const void* ns;
  void* dx;
  float* part;  // [G + r - 1, 2, d]: one partial a row-group segment
  float* ab;    // [r, 2, d]: A, then B
  int r, s, d, rows, tiles_per_group, n_tiles;
  float eps;
  int v_bf16, n_bf16;
};

// shared memory of a block: two [kBwdWarps][2 kTileRows] slices of the
// warps' row sums, then, where they fit, the row group's w = ns (1 +
// scale[r]) and its sums (else read from and kept in device memory)
__host__ __device__ constexpr int mn_bwd_red_bytes() { return 2 * kBwdWarps * 2 * kTileRows * 4; }
__host__ __device__ inline bool mn_bwd_held(int d) {
  return mn_bwd_red_bytes() + 12L * d <= kSmemLimit;
}
__host__ __device__ inline int mn_bwd_smem(int d) {
  return mn_bwd_red_bytes() + (mn_bwd_held(d) ? 12 * d : 0);
}

// the block that walks tile t
__device__ __forceinline__ int mn_bwd_block_of(const MnBwd& p, int t) {
  return (int)(((long)(t + 1) * gridDim.x - 1) / p.n_tiles);
}

// v[k] summed over the block, the same order in every thread: each warp's
// sum into red[warp][k], then, past a barrier, the warps' in order
__device__ __forceinline__ void block_sums(float (&v)[2 * kTileRows], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 2 * kTileRows; ++k) v[k] = general::warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 2 * kTileRows; k += 4)
      *reinterpret_cast<float4*>(red + warp * 2 * kTileRows + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2 * kTileRows; ++k) v[k] = 0.0f;
#pragma unroll
  for (int w = 0; w < kBwdWarps; ++w)
#pragma unroll
    for (int k = 0; k < 2 * kTileRows; k += 4) {
      const float4 r = *reinterpret_cast<const float4*>(red + w * 2 * kTileRows + k);
      v[k] += r.x;
      v[k + 1] += r.y;
      v[k + 2] += r.z;
      v[k + 3] += r.w;
    }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
mn_general_bwd_kernel(const __grid_constant__ MnBwd p) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;  // [2][kBwdWarps][2 kTileRows], one a reduction of a tile
  const int d = p.d, d4 = d / 4;
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ dout = static_cast<const T*>(p.dout);
  T* __restrict__ dx = static_cast<T*>(p.dx);
  const bool held = mn_bwd_held(d);
  float* ws = smem + mn_bwd_red_bytes() / 4;  // [d], held
  float* acc = ws + d;                        // [2, d]: A, B of the group
  const int t0 = (int)((long)blockIdx.x * p.n_tiles / gridDim.x);
  const int t1 = (int)((long)(blockIdx.x + 1) * p.n_tiles / gridDim.x);
  int group = -1;
  long vrow = 0;
  const auto slot = [&](int r) { return p.part + (long)(blockIdx.x + r) * 2 * d; };
  const auto w4 = [&](int c) {  // w of columns c .. c + 3 of the group
    if (held) return *reinterpret_cast<const float4*>(ws + c);
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = ld_param(p.ns, c + e, p.n_bf16) * (1.0f + ld_param(p.scale, vrow + c + e, p.v_bf16));
    return make_float4(w[0], w[1], w[2], w[3]);
  };
  const auto leave = [&]() {  // the sums of `group` into its slot
    if (!held || group < 0) return;
    float4* to = reinterpret_cast<float4*>(slot(group));
    for (int c4 = threadIdx.x; c4 < d4; c4 += kBwdThreads) {
      to[c4] = reinterpret_cast<const float4*>(acc)[c4];
      to[d4 + c4] = reinterpret_cast<const float4*>(acc + d)[c4];
    }
  };
  for (int t = t0; t < t1; ++t) {
    const int r = t / p.tiles_per_group, s0 = (t - r * p.tiles_per_group) * p.rows;
    const int n = min(p.rows, p.s - s0);
    if (r != group) {  // a new row group: its w, its sums from 0
      leave();
      group = r;
      vrow = (long)r * p.v_stride;
      if (!held) acc = slot(group);
      __syncthreads();  // every thread is done with the last group's w
      for (int c4 = threadIdx.x; c4 < d4; c4 += kBwdThreads) {
        if (held) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = ld_param(p.ns, 4 * c4 + e, p.n_bf16) *
                   (1.0f + ld_param(p.scale, vrow + 4 * c4 + e, p.v_bf16));
          reinterpret_cast<float4*>(ws)[c4] = make_float4(w[0], w[1], w[2], w[3]);
        }
        reinterpret_cast<float4*>(acc)[c4] = general::zero4();
        reinterpret_cast<float4*>(acc + d)[c4] = general::zero4();
      }
      __syncthreads();  // the group's w, to every thread
    }
    const long row0 = (long)r * p.s + s0;
    // a pass over the tile: f(i, c, x, dout, w) for rows i < n and columns c .. c + 3,
    // kChunks float4 chunks a thread at once (2 kTileRows kChunks loads in flight)
    const auto pass = [&](auto&& f) {
      for (int c0 = threadIdx.x; c0 < d4; c0 += kBwdThreads * kChunks) {
        float4 xv[kTileRows][kChunks], dv[kTileRows][kChunks];
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
#pragma unroll
          for (int j = 0; j < kChunks; ++j) {
            const int c4 = c0 + j * kBwdThreads;
            if (i < n && c4 < d4) {
              xv[i][j] = Elem<T>::ld4(x + (row0 + i) * d + 4 * c4);
              dv[i][j] = Elem<T>::ld4(dout + (row0 + i) * d + 4 * c4);
            }
          }
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int c4 = c0 + j * kBwdThreads;
          if (c4 < d4) f(4 * c4, xv, dv, j, w4(4 * c4));
        }
      }
    };
    // (1) each row's sum of x and of g = dout w
    float v[2 * kTileRows] = {};
    pass([&](int, auto& xv, auto& dv, int j, float4 w) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        if (i < n) {
          const float4 a = xv[i][j], g = dv[i][j];
          v[i] += (a.x + a.y) + (a.z + a.w);
          v[kTileRows + i] += (g.x * w.x + g.y * w.y) + (g.z * w.z + g.w * w.w);
        }
    });
    block_sums(v, red);
    float mean[kTileRows], gm[kTileRows];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      mean[i] = v[i] / d;
      gm[i] = v[kTileRows + i] / d;
      v[i] = v[kTileRows + i] = 0.0f;
    }
    // (2) each row's sum of (x - mean)^2 and of g (x - mean)
    pass([&](int, auto& xv, auto& dv, int j, float4 w) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        if (i < n) {
          const float4 a = xv[i][j], g = dv[i][j];
          const float e0 = a.x - mean[i], e1 = a.y - mean[i], e2 = a.z - mean[i],
                      e3 = a.w - mean[i];
          v[i] = fmaf(e3, e3, fmaf(e2, e2, fmaf(e1, e1, fmaf(e0, e0, v[i]))));
          v[kTileRows + i] = fmaf(g.w * w.w, e3, fmaf(g.z * w.z, e2, fmaf(g.y * w.y, e1,
                                  fmaf(g.x * w.x, e0, v[kTileRows + i]))));
        }
    });
    block_sums(v, red + kBwdWarps * 2 * kTileRows);
    float inv[kTileRows], gxm[kTileRows];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      inv[i] = rsqrtf(v[i] / d + p.eps);
      gxm[i] = inv[i] * v[kTileRows + i] / d;
    }
    // (3) dx, and the tile's rows in order into the group's sums
    pass([&](int c, auto& xv, auto& dv, int j, float4 w) {
      float4* a4 = reinterpret_cast<float4*>(acc + c);
      float4* b4 = reinterpret_cast<float4*>(acc + d + c);
      float sa[4] = {a4->x, a4->y, a4->z, a4->w}, sb[4] = {b4->x, b4->y, b4->z, b4->w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        if (i < n) {
          const float xs[4] = {xv[i][j].x, xv[i][j].y, xv[i][j].z, xv[i][j].w};
          const float ds[4] = {dv[i][j].x, dv[i][j].y, dv[i][j].z, dv[i][j].w};
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float xh = (xs[e] - mean[i]) * inv[i];
            o[e] = inv[i] * ((ds[e] * wv[e] - gm[i]) - xh * gxm[i]);
            sa[e] += ds[e];
            sb[e] = fmaf(ds[e], xh, sb[e]);
          }
          Elem<T>::st4(dx + (row0 + i) * d + c, make_float4(o[0], o[1], o[2], o[3]));
        }
      *a4 = make_float4(sa[0], sa[1], sa[2], sa[3]);
      *b4 = make_float4(sb[0], sb[1], sb[2], sb[3]);
    });
  }
  leave();
  cooperative_groups::this_grid().sync();  // every partial, to the blocks that add them

  // ab[r, k, c] = the slots of group r in order: a float4 unit by s lanes of one warp,
  // lane j adding slots lo + j, lo + j + s, ... (8 loads in flight), then a butterfly
  constexpr int kBatch = 8;
  const long units = (long)p.r * 2 * d4, threads = (long)gridDim.x * kBwdThreads;
  int s = 1;
  while (s < 32 && 2 * s * units <= threads) s *= 2;
  const float4* __restrict__ part = reinterpret_cast<const float4*>(p.part);
  for (long base = (long)blockIdx.x * kBwdThreads; base < units * s; base += threads) {
    const long u = (base + threadIdx.x) / s;  // whole warps step together
    const int j = (int)((base + threadIdx.x) % s);
    float4 sum = general::zero4();
    if (u < units) {
      const int r = (int)(u / (2 * d4)), within = (int)(u - (long)r * 2 * d4);
      const int lo = mn_bwd_block_of(p, r * p.tiles_per_group) + r;
      const int hi = mn_bwd_block_of(p, (r + 1) * p.tiles_per_group - 1) + r;
      for (int k0 = lo + j; k0 <= hi; k0 += kBatch * s) {
        float4 v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (k0 + q * s <= hi) v[q] = __ldcg(part + (long)(k0 + q * s) * 2 * d4 + within);
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (k0 + q * s <= hi)
            sum = make_float4(sum.x + v[q].x, sum.y + v[q].y, sum.z + v[q].z, sum.w + v[q].w);
      }
    }
    for (int o = s / 2; o > 0; o >>= 1) {
      sum.x += __shfl_xor_sync(0xffffffffu, sum.x, o);
      sum.y += __shfl_xor_sync(0xffffffffu, sum.y, o);
      sum.z += __shfl_xor_sync(0xffffffffu, sum.z, o);
      sum.w += __shfl_xor_sync(0xffffffffu, sum.w, o);
    }
    if (u < units && j == 0) reinterpret_cast<float4*>(p.ab)[u] = sum;
  }
}

// dy = T(gate[r] * dout); part[r, chunk, c]: sum of dout * y over the chunk's rows
template <typename T>
__global__ void __launch_bounds__(kColThreads)
gr_general_bwd_cols_kernel(const T* __restrict__ dout, const T* __restrict__ y, const void* gate,
                           long g_stride, T* __restrict__ dy, float* __restrict__ part, int s,
                           int d, int chunk_rows, int g_bf16) {
  const int c = blockIdx.x * kColThreads + threadIdx.x, chunk = blockIdx.y, r = blockIdx.z;
  if (c >= d) return;
  const int s0 = chunk * chunk_rows, s1 = min(s, s0 + chunk_rows);
  const float gt = ld_param(gate, (long)r * g_stride + c, g_bf16);
  float acc = 0.0f;
  for (int i = s0; i < s1; ++i) {
    const long at = ((long)r * s + i) * d + c;
    const float g = Elem<T>::ld(dout + at);
    Elem<T>::st(dy + at, gt * g);
    acc = fmaf(g, Elem<T>::ld(y + at), acc);
  }
  part[((long)r * gridDim.y + chunk) * d + c] = acc;
}

// sums[r, k] = part[r, 0, k] + part[r, 1, k] + ... over the chunks in order,
// for r < n_r and k < width (a row's sums: 2 D or D floats)
__global__ void __launch_bounds__(kSumThreads)
general_chunk_sums_kernel(const float* __restrict__ part, float* __restrict__ sums, int n_r,
                          int width, int n_chunks) {
  const long i = (long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= (long)n_r * width) return;
  const long r = i / width, k = i - r * width;
  const float* p = part + r * n_chunks * width + k;
  float acc = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) acc += p[(long)ch * width];
  sums[i] = acc;
}

bool takes_shape(int r, int s, int d) {
  return r >= 1 && r <= 65535 && s >= 1 && d >= 8 && d % 8 == 0;
}

bool takes(int r, int s, int d, int chunk_rows) {
  return takes_shape(r, s, d) && chunk_rows >= 1 && (s + chunk_rows - 1) / chunk_rows <= 65535;
}

dim3 col_grid(int r, int s, int d, int chunk_rows) {
  return dim3((d + kColThreads - 1) / kColThreads, (s + chunk_rows - 1) / chunk_rows, r);
}

int chunk_sums(const float* part, float* sums, int r, int width, int n_chunks, cudaStream_t st) {
  const long n = (long)r * width;
  general_chunk_sums_kernel<<<(unsigned)((n + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                              st>>>(part, sums, r, width, n_chunks);
  return (int)cudaGetLastError();
}

// (lanes a row, chunks a lane) of the forward's instance for rows of d
// elements of T (adaln.py's modulate_norm_general_instance mirrors this):
// rows of up to 16 chunks take 4, 8 or 16 lanes and one chunk a lane, wider
// ones a warp and the fewest chunks a lane, a power of two, that hold them
// (kMaxHeld<T> past 4096 columns)
template <typename T>
void mn_fwd_instance(int d, int* lanes, int* held) {
  const int n = d / Chunk<T>::kE;
  *lanes = n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
  *held = 1;
  while (*lanes == 32 && *held < kMaxHeld<T> && 32 * *held < n) *held *= 2;
}

// The forward's instance <T, kLanes, kHeld> at p's [r, s, d]: launched on
// st, or, with info, its attributes and grid into info (registers, local
// bytes a thread, dynamic shared bytes a block, lanes, held, rows a block,
// blocks).
template <typename T, int kLanes, int kHeld>
int mn_fwd_launch(MnFwd p, int r, cudaStream_t st, int* info) {
  const auto kernel = mn_general_fwd_kernel<T, kLanes, kHeld>;
  constexpr int kStep = kFwdWarps * 32 / kLanes;
  p.tiles_per_group = (p.s + kStep - 1) / kStep;
  const long blocks = (long)r * p.tiles_per_group;
  const int smem = 16 * min(p.d, kCoefCols);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (info) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    const int got[7] = {a.numRegs, (int)a.localSizeBytes, smem, kLanes, kHeld, kStep,
                        (int)blocks};
    for (int i = 0; i < 7; ++i) info[i] = got[i];
    return 0;
  }
  kernel<<<(unsigned)blocks, kFwdThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int mn_fwd(const MnFwd& p, int r, cudaStream_t st, int* info) {
  int lanes, held;
  mn_fwd_instance<T>(p.d, &lanes, &held);
  if (lanes == 4) return mn_fwd_launch<T, 4, 1>(p, r, st, info);
  if (lanes == 8) return mn_fwd_launch<T, 8, 1>(p, r, st, info);
  if (lanes == 16) return mn_fwd_launch<T, 16, 1>(p, r, st, info);
  switch (held) {
    case 1: return mn_fwd_launch<T, 32, 1>(p, r, st, info);
    case 2: return mn_fwd_launch<T, 32, 2>(p, r, st, info);
    case 4: return mn_fwd_launch<T, 32, 4>(p, r, st, info);
    case 8: return mn_fwd_launch<T, 32, 8>(p, r, st, info);
    case 16: return mn_fwd_launch<T, 32, 16>(p, r, st, info);
    default: return mn_fwd_launch<T, 32, kMaxHeld<T>>(p, r, st, info);
  }
}

// out[0]: the most rows a tile may have; out[1]: the blocks of the instance
// for T at width d that the plan may launch at once (all resident, at most
// kBwdBlocksPerSm a multiprocessor). Also lifts the kernel's shared-memory
// limit.
template <typename T>
int mn_bwd_limits(int d, int* out) {
  const auto kernel = mn_general_bwd_kernel<T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads,
                                                        mn_bwd_smem(d));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = kTileRows;
  out[1] = min(per_sm, kBwdBlocksPerSm) * sms;
  return (int)cudaSuccess;
}

template <typename T>
int mn_bwd(MnBwd p, int grid, cudaStream_t st) {
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mn_general_bwd_kernel<T>),
                                          dim3(grid), dim3(kBwdThreads), args, mn_bwd_smem(p.d),
                                          st);
}

template <typename T>
int gr_bwd(const void* dout, const void* y, const void* gate, long g_stride, void* dy, void* part,
           void* dgate, int r, int s, int d, int chunk_rows, int g_bf16, cudaStream_t st) {
  const dim3 grid = col_grid(r, s, d, chunk_rows);
  gr_general_bwd_cols_kernel<T><<<grid, kColThreads, 0, st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(y), gate, g_stride, static_cast<T*>(dy),
      static_cast<float*>(part), s, d, chunk_rows, g_bf16);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return chunk_sums(static_cast<const float*>(part), static_cast<float*>(dgate), r, d, grid.y, st);
}

}  // namespace

// x, out: [r, s, d] contiguous, 16-byte aligned, f32 if is_f32 else bf16;
// scale, shift: [r, d] with row stride v_stride (bf16 if v_bf16 else f32);
// ns, nb: [d] (bf16 if n_bf16 else f32). 1 <= r <= 65535, s >= 1, d % 8 ==
// 0 (else cudaErrorInvalidValue). Returns the launch's CUDA error.
extern "C" int orv_modulate_norm_general(const void* x, const void* scale, const void* shift,
                                         long v_stride, const void* ns, const void* nb, void* out,
                                         int r, int s, int d, float eps, int v_bf16, int n_bf16,
                                         int is_f32, void* stream) {
  if (!takes_shape(r, s, d)) return (int)cudaErrorInvalidValue;
  const uintptr_t at = reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(shift) |
                       reinterpret_cast<uintptr_t>(ns) | reinterpret_cast<uintptr_t>(nb);
  const int coef_async = !v_bf16 && !n_bf16 && v_stride % 4 == 0 && at % 16 == 0;
  const MnFwd p{x, scale, shift, v_stride, ns, nb, out, s, d, 0, eps, v_bf16, n_bf16, coef_async};
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? mn_fwd<float>(p, r, st, nullptr) : mn_fwd<__nv_bfloat16>(p, r, st, nullptr);
}

// The instance and grid a launch of orv_modulate_norm_general at [r, s, d]
// (f32 if is_f32 else bf16) takes on the current card, into out[0..6]: its
// registers a thread, local memory a thread in bytes (spills and stack),
// dynamic shared memory a block in bytes, lanes a row, 16-byte chunks a
// lane held in registers, rows a block, blocks launched. Returns the CUDA
// error (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int orv_modulate_norm_general_info(int r, int s, int d, int is_f32, void* out) {
  if (!takes_shape(r, s, d)) return (int)cudaErrorInvalidValue;
  const MnFwd p{nullptr, nullptr, nullptr, 0, nullptr, nullptr, nullptr, s, d, 0, 0.0f, 0, 0, 1};
  int* info = static_cast<int*>(out);
  return is_f32 ? mn_fwd<float>(p, r, nullptr, info) : mn_fwd<__nv_bfloat16>(p, r, nullptr, info);
}

// limits[0]: the most rows a tile of the adaLN backward may have; limits[1]:
// the blocks its instance for f32 (is_f32) or bf16 x of width d may launch at
// once on the current device. d % 8 == 0 (else cudaErrorInvalidValue).
// Returns the CUDA error.
extern "C" int orv_modulate_norm_bwd_general_limits(int d, int is_f32, void* limits) {
  if (!takes_shape(1, 1, d)) return (int)cudaErrorInvalidValue;
  int* out = static_cast<int*>(limits);
  return is_f32 ? mn_bwd_limits<float>(d, out) : mn_bwd_limits<__nv_bfloat16>(d, out);
}

// x, dout, dx: [r, s, d] as modulate_norm's x; scale: [r, d] with row stride
// v_stride; ns: [d]. rows and grid: the wrapper's plan from
// orv_modulate_norm_bwd_general_limits on this device (rows <= limits[0],
// grid <= limits[1] and at most the r * ceil(s / rows) tiles). Scratch:
// part [grid + r - 1, 2, d] f32. ab: [r, 2, d] f32 out (A, then B). One
// cooperative launch. Returns the launch's CUDA error.
extern "C" int orv_modulate_norm_bwd_general(const void* x, const void* dout, const void* scale,
                                             long v_stride, const void* ns, void* dx, void* part,
                                             void* ab, int r, int s, int d, int rows, int grid,
                                             float eps, int v_bf16, int n_bf16, int is_f32,
                                             void* stream) {
  if (!takes_shape(r, s, d) || rows < 1 || rows > kTileRows) return (int)cudaErrorInvalidValue;
  const int tiles_per_group = (s + rows - 1) / rows;
  const long n_tiles = (long)r * tiles_per_group;
  if (grid < 1 || grid > n_tiles || n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const MnBwd p{x, dout, scale, v_stride, ns, dx, static_cast<float*>(part),
                static_cast<float*>(ab), r, s, d, rows, tiles_per_group, (int)n_tiles, eps,
                v_bf16, n_bf16};
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? mn_bwd<float>(p, grid, st) : mn_bwd<__nv_bfloat16>(p, grid, st);
}

// dout, y, dy: [r, s, d] contiguous, 16-byte aligned, f32 if is_f32 else
// bf16; gate: [r, d] with row stride g_stride (bf16 if g_bf16 else f32).
// Scratch: part [r, ceil(s / chunk_rows), d] f32. dgate: [r, d] f32 out. Two
// launches (column chunks, chunk sums). Returns the first CUDA error.
extern "C" int orv_gated_residual_bwd_general(const void* dout, const void* y, const void* gate,
                                              long g_stride, void* dy, void* part, void* dgate,
                                              int r, int s, int d, int chunk_rows, int g_bf16,
                                              int is_f32, void* stream) {
  if (!takes(r, s, d, chunk_rows)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? gr_bwd<float>(dout, y, gate, g_stride, dy, part, dgate, r, s, d, chunk_rows,
                                g_bf16, st)
                : gr_bwd<__nv_bfloat16>(dout, y, gate, g_stride, dy, part, dgate, r, s, d,
                                        chunk_rows, g_bf16, st);
}
