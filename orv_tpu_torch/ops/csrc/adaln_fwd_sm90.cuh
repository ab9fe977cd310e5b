// The two adaLN forwards for Hopper (sm_90a), shared by modulate_norm.cu
// (OutMode::kBf16) and modulate_norm_q8.cu (OutMode::kQ8).
//
// Every token row of x [R, S, D] bf16 in row group r computes in f32, as the
// TPU kernels and the plain versions do:
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D        (two passes)
//   y = ((x - mean) * rsqrt(var + eps) * ns + nb) * (1 + scale[r]) + shift[r]
// with scale/shift [R, D] (row stride ss_stride, bf16 or f32) and ns/nb [D]
// (bf16 or f32). kBf16 writes bf16(y) [R, S, D]. kQ8 writes the per-token
// int8 quantization that the W8A8 projections take:
//   amax = max(max|y|, 1e-6),  xq = int8(round_half_even(y * (127 / amax)))
//   xscale = amax * (1/127)                                 (f32 [R, S])
// with a true division and __float2int_rn (half to even, as jnp.round).
// y keeps the roundings of the first design: one FMA for `* ns + nb` and one
// for `* (1 + scale) + shift`; ns * (1 + scale) is not folded into one
// coefficient, which would round differently.
//
// Bound on the H100: bytes. At the flagship shape [13, 600, 1920] kBf16 reads
// x and writes out once (60 MB), kQ8 reads x and writes xq (45 MB), for a
// few tens of f32 operations an element.
//
// Design. A tile is kRows consecutive rows of one row group (a group's last
// tile is ragged). The grid is persistent: as many blocks as fit on the SMs
// at once (at D = 1920, 5 warps of up to 168 registers and 62 KB of shared
// memory each: 2 an SM, as the registers allow), each walking a
// contiguous range of tiles, so that it enters a new row group at most once
// or twice. Tiles of 4 rows and a ring of 2 stages timed faster than 8 rows
// and 4 stages, in turns on the card (scripts/time_adaln_variants.py).
// - Once per block, ns and nb are converted to f32 in shared memory; once
//   per row group a block enters, (1 + scale[r]) and shift[r] likewise, each
//   thread issuing all its loads before it converts any (one round trip;
//   converted one by one they cost a round trip each). A lane owns 4
//   contiguous columns of each 128-column chunk, so it reads the four
//   coefficients as 16-byte vectors and x as 8 bytes, both conflict-free,
//   where the first design loaded every coefficient as a scalar from global
//   memory, once per row.
// - One thread of the producer warp copies each tile's kRows * D * 2
//   contiguous bytes with one 1-D bulk copy (cp.async.bulk, no tensor map)
//   into a ring of kStages stages, signalled by a full mbarrier (transaction
//   bytes) and handed back by an empty mbarrier that each of the kRows
//   consumer warps arrives on. D % 128 == 0 keeps every row a multiple of
//   256 bytes, so every copy meets the 16-byte rules. The first tiles are in
//   flight while the coefficients load.
// - One consumer warp a row. A lane holds its columns of the first kHeld
//   chunks of 128 columns in registers from the mean pass on, x and then y
//   in place, with a compile-time trip count, so that each pass over them is
//   straight-line code whose loads issue together (with a runtime trip
//   count, the guards on each chunk kept ptxas from issuing a pass's loads
//   together). Each entry file instantiates the kernel for kHeld = 1 ..
//   kCache: below kCache a row is exactly kHeld chunks wide; the kCache
//   instance takes every width from kCache to kMaxNV chunks (D 2048 to
//   4096) and re-reads the chunks past the held ones from the stage in each
//   pass, 4 at a time, so registers do not grow with D.
//   (Warps sharing each tile by columns instead, the coefficients of a
//   warp's columns in registers and the row sums added across warps through
//   shared memory behind named barriers, timed slower in a trial.)
// - Output: bf16 written back into the row's place in its stage and sent
//   out by one bulk store (cp.async.bulk, its reads of the stage waited for
//   before the stage is handed back), which timed faster in turns than
//   8-byte stores from registers; int8 in 4-byte stores, xscale from lane 0.
// scripts/time_adaln_variants.py times these choices (kRows, the ring's
// depth, the bulk store, kCache, one or two coefficient round trips) against
// each other on the card, as text substitutions of this header.

#pragma once

#include <array>
#include <atomic>
#include <utility>

#include "modulate_norm.cuh"
#include "sm90_common.cuh"

namespace adaln_sm90 {
namespace {  // internal linkage: launch's statics stay this library's own

enum class OutMode { kBf16, kQ8 };

constexpr int kRows = 4;                    // rows a tile: one consumer warp each
constexpr int kThreads = (kRows + 1) * 32;  // and one producer warp
constexpr int kStages = 2;                  // the ring's depth
constexpr int kMaxNV = 32;                  // chunks of 128 columns: D <= 4096
constexpr int kCache = 16;                  // chunks a lane holds in registers, at most
constexpr int kBarBytes = 2 * kStages * 8;  // full and empty mbarriers
constexpr int kMaxDevices = 64;
constexpr float kInv127 = (float)(1.0 / 127.0);

struct Params {
  const bf16* x;
  const void* scale;
  const void* shift;
  long ss_stride;
  const void* ns;
  const void* nb;
  void* out;      // bf16 (kBf16) or int8 (kQ8) [R, S, D]
  float* xscale;  // kQ8: [R, S]
  int s;
  float eps;
  int ss_bf16, n_bf16;
  int tiles_per_group;  // ceil(S / kRows)
  int n_tiles;          // R * tiles_per_group
  int nv;               // D / 128
};

// barriers, the four f32 coefficient rows and the ring, at width d
constexpr int smem_bytes(int d) { return kBarBytes + 16 * d + kStages * kRows * d * 2; }
static_assert(smem_bytes(kMaxNV * 128) <= 232448, "the widest rows overflow shared memory");

// chunks of 128 columns a row of the kHeld instance: kHeld, or the launch's
// count for the widest instance
template <int kHeld>
__device__ __forceinline__ int row_chunks(const Params& p) {
  return kHeld < kCache ? kHeld : p.nv;
}

__device__ __forceinline__ float4 ld_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

__device__ __forceinline__ float modulate(float x, float mean, float inv, float ns, float nb,
                                          float sc1, float sh) {
  return __fmaf_rn(__fmaf_rn(__fmul_rn(__fsub_rn(x, mean), inv), ns, nb), sc1, sh);
}

// y of columns c .. c + 3, whose x is v; coef holds ns, nb, 1 + scale[r] and
// shift[r] as four f32 rows of d
__device__ __forceinline__ float4 modulate4(float4 v, int c, int d, float mean, float inv,
                                            const float* __restrict__ coef) {
  const float4 a = *reinterpret_cast<const float4*>(coef + c);
  const float4 b = *reinterpret_cast<const float4*>(coef + d + c);
  const float4 s = *reinterpret_cast<const float4*>(coef + 2 * d + c);
  const float4 h = *reinterpret_cast<const float4*>(coef + 3 * d + c);
  return make_float4(modulate(v.x, mean, inv, a.x, b.x, s.x, h.x),
                     modulate(v.y, mean, inv, a.y, b.y, s.y, h.y),
                     modulate(v.z, mean, inv, a.z, b.z, s.z, h.z),
                     modulate(v.w, mean, inv, a.w, b.w, s.w, h.w));
}

__device__ __forceinline__ float sq_dev4(float sq, float4 v, float mean) {
  const float c0 = v.x - mean, c1 = v.y - mean, c2 = v.z - mean, c3 = v.w - mean;
  return __fmaf_rn(c3, c3, __fmaf_rn(c2, c2, __fmaf_rn(c1, c1, __fmaf_rn(c0, c0, sq))));
}

__device__ __forceinline__ uint2 pack_bf16x4(float4 y) {
  return make_uint2(sm90::pack_bf16(y.x, y.y), sm90::pack_bf16(y.z, y.w));
}

__device__ __forceinline__ uint32_t pack_s8x4(float4 y, float q) {
  const float t[4] = {y.x, y.y, y.z, y.w};
  return sm90::pack_s8(t, q);
}

__device__ __forceinline__ float abs_max4(float m, float4 y) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(y.x), fabsf(y.y)), fmaxf(fabsf(y.z), fabsf(y.w))));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One coefficient row's source: element off + c of p (bf16 or f32) goes to
// column c, with 1 added if add_one.
struct CoefSrc {
  const void* p;
  long off;
  int is_bf16;
  bool add_one;
};

// Coefficient rows row0 .. row0 + kSrc - 1 of width d <= kDMax from src, by
// kN threads from thread i on. Each thread issues all its loads (raw bits;
// the dtype branch is outside the loads) before it converts or stores any,
// so a call costs one round trip to memory; converted one at a time, the
// loads took one round trip each.
template <int kDMax, int kN, int kSrc>
__device__ __forceinline__ void load_coef(float* coef, int d, int row0,
                                          const CoefSrc (&src)[kSrc], int i) {
  constexpr int kPer = (kDMax + kN - 1) / kN;
  uint32_t raw[kSrc][kPer];
#pragma unroll
  for (int k = 0; k < kSrc; ++k) {
    if (src[k].is_bf16) {
      const uint16_t* a = static_cast<const uint16_t*>(src[k].p) + src[k].off;
#pragma unroll
      for (int j = 0; j < kPer; ++j) raw[k][j] = i + j * kN < d ? a[i + j * kN] : 0u;
    } else {
      const uint32_t* a = static_cast<const uint32_t*>(src[k].p) + src[k].off;
#pragma unroll
      for (int j = 0; j < kPer; ++j) raw[k][j] = i + j * kN < d ? a[i + j * kN] : 0u;
    }
  }
#pragma unroll
  for (int k = 0; k < kSrc; ++k) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float v = __uint_as_float(src[k].is_bf16 ? raw[k][j] << 16 : raw[k][j]);
      if (i + j * kN < d) coef[(row0 + k) * d + i + j * kN] = src[k].add_one ? 1.0f + v : v;
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kRows * 32) : "memory");
}

// One token row of nv chunks of 128 columns: xr is its bf16 in the ring,
// row its index in [R * S]. The first kHeld chunks stay in registers from
// the mean pass on (x, then y in place); chunks past them (the widest
// instance, D > 2048) are re-read from the ring in each pass, 4 at a time,
// and y recomputed for kQ8's second pass (the same instructions give the
// same bits). Sums run over the chunks in order.
template <OutMode kMode, int kHeld>
__device__ __forceinline__ void modulate_row(bf16* __restrict__ xr, long row,
                                             const float* __restrict__ coef, const Params& p,
                                             int lane) {
  const int nv = row_chunks<kHeld>(p), d = nv * 128;
  const auto col = [&](int i) { return (i * 32 + lane) * 4; };
  const auto y4 = [&](float4 x, int i, float mean, float inv) {
    return modulate4(x, col(i), d, mean, inv, coef);
  };
  float4 xc[kHeld];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    xc[i] = ld_bf16x4(xr + col(i));
    sum += (xc[i].x + xc[i].y) + (xc[i].z + xc[i].w);
  }
#pragma unroll 4
  for (int i = kHeld; i < nv; ++i) {
    const float4 v = ld_bf16x4(xr + col(i));
    sum += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) sq = sq_dev4(sq, xc[i], mean);
#pragma unroll 4
  for (int i = kHeld; i < nv; ++i) sq = sq_dev4(sq, ld_bf16x4(xr + col(i)), mean);
  const float inv = rsqrtf(warp_sum(sq) / d + p.eps);

  if constexpr (kMode == OutMode::kBf16) {  // y back into the stage, out by one bulk store
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      *reinterpret_cast<uint2*>(xr + col(i)) = pack_bf16x4(y4(xc[i], i, mean, inv));
#pragma unroll 4
    for (int i = kHeld; i < nv; ++i)
      *reinterpret_cast<uint2*>(xr + col(i)) =
          pack_bf16x4(y4(ld_bf16x4(xr + col(i)), i, mean, inv));
    sm90::fence_proxy_async();  // the stage's new bytes, to the bulk store
    __syncwarp();
    if (lane == 0) {
      sm90::bulk_store(static_cast<bf16*>(p.out) + row * d, xr, (uint32_t)d * 2);
      sm90::bulk_commit();
      sm90::bulk_wait_read<0>();  // the stage may be refilled after this
    }
    __syncwarp();
  } else {
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      xc[i] = y4(xc[i], i, mean, inv);
      amax = abs_max4(amax, xc[i]);
    }
#pragma unroll 4
    for (int i = kHeld; i < nv; ++i)
      amax = abs_max4(amax, y4(ld_bf16x4(xr + col(i)), i, mean, inv));
    amax = fmaxf(warp_max(amax), 1e-6f);
    const float q = 127.0f / amax;
    int8_t* __restrict__ orow = static_cast<int8_t*>(p.out) + row * d;
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      *reinterpret_cast<uint32_t*>(orow + col(i)) = pack_s8x4(xc[i], q);
#pragma unroll 4
    for (int i = kHeld; i < nv; ++i)
      *reinterpret_cast<uint32_t*>(orow + col(i)) =
          pack_s8x4(y4(ld_bf16x4(xr + col(i)), i, mean, inv), q);
    if (lane == 0) p.xscale[row] = amax * kInv127;
  }
}

template <OutMode kMode, int kHeld>
__device__ __forceinline__ void adaln_fwd(const Params& p) {
  constexpr int kDMax = (kHeld < kCache ? kHeld : kMaxNV) * 128;
  const int d = row_chunks<kHeld>(p) * 128;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* coef = reinterpret_cast<float*>(smem + kBarBytes);  // ns, nb, 1 + scale, shift
  bf16* ring = reinterpret_cast<bf16*>(coef + 4 * d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = (int)((long)blockIdx.x * p.n_tiles / gridDim.x);
  const int t1 = (int)((long)(blockIdx.x + 1) * p.n_tiles / gridDim.x);
  int group = t0 / p.tiles_per_group;
  const bool producer = warp == kRows && lane == 0;  // the thread that keeps the ring full

  // tile t0 + n into stage n % kStages, once its consumers handed the stage back
  const auto issue = [&](int n) {
    const int st = n % kStages, t = t0 + n;
    if (n >= kStages) sm90::mbar_wait(&empty[st], (n / kStages - 1) & 1);
    const int r = t / p.tiles_per_group, s0 = (t - r * p.tiles_per_group) * kRows;
    const uint32_t bytes = (uint32_t)(min(kRows, p.s - s0) * d * 2);
    sm90::mbar_expect_tx(&full[st], bytes);
    sm90::bulk_load(ring + (long)st * kRows * d, p.x + ((long)r * p.s + s0) * d, bytes,
                    &full[st]);
  };
  if (producer) {  // the first tiles are in flight while the coefficients load
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kRows);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int n = 0; n < kStages && t0 + n < t1; ++n) issue(n);
  }
  {  // ns and nb, then 1 + scale[group] and shift[group]
    const long off = (long)group * p.ss_stride;
    const CoefSrc norm[2] = {{p.ns, 0, p.n_bf16, false}, {p.nb, 0, p.n_bf16, false}};
    const CoefSrc mod[2] = {{p.scale, off, p.ss_bf16, true}, {p.shift, off, p.ss_bf16, false}};
    load_coef<kDMax, kThreads>(coef, d, 0, norm, threadIdx.x);
    load_coef<kDMax, kThreads>(coef, d, 2, mod, threadIdx.x);
  }
  __syncthreads();

  if (warp == kRows) {
    if (producer)
      for (int n = kStages; t0 + n < t1; ++n) issue(n);
    return;
  }

  for (int t = t0, n = 0; t < t1; ++t, ++n) {
    const int st = n % kStages;
    const int r = t / p.tiles_per_group, row = (t - r * p.tiles_per_group) * kRows + warp;
    if (r != group) {  // the block enters the next row group
      consumer_sync();  // every consumer is done with the last group's rows
      const long off = (long)r * p.ss_stride;
      const CoefSrc src[2] = {{p.scale, off, p.ss_bf16, true}, {p.shift, off, p.ss_bf16, false}};
      load_coef<kDMax, kRows * 32>(coef, d, 2, src, threadIdx.x);
      consumer_sync();
      group = r;
    }
    sm90::mbar_wait(&full[st], (n / kStages) & 1);
    if (row < p.s)
      modulate_row<kMode, kHeld>(ring + ((long)st * kRows + warp) * d, (long)r * p.s + row,
                                 coef, p, lane);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }
}

// An entry file's kernels, one per held-chunk count: [h - 1] runs rows of h
// chunks (h < kCache), or of kCache .. kMaxNV chunks (h = kCache).
using Kernel = void (*)(Params);
using Kernels = std::array<Kernel, kCache>;
constexpr auto kHeldCounts = std::make_integer_sequence<int, kCache>();  // h - 1 for each h

// Fills in the tiling and launches the kernel of d's held-chunk count on r
// row groups: as many blocks as fit on the SMs at once, never more than the
// tiles. Returns the CUDA error (cudaErrorInvalidValue for d % 128 != 0 or
// d > 4096).
int launch(const Kernels& kernels, Params p, int r, int d, void* stream) {
  if (d <= 0 || d % 128 != 0 || d > kMaxNV * 128 || r < 0 || p.s < 0)
    return (int)cudaErrorInvalidValue;
  if (r == 0 || p.s == 0) return (int)cudaSuccess;
  p.nv = d / 128;
  const int held = p.nv < kCache ? p.nv : kCache;
  const auto kernel = kernels[held - 1];
  p.tiles_per_group = (p.s + kRows - 1) / kRows;
  p.n_tiles = r * p.tiles_per_group;
  const int smem = smem_bytes(d);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  // per device, fetched once: the SM count, and each width's blocks per SM
  // (0 until fetched; the first launch of a kernel also sets its
  // shared-memory limit, to what its widest rows take)
  static std::atomic<int> sm_count[kMaxDevices];
  static std::atomic<int> per_sm[kMaxDevices][kMaxNV];
  int sms = sm_count[dev].load();
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sm_count[dev] = sms;
  }
  int blocks = per_sm[dev][p.nv - 1].load();
  if (blocks == 0) {
    const int limit = smem_bytes((held < kCache ? held : kMaxNV) * 128);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm[dev][p.nv - 1] = blocks;
  }
  const int grid = p.n_tiles < sms * blocks ? p.n_tiles : sms * blocks;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace adaln_sm90
