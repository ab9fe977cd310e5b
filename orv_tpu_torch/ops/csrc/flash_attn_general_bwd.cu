// General flash attention backward for Hopper (sm_90a): f32 or bf16, any head
// dim that is a multiple of 8 up to 128, any Sq and Skv, with an optional lse
// cotangent.
//
// Replaces the TPU kernels orv_tpu/ops/attention.py:_bwd_dq_kernel (:389) and
// _bwd_dkv_kernel (:432) wherever the Hopper backward (flash_attn_bwd.cu:
// bf16 at head dim 64) does not take the operands, as
// flash_attn_general.cu does for the forwards. Arithmetic, as
// flash_attention_bwd_plain (ops/attention.py): p = exp(f32(q . k) * scale -
// lse); delta = rowsum(f32(out * dout)) - dlse (as _bwd_impl, :492, folds
// the lse cotangent); dp = f32(dout . v); ds = p * (dp - delta) * scale; dq
// and dk take ds rounded to T, dv the f32 p.
//
// Bound on the H100: operations, f32 FMAs on the CUDA cores (no TF32, which
// would miss the f32 tolerance): dq 6 Sq Skv Dh and dk/dv 8 Sq Skv Dh a head
// at 67 TFLOP/s.
//
// Design: register tiling, as an SGEMM. What limits an f32 product on the
// CUDA cores besides the FMAs is shared memory: a multiprocessor delivers one
// 4-byte word a lane per cycle to 32 lanes (a 16-byte read of a warp takes
// four such cycles, one a quarter-warp, broadcast or not) against 128 FMAs,
// so every float a lane reads must feed 4 of its FMAs: a lane's tile of a
// product must be 8 x 8 (8 + 8 floats read a step, 64 FMAs). A block of 256
// threads owns R rows (keys for dk/dv, queries for dq; R = 128, or 64 at head
// dims above 64) in shared memory in f32 and walks 64-row tiles of the other
// side (Q, dO, lse and delta for dk/dv; K and V for dq), double-buffered: f32
// tiles land by 16-byte cp.async, zero-filled past the rows and dims that
// exist, while the block computes the tile before; bf16 tiles are widened to
// f32 by the threads on the way in. A tile is three steps:
// - the scores: threads 0-127 compute S = (own rows) . (tile rows) over the
//   64-row tile, threads 128-255 dP, a lane an 8 x 8 tile of one of them (8 x
//   4 at R = 64): own rows a + R/8 i, tile rows b + 64/MJ j, lane % 8 picking
//   a and lane / 8 b, so that a quarter-warp reads 8 consecutive own rows
//   (distinct bank groups: rows are padded to Dh + 4 floats) and one tile row
//   (a broadcast). Each element is summed by its lane over every dim in
//   order of d: 64 independent accumulators, no shuffle;
// - p and ds: a lane of the S half and its partner in the dP half (the same
//   elements) each finish half of their elements (the S lane rows i < 4, the
//   dP lane rows i >= 4): each first hands the other the scores it lacks
//   through the elements' places in a [tile row][own row] tile (rows padded
//   to R + 8 floats, so that a warp's 32 stores fall on 32 banks), then, past
//   a barrier, stores p = exp(s scale - lse) (0 past the tile's rows) and
//   ds = p (dp - delta) scale rounded to T (dk/dv: p and ds tiles; dq: ds
//   alone, one tile), so that all 256 threads share the exponentials;
// - the gradients: dV += P^T dO on threads 0-127 and dK += dS^T Q on 128-255
//   (dk/dv), or dQ += dS K on all 256, each half over 32 of the tile's keys
//   (dq). A lane owns 8 consecutive own rows x 8 dims (float4 chunks 4 e and
//   4 e + Dh/2; fewer dims at Dh < 64) in registers for the whole walk, the
//   tile's rows in order; a quarter-warp reads one row of p or ds (a
//   broadcast) and 8 consecutive chunks of the tile row. The two halves of dQ
//   are added in order at the end.
// The dims past Dh up to the capacity are zeros in every tile, so the sums
// run over the capacity with no runtime bound. Each output element is summed
// in a fixed order (dq: two fixed halves added in a fixed order): no atomics,
// the same bits from run to run. delta is summed as before (a quad of threads
// a row, float4 chunks 16 c + 4 j, two shuffles).
//
// Shared memory a block (f32; rows of Dh + 4 floats, the p and ds tiles 64 x
// (R + 8)):
//
//   cap. | R   | dk/dv: K, V + stages x (Q, dO, lse, delta) + P, dS | dq: Q, dO + 2 x (K, V) + P/dS + lse, delta
//   16   | 128 | 20,480 + 2 x 10,752 +  69,632 = 111,616 (2 stages) | 20,480 + 2 x 10,240 + 34,816 + 1,024 =  76,800
//   32   | 128 | 36,864 + 2 x 18,944 +  69,632 = 144,384 (2 stages) | 36,864 + 2 x 18,432 + 34,816 + 1,024 = 109,568
//   64   | 128 | 69,632 + 2 x 35,328 +  69,632 = 209,920 (2 stages) | 69,632 + 2 x 34,816 + 34,816 + 1,024 = 175,104
//   128  | 64  | 67,584 + 1 x 68,096 +  36,864 = 172,544 (1 stage)  | 67,584 + 2 x 67,584 + 18,432 +   512 = 221,696
//
// in bytes, of Hopper's 232,448 a block: dk/dv at capacity 128 takes one
// stage (two would need 240,640), its next tile copied after the last read
// of the one before. One block a multiprocessor: a lane's 128 sums and their
// operands take 196-254 registers (ptxas, no spills).

#include "general.cuh"

namespace {

using general::cp_async4;
using general::cp_async_commit;
using general::cp_async_wait_all;
using general::Elem;
using general::ex2;
using general::products;
using general::scores;
using general::store_rows;

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;  // the threads of one product
constexpr int kTile = 64;            // rows of the other side a tile
constexpr int kPad = 4;              // floats padding a Q, K, V or dO row
constexpr float kLog2e = 1.4426950408889634f;

// The tiling of one capacity: R owned rows, their 8 x kMJ score tile and
// 8 x kMD gradient tile a lane.
template <int kDh>
struct Shape {
  static constexpr int R = kDh <= 64 ? 128 : 64;
  static constexpr int S = kDh + kPad;   // stride of a Q, K, V or dO row
  static constexpr int PS = R + 8;       // stride of a p or ds row
  static constexpr int kMJ = R * kTile / (8 * kHalf);  // tile rows of a lane's scores
  static constexpr int kMD = R * kDh / (8 * kHalf);    // dims of a lane's gradients
  static constexpr int kE = kDh / kMD;                 // lanes across the dims
  static constexpr int kDkvStages = kDh <= 64 ? 2 : 1;
  static constexpr int kDkvFloats = 2 * R * S + kDkvStages * 2 * kTile * (S + 1) + 2 * kTile * PS;
  static constexpr int kDqFloats = 2 * R * S + 2 * 2 * kTile * S + kTile * PS + 2 * R;
  static_assert(kMD == 2 || kMD == 4 || kMD == 8, "a lane's dims: a float2 or float4 chunks");
  static_assert(kE % 8 == 0 && R / 8 * kE == kHalf && R / 8 * (kTile / kMJ) == kHalf,
                "a product's lanes cover its tile once");
};

static_assert(Shape<64>::kDkvFloats * 4 == 209920 && Shape<128>::kDkvFloats * 4 == 172544,
              "the header's table");
static_assert(Shape<64>::kDqFloats * 4 == 175104 && Shape<128>::kDqFloats * 4 == 221696,
              "the header's table");

// rows [0, kN) x dims [0, kDh) of a [rows, dh] array into dst (general::stage)
template <typename T, int kDh, int kN>
__device__ __forceinline__ void stage(float* dst, const T* src, int n, int dh) {
  general::stage<T, kDh, kN, Shape<kDh>::S, kThreads>(dst, src, n, dh);
}

// kTile f32 values (lse or delta of the tile's rows) into dst, zeros past n,
// by cp.async: value i by the thread `thread` == i
__device__ __forceinline__ void stage_row(float* dst, const float* src, int n, int thread) {
  if (thread >= 0 && thread < kTile)
    cp_async4(dst + thread, thread < n ? src + thread : src, thread < n ? 4 : 0);
}

// A lane's places in its product's 128 threads: the scores' own rows a + R/8 i
// and tile rows b + kTile/kMJ j; the gradients' own rows 8 g .. 8 g + 7 and
// dims from dd0.
template <int kDh>
struct Places {
  int a, b, g, dd0;
  __device__ __forceinline__ explicit Places(int t) {
    using Sh = Shape<kDh>;
    const int w = (t % kHalf) / 32, lane = t % 32;
    a = (w % (Sh::R / 64)) * 8 + lane % 8;
    b = (w / (Sh::R / 64)) * 4 + lane / 8;
    const int e = (w % (Sh::kE / 8)) * 8 + lane % 8;
    g = (w / (Sh::kE / 8)) * 4 + lane / 8;
    dd0 = e * (Sh::kMD >= 4 ? 4 : Sh::kMD);
  }
};

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads, 1)
flash_general_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ out,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ dlse, T* __restrict__ dq,
                        float* __restrict__ delta, int sq, int skv, int dh, float scale) {
  using Sh = Shape<kDh>;
  constexpr int R = Sh::R, S = Sh::S, PS = Sh::PS, kMJ = Sh::kMJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [R][S]
  float* dos = qs + R * S;           // [R][S]
  float* ks = dos + R * S;           // [2][kTile][S]
  float* vs = ks + 2 * kTile * S;    // [2][kTile][S]
  float* pds = vs + 2 * kTile * S;   // [kTile][PS]: p, then ds in place, key-major
  float* rows = pds + kTile * PS;    // lse [R], then delta [R]

  const long bh = blockIdx.y;
  const int row0 = blockIdx.x * R, nr = min(R, sq - row0);
  const long q_off = (bh * sq + row0) * dh, kv_off = bh * skv * dh;
  const int tid = threadIdx.x, prod = tid / kHalf;
  const Places<kDh> at(tid);

  stage<T, kDh, R>(qs, q + q_off, nr, dh);
  stage<T, kDh, R>(dos, dout + q_off, nr, dh);
  stage<T, kDh, kTile>(ks, k + kv_off, min(kTile, skv), dh);
  stage<T, kDh, kTile>(vs, v + kv_off, min(kTile, skv), dh);
  cp_async_commit();

  // delta = rowsum(out * dout) - dlse: a quad of threads a row, chunks 16 c + 4 j in order
  for (int row = tid / 4; row < R; row += kThreads / 4) {
    const int j = tid % 4;
    float od = 0.0f;
#pragma unroll
    for (int c = 0; c < kDh / 16; ++c) {
      const int d = 16 * c + 4 * j;
      if (row < nr && d < dh) {
        const long o = q_off + (long)row * dh + d;
        od = general::dot4(od, Elem<T>::ld4(out + o), Elem<T>::ld4(dout + o));
      }
    }
    float dl = general::quad_sum(od), row_lse = 0.0f;
    if (row < nr) {
      if (dlse != nullptr) dl -= dlse[bh * sq + row0 + row];
      row_lse = lse[bh * sq + row0 + row];
      if (j == 0) delta[bh * sq + row0 + row] = dl;
    }
    if (j == 0) {
      rows[row] = row_lse;
      rows[R + row] = dl;
    }
  }

  float acc[8][Sh::kMD] = {};  // this half's keys' share of dQ
  const int tiles = (skv + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, nk = min(kTile, skv - t * kTile);
    const float* kt = ks + buf * kTile * S;
    const float* vt = vs + buf * kTile * S;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; the gradients of tile t - 1 are done
    if (t + 1 < tiles) {
      const long o = kv_off + (long)(t + 1) * kTile * dh;
      const int n = min(kTile, skv - (t + 1) * kTile);
      stage<T, kDh, kTile>(ks + (buf ^ 1) * kTile * S, k + o, n, dh);
      stage<T, kDh, kTile>(vs + (buf ^ 1) * kTile * S, v + o, n, dh);
      cp_async_commit();
    }
    float s[8][kMJ] = {};  // S (threads 0-127) or dP (128-255)
    scores<kDh, S, kMJ, R / 8, kTile / kMJ>(s, (prod ? dos : qs) + at.a * S,
                                         (prod ? vt : kt) + at.b * S);
    // p and ds: a lane and its partner (tid +- 128, the same elements) finish half of them
    // each, rows i < 4 the S lane and rows i >= 4 the dP lane; first each hands the other
    // what it lacks, into the elements' places in the p/ds tile
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = at.a + R / 8 * (prod ? h : h + 4);
#pragma unroll
      for (int j = 0; j < kMJ; ++j)
        pds[(at.b + kTile / kMJ * j) * PS + r] = prod ? s[h][j] : s[h + 4][j];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = at.a + R / 8 * (prod ? h + 4 : h);
      const float row_lse = rows[r], dl = rows[R + r];
#pragma unroll
      for (int j = 0; j < kMJ; ++j) {
        const int key = at.b + kTile / kMJ * j;
        const float mine = prod ? s[h + 4][j] : s[h][j], other = pds[key * PS + r];
        const float p =
            key < nk ? ex2(((prod ? other : mine) * scale - row_lse) * kLog2e) : 0.0f;
        pds[key * PS + r] = Elem<T>::round(p * ((prod ? mine : other) - dl) * scale);
      }
    }
    __syncthreads();
    const int c0 = prod * (kTile / 2);
    products<kTile / 2, PS, S, Sh::kMD, Sh::kE>(acc, pds + c0 * PS + 8 * at.g,
                                                kt + c0 * S + at.dd0);
  }

  // the second half's sums into the first's, in order, through the free K tiles
  __syncthreads();
  float* part = ks;  // [8 kMD][kHalf]
  if (prod == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int m = 0; m < Sh::kMD; ++m) part[(i * Sh::kMD + m) * kHalf + tid - kHalf] = acc[i][m];
  }
  __syncthreads();
  if (prod == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int m = 0; m < Sh::kMD; ++m) acc[i][m] += part[(i * Sh::kMD + m) * kHalf + tid];
    store_rows<T, Sh::kMD, Sh::kE>(dq + q_off, acc, 8 * at.g, at.dd0, nr, dh);
  }
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads, 1)
flash_general_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int dh,
                         float scale) {
  using Sh = Shape<kDh>;
  constexpr int R = Sh::R, S = Sh::S, PS = Sh::PS, kMJ = Sh::kMJ, kStages = Sh::kDkvStages;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [R][S]
  float* vs = ks + R * S;                 // [R][S]
  float* qs = vs + R * S;                 // [kStages][kTile][S]
  float* dos = qs + kStages * kTile * S;  // [kStages][kTile][S]
  float* ps = dos + kStages * kTile * S;  // [kTile][PS]: p, query-major
  float* dss = ps + kTile * PS;           // [kTile][PS]: ds, query-major
  float* lses = dss + kTile * PS;         // [kStages][kTile]
  float* deltas = lses + kStages * kTile; // [kStages][kTile]

  const long bh = blockIdx.y;
  const int key0 = blockIdx.x * R, nk = min(R, skv - key0);
  const long q_off = bh * sq * dh, kv_off = (bh * skv + key0) * dh;
  const int tid = threadIdx.x, prod = tid / kHalf;
  const Places<kDh> at(tid);
  lse += bh * sq;
  delta += bh * sq;

  // the tile of queries from q0 into stage `buf`
  auto stage_tile = [&](int q0, int buf) {
    const int n = min(kTile, sq - q0);
    stage<T, kDh, kTile>(qs + buf * kTile * S, q + q_off + (long)q0 * dh, n, dh);
    stage<T, kDh, kTile>(dos + buf * kTile * S, dout + q_off + (long)q0 * dh, n, dh);
    stage_row(lses + buf * kTile, lse + q0, n, tid);
    stage_row(deltas + buf * kTile, delta + q0, n, tid - kTile);
    cp_async_commit();
  };
  stage<T, kDh, R>(ks, k + kv_off, nk, dh);
  stage<T, kDh, R>(vs, v + kv_off, nk, dh);
  stage_tile(0, 0);

  float acc[8][Sh::kMD] = {};  // dV (threads 0-127) or dK (128-255)
  const int tiles = (sq + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = kStages == 2 ? t & 1 : 0, nq = min(kTile, sq - t * kTile);
    const float* qt = qs + buf * kTile * S;
    const float* dot = dos + buf * kTile * S;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; the gradients of tile t - 1 are done
    if (kStages == 2 && t + 1 < tiles) stage_tile((t + 1) * kTile, buf ^ 1);
    float s[8][kMJ] = {};  // S^T (threads 0-127) or dP^T (128-255)
    scores<kDh, S, kMJ, R / 8, kTile / kMJ>(s, (prod ? vs : ks) + at.a * S,
                                         (prod ? dot : qt) + at.b * S);
    // p and ds: a lane and its partner (tid +- 128, the same elements) finish half of them
    // each, rows i < 4 the S lane and rows i >= 4 the dP lane; first each hands the other
    // what it lacks, the S lane its scores into p's places, the dP lane its dp into ds's
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = at.a + R / 8 * (prod ? h : h + 4);
#pragma unroll
      for (int j = 0; j < kMJ; ++j)
        (prod ? dss : ps)[(at.b + kTile / kMJ * j) * PS + r] = prod ? s[h][j] : s[h + 4][j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMJ; ++j) {
      const int qi = at.b + kTile / kMJ * j;
      const float row_lse = lses[buf * kTile + qi], dl = deltas[buf * kTile + qi];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int o = qi * PS + at.a + R / 8 * (prod ? h + 4 : h);
        const float mine = prod ? s[h + 4][j] : s[h][j], other = (prod ? ps : dss)[o];
        const float p =
            qi < nq ? ex2(((prod ? other : mine) * scale - row_lse) * kLog2e) : 0.0f;
        ps[o] = p;
        dss[o] = Elem<T>::round(p * ((prod ? mine : other) - dl) * scale);
      }
    }
    __syncthreads();
    products<kTile, PS, S, Sh::kMD, Sh::kE>(acc, (prod ? dss : ps) + 8 * at.g,
                                            (prod ? qt : dot) + at.dd0);
    if (kStages == 1 && t + 1 < tiles) {
      __syncthreads();  // the last read of the one stage
      stage_tile((t + 1) * kTile, 0);
    }
  }
  store_rows<T, Sh::kMD, Sh::kE>((prod ? dk : dv) + kv_off, acc, 8 * at.g, at.dd0, nk, dh);
}

bool takes(int bh, int sq, int skv, int dh) {
  return dh >= 8 && dh <= 128 && dh % 8 == 0 && bh >= 1 && bh <= 65535 && sq >= 1 && skv >= 1;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, dim3 grid, cudaStream_t stream, Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int kDh>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const void* lse, const void* dlse, void* dq, void* delta, int bh, int sq, int skv,
              int dh, float scale, cudaStream_t stream) {
  using Sh = Shape<kDh>;
  return launch(flash_general_dq_kernel<T, kDh>, Sh::kDqFloats * 4,
                dim3((sq + Sh::R - 1) / Sh::R, bh), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(out),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(dlse), static_cast<T*>(dq), static_cast<float*>(delta),
                sq, skv, dh, scale);
}

template <typename T, int kDh>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int sq, int skv, int dh,
               float scale, cudaStream_t stream) {
  using Sh = Shape<kDh>;
  return launch(flash_general_dkv_kernel<T, kDh>, Sh::kDkvFloats * 4,
                dim3((skv + Sh::R - 1) / Sh::R, bh), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, dh, scale);
}

template <typename T, int kDh>
int instance(int is_dkv, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = is_dkv ? cudaFuncGetAttributes(&a, flash_general_dkv_kernel<T, kDh>)
                                 : cudaFuncGetAttributes(&a, flash_general_dq_kernel<T, kDh>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (is_dkv ? Shape<kDh>::kDkvFloats : Shape<kDh>::kDqFloats) * 4;
  return 0;
}

// the smallest capacity (16, 32, 64, 128) that holds dh
#define ORV_BY_CAPACITY(FN, T, ...)                     \
  (dh <= 16   ? FN<T, 16>(__VA_ARGS__)                  \
   : dh <= 32 ? FN<T, 32>(__VA_ARGS__)                  \
   : dh <= 64 ? FN<T, 64>(__VA_ARGS__)                  \
              : FN<T, 128>(__VA_ARGS__))

}  // namespace

// q, out, dout, dq: [bh, sq, dh]; k, v: [bh, skv, dh], contiguous, 16-byte
// aligned, f32 if is_f32 else bf16; lse and dlse (or null): [bh, sq] f32;
// delta: [bh, sq] f32 out, rowsum(out * dout) - dlse, for the dk/dv kernel.
// dh % 8 == 0, 8 <= dh <= 128, 1 <= bh <= 65535, sq, skv >= 1 (else
// cudaErrorInvalidValue). Returns the launch's CUDA error.
extern "C" int orv_flash_attn_general_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, const void* lse,
                                             const void* dlse, void* dq, void* delta, int bh,
                                             int sq, int skv, int dh, float scale, int is_f32,
                                             void* stream) {
  if (!takes(bh, sq, skv, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? ORV_BY_CAPACITY(launch_dq, float, q, k, v, out, dout, lse, dlse, dq, delta, bh,
                                  sq, skv, dh, scale, st)
                : ORV_BY_CAPACITY(launch_dq, __nv_bfloat16, q, k, v, out, dout, lse, dlse, dq,
                                  delta, bh, sq, skv, dh, scale, st);
}

// q, dout: [bh, sq, dh]; k, v, dk, dv: [bh, skv, dh], as the dq kernel's;
// lse and delta (the dq kernel's): [bh, sq] f32. Returns the launch's CUDA
// error.
extern "C" int orv_flash_attn_general_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int bh,
                                              int sq, int skv, int dh, float scale, int is_f32,
                                              void* stream) {
  if (!takes(bh, sq, skv, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? ORV_BY_CAPACITY(launch_dkv, float, q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                  skv, dh, scale, st)
                : ORV_BY_CAPACITY(launch_dkv, __nv_bfloat16, q, k, v, dout, lse, delta, dk, dv,
                                  bh, sq, skv, dh, scale, st);
}

// The instance a dq (is_dkv 0) or dk/dv (1) launch at head dim dh takes:
// out[0] its registers a thread, out[1] its local memory a thread in bytes
// (spills and stack), out[2] its dynamic shared memory a block in bytes.
// Returns cudaErrorInvalidValue for a head dim the kernels do not take.
extern "C" int orv_flash_attn_general_bwd_info(int dh, int is_f32, int is_dkv, void* out) {
  if (!takes(1, 1, 1, dh)) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  return is_f32 ? ORV_BY_CAPACITY(instance, float, is_dkv, o)
                : ORV_BY_CAPACITY(instance, __nv_bfloat16, is_dkv, o);
}
