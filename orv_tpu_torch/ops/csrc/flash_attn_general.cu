// General flash attention forward for Hopper (sm_90a): f32 or bf16, any head
// dim that is a multiple of 8 up to 128, any Sq and Skv.
//
// Replaces the TPU kernels orv_tpu/ops/attention.py:_fwd_kernel (:62, the
// online softmax) and _fwd_kernel_static_max (:124) wherever the Hopper
// kernel (flash_fwd_sm90.cuh: bf16 at head dim 64) does not take the
// operands: the JAX kernels take any dtype and any lane-tileable head dim,
// and an f32 model (train.mixed_precision=no) or a narrow one (the PAB
// harness's heads of 16) calls them there. One template, its mode a flag
// (kOnline), instantiated for T in {float, bf16} and for head-dim
// capacities 16, 32, 64 and 128; a launch takes the smallest capacity that
// holds its head dim, the dims past it zeros.
//
// Arithmetic, as flash_attention_plain (ops/attention.py): q pre-scaled in T
// (q * T(scale), rounded to T); s = f32 q . k; the static mode takes
// p = exp(s - static_max), the online mode a running row max m with the
// accumulator rescaled by exp(m_old - m_new) once a key tile; the
// denominator sums the f32 p, the PV product takes p rounded to T; out =
// acc / l (l = 0 -> 1) rounded to T, lse = m + log(l), exact in f32.
//
// Bound on the H100: operations. An f32 product has no tensor-core path that
// keeps f32's 24-bit mantissa (TF32 keeps 10 and cannot meet the f32
// tolerance), so both products run as f32 FMAs on the CUDA cores: 4 Sq Skv
// Dh operations a head at 67 TFLOP/s.
//
// Design: register tiling, as the backward's (flash_attn_general_bwd.cu,
// whose header counts the shared-memory words an FMA needs: every float a
// lane reads must feed 4 of its FMAs, so a lane's tile of a product is
// 8 x 8). A block of 256 threads owns R query rows (256, or 128 at capacity
// 128; where that grid would leave multiprocessors without a block, as the
// ring's 226 queries do, the fewest rows whose lane tiles stay 8 x 2: 4096 /
// Dh, 64 at capacity 128) in shared memory in f32, q scaled and rounded on
// the way in, and walks 64-key tiles of K and V, double-buffered (one stage
// at capacity 128 and 128 rows): f32 tiles land by 16-byte cp.async,
// zero-filled past the keys and dims that exist, while the block works on
// the tile before; bf16 tiles are widened to f32 by the threads on the way
// in. A tile is three steps with a barrier after each:
// - the scores: a lane computes an 8 x kMJ tile of S = Q K^T (8 x 8 at 256
//   rows, 8 x 4 at 128, 8 x 2 at 64), own rows a + R/8 i and keys
//   b + 64/kMJ j, lane % 8 picking a and lane / 8 b, so that a quarter-warp
//   reads 8 consecutive rows of Q (distinct bank groups: rows are padded to
//   Dh + 4 floats) and one key of K (a broadcast); each summed over d in
//   order, no shuffle. It stores them into a [key][row] P tile (rows padded
//   to R + 8 floats, so that a warp's 32 stores fall on 32 banks);
// - the rows: thread t < R owns query row t for the whole walk (its m and l
//   in registers) and reads its column of the P tile, consecutive threads
//   consecutive words: the tile max and the rescale alpha (online mode),
//   then p = exp(s - m) over the 64 keys in order (0 past the tile's keys),
//   l = l alpha + p in key order, p rounded to T back into its place, alpha
//   into a [R] slice. The row max and the denominator cost no shuffles and
//   keep a fixed order;
// - P V: a lane owns 8 consecutive rows x kMD dims of O in registers for the
//   whole walk (R Dh / 2048: 8 at capacity 64 and 256 rows), rescales
//   them by their rows' alpha (online mode) and adds the tile's keys in
//   order; a quarter-warp reads one key's 8 p (a broadcast) and 8
//   consecutive float4 chunks of its V row.
// At the end the row threads write lse and l, and each lane divides its O
// block by its rows' l. Each output is summed in a fixed order: no atomics,
// the same bits from run to run.
//
// Shared memory a block (f32; rows of Dh + 4 floats, P 64 x (R + 8), alpha
// and l [R] each):
//
//   cap. | R   | Q      + stages x 2 x 64 x (Dh + 4) + P      + alpha, l = total
//   16   | 256 | 20,480 + 2 x 10,240                 + 67,584 + 2,048    = 110,592
//   32   | 256 | 36,864 + 2 x 18,432                 + 67,584 + 2,048    = 143,360
//   64   | 256 | 69,632 + 2 x 34,816                 + 67,584 + 2,048    = 208,896
//   128  | 128 | 67,584 + 1 x 67,584                 + 34,816 + 1,024    = 171,008
//   32   | 128 | 18,432 + 2 x 18,432                 + 34,816 + 1,024    =  91,136
//   64   | 64  | 17,408 + 2 x 34,816                 + 18,432 +   512    = 105,984
//   128  | 64  | 33,792 + 2 x 67,584                 + 18,432 +   512    = 187,904
//
// in bytes, of Hopper's 232,448 a block (capacity 128 with two stages at 128
// rows would need 238,592). One block a multiprocessor (two at 64 rows of
// capacity 64): at the f32 training shape [1,30,3226,64], 13 row blocks x 30
// heads = 390 blocks, 2.95 waves of the H100's 132 multiprocessors; the
// ring's [1,30,226,64] x 1950, 120 blocks of 64 rows.

#include "general.cuh"

namespace {

using general::cp_async_commit;
using general::cp_async_wait_all;
using general::Elem;
using general::ex2;

constexpr int kThreads = 256;
constexpr int kTile = 64;  // keys a tile
constexpr int kPad = 4;    // floats padding a Q, K or V row
constexpr int kSmemBlock = 232448;  // dynamic shared memory a block may take
constexpr int kSmemSm = 233472;     // shared memory of a multiprocessor
constexpr float kLog2e = 1.4426950408889634f;

// rows a block at a capacity: where the grid fills the card, and where it
// does not (the fewest rows whose lane tiles still cover 8 x 2)
__host__ __device__ constexpr int full_rows(int dh) { return dh <= 64 ? 256 : 128; }
__host__ __device__ constexpr int few_rows(int dh) { return dh <= 64 ? 4096 / dh : 64; }

// The tiling of one capacity at R rows a block: a lane's 8 x kMJ score tile
// and 8 x kMD output tile, kE lanes across the dims; two stages of K and V
// where they fit, and two blocks a multiprocessor (128 registers a thread)
// where the tiles are 8 x 2 and the shared memory fits (8 x 4 score tiles
// spilled at 128 registers).
template <int kDh, int kR>
struct Shape {
  static constexpr int R = kR;
  static constexpr int S = kDh + kPad;  // stride of a Q, K or V row
  static constexpr int PS = R + 8;      // stride of a P row
  static constexpr int kMJ = R * kTile / (8 * kThreads);
  static constexpr int kMD = R * kDh / (8 * kThreads);
  static constexpr int kE = kDh / kMD;
  static constexpr int floats(int stages) {
    return R * S + stages * 2 * kTile * S + kTile * PS + 2 * R;
  }
  static constexpr int kStages = floats(2) * 4 <= kSmemBlock ? 2 : 1;
  static constexpr int kFloats = floats(kStages);
  static constexpr int kBlocks = kMJ == 2 && 2 * (kFloats * 4 + 1024) <= kSmemSm ? 2 : 1;
  static_assert(kMD == 2 || kMD == 4 || kMD == 8, "a lane's dims: a float2 or float4 chunks");
  static_assert(kE % 8 == 0 && R / 8 * kE == kThreads && R / 8 * (kTile / kMJ) == kThreads,
                "the lanes cover each product's tile once");
};

static_assert(Shape<16, 256>::kFloats * 4 == 110592 && Shape<32, 256>::kFloats * 4 == 143360 &&
                  Shape<64, 256>::kFloats * 4 == 208896 &&
                  Shape<128, 128>::kFloats * 4 == 171008 &&
                  Shape<32, 128>::kFloats * 4 == 91136 && Shape<64, 64>::kFloats * 4 == 105984 &&
                  Shape<128, 64>::kFloats * 4 == 187904,
              "the header's table");

template <typename T, int kDh, bool kOnline, int kR>
__global__ void __launch_bounds__(kThreads, (Shape<kDh, kR>::kBlocks))
flash_general_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                         int sq, int skv, int dh, float scale, float static_max) {
  using Sh = Shape<kDh, kR>;
  constexpr int R = Sh::R, S = Sh::S, PS = Sh::PS, kMJ = Sh::kMJ, kMD = Sh::kMD, kE = Sh::kE;
  constexpr int kStages = Sh::kStages;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [R][S]
  float* ks = qs + R * S;               // [kStages][kTile][S]
  float* vs = ks + kStages * kTile * S; // [kStages][kTile][S]
  float* pt = vs + kStages * kTile * S; // [kTile][PS]: s, then p in place, key-major
  float* alphas = pt + kTile * PS;      // [R]
  float* ls = alphas + R;               // [R]

  const long bh = blockIdx.y;
  const int row0 = blockIdx.x * R, nr = min(R, sq - row0);
  const long q_off = (bh * sq + row0) * dh, kv_off = bh * skv * dh;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  // the scores' own rows a + R/8 i and keys b + kTile/kMJ j
  const int a = (w % (R / 64)) * 8 + lane % 8, b = (w / (R / 64)) * 4 + lane / 8;
  // P V's own rows 8 g .. 8 g + 7 and dims from dd0
  const int e = (w % (kE / 8)) * 8 + lane % 8, g = (w / (kE / 8)) * 4 + lane / 8;
  const int dd0 = e * (kMD >= 4 ? 4 : kMD);

  const auto stage_tile = [&](int t, int buf) {
    const long o = kv_off + (long)t * kTile * dh;
    const int n = min(kTile, skv - t * kTile);
    general::stage<T, kDh, kTile, S, kThreads>(ks + buf * kTile * S, k + o, n, dh);
    general::stage<T, kDh, kTile, S, kThreads>(vs + buf * kTile * S, v + o, n, dh);
    cp_async_commit();
  };
  stage_tile(0, 0);
  {  // q * T(scale), rounded to T, zeros past the rows and dims that exist
    constexpr int kChunks = kDh / 4;
    const float qscale = Elem<T>::round(scale);
#pragma unroll
    for (int round = 0; round < R * kChunks / kThreads; ++round) {
      const int i = round * kThreads + tid, r = i / kChunks, d = (i % kChunks) * 4;
      float4 x = general::zero4();
      if (r < nr && d < dh) x = Elem<T>::ld4(q + q_off + (long)r * dh + d);
      *reinterpret_cast<float4*>(qs + r * S + d) =
          make_float4(Elem<T>::round(x.x * qscale), Elem<T>::round(x.y * qscale),
                      Elem<T>::round(x.z * qscale), Elem<T>::round(x.w * qscale));
    }
  }

  float o[8][kMD] = {};                                // O, rows 8 g + i
  float m = kOnline ? -INFINITY : static_max, l = 0.0f;  // row tid's (tid < R)
  const int tiles = (skv + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int buf = kStages == 2 ? t & 1 : 0, nk = min(kTile, skv - t * kTile);
    const float* kt = ks + buf * kTile * S;
    const float* vt = vs + buf * kTile * S;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; P V of tile t - 1 is done
    if (kStages == 2 && t + 1 < tiles) stage_tile(t + 1, buf ^ 1);
    float s[8][kMJ] = {};
    general::scores<kDh, S, kMJ, R / 8, kTile / kMJ>(s, qs + a * S, kt + b * S);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kMJ; ++j) pt[(b + kTile / kMJ * j) * PS + a + R / 8 * i] = s[i][j];
    __syncthreads();
    if (tid < R) {  // row tid: its max, p in key order, l
      float* col = pt + tid;
      float m_new = m;
      if (kOnline) {
#pragma unroll
        for (int key = 0; key < kTile; ++key)
          if (key < nk) m_new = fmaxf(m_new, col[key * PS]);
      }
      const float alpha = kOnline ? ex2((m - m_new) * kLog2e) : 1.0f;  // 0 on the first tile
      if (kOnline) l *= alpha;
#pragma unroll
      for (int key = 0; key < kTile; ++key) {
        const float p = key < nk ? ex2((col[key * PS] - m_new) * kLog2e) : 0.0f;
        l += p;
        col[key * PS] = Elem<T>::round(p);
      }
      m = m_new;
      if (kOnline) alphas[tid] = alpha;
    }
    __syncthreads();
    if (kOnline) {
      const float4 a0 = *reinterpret_cast<const float4*>(alphas + 8 * g);
      const float4 a1 = *reinterpret_cast<const float4*>(alphas + 8 * g + 4);
      const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kMD; ++c) o[i][c] *= al[i];
    }
    general::products<kTile, PS, S, kMD, kE>(o, pt + 8 * g, vt + dd0);
    if (kStages == 1 && t + 1 < tiles) {
      __syncthreads();  // the last read of the one stage
      stage_tile(t + 1, 0);
    }
  }

  if (tid < R) {
    const float l_safe = l == 0.0f ? 1.0f : l;
    ls[tid] = l_safe;
    if (tid < nr) lse[bh * sq + row0 + tid] = m + logf(l_safe);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float li = ls[8 * g + i];
#pragma unroll
    for (int c = 0; c < kMD; ++c) o[i][c] = o[i][c] / li;
  }
  general::store_rows<T, kMD, kE>(out + q_off, o, 8 * g, dd0, nr, dh);
}

template <typename T, int kDh, bool kOnline, int kR>
int launch_rows(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq,
                int skv, int dh, float scale, float static_max, cudaStream_t stream) {
  using Sh = Shape<kDh, kR>;
  const auto kernel = flash_general_fwd_kernel<T, kDh, kOnline, kR>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kFloats * 4);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((sq + kR - 1) / kR, bh), kThreads, Sh::kFloats * 4, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), sq, skv, dh, scale, static_max);
  return (int)cudaGetLastError();
}

// full_rows a block where that gives every multiprocessor a block, else
// few_rows (the ring's [1,30,226,64] x 1950: 120 blocks of 64 rows, not 30
// of 256)
template <typename T, int kDh, bool kOnline>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int sq,
           int skv, int dh, float scale, float static_max, cudaStream_t stream) {
  constexpr int kFull = full_rows(kDh), kFew = few_rows(kDh);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return (long)bh * ((sq + kFull - 1) / kFull) >= sms
             ? launch_rows<T, kDh, kOnline, kFull>(q, k, v, out, lse, bh, sq, skv, dh, scale,
                                                   static_max, stream)
             : launch_rows<T, kDh, kOnline, kFew>(q, k, v, out, lse, bh, sq, skv, dh, scale,
                                                  static_max, stream);
}

// the instance a grid that fills the card takes (full_rows a block)
template <typename T, int kDh, bool kOnline>
int instance(int* out) {
  constexpr int kR = full_rows(kDh);
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, flash_general_fwd_kernel<T, kDh, kOnline, kR>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = Shape<kDh, kR>::kFloats * 4;
  return 0;
}

bool takes(int bh, int sq, int skv, int dh) {
  return dh >= 8 && dh <= 128 && dh % 8 == 0 && bh >= 1 && bh <= 65535 && sq >= 1 && skv >= 1;
}

// FN's instance for the element type, the smallest capacity (16, 32, 64,
// 128) that holds dh, and the mode
#define ORV_FWD_INSTANCE(FN, ...)                                                 \
  (is_f32 ? (online ? ORV_FWD_BY_CAPACITY(FN, float, true, __VA_ARGS__)           \
                    : ORV_FWD_BY_CAPACITY(FN, float, false, __VA_ARGS__))         \
          : (online ? ORV_FWD_BY_CAPACITY(FN, __nv_bfloat16, true, __VA_ARGS__)   \
                    : ORV_FWD_BY_CAPACITY(FN, __nv_bfloat16, false, __VA_ARGS__)))
#define ORV_FWD_BY_CAPACITY(FN, T, M, ...)  \
  (dh <= 16   ? FN<T, 16, M>(__VA_ARGS__)   \
   : dh <= 32 ? FN<T, 32, M>(__VA_ARGS__)   \
   : dh <= 64 ? FN<T, 64, M>(__VA_ARGS__)   \
              : FN<T, 128, M>(__VA_ARGS__))

}  // namespace

// q, out: [bh, sq, dh]; k, v: [bh, skv, dh], contiguous, 16-byte aligned, f32
// if is_f32 else bf16; lse: [bh, sq] f32 out. dh % 8 == 0 and 8 <= dh <= 128,
// 1 <= bh <= 65535, sq >= 1, skv >= 1 (else cudaErrorInvalidValue). online:
// the running-max softmax, else exp(s - static_max). Returns the launch's
// CUDA error.
extern "C" int orv_flash_attn_general(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int bh, int sq, int skv, int dh, float scale,
                                      float static_max, int online, int is_f32, void* stream) {
  if (!takes(bh, sq, skv, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return ORV_FWD_INSTANCE(launch, q, k, v, out, lse, bh, sq, skv, dh, scale, static_max, st);
}

// The instance a launch at head dim dh in f32 (is_f32) or bf16 and the mode
// (online) takes where its grid fills the card: out[0] its registers a
// thread, out[1] its local memory a thread in bytes (spills and stack),
// out[2] its dynamic shared memory a block in bytes. Returns
// cudaErrorInvalidValue for a head dim the kernel does not take.
extern "C" int orv_flash_attn_general_info(int dh, int is_f32, int online, void* out) {
  if (!takes(1, 1, 1, dh)) return (int)cudaErrorInvalidValue;
  return ORV_FWD_INSTANCE(instance, static_cast<int*>(out));
}
