// Fused adaLN-Zero gated residual for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_gate_kernel (pallas_call at
// adaln.py:280, `gated_residual`): out = x + gate[r] * y for x, y [R, S, D]
// and a per-row gate [R, D], f32 math with the product and the sum each
// rounded once, the gate never broadcast to [R, S, D] in memory. The gate
// may be bf16 or f32 and a row-strided view.
//
// Two instances, each bound on the H100 by bytes (read x and y, write out;
// one multiply and one add an element):
// - bf16 (orv_gated_residual, the Hopper route; ~90 MB at the flagship
//   video shape [13, 600, 1920]): a grid-stride loop over 16-byte vectors (8
//   bf16), consecutive threads on consecutive addresses; the gate row comes
//   from L2 (it is re-read by all S rows of its frame).
// - f32 (orv_gated_residual_f32, the general route: an f32 model,
//   train.mixed_precision=no, calls the gate there, which the JAX kernel
//   takes in any dtype; 69 MB at the f32 fine-tune's [5, 600, 1920]). A
//   thread owns one float4 column chunk c of one row group r: it loads and
//   converts gate[r, c .. c + 3] once, then walks the rows s0, s0 + m,
//   s0 + 2m, ... of r (the group's m * D / 4 threads sweep its rows as one
//   grid-stride loop whose stride is a multiple of the row, so a thread's
//   column never changes and no index is divided inside the loop). It issues
//   kF32Rows rows' loads of x and y before any arithmetic, reads x and y
//   with streaming loads and writes out with streaming stores (nothing
//   reads them again here). The grid is one wave: m is the most rows a step
//   that keeps R * m * D / 4 threads within the blocks the card holds at
//   once (occupancy calculator, asked once a device), so every thread walks
//   ceil(S / m) or one fewer rows and no second, partial wave follows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float ld(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// eight consecutive elements (one 16-byte vector of bf16) as f32, and back
// with one rounding each
template <typename T>
struct Vec8;

template <>
struct Vec8<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
__global__ void __launch_bounds__(256)
gated_residual_kernel(const T* __restrict__ x, const T* __restrict__ y, const void* gate,
                      long g_stride, T* __restrict__ out, long n_vec, long row_elems, int d,
                      int g_bf16) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += (long)gridDim.x * blockDim.x) {
    const long e = i * 8;
    const long r = e / row_elems;
    const int c = (int)(e % d);
    float xs[8], ys[8], os[8];
    Vec8<T>::load(x + e, xs);
    Vec8<T>::load(y + e, ys);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // separate rounding of the product, as the plain version computes it
      const float gy = __fmul_rn(ld(gate, r * g_stride + c + j, g_bf16), ys[j]);
      os[j] = __fadd_rn(xs[j], gy);
    }
    Vec8<T>::store(out + e, os);
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* gate, long g_stride, void* out, int r, int s,
           int d, int g_bf16, void* stream) {
  const long n_vec = (long)r * s * d / 8;
  long blocks = (n_vec + 255) / 256;
  if (blocks > 132L * 16) blocks = 132L * 16;  // grid-stride: 16 blocks per SM
  if (blocks < 1) blocks = 1;
  gated_residual_kernel<T><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)y, gate, g_stride, (T*)out, n_vec, (long)s * d, d, g_bf16);
  return (int)cudaGetLastError();
}

// ---- the f32 instance ----

constexpr int kF32Threads = 256;
constexpr int kF32MinBlocks = 4;  // blocks a multiprocessor: at most 64 registers a thread
constexpr int kF32Rows = 4;       // rows whose x and y loads a thread issues at once

// kF32Rows (or, kGuard, the rows below s of them) rows row, row + m, ... of
// one column chunk: the loads first, then out = x + gate * y
template <bool kGuard>
__device__ __forceinline__ void gr_f32_rows(const float4* __restrict__ x,
                                            const float4* __restrict__ y, float4* __restrict__ out,
                                            const float (&g)[4], int row, int m, int s, int d4) {
  float4 a[kF32Rows], b[kF32Rows];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i)
    if (!kGuard || row + i * m < s) {
      const long at = (long)(row + i * m) * d4;
      a[i] = __ldcs(x + at);
      b[i] = __ldcs(y + at);
    }
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i)
    if (!kGuard || row + i * m < s) {
      // separate rounding of the product, as the plain version computes it
      const float4 o = make_float4(
          __fadd_rn(a[i].x, __fmul_rn(g[0], b[i].x)), __fadd_rn(a[i].y, __fmul_rn(g[1], b[i].y)),
          __fadd_rn(a[i].z, __fmul_rn(g[2], b[i].z)), __fadd_rn(a[i].w, __fmul_rn(g[3], b[i].w)));
      __stcs(out + (long)(row + i * m) * d4, o);
    }
}

// thread t of the grid: row group t / (m d4), column chunk t % d4, rows from
// (t % (m d4)) / d4 on in steps of m
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
gr_general_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y, const void* gate,
                      long g_stride, float* __restrict__ out, int r, int s, int d4, int m,
                      int g_bf16) {
  const long t = (long)blockIdx.x * kF32Threads + threadIdx.x, per_group = (long)m * d4;
  const int group = (int)(t / per_group);
  if (group >= r) return;
  const int j = (int)(t - group * per_group), row0 = j / d4, c4 = j - row0 * d4;
  float g[4];
  const long go = group * g_stride + 4L * c4;
  if (g_bf16) {
    const bf16* gp = static_cast<const bf16*>(gate) + go;
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = __bfloat162float(gp[e]);
  } else {
    const float* gp = static_cast<const float*>(gate) + go;
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = gp[e];
  }
  const long base = (long)group * s * d4 + c4;  // float4 (group, row 0, c4)
  const float4* xg = reinterpret_cast<const float4*>(x) + base;
  const float4* yg = reinterpret_cast<const float4*>(y) + base;
  float4* og = reinterpret_cast<float4*>(out) + base;
  int row = row0;
  for (; row + (kF32Rows - 1) * m < s; row += kF32Rows * m)
    gr_f32_rows<false>(xg, yg, og, g, row, m, s, d4);
  if (row < s) gr_f32_rows<true>(xg, yg, og, g, row, m, s, d4);
}

// The f32 instance's launch at [r, s, d] on a card that holds `resident`
// threads at once: m rows a step (threads a column chunk of a row group) and
// the threads, r * m * d / 4. A thread walks k = ceil(s / m) rows or one
// fewer; k is the fewest that keeps the threads within `resident` (adaln.py's
// gated_residual_f32_plan mirrors this).
struct GrF32Plan {
  int m;
  long threads;
};

GrF32Plan gr_f32_plan(int r, int s, int d, long resident) {
  const long d4 = d / 4, total = (long)r * s * d4;
  if (r * d4 >= resident) return GrF32Plan{1, r * d4};  // a row a step: several waves
  long k = (total + resident - 1) / resident;
  long m = (s + k - 1) / k;
  while (k < s && r * m * d4 > resident) {
    ++k;
    m = (s + k - 1) / k;
  }
  return GrF32Plan{(int)m, r * m * d4};
}

constexpr int kMaxDevices = 64;
std::atomic<int> g_f32_resident[kMaxDevices];  // by device: blocks it holds at once

// *blocks = the f32 kernel's blocks the current device holds at once: its
// multiprocessors times the occupancy calculator's blocks a multiprocessor,
// asked once a device. Returns the CUDA error.
int gr_f32_resident(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && (*blocks = g_f32_resident[dev].load(std::memory_order_relaxed)) > 0)
    return 0;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gr_general_fwd_kernel,
                                                        kF32Threads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) g_f32_resident[dev].store(*blocks, std::memory_order_relaxed);
  return 0;
}

}  // namespace

// x, y, out: [r, s, d] bf16 contiguous, d % 8 == 0; gate: [r, d] with row
// stride g_stride (bf16 if g_bf16 else f32). Returns the launch's CUDA error.
extern "C" int orv_gated_residual(const void* x, const void* y, const void* gate, long g_stride,
                                  void* out, int r, int s, int d, int g_bf16, void* stream) {
  return launch<bf16>(x, y, gate, g_stride, out, r, s, d, g_bf16, stream);
}

// The f32 instance: x, y, out [r, s, d] f32 contiguous, 16-byte aligned,
// d % 8 == 0, r, s >= 1 (else cudaErrorInvalidValue); gate as
// orv_gated_residual's. Returns the launch's CUDA error.
extern "C" int orv_gated_residual_f32(const void* x, const void* y, const void* gate,
                                      long g_stride, void* out, int r, int s, int d, int g_bf16,
                                      void* stream) {
  if (r < 1 || s < 1 || d < 8 || d % 8) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const int err = gr_f32_resident(&resident);
  if (err) return err;
  const GrF32Plan p = gr_f32_plan(r, s, d, (long)resident * kF32Threads);
  const long blocks = (p.threads + kF32Threads - 1) / kF32Threads;
  gr_general_fwd_kernel<<<(unsigned)blocks, kF32Threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), gate, g_stride,
      static_cast<float*>(out), r, s, d / 4, p.m, g_bf16);
  return (int)cudaGetLastError();
}

// The f32 instance's launch at [r, s, d] on the current card: out[0] its
// registers a thread, out[1] its local memory a thread in bytes (spills and
// stack), out[2] its dynamic shared memory a block in bytes (none), out[3]
// the blocks the card holds at once, out[4] m (rows a step), out[5] the
// blocks launched. Returns the CUDA error (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int orv_gated_residual_f32_info(int r, int s, int d, void* out) {
  if (r < 1 || s < 1 || d < 8 || d % 8) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, gr_general_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  const int rerr = gr_f32_resident(&resident);
  if (rerr) return rerr;
  const GrF32Plan p = gr_f32_plan(r, s, d, (long)resident * kF32Threads);
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  o[2] = 0;
  o[3] = resident;
  o[4] = p.m;
  o[5] = (int)((p.threads + kF32Threads - 1) / kF32Threads);
  return 0;
}
