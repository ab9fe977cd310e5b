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
// Bound on the H100: bytes (a few f32 operations an element). Design, simple
// first: a warp a row for the row passes (the row read again from L1 for the
// variance and the output, lanes on consecutive 16-byte chunks); the sums
// over S in two more launches, a thread a column summing a chunk of rows in
// order into a partial, then each column's partials added in chunk order: no
// atomics, the same bits from run to run. Scratch comes from the wrapper.

#include "general.cuh"

namespace {

using general::Elem;
using general::ld_param;

constexpr int kWarps = 8;          // rows a block in the row passes
constexpr int kColThreads = 256;   // columns a block in the column passes
constexpr int kSumThreads = 256;   // outputs a block in the chunk sums

template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ xr, int d, int lane, float eps,
                                          float& mean, float& inv) {
  float sum = 0.0f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 x = Elem<T>::ld4(xr + c);
    sum += (x.x + x.y) + (x.z + x.w);
  }
  mean = general::warp_sum(sum) / d;
  float sq = 0.0f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 x = Elem<T>::ld4(xr + c);
    const float a = x.x - mean, b = x.y - mean, e = x.z - mean, f = x.w - mean;
    sq = fmaf(f, f, fmaf(e, e, fmaf(b, b, fmaf(a, a, sq))));
  }
  inv = rsqrtf(general::warp_sum(sq) / d + eps);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mn_general_fwd_kernel(const T* __restrict__ x, const void* scale, const void* shift,
                      long v_stride, const void* ns, const void* nb, T* __restrict__ out,
                      long rows, int s, int d, float eps, int v_bf16, int n_bf16) {
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp
  const T* xr = x + row * d;
  const long vrow = (row / s) * v_stride;
  float mean, inv;
  row_stats(xr, d, lane, eps, mean, inv);
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 xv = Elem<T>::ld4(xr + c);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = (xs[e] - mean) * inv;
      y = y * ld_param(ns, c + e, n_bf16) + ld_param(nb, c + e, n_bf16);
      o[e] = y * (1.0f + ld_param(scale, vrow + c + e, v_bf16)) +
             ld_param(shift, vrow + c + e, v_bf16);
    }
    Elem<T>::st4(out + row * d + c, make_float4(o[0], o[1], o[2], o[3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mn_general_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                           const void* scale, long v_stride, const void* ns, T* __restrict__ dx,
                           float2* __restrict__ stat, long rows, int s, int d, float eps,
                           int v_bf16, int n_bf16) {
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + row * d;
  const T* dr = dout + row * d;
  const long vrow = (row / s) * v_stride;
  float mean, inv;
  row_stats(xr, d, lane, eps, mean, inv);
  const auto w_at = [&](int c) {
    return ld_param(ns, c, n_bf16) * (1.0f + ld_param(scale, vrow + c, v_bf16));
  };
  float gsum = 0.0f, gxsum = 0.0f;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 xv = Elem<T>::ld4(xr + c), dv = Elem<T>::ld4(dr + c);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ds[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float g = ds[e] * w_at(c + e);
      gsum += g;
      gxsum = fmaf(g, (xs[e] - mean) * inv, gxsum);
    }
  }
  const float gm = general::warp_sum(gsum) / d, gxm = general::warp_sum(gxsum) / d;
  for (int c = 4 * lane; c < d; c += 128) {
    const float4 xv = Elem<T>::ld4(xr + c), dv = Elem<T>::ld4(dr + c);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, ds[4] = {dv.x, dv.y, dv.z, dv.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xh = (xs[e] - mean) * inv;
      o[e] = inv * ((ds[e] * w_at(c + e) - gm) - xh * gxm);
    }
    Elem<T>::st4(dx + row * d + c, make_float4(o[0], o[1], o[2], o[3]));
  }
  if (lane == 0) stat[row] = make_float2(mean, inv);
}

// part[r, chunk, 0 | 1, c]: sum of dout and of dout * xhat over the chunk's rows
template <typename T>
__global__ void __launch_bounds__(kColThreads)
mn_general_bwd_cols_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                           const float2* __restrict__ stat, float* __restrict__ part, int s,
                           int d, int chunk_rows) {
  const int c = blockIdx.x * kColThreads + threadIdx.x, chunk = blockIdx.y, r = blockIdx.z;
  if (c >= d) return;
  const int s0 = chunk * chunk_rows, s1 = min(s, s0 + chunk_rows);
  float a = 0.0f, b = 0.0f;
  for (int i = s0; i < s1; ++i) {
    const long row = (long)r * s + i;
    const float2 st = stat[row];
    const float g = Elem<T>::ld(dout + row * d + c);
    a += g;
    b = fmaf(g, (Elem<T>::ld(x + row * d + c) - st.x) * st.y, b);
  }
  float* out = part + ((long)r * gridDim.y + chunk) * 2 * d;
  out[c] = a;
  out[d + c] = b;
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

bool takes(int r, int s, int d, int chunk_rows) {
  return r >= 1 && r <= 65535 && s >= 1 && d >= 8 && d % 8 == 0 && chunk_rows >= 1 &&
         (s + chunk_rows - 1) / chunk_rows <= 65535;
}

dim3 row_grid(long rows) { return dim3((unsigned)((rows + kWarps - 1) / kWarps)); }

dim3 col_grid(int r, int s, int d, int chunk_rows) {
  return dim3((d + kColThreads - 1) / kColThreads, (s + chunk_rows - 1) / chunk_rows, r);
}

int chunk_sums(const float* part, float* sums, int r, int width, int n_chunks, cudaStream_t st) {
  const long n = (long)r * width;
  general_chunk_sums_kernel<<<(unsigned)((n + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                              st>>>(part, sums, r, width, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int mn_bwd(const void* x, const void* dout, const void* scale, long v_stride, const void* ns,
           void* dx, void* stat, void* part, void* ab, int r, int s, int d, int chunk_rows,
           float eps, int v_bf16, int n_bf16, cudaStream_t st) {
  const long rows = (long)r * s;
  mn_general_bwd_rows_kernel<T><<<row_grid(rows), kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), scale, v_stride, ns,
      static_cast<T*>(dx), static_cast<float2*>(stat), rows, s, d, eps, v_bf16, n_bf16);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid = col_grid(r, s, d, chunk_rows);
  mn_general_bwd_cols_kernel<T><<<grid, kColThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const float2*>(stat),
      static_cast<float*>(part), s, d, chunk_rows);
  err = (int)cudaGetLastError();
  if (err) return err;
  return chunk_sums(static_cast<const float*>(part), static_cast<float*>(ab), r, 2 * d, grid.y,
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
// ns, nb: [d] (bf16 if n_bf16 else f32). r, s >= 1, d % 8 == 0 (else
// cudaErrorInvalidValue). Returns the launch's CUDA error.
extern "C" int orv_modulate_norm_general(const void* x, const void* scale, const void* shift,
                                         long v_stride, const void* ns, const void* nb, void* out,
                                         int r, int s, int d, float eps, int v_bf16, int n_bf16,
                                         int is_f32, void* stream) {
  if (!takes(r, s, d, 1)) return (int)cudaErrorInvalidValue;
  const long rows = (long)r * s;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    mn_general_fwd_kernel<float><<<row_grid(rows), kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), scale, shift, v_stride, ns, nb, static_cast<float*>(out),
        rows, s, d, eps, v_bf16, n_bf16);
  else
    mn_general_fwd_kernel<__nv_bfloat16><<<row_grid(rows), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), scale, shift, v_stride, ns, nb,
        static_cast<__nv_bfloat16*>(out), rows, s, d, eps, v_bf16, n_bf16);
  return (int)cudaGetLastError();
}

// x, dout, dx: [r, s, d] as modulate_norm's x; scale: [r, d] with row stride
// v_stride; ns: [d]. Scratch: stat [r * s] float2, part [r, ceil(s /
// chunk_rows), 2, d] f32. ab: [r, 2, d] f32 out (A, then B). Three launches
// (rows, column chunks, chunk sums). Returns the first CUDA error.
extern "C" int orv_modulate_norm_bwd_general(const void* x, const void* dout, const void* scale,
                                             long v_stride, const void* ns, void* dx, void* stat,
                                             void* part, void* ab, int r, int s, int d,
                                             int chunk_rows, float eps, int v_bf16, int n_bf16,
                                             int is_f32, void* stream) {
  if (!takes(r, s, d, chunk_rows)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? mn_bwd<float>(x, dout, scale, v_stride, ns, dx, stat, part, ab, r, s, d,
                                chunk_rows, eps, v_bf16, n_bf16, st)
                : mn_bwd<__nv_bfloat16>(x, dout, scale, v_stride, ns, dx, stat, part, ab, r, s,
                                        d, chunk_rows, eps, v_bf16, n_bf16, st);
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
