// Fused adaLN modulate backward for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_mn_bwd_kernel (:105,
// pallas_call at :152). For x and dout [R, S, D] bf16, w = ns * (1 +
// scale[r]) and xhat the normalized row, every token row computes in f32
//   g = dout * w,  dx = bf16(inv * (g - mean(g) - xhat * mean(g * xhat)))
// and each row group r the sums over its S rows
//   A[r] = sum_S dout,  B[r] = sum_S dout * xhat        (f32 [R, 2, D])
// from which the caller derives dscale, dshift, dns and dnb ([R, D] algebra,
// plain PyTorch, as the JAX package leaves it to XLA).
//
// Bound on the H100: bytes (read x and dout, write dx: 34.6 MB at the
// training shape [5, 600, 1920]). The kernel is adaln_bwd_sm90.cuh's in
// Mode::kModulateNorm: a persistent cooperative grid over tiles of rows of
// one row group, x and dout through a ring of 1-D bulk copies, dx out by
// bulk stores, A and B summed in registers a row-group segment and the
// segments' partials added in a fixed order after a grid sync, in the same
// launch.

#include "adaln_bwd_sm90.cuh"

namespace {

using adaln_bwd::Mode;

template <int kHeld>
__global__ void __launch_bounds__(adaln_bwd::block_threads(Mode::kModulateNorm), 1)
modulate_norm_bwd_kernel(const __grid_constant__ adaln_bwd::Params p) {
  adaln_bwd::run<Mode::kModulateNorm, kHeld>(p);
}

// the instance for rows of d columns: as many chunks of 128 held in
// registers as the row has, up to kCache
template <int... kI>
adaln_bwd::Kernel kernel_of(int d, std::integer_sequence<int, kI...>) {
  const adaln_bwd::Kernel kernels[] = {modulate_norm_bwd_kernel<kI + 1>...};
  const int nv = d / 128;
  return kernels[(nv < adaln_bwd::kCache ? nv : adaln_bwd::kCache) - 1];
}

adaln_bwd::Kernel kernel_for(int d) {
  return kernel_of(d, std::make_integer_sequence<int, adaln_bwd::kCache>());
}

}  // namespace

// limits[0]: the most rows a tile of d columns may have; limits[1]: the
// blocks that fit on the current device at once. d % 128 == 0 and d <= 4096
// (else cudaErrorInvalidValue). Returns the CUDA error.
extern "C" int orv_modulate_norm_bwd_limits(int d, void* limits) {
  if (!adaln_bwd::takes_width(Mode::kModulateNorm, d)) return (int)cudaErrorInvalidValue;
  return adaln_bwd::limits(Mode::kModulateNorm, kernel_for(d), d, static_cast<int*>(limits));
}

// x, dout, dx: [r, s, d] bf16 contiguous, 16-byte aligned, d % 128 == 0 and
// d <= 4096; scale: [r, d] with row stride sc_stride (bf16 if sc_bf16 else
// f32); ns: [d] (bf16 if n_bf16 else f32). rows and grid: the wrapper's
// plan from orv_modulate_norm_bwd_limits on this device; part: [grid + r -
// 1, 2, d] f32 scratch; ab: [r, 2, d] f32 out (A, then B). Returns the
// launch's CUDA error.
extern "C" int orv_modulate_norm_bwd(const void* x, const void* dout, const void* scale,
                                     long sc_stride, const void* ns, void* dx, void* part,
                                     void* ab, int r, int s, int d, int rows, int grid, float eps,
                                     int sc_bf16, int n_bf16, void* stream) {
  if (!adaln_bwd::takes_width(Mode::kModulateNorm, d)) return (int)cudaErrorInvalidValue;
  const adaln_bwd::Params p{(const bf16*)x, (const bf16*)dout, (bf16*)dx, (float*)part,
                            (float*)ab, scale, sc_stride, ns, eps, sc_bf16, n_bf16, r, s, d,
                            0, 0, 0};
  return adaln_bwd::launch(Mode::kModulateNorm, kernel_for(d), p, rows, grid, stream);
}
