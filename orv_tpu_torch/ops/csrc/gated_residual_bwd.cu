// Fused adaLN-Zero gated residual backward for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_gr_bwd_kernel (:298,
// pallas_call at :328). For the forward out = x + gate[r] * y over
// [R, S, D], given dout and y [R, S, D] bf16:
//   dy = bf16(gate[r] * dout)                (f32 product, one rounding)
//   dgate[r] = sum_S dout * y                (f32 [R, D])
// and dx = dout, which the caller passes on without a kernel.
//
// Bound on the H100: bytes (read dout and y, write dy: 34.6 MB at the video
// stream's [5, 600, 1920], 2.6 MB at the text stream's [1, 226, 1920]). The
// kernel is adaln_bwd_sm90.cuh's in Mode::kGatedResidual: a persistent
// cooperative grid over tiles of rows of one row group, dout and y through a
// ring of 1-D bulk copies, dy out by bulk stores, each consumer thread's
// columns' gate and sums in registers, the row-group segments' partials
// added in a fixed order after a grid sync, in the same launch. The gate may
// be bf16 or f32 and a row-strided view.

#include "adaln_bwd_sm90.cuh"

namespace {

using adaln_bwd::Mode;

template <int kVecs>
__global__ void __launch_bounds__(adaln_bwd::block_threads(Mode::kGatedResidual), 1)
gated_residual_bwd_kernel(const __grid_constant__ adaln_bwd::Params p) {
  adaln_bwd::run<Mode::kGatedResidual, kVecs>(p);
}

// the instance for rows of d columns: ceil(d / 2048) vectors a thread
template <int... kI>
adaln_bwd::Kernel kernel_of(int d, std::integer_sequence<int, kI...>) {
  const adaln_bwd::Kernel kernels[] = {gated_residual_bwd_kernel<kI + 1>...};
  return kernels[(d + 2047) / 2048 - 1];
}

adaln_bwd::Kernel kernel_for(int d) {
  return kernel_of(d, std::make_integer_sequence<int, adaln_bwd::kMaxVecs>());
}

}  // namespace

// limits[0]: the most rows a tile of d columns may have; limits[1]: the
// blocks that fit on the current device at once. d % 8 == 0 and d <= 16384
// (else cudaErrorInvalidValue). Returns the CUDA error.
extern "C" int orv_gated_residual_bwd_limits(int d, void* limits) {
  if (!adaln_bwd::takes_width(Mode::kGatedResidual, d)) return (int)cudaErrorInvalidValue;
  return adaln_bwd::limits(Mode::kGatedResidual, kernel_for(d), d, static_cast<int*>(limits));
}

// dout, y, dy: [r, s, d] bf16 contiguous, 16-byte aligned, d % 8 == 0 and
// d <= 16384; gate: [r, d] with row stride g_stride (bf16 if g_bf16 else
// f32). rows and grid: the wrapper's plan from orv_gated_residual_bwd_limits
// on this device; part: [grid + r - 1, d] f32 scratch; dgate: [r, d] f32
// out. Returns the launch's CUDA error.
extern "C" int orv_gated_residual_bwd(const void* dout, const void* y, const void* gate,
                                      long g_stride, void* dy, void* part, void* dgate, int r,
                                      int s, int d, int rows, int grid, int g_bf16,
                                      void* stream) {
  if (!adaln_bwd::takes_width(Mode::kGatedResidual, d)) return (int)cudaErrorInvalidValue;
  const adaln_bwd::Params p{(const bf16*)dout, (const bf16*)y, (bf16*)dy, (float*)part,
                            (float*)dgate, gate, g_stride, nullptr, 0.0f, g_bf16, 0, r, s, d,
                            0, 0, 0};
  return adaln_bwd::launch(Mode::kGatedResidual, kernel_for(d), p, rows, grid, stream);
}
