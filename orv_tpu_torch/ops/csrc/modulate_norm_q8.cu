// Fused adaLN modulate emitting the W8A8 activation quantization, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_kernel_q8 (pallas_call at
// adaln.py:219, `modulate_norm_q8`). Every token row of x [R, S, D] computes
// the modulated f32 row y exactly as modulate_norm.cu does, then quantizes it
// per token for the int8 projections that follow:
//   amax = max(max|y|, 1e-6)
//   xq = int8(round_half_even(y * (127 / amax)))      [R, S, D]
//   xscale = amax * (1/127)                            [R, S] f32
//
// Bound on the H100: bytes (read x, 30 MB bf16, write xq, 15 MB, and xscale
// at the flagship shape [13, 600, 1920]). The kernel is adaln_fwd_sm90.cuh's
// in OutMode::kQ8: modulate_norm.cu's pipeline, with y of a row's first kCache
// chunks of 128 columns kept in registers between the amax pass and the
// quantizing pass.

#include "adaln_fwd_sm90.cuh"

namespace {

template <int kHeld>
__global__ void __launch_bounds__(adaln_sm90::kThreads, 1)
modulate_norm_q8_kernel(const __grid_constant__ adaln_sm90::Params p) {
  adaln_sm90::adaln_fwd<adaln_sm90::OutMode::kQ8, kHeld>(p);
}

template <int kHeld>
adaln_sm90::Kernel kernel() {
  return modulate_norm_q8_kernel<kHeld>;
}

template <int... kI>
adaln_sm90::Kernels kernels(std::integer_sequence<int, kI...>) {
  return {kernel<kI + 1>()...};
}

}  // namespace

// x: [r, s, d] bf16 contiguous, 16-byte aligned, d % 128 == 0 and d <= 4096
// (else cudaErrorInvalidValue); xq: [r, s, d] int8 contiguous; xscale:
// [r, s] f32 contiguous. scale, shift, ns, nb as in orv_modulate_norm.
// Returns the launch's CUDA error.
extern "C" int orv_modulate_norm_q8(const void* x, const void* scale, const void* shift,
                                    long ss_stride, const void* ns, const void* nb, void* xq,
                                    void* xscale, int r, int s, int d, float eps, int ss_bf16,
                                    int n_bf16, void* stream) {
  const adaln_sm90::Params p{(const bf16*)x, scale, shift, ss_stride, ns, nb, xq,
                             (float*)xscale, s, eps, ss_bf16, n_bf16, 0, 0, 0};
  return adaln_sm90::launch(kernels(adaln_sm90::kHeldCounts), p, r, d, stream);
}
