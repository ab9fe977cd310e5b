// Fused adaLN modulate (LayerNorm + norm affine + per-row modulation), bf16
// out, for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/adaln.py:_kernel (pallas_call at
// adaln.py:85, `modulate_norm`). For x [R, S, D] and per-row scale/shift
// [R, D] (row r = batch*frame), every token row computes in f32:
//   mean = sum(x)/D,  var = sum((x - mean)^2)/D        (two passes)
//   y = (x - mean) * rsqrt(var + eps) * ns + nb
//   out = bf16(y * (1 + scale[r]) + shift[r])
//
// Bound on the H100: bytes (read x, write out: ~60 MB at the flagship shape
// [13, 600, 1920]). The kernel is adaln_fwd_sm90.cuh's in OutMode::kBf16: a
// persistent grid over tiles of kRows rows of one row group, x through a ring
// of 1-D bulk copies, the norm and modulation coefficients in shared memory.

#include "adaln_fwd_sm90.cuh"

namespace {

template <int kHeld>
__global__ void __launch_bounds__(adaln_sm90::kThreads, 1)
modulate_norm_kernel(const __grid_constant__ adaln_sm90::Params p) {
  adaln_sm90::adaln_fwd<adaln_sm90::OutMode::kBf16, kHeld>(p);
}

template <int kHeld>
adaln_sm90::Kernel kernel() {
  return modulate_norm_kernel<kHeld>;
}

template <int... kI>
adaln_sm90::Kernels kernels(std::integer_sequence<int, kI...>) {
  return {kernel<kI + 1>()...};
}

}  // namespace

// x, out: [r, s, d] bf16 contiguous, 16-byte aligned, d % 128 == 0 and
// d <= 4096 (else cudaErrorInvalidValue). scale, shift: [r, d] with row
// stride ss_stride (bf16 if ss_bf16 else f32); ns, nb: [d] (bf16 if n_bf16
// else f32). Returns the launch's CUDA error.
extern "C" int orv_modulate_norm(const void* x, const void* scale, const void* shift,
                                 long ss_stride, const void* ns, const void* nb, void* out,
                                 int r, int s, int d, float eps, int ss_bf16, int n_bf16,
                                 void* stream) {
  const adaln_sm90::Params p{(const bf16*)x, scale, shift, ss_stride, ns, nb, out, nullptr,
                             s, eps, ss_bf16, n_bf16, 0, 0, 0};
  return adaln_sm90::launch(kernels(adaln_sm90::kHeldCounts), p, r, d, stream);
}
