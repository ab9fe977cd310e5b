// Static-max flash attention forward with an int8 QK^T product, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/attention.py:_fwd_kernel_q8
// (pallas_call at attention.py:267), the W8A8 serving model's joint
// text+video attention. The host (`prepare_k_q8` in ops/attention.py, as
// `_fwd_q8` does in XLA) mean-smooths k and quantizes it to int8 with one
// scale per (batch*head, block_k keys); this kernel computes, per query row
// i of one (batch, head):
//   q_i   = bf16(q_i * scale)                      (pre-scaled in q's dtype)
//   sq_i  = max(max|q_i|, 1e-6);  q8_i = round_half_even(q_i * (127/sq_i))
//   s_ij  = f32(q8_i . k8_j  in int32) * ((sq_i * (1/127)) * sk_r[j / block_k])
//   p_ij  = exp(s_ij - static_max)                 (f32; j >= kv_len -> 0)
//   l_i   = sum_j p_ij                             (f32 p, before rounding)
//   o_i   = (sum_j bf16(p_ij) * v_j) / l_i         (f32 accumulate, one rounding)
// with l_i == 0 -> 1. There is no lse output: nothing consumes it on this
// path (the smoothing would shift it per query by q . mean(k) anyway).
//
// Bound on the H100: operations. At the flagship shape ([1,30,8026,64]) QK^T
// is 2*S^2*D*H = 2.47e11 int8 ops and PV as many bf16 FLOP, against ~108 MB
// of q/k8/v/o. The kernel is flash_fwd_sm90.cuh's TMA + wgmma design in
// Mode::kQ8: each consumer thread quantizes its own rows of q into the
// register A fragments of an s8 wgmma (m64n128k32, s32 accumulators); int8
// K tiles arrive by TMA (64-byte rows, 64-byte swizzle) into the same
// mbarrier ring as the bf16 V tiles; the scores are scaled in registers,
// one key-block scale per 128-key tile; P.V is the bf16 modes' wgmma.

#include "flash_fwd_sm90.cuh"

namespace {

__global__ void __launch_bounds__(flash_sm90::kThreads, 1)
flash_fwd_q8_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const flash_sm90::Params prm) {
  flash_sm90::flash_fwd<flash_sm90::Mode::kQ8>(nullptr, &tk, &tv, prm);
}

}  // namespace

// q, o: [bh, sq, 64] bf16; k8: [bh, skv_pad, 64] int8 (mean-smoothed keys,
// zero past skv); sk_r: [bh, n_kblocks] f32, the scale of keys
// [j*block_k, (j+1)*block_k) over 127; v: [bh, skv, 64] bf16. All
// contiguous and 16-byte aligned; block_k % 128 == 0 (a 128-key tile lies
// in one scale block) and skv <= skv_pad = n_kblocks * block_k, else
// cudaErrorInvalidValue. Returns the CUDA error of the launch, or
// flash_sm90::kErrTensorMap + the CUresult of a failed tensor-map encoding.
extern "C" int orv_flash_attn_q8(const void* q, const void* k8, const void* sk_r, const void* v,
                                 void* o, int bh, int sq, int skv, int skv_pad, int block_k,
                                 int n_kblocks, float scale, float static_max, void* stream) {
  if (block_k <= 0 || block_k % flash_sm90::kBK != 0 || skv > skv_pad ||
      skv_pad != n_kblocks * block_k)
    return (int)cudaErrorInvalidValue;
  const flash_sm90::Params prm{(__nv_bfloat16*)o, nullptr, (const __nv_bfloat16*)q,
                               (const float*)sk_r, sq, skv, n_kblocks, block_k / flash_sm90::kBK,
                               scale, static_max};
  return flash_sm90::launch<flash_sm90::Mode::kQ8>(flash_fwd_q8_kernel, k8, skv_pad, v, bh, prm,
                                                   stream);
}
