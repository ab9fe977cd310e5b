// Online-softmax flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel orv_tpu/ops/attention.py:_fwd_kernel (pallas_call
// at attention.py:353 with static_max=None): the forward of every attention
// op whose logits have no known bound (flash_attention's default, ring
// attention without qk-norm, JointAttention(qk_norm=False)). It computes,
// per query row i of one (batch, head), walking the keys in tiles t:
//   q_i   = bf16(q_i * scale)                     (pre-scaled in q's dtype)
//   s_ij  = f32(q_i . k_j)                        (keys j >= kv_len masked)
//   m_new = max(m, max_j s_ij)                    (masked keys never enter)
//   alpha = exp(m - m_new)
//   p_ij  = exp(s_ij - m_new)                     (f32; masked -> 0)
//   l     = l * alpha + sum_j p_ij                (f32 p, before rounding)
//   o     = o * alpha + sum_j bf16(p_ij) * v_j    (f32 accumulate)
// and at the end out_i = o / l_safe, lse_i = m + log(l_safe) (l == 0 -> 1),
// with m starting at -1e30 as in the TPU kernel. Sq and Skv may differ.
//
// Bound on the H100: operations (4*Sq*Skv*D*H FLOP; 4.95e11 at
// [1,30,8026,64]). The kernel is flash_fwd_sm90.cuh's TMA + wgmma design
// in Mode::kOnline: the running max is a per-thread max over the
// accumulator's columns and two shuffles, and O is rescaled by alpha in
// the registers that hold it.

#include "flash_fwd_sm90.cuh"

namespace {

__global__ void __launch_bounds__(flash_sm90::kThreads, 1)
flash_fwd_online_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const flash_sm90::Params prm) {
  flash_sm90::flash_fwd<flash_sm90::Mode::kOnline>(&tq, &tk, &tv, prm);
}

}  // namespace

// q: [bh, sq, 64], k, v: [bh, skv, 64], o: [bh, sq, 64], all bf16 contiguous
// and 16-byte aligned; lse: [bh, sq] f32. Returns the CUDA error of the
// launch (0 on success).
extern "C" int orv_flash_attn_online(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int bh, int sq, int skv, float scale,
                                     void* stream) {
  const flash_sm90::Params prm{(__nv_bfloat16*)o, (float*)lse, (const __nv_bfloat16*)q,
                               nullptr, sq, skv, 0, 0, scale, 0.0f};
  return flash_sm90::launch<flash_sm90::Mode::kOnline>(flash_fwd_online_kernel, k, skv, v, bh,
                                                       prm, stream);
}
