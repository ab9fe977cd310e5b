"""Joint text+video attention: the flash forwards, their backward, and the
dispatchers.

Counterpart of `orv_tpu/ops/attention.py`. Layout at the public functions is
[B, H, S, D]. Three forwards:

* bf16 online softmax (`_fwd_kernel`, attention.py:62), the default of every
  public op, as in the JAX package (`static_max=None`): a running row max
  and an accumulator rescale, so any logits are safe.
  `flash_attention_online_kernel` launches `csrc/flash_attn_online.cu`.
* bf16 static max (`_fwd_kernel_static_max`, attention.py:124), for callers
  that pass a logit bound: the DiT qk-LayerNorms every head, so its logits
  are bounded and `static_max=24.0` (`QK_NORM_LOGIT_BOUND`) replaces the
  running max. Launches `csrc/flash_attn_static_max.cu`.
  `flash_attention` picks one of the two by `static_max` on a CUDA tensor
  (or raises), and runs `flash_attention_plain` on a CPU tensor. Returns
  (out, lse), both differentiable (the counterpart of `_flash_lse`,
  attention.py:601): a `torch.autograd.Function` saves (q, k, v, out, lse)
  and its backward is `flash_attention_bwd`, whose dq and dk/dv kernels
  (`_bwd_dq_kernel`, attention.py:389, `_bwd_dkv_kernel`, :432) live in
  `csrc/flash_attn_bwd.cu`. Both forwards emit an exact lse, so one
  backward serves both. The lse cotangent, where there is one, shifts the
  backward's delta term; where lse is unused it is None and costs nothing.
* int8 QK^T, the W8A8 serving model's (`_fwd_kernel_q8`, attention.py:174,
  host prep in `_fwd_q8`, :237): `prepare_k_q8` mean-smooths k and
  quantizes it per (batch*head, 1024-key block) in plain PyTorch, as XLA
  does it outside the TPU kernel; `flash_attention_q8` then launches
  `csrc/flash_attn_q8.cu` (the third mode of the bf16 forwards' TMA +
  wgmma kernel, with an s8 wgmma Q.K^T) on a CUDA tensor or raises, and runs
  `flash_attention_q8_plain` on a CPU tensor. Returns out only: the
  inference-only kernel has no lse and no backward: it raises under grad
  mode when an input requires grad.

`mha_reference`, `attention` and `attention_with_lse` are the JAX package's
dispatchers (attention.py:49, :663, :678); `impl="auto"` is "flash" on a
CUDA tensor and "xla" (the plain reference) on a CPU one.

Each kernel counts its launches in `<wrapper>.launches` (the static-max
forward in `flash_attention.launches`, the online one in
`flash_attention_online_kernel.launches`); the `*_plain` functions are the
kernels' oracles and the CPU path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from orv_tpu_torch.ops import _build
from orv_tpu_torch.ops.quant import quantize_tokens, refuse_grad

# qk-LayerNorm bounds attention logits (|s| <= |q||k|/sqrt(d) with unit-var
# rows times learned gains); 24.0 leaves ample headroom (orv_tpu layers.py:28).
QK_NORM_LOGIT_BOUND = 24.0


def flash_attention_plain(q, k, v, scale: Optional[float] = None,
                          static_max: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward in plain PyTorch: returns (out [B,H,Sq,D] in q's
    dtype, lse [B,H,Sq] f32). q is pre-scaled in its own dtype; p = exp(s -
    m) with m the row max (`static_max=None`, the online kernel's) or the
    given bound; the denominator sums the f32 p, the PV product takes p
    rounded to v's dtype. The global row max agrees with the kernel's running
    max to within one rounding of p to v's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    if static_max is None:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        m = m.squeeze(-1)
    else:
        m = float(static_max)
        p = torch.exp(s - m)
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def mha_reference(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """[B,H,S,D] reference attention (attention.py:49): f32 logits of the
    inputs' values, f32 softmax, probabilities rounded to q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype)


def _check_qkv(name, q, k, v):
    """Raise unless the attention kernels take q, k, v."""
    for n, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned bf16 "
                             f"tensors on one device; {n} is {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if q.dim() != 4 or q.shape[-1] != 64:
        raise ValueError(f"{name} kernel takes [B,H,S,64]; got q {tuple(q.shape)}")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[-1] != D:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_ONLINE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_online_kernel(q, k, v, scale: float):
    """One launch of the online-softmax forward on checked CUDA q [B,H,Sq,64]
    and k, v [B,H,Skv,64]: returns (out, lse). Counted in
    `flash_attention_online_kernel.launches`."""
    B, H, S, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_flash_attn_online", _ONLINE_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B * H, S, k.shape[2], float(scale), stream)
    _build.check(err, "flash_attention_online_kernel")
    _build.count(flash_attention_online_kernel)
    return out, lse


flash_attention_online_kernel.launches = 0


def _flash_forward(q, k, v, scale: float, static_max: Optional[float]):
    """(out, lse): `flash_attention_plain` on the CPU; on CUDA the online
    kernel for `static_max=None`, else the static-max kernel (counted in
    `flash_attention.launches`)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, static_max)
    if static_max is None:
        return flash_attention_online_kernel(q, k, v, scale)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_flash_attn_static_max", _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B * H, S, k.shape[2], float(scale), float(static_max), stream)
    _build.check(err, "flash_attention")
    _build.count(flash_attention)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with the flash backward; the JAX package's `_flash_lse`.
    Both forwards emit an exact lse, so the backward is the same for both."""

    @staticmethod
    def forward(ctx, q, k, v, scale, static_max):
        out, lse = _flash_forward(q, k, v, scale, static_max)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.set_materialize_grads(False)  # an unused lse brings no cotangent
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale,
                                         None if dlse is None else dlse.contiguous())
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale: Optional[float] = None,
                    static_max: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over q [B, H, Sq, D] and k, v [B, H, Skv, D]: returns
    (out, lse), differentiable in q, k, v through the flash backward.
    `static_max=None` (the default, as in the JAX package) runs the online
    softmax; a logit bound runs the cheaper static-max forward, which is
    only right where the logits stay below it.

    CPU tensors run `flash_attention_plain` (and `flash_attention_bwd_plain`
    backward). CUDA tensors must be bf16, contiguous, with D == 64; anything
    else raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.device.type == "cuda":
        _check_qkv("flash_attention", q, k, v)
    return _FlashAttention.apply(q, k, v, float(scale),
                                 None if static_max is None else float(static_max))


flash_attention.launches = 0


def _resolve_impl(impl: str, q: torch.Tensor) -> str:
    """"auto" -> "flash" on a CUDA tensor, "xla" (the plain reference) on a
    CPU one; the JAX package picks by backend (attention.py:668-669)."""
    if impl == "auto":
        return "flash" if q.device.type == "cuda" else "xla"
    if impl not in ("flash", "flash_q8", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return impl


def attention(q, k, v, scale: Optional[float] = None, impl: str = "auto",
              static_max: Optional[float] = None) -> torch.Tensor:
    """Attention out [B, H, Sq, D] (attention.py:663): "flash" is
    `flash_attention` (online softmax unless `static_max` is given),
    "flash_q8" the int8-QK^T kernel with `static_max` defaulting to 24.0,
    "xla" `mha_reference`."""
    impl = _resolve_impl(impl, q)
    if impl == "flash":
        return flash_attention(q, k, v, scale, static_max=static_max)[0]
    if impl == "flash_q8":
        return flash_attention_q8(q, k, v, scale,
                                  static_max=static_max if static_max else QK_NORM_LOGIT_BOUND)
    return mha_reference(q, k, v, scale)


def attention_with_lse(q, k, v, scale: Optional[float] = None, impl: str = "auto",
                       static_max: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention that also returns the per-row logsumexp [B, H, Sq], the
    statistic ring attention merges partial results by (attention.py:678).

    "flash" and "flash_q8" both run the bf16 `flash_attention`, differentiable
    in out and lse: the int8-QK^T kernel has no lse, and the O(S^2) reference
    would defeat the ring. `static_max` picks the static-max forward (lse
    stays exact). "xla" computes the exact lse in plain PyTorch."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    impl = _resolve_impl(impl, q)
    if impl in ("flash", "flash_q8"):
        return flash_attention(q, k, v, scale, static_max=static_max)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(), v.float()).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale: Optional[float] = None,
                              dlse: Optional[torch.Tensor] = None):
    """The flash backward in plain PyTorch, with the TPU kernels' rounding
    (attention.py:404-425, :453-480): returns (dq, dk, dv) in the dtypes of
    q, k, v. p = exp(f32(q . k) * scale - lse); delta = rowsum(f32(o * dO)),
    minus dlse where given; dp = f32(dO . v); ds = p * (dp - delta) * scale;
    dq and dk take ds rounded to q's dtype, dv the f32 p."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, do = q.float(), k.float(), dout.float()
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale - lse.float()[..., None])
    delta = (out.float() * do).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float()[..., None]
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, v.float()) - delta) * scale
    ds_r = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds_r, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds_r, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, out, lse, dout, dlse):
    """Raise unless the backward kernels take these operands."""
    _check_qkv("flash_attention_bwd", q, k, v)
    _check_qkv("flash_attention_bwd", q, out, dout)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} do not match q {tuple(q.shape)}")
    for n, t in (("lse", lse), ("dlse", dlse)):
        if t is not None and (t.device != q.device or t.dtype != torch.float32
                              or t.shape != q.shape[:3] or not t.is_contiguous()):
            raise ValueError(f"flash_attention_bwd takes a contiguous f32 {n} of shape "
                             f"{tuple(q.shape[:3])}; got {t.dtype} {tuple(t.shape)}")


_BWD_DQ_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
_BWD_DKV_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_bwd_dq(q, k, v, out, lse, dout, scale: float, dlse=None) -> torch.Tensor:
    """dq of the flash backward: one launch of the dq kernel on checked CUDA
    operands (counted in `flash_attention_bwd_dq.launches`)."""
    B, H, S, _ = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_flash_attn_bwd_dq", _BWD_DQ_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), _ptr(dlse), dq.data_ptr(), B * H, S, k.shape[2], float(scale),
            stream)
    _build.check(err, "flash_attention_bwd_dq")
    _build.count(flash_attention_bwd_dq)
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, scale: float, dlse=None):
    """(dk, dv) of the flash backward: one launch of the dk/dv kernel on
    checked CUDA operands (counted in `flash_attention_bwd_dkv.launches`)."""
    B, H, S, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_flash_attn_bwd_dkv", _BWD_DKV_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), _ptr(dlse), dk.data_ptr(), dv.data_ptr(), B * H, S, k.shape[2],
            float(scale), stream)
    _build.check(err, "flash_attention_bwd_dkv")
    _build.count(flash_attention_bwd_dkv)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, scale: Optional[float] = None,
                        dlse: Optional[torch.Tensor] = None):
    """The flash backward (`_bwd_impl`, attention.py:492): (dq, dk, dv).

    CPU tensors run `flash_attention_bwd_plain`. CUDA tensors launch the dq
    and dk/dv kernels: q, k, v, out, dout contiguous bf16 [B, H, S, 64], lse
    (and dlse, if given) contiguous f32 [B, H, S]; anything else raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, dlse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check_bwd(q, k, v, out, lse, dout, dlse)
    dq = flash_attention_bwd_dq(q, k, v, out, lse, dout, scale, dlse)
    dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, dout, scale, dlse)
    return dq, dk, dv


def _pick_block(n: int, preferred: int = 1024, align: int = 128) -> int:
    """The reference's block choice (attention.py:635): `preferred` for
    n >= preferred, else one block of n rounded up to `align`."""
    return preferred if n >= preferred else max(align, -(-n // align) * align)


def prepare_k_q8(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """k [B, H, Skv, D] -> (k8 int8 [B, H, Skv_pad, D], sk_r f32 [B*H, nk],
    block_k): k minus its per-head token mean (in k's dtype), zero-padded to
    nk blocks of `block_k` keys, one absmax scale per (b*h, block) clamped
    at 1e-6, k8 = round_half_even(k * (127/scale)) and sk_r = scale / 127
    (the host prep of `_fwd_q8`, attention.py:250-259)."""
    B, H, Skv, D = k.shape
    block_k = _pick_block(Skv)
    nk = -(-Skv // block_k)
    k = k - k.mean(dim=2, keepdim=True)
    kb = torch.nn.functional.pad(k, (0, 0, 0, nk * block_k - Skv)).reshape(
        B * H, nk, block_k, D).float()
    sk = kb.abs().amax(dim=(2, 3)).clamp_min(1e-6)
    # a true division: torch's `127.0 / t` is t.reciprocal() * 127, which rounds twice
    k8 = torch.round(kb * (torch.tensor(127.0) / sk)[:, :, None, None]).to(torch.int8)
    return k8.reshape(B, H, nk * block_k, D), sk / 127.0, block_k


def flash_attention_q8_plain(q, k, v, scale: Optional[float] = None,
                             static_max: float = QK_NORM_LOGIT_BOUND) -> torch.Tensor:
    """The int8-QK^T forward in plain PyTorch: returns out [B, H, S, D] in
    q's dtype. q is pre-scaled in its own dtype and quantized per token
    (sq = max(max|q|, 1e-6), q8 = round(q * (127/sq))); the score is
    f32(q8 . k8) * ((sq * (1/127)) * sk_r[key block]); p = exp(s -
    static_max) over the first Skv keys; the denominator sums the f32 p,
    the PV product takes p rounded to v's dtype."""
    B, H, S, D = q.shape
    Skv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k8, sk_r, block_k = prepare_k_q8(k)
    q8, sq_r = quantize_tokens(q * torch.tensor(scale, dtype=q.dtype))
    # |q8 . k8| <= 64 * 127^2 < 2^24: the f32 product of the int8 values is exact
    s = torch.einsum("bhqd,bhkd->bhqk", q8.float(), k8[:, :, :Skv].float())
    sk_r = sk_r.reshape(B, H, -1)
    for j in range(sk_r.shape[-1]):
        s[..., j * block_k:(j + 1) * block_k] *= (sq_r * sk_r[..., j, None])[..., None]
    p = s.sub_(static_max).exp_()
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype)


_Q8_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]


def flash_attention_q8(q, k, v, scale: Optional[float] = None,
                       static_max: float = QK_NORM_LOGIT_BOUND) -> torch.Tensor:
    """int8-QK^T static-max flash attention over [B, H, S, D]: returns out.

    CPU tensors run `flash_attention_q8_plain`. CUDA tensors must be bf16,
    contiguous, with D == 64; anything else raises. `prepare_k_q8` runs on
    the host side in plain PyTorch before the launch. Inference only: raises
    under grad mode when q, k or v requires grad."""
    refuse_grad("flash_attention_q8", q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_q8_plain(q, k, v, scale, static_max)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_q8: unsupported device {q.device}")
    _check_qkv("flash_attention_q8", q, k, v)
    return flash_attention_q8_kernel(q, prepare_k_q8(k), v, k.shape[2], scale, static_max)


flash_attention_q8.launches = 0


def _check_k_prep(q, k_prep, skv: int) -> None:
    """Raise unless `k_prep` is what `prepare_k_q8` gives for q's heads and a
    k of `skv` keys. The kernel takes one k scale per 128-key tile, so
    block_k must be a multiple of 128."""
    k8, sk_r, block_k = k_prep
    if block_k <= 0 or block_k % 128:
        raise ValueError(f"flash_attention_q8_kernel: block_k must be a positive multiple of "
                         f"128 (a 128-key tile takes one k scale); got {block_k}")
    B, H = q.shape[:2]
    nk = -(-skv // block_k)
    if (k8.dtype != torch.int8 or tuple(k8.shape) != (B, H, nk * block_k, 64)
            or sk_r.dtype != torch.float32 or tuple(sk_r.shape) != (B * H, nk)
            or not (k8.is_contiguous() and sk_r.is_contiguous())
            or k8.device != q.device or sk_r.device != q.device):
        raise ValueError(f"flash_attention_q8_kernel: k_prep must be prepare_k_q8 of a k of "
                         f"{skv} keys: k8 int8 {(B, H, nk * block_k, 64)} and sk_r f32 "
                         f"{(B * H, nk)}, contiguous on {q.device}; got k8 {k8.dtype} "
                         f"{tuple(k8.shape)}, sk_r {sk_r.dtype} {tuple(sk_r.shape)}")


def flash_attention_q8_kernel(q, k_prep, v, skv: int, scale: float,
                              static_max: float = QK_NORM_LOGIT_BOUND) -> torch.Tensor:
    """The launch of `flash_attention_q8` on checked CUDA q, v and
    `k_prep = prepare_k_q8(k)` for a k of `skv` keys (counted in
    `flash_attention_q8.launches`). Separate so the kernel can be timed
    without the host prep. Raises before any launch on a `k_prep` the
    kernel does not take (`_check_k_prep`) or on a tensor not on CUDA."""
    _check_k_prep(q, k_prep, skv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_q8_kernel launches a CUDA kernel; q is on {q.device}")
    k8, sk_r, block_k = k_prep
    B, H, S, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_flash_attn_q8", _Q8_ARGS)(
            q.data_ptr(), k8.data_ptr(), sk_r.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, S, skv, k8.shape[2], block_k, sk_r.shape[1], float(scale),
            float(static_max), stream)
    _build.check(err, "flash_attention_q8")
    _build.count(flash_attention_q8)
    return out
