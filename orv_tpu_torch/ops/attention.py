"""Joint text+video attention: the static-max flash forwards.

Counterpart of `orv_tpu/ops/attention.py`. The DiT qk-LayerNorms every
head, so its logits are bounded and the forward uses a fixed softmax max
(`static_max=24.0`) instead of a running one. Layout at the public
functions is [B, H, S, D]. Two forwards:

* bf16 (`_fwd_kernel_static_max`, attention.py:124): `flash_attention`
  launches `csrc/flash_attn_static_max.cu` on a CUDA tensor or raises, and
  runs `flash_attention_plain` on a CPU tensor. Returns (out, lse).
* int8 QK^T, the W8A8 serving model's (`_fwd_kernel_q8`, attention.py:174,
  host prep in `_fwd_q8`, :237): `prepare_k_q8` mean-smooths k and
  quantizes it per (batch*head, 1024-key block) in plain PyTorch, as XLA
  does it outside the TPU kernel; `flash_attention_q8` then launches
  `csrc/flash_attn_q8.cu` on a CUDA tensor or raises, and runs
  `flash_attention_q8_plain` on a CPU tensor. Returns out only: the
  inference-only kernel has no lse.

Each wrapper counts its kernel launches in `<wrapper>.launches`; the
`*_plain` functions are the kernels' oracles and the CPU path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from orv_tpu_torch.ops import _build
from orv_tpu_torch.ops.quant import quantize_tokens

# qk-LayerNorm bounds attention logits (|s| <= |q||k|/sqrt(d) with unit-var
# rows times learned gains); 24.0 leaves ample headroom (orv_tpu layers.py:28).
QK_NORM_LOGIT_BOUND = 24.0


def flash_attention_plain(q, k, v, scale: Optional[float] = None,
                          static_max: float = QK_NORM_LOGIT_BOUND
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The static-max forward in plain PyTorch: returns (out [B,H,S,D] in
    q's dtype, lse [B,H,S] f32). q is pre-scaled in its own dtype; the
    denominator sums the f32 p, the PV product takes p rounded to v's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    p = torch.exp(s - static_max)
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype), static_max + torch.log(l_safe)


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


def flash_attention(q, k, v, scale: Optional[float] = None,
                    static_max: float = QK_NORM_LOGIT_BOUND
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-max flash attention over [B, H, S, D]: returns (out, lse).

    CPU tensors run `flash_attention_plain`. CUDA tensors must be bf16,
    contiguous, with D == 64; anything else raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, static_max)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_qkv("flash_attention", q, k, v)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_flash_attn_static_max", _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B * H, S, k.shape[2], float(scale), float(static_max), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


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
    the host side in plain PyTorch before the launch."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_q8_plain(q, k, v, scale, static_max)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_q8: unsupported device {q.device}")
    _check_qkv("flash_attention_q8", q, k, v)
    return flash_attention_q8_kernel(q, prepare_k_q8(k), v, k.shape[2], scale, static_max)


flash_attention_q8.launches = 0


def flash_attention_q8_kernel(q, k_prep, v, skv: int, scale: float,
                              static_max: float = QK_NORM_LOGIT_BOUND) -> torch.Tensor:
    """The launch of `flash_attention_q8` on checked CUDA q, v and
    `k_prep = prepare_k_q8(k)` for a k of `skv` keys (counted in
    `flash_attention_q8.launches`). Separate so the kernel can be timed
    without the host prep."""
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
    flash_attention_q8.launches += 1
    return out
