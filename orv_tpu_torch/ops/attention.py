"""Joint text+video attention: the static-max flash forward.

Counterpart of `orv_tpu/ops/attention.py`. The DiT qk-LayerNorms every
head, so its logits are bounded and the forward uses a fixed softmax max
(`static_max=24.0`) instead of a running one (`_fwd_kernel_static_max`,
attention.py:124). Layout at the public functions is [B, H, S, D].

* `flash_attention` — the wrapper: on a CUDA tensor it launches the
  hand-written kernel (`csrc/flash_attn_static_max.cu`) or raises; on a CPU
  tensor it runs `flash_attention_plain`. It counts its kernel launches in
  `flash_attention.launches`.
* `flash_attention_plain` — the same arithmetic in plain PyTorch (the
  kernel's oracle and the CPU path).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from orv_tpu_torch.ops import _build

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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention kernel takes contiguous, 16-byte aligned bf16 "
                             f"tensors on one device; {name} is {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if q.dim() != 4 or q.shape[-1] != 64:
        raise ValueError(f"flash_attention kernel takes [B,H,S,64]; got q {tuple(q.shape)}")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[-1] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
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
