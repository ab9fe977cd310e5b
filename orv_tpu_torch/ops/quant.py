"""Per-token int8 quantization, shared by the W8A8 path's plain versions.

Counterpart of `orv_tpu/models/layers.py:quantize_tokens` (layers.py:328),
the arithmetic that `Int8Dense` applies to a floating-point input, that
`modulate_norm_q8` applies to its modulated row and that the int8-QK^T
attention applies to each pre-scaled query; and `refuse_grad`, which the
inference-only W8A8 wrappers call first.
"""

from __future__ import annotations

import torch


def quantize_tokens(x: torch.Tensor, reduce_amax=None):
    """Returns (xq int8 [..., D], xscale f32 [...]) with
    amax = max(max|x|, 1e-6) in f32, xq = round_half_even(x * (127/amax))
    and xscale = amax * (1/127). `reduce_amax` maps each token's max|x|
    before the clamp (a row split over ranks: the max over the ranks)."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    amax = (amax if reduce_amax is None else reduce_amax(amax)).clamp_min(1e-6)
    q = torch.tensor(127.0) / amax  # a true division: torch's `127.0 / t` is t.reciprocal() * 127
    return torch.round(xf * q[..., None]).to(torch.int8), amax * (1.0 / 127.0)


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would have to go through an inference-only W8A8
    op: grad mode is on and one of `tensors` requires grad. Rounding to int8
    has no useful gradient and the JAX package gives these ops no VJP, so a
    result would silently cut every gradient that flows through it."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{name} is inference-only (it has no backward): call it under "
                           "torch.no_grad() or torch.inference_mode(), or train the bf16 model")
