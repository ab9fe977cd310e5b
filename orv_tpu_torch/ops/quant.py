"""Per-token int8 quantization, shared by the W8A8 path's plain versions.

Counterpart of `orv_tpu/models/layers.py:quantize_tokens` (layers.py:328),
the arithmetic that `Int8Dense` applies to a floating-point input, that
`modulate_norm_q8` applies to its modulated row and that the int8-QK^T
attention applies to each pre-scaled query.
"""

from __future__ import annotations

import torch


def quantize_tokens(x: torch.Tensor):
    """Returns (xq int8 [..., D], xscale f32 [...]) with
    amax = max(max|x|, 1e-6) in f32, xq = round_half_even(x * (127/amax))
    and xscale = amax * (1/127)."""
    xf = x.float()
    amax = xf.abs().amax(-1).clamp_min(1e-6)
    q = torch.tensor(127.0) / amax  # a true division: torch's `127.0 / t` is t.reciprocal() * 127
    return torch.round(xf * q[..., None]).to(torch.int8), amax * (1.0 / 127.0)
