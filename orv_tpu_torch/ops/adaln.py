"""Fused adaLN modulate and gated residual.

Counterpart of `orv_tpu/ops/adaln.py` (forward kernels `_kernel`, adaln.py:52,
and `_gate_kernel`, adaln.py:248). Layout: x [R, S, D] with per-row vectors
[R, D]; the caller folds (batch, frame) into R so that per-frame vectors
apply to each frame's patch rows.

* `modulate_norm` / `gated_residual` — the wrappers: on a CUDA tensor each
  launches its hand-written kernel (`csrc/modulate_norm.cu`,
  `csrc/gated_residual.cu`) or raises; on a CPU tensor it runs its plain
  version. Each counts its kernel launches in `<wrapper>.launches`.
* `modulate_norm_plain` / `gated_residual_plain` — the same arithmetic in
  plain PyTorch (the kernels' oracles and the CPU path).
"""

from __future__ import annotations

import ctypes

import torch

from orv_tpu_torch.ops import _build

_PARAM_DTYPES = (torch.bfloat16, torch.float32)


def modulate_norm_plain(x, scale, shift, norm_scale, norm_bias, eps: float = 1e-5):
    """x [R, S, D]; scale/shift [R, D]; norm_scale/bias [D] -> [R, S, D]:
    LayerNorm (two-pass variance) then `*ns + nb`, then `*(1+scale) + shift`,
    f32 throughout, one rounding to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * norm_scale.float() + norm_bias.float()
    y = y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return y.to(x.dtype)


def gated_residual_plain(x, y, gate):
    """x [R, S, D] + gate [R, D] * y [R, S, D], f32 math, x's dtype out."""
    return (x.float() + y.float() * gate.float()[:, None, :]).to(x.dtype)


def _check_rows(name, x, *rows):
    """x: contiguous bf16 [R, S, D] on CUDA; rows: [R, D]-shaped tensors
    (bf16 or f32, last dim contiguous) on x's device."""
    if (x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"{name} kernel takes a contiguous, 16-byte aligned bf16 [R,S,D] x; "
                         f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    R, _, D = x.shape
    for t in rows:
        if (t.device != x.device or t.dtype not in _PARAM_DTYPES or tuple(t.shape) != (R, D)
                or t.stride(-1) != 1):
            raise ValueError(f"{name} kernel takes [R,D]=({R},{D}) bf16/f32 vectors with a "
                             f"contiguous last dim on {x.device}; got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


_MN_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def modulate_norm(x, scale, shift, norm_scale, norm_bias, eps: float = 1e-5):
    """Fused `LayerNorm(x)*(1+scale[r]) + shift[r]` over x [R, S, D].

    CPU tensors run `modulate_norm_plain`. On CUDA, x must be contiguous
    bf16 with D % 128 == 0 and D <= 2048; anything else raises."""
    if x.device.type == "cpu":
        return modulate_norm_plain(x, scale, shift, norm_scale, norm_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"modulate_norm: unsupported device {x.device}")
    _check_rows("modulate_norm", x, scale, shift)
    R, S, D = x.shape
    if D % 128 != 0 or D > 2048:
        raise ValueError(f"modulate_norm kernel takes D % 128 == 0 and D <= 2048; got D={D}")
    if scale.stride(0) != shift.stride(0) or scale.dtype != shift.dtype:
        raise ValueError("modulate_norm kernel takes scale and shift of one dtype and stride")
    for t in (norm_scale, norm_bias):
        if (t.device != x.device or t.dtype != norm_scale.dtype or t.dtype not in _PARAM_DTYPES
                or tuple(t.shape) != (D,) or not t.is_contiguous()):
            raise ValueError(f"modulate_norm kernel takes contiguous [D] bf16/f32 norm params; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_modulate_norm", _MN_ARGS)(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), scale.stride(0),
            norm_scale.data_ptr(), norm_bias.data_ptr(), out.data_ptr(), R, S, D, float(eps),
            int(scale.dtype == torch.bfloat16), int(norm_scale.dtype == torch.bfloat16), stream)
    _build.check(err, "modulate_norm")
    modulate_norm.launches += 1
    return out


modulate_norm.launches = 0

_GR_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def gated_residual(x, y, gate):
    """Fused `x + gate[r] * y` over x, y [R, S, D], gate [R, D].

    CPU tensors run `gated_residual_plain`. On CUDA, x and y must be
    contiguous bf16 of one shape with D % 8 == 0; anything else raises."""
    if x.device.type == "cpu":
        return gated_residual_plain(x, y, gate)
    if x.device.type != "cuda":
        raise ValueError(f"gated_residual: unsupported device {x.device}")
    _check_rows("gated_residual", x, gate)
    if (y.shape != x.shape or y.dtype != x.dtype or y.device != x.device
            or not y.is_contiguous() or y.data_ptr() % 16):
        raise ValueError(f"gated_residual kernel takes y like x {tuple(x.shape)}: bf16, "
                         f"contiguous, 16-byte aligned; got {y.dtype} {tuple(y.shape)} "
                         f"on {y.device}")
    R, S, D = x.shape
    if D % 8 != 0:
        raise ValueError(f"gated_residual kernel takes D % 8 == 0; got D={D}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_gated_residual", _GR_ARGS)(
            x.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), out.data_ptr(),
            R, S, D, int(gate.dtype == torch.bfloat16), stream)
    _build.check(err, "gated_residual")
    gated_residual.launches += 1
    return out


gated_residual.launches = 0
