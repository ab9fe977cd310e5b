"""Fused adaLN modulate and gated residual.

Counterpart of `orv_tpu/ops/adaln.py` (forward kernels `_kernel`, adaln.py:52,
`_kernel_q8`, adaln.py:190, and `_gate_kernel`, adaln.py:248). Layout: x
[R, S, D] with per-row vectors [R, D]; the caller folds (batch, frame) into R
so that per-frame vectors apply to each frame's patch rows.

* `modulate_norm` / `modulate_norm_q8` / `gated_residual` — the wrappers: on
  a CUDA tensor each launches its hand-written kernel
  (`csrc/modulate_norm.cu`, `csrc/modulate_norm_q8.cu`,
  `csrc/gated_residual.cu`) or raises; on a CPU tensor it runs its plain
  version. Each counts its kernel launches in `<wrapper>.launches`.
* `modulate_norm_plain` / `modulate_norm_q8_plain` / `gated_residual_plain`
  — the same arithmetic in plain PyTorch (the kernels' oracles and the CPU
  path).

`modulate_norm` and `gated_residual` are differentiable, as the JAX
package's custom VJPs are: each is a `torch.autograd.Function` whose
backward is a kernel of its own (`_mn_bwd_kernel`, adaln.py:105, in
`csrc/modulate_norm_bwd.cu`; `_gr_bwd_kernel`, adaln.py:298, in
`csrc/gated_residual_bwd.cu`), wrapped by `modulate_norm_bwd` and
`gated_residual_bwd` with their plain versions beside them. The `[R, D]`
algebra after the adaLN backward kernel runs in plain PyTorch, as the JAX
package leaves it to XLA (adaln.py:176-184). `modulate_norm_q8` is
inference only and raises under grad mode when an input requires grad.
"""

from __future__ import annotations

import ctypes

import torch

from orv_tpu_torch.ops import _build
from orv_tpu_torch.ops.quant import quantize_tokens, refuse_grad

_PARAM_DTYPES = (torch.bfloat16, torch.float32)


def _modulated(x, scale, shift, norm_scale, norm_bias, eps):
    """The f32 modulated value both adaLN kernels start from."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * norm_scale.float() + norm_bias.float()
    return y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]


def modulate_norm_plain(x, scale, shift, norm_scale, norm_bias, eps: float = 1e-5):
    """x [R, S, D]; scale/shift [R, D]; norm_scale/bias [D] -> [R, S, D]:
    LayerNorm (two-pass variance) then `*ns + nb`, then `*(1+scale) + shift`,
    f32 throughout, one rounding to x's dtype."""
    return _modulated(x, scale, shift, norm_scale, norm_bias, eps).to(x.dtype)


def modulate_norm_q8_plain(x, scale, shift, norm_scale, norm_bias, eps: float = 1e-5):
    """`modulate_norm`'s f32 value y, quantized per token without rounding
    to x's dtype first (`quantize_tokens`): returns (xq int8 [R, S, D],
    xscale f32 [R, S]), what `Int8Dense` takes pre-quantized."""
    return quantize_tokens(_modulated(x, scale, shift, norm_scale, norm_bias, eps))


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


# widest rows each adaLN kernel takes: the forwards hold at most 2048 columns
# of a row in registers and re-read the rest from shared memory
# (csrc/adaln_fwd_sm90.cuh); the backward holds the whole row in registers
MAX_D_FORWARD = 4096
MAX_D_BACKWARD = 2048


def _check_modulate(name, x, scale, shift, norm_scale, norm_bias, max_d=MAX_D_FORWARD):
    """Raise unless the adaLN kernels take these operands (rows of D % 128 ==
    0 and D <= max_d)."""
    _check_rows(name, x, scale, shift)
    D = x.shape[2]
    if D % 128 != 0 or D > max_d:
        raise ValueError(f"{name} kernel takes D % 128 == 0 and D <= {max_d}; got D={D}")
    if scale.stride(0) != shift.stride(0) or scale.dtype != shift.dtype:
        raise ValueError(f"{name} kernel takes scale and shift of one dtype and stride")
    for t in (norm_scale, norm_bias):
        if (t.device != x.device or t.dtype != norm_scale.dtype or t.dtype not in _PARAM_DTYPES
                or tuple(t.shape) != (D,) or not t.is_contiguous()):
            raise ValueError(f"{name} kernel takes contiguous [D] bf16/f32 norm params; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _modulate_norm_forward(x, scale, shift, norm_scale, norm_bias, eps: float):
    """`modulate_norm_plain` on the CPU, the kernel on CUDA (counted in
    `modulate_norm.launches`)."""
    if x.device.type == "cpu":
        return modulate_norm_plain(x, scale, shift, norm_scale, norm_bias, eps)
    R, S, D = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_modulate_norm", _MN_ARGS)(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), scale.stride(0),
            norm_scale.data_ptr(), norm_bias.data_ptr(), out.data_ptr(), R, S, D, float(eps),
            int(scale.dtype == torch.bfloat16), int(norm_scale.dtype == torch.bfloat16), stream)
    _build.check(err, "modulate_norm")
    _build.count(modulate_norm)
    return out


class _ModulateNorm(torch.autograd.Function):
    """`modulate_norm` with the fused backward (`_mn_fwd`/`_mn_bwd`,
    adaln.py:138-184)."""

    @staticmethod
    def forward(ctx, x, scale, shift, norm_scale, norm_bias, eps):
        ctx.save_for_backward(x, scale, norm_scale, norm_bias)
        ctx.eps = eps
        return _modulate_norm_forward(x, scale, shift, norm_scale, norm_bias, eps)

    @staticmethod
    def backward(ctx, dout):
        x, scale, norm_scale, norm_bias = ctx.saved_tensors
        dx, a, b = modulate_norm_bwd(x, dout.contiguous(), scale, norm_scale, ctx.eps)
        one_p = 1.0 + scale.float()
        ns32, nb32 = norm_scale.float()[None], norm_bias.float()[None]
        dscale = (ns32 * b + nb32 * a).to(scale.dtype)
        dshift = a.to(scale.dtype)
        dns = (one_p * b).sum(0).to(norm_scale.dtype)
        dnb = (one_p * a).sum(0).to(norm_bias.dtype)
        return dx, dscale, dshift, dns, dnb, None


def modulate_norm(x, scale, shift, norm_scale, norm_bias, eps: float = 1e-5):
    """Fused `LayerNorm(x)*(1+scale[r]) + shift[r]` over x [R, S, D],
    differentiable in all five tensors through the fused backward.

    CPU tensors run `modulate_norm_plain` (and `modulate_norm_bwd_plain`
    backward). On CUDA, x must be contiguous bf16 with D % 128 == 0 and
    D <= 4096 (the backward: D <= 2048); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"modulate_norm: unsupported device {x.device}")
    if x.device.type == "cuda":
        _check_modulate("modulate_norm", x, scale, shift, norm_scale, norm_bias)
    return _ModulateNorm.apply(x, scale, shift, norm_scale, norm_bias, float(eps))


modulate_norm.launches = 0

_MNQ_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def modulate_norm_q8(x, scale, shift, norm_scale, norm_bias, eps: float = 1e-5):
    """`modulate_norm` emitting the W8A8 activation quantization: returns
    (xq int8 [R, S, D], xscale f32 [R, S]) as `modulate_norm_q8_plain`.

    CPU tensors run `modulate_norm_q8_plain`. On CUDA, x must be contiguous
    bf16 with D % 128 == 0 and D <= 4096; anything else raises. Inference
    only: raises under grad mode when an input requires grad."""
    refuse_grad("modulate_norm_q8", x, scale, shift, norm_scale, norm_bias)
    if x.device.type == "cpu":
        return modulate_norm_q8_plain(x, scale, shift, norm_scale, norm_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"modulate_norm_q8: unsupported device {x.device}")
    _check_modulate("modulate_norm_q8", x, scale, shift, norm_scale, norm_bias)
    R, S, D = x.shape
    xq = torch.empty((R, S, D), dtype=torch.int8, device=x.device)
    xscale = torch.empty((R, S), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_modulate_norm_q8", _MNQ_ARGS)(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), scale.stride(0),
            norm_scale.data_ptr(), norm_bias.data_ptr(), xq.data_ptr(), xscale.data_ptr(),
            R, S, D, float(eps), int(scale.dtype == torch.bfloat16),
            int(norm_scale.dtype == torch.bfloat16), stream)
    _build.check(err, "modulate_norm_q8")
    _build.count(modulate_norm_q8)
    return xq, xscale


modulate_norm_q8.launches = 0

_GR_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _gated_residual_forward(x, y, gate):
    """`gated_residual_plain` on the CPU, the kernel on CUDA (counted in
    `gated_residual.launches`)."""
    if x.device.type == "cpu":
        return gated_residual_plain(x, y, gate)
    R, S, D = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_gated_residual", _GR_ARGS)(
            x.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), out.data_ptr(),
            R, S, D, int(gate.dtype == torch.bfloat16), stream)
    _build.check(err, "gated_residual")
    _build.count(gated_residual)
    return out


class _GatedResidual(torch.autograd.Function):
    """`gated_residual` with the fused backward (`_gr_fwd`/`_gr_bwd`,
    adaln.py:314-349): dx = dout unchanged, dy and dgate from the kernel."""

    @staticmethod
    def forward(ctx, x, y, gate):
        ctx.save_for_backward(y, gate)
        return _gated_residual_forward(x, y, gate)

    @staticmethod
    def backward(ctx, dout):
        y, gate = ctx.saved_tensors
        dy, dgate = gated_residual_bwd(dout.contiguous(), y, gate)
        return dout, dy, dgate.to(gate.dtype)


def _check_gated(name, x, y, gate):
    """Raise unless the gated-residual kernels take these operands."""
    _check_rows(name, x, gate)
    if (y.shape != x.shape or y.dtype != x.dtype or y.device != x.device
            or not y.is_contiguous() or y.data_ptr() % 16):
        raise ValueError(f"{name} kernel takes y like x {tuple(x.shape)}: bf16, "
                         f"contiguous, 16-byte aligned; got {y.dtype} {tuple(y.shape)} "
                         f"on {y.device}")
    if x.shape[2] % 8 != 0:
        raise ValueError(f"{name} kernel takes D % 8 == 0; got D={x.shape[2]}")


def gated_residual(x, y, gate):
    """Fused `x + gate[r] * y` over x, y [R, S, D], gate [R, D],
    differentiable in all three through the fused backward.

    CPU tensors run `gated_residual_plain` (and `gated_residual_bwd_plain`
    backward). On CUDA, x and y must be contiguous bf16 of one shape with
    D % 8 == 0; anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gated_residual: unsupported device {x.device}")
    if x.device.type == "cuda":
        _check_gated("gated_residual", x, y, gate)
    return _GatedResidual.apply(x, y, gate)


gated_residual.launches = 0


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------

# rows of one row group r that one block of a backward kernel sums over
BWD_CHUNK_ROWS = 16


def modulate_norm_bwd_plain(x, dout, scale, norm_scale, eps: float = 1e-5):
    """The adaLN backward tile (`_mn_bwd_kernel`, adaln.py:105) in plain
    PyTorch, f32 throughout: with w = ns * (1 + scale[r]) and xhat the
    normalized row, g = dout * w and dx = inv * (g - mean(g) - xhat *
    mean(g * xhat)) in x's dtype; A = sum_S dout and B = sum_S dout * xhat,
    f32 [R, D]. Returns (dx, A, B)."""
    xf, do = x.float(), dout.float()
    mean = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * inv
    g = do * (norm_scale.float() * (1.0 + scale.float()))[:, None, :]
    gm = g.mean(-1, keepdim=True)
    gxm = (g * xhat).mean(-1, keepdim=True)
    dx = (inv * (g - gm - xhat * gxm)).to(x.dtype)
    return dx, do.sum(1), (do * xhat).sum(1)


def _check_modulate_bwd(x, dout, scale, norm_scale):
    """Raise unless the adaLN backward kernel takes these operands: as the
    forwards', with D <= 2048 (its warp holds a row in registers) and dout
    like x."""
    _check_modulate("modulate_norm_bwd", x, scale, scale, norm_scale, norm_scale,
                    max_d=MAX_D_BACKWARD)
    if dout.shape != x.shape or dout.dtype != x.dtype or not dout.is_contiguous():
        raise ValueError(f"modulate_norm_bwd takes a contiguous dout like x {tuple(x.shape)}; "
                         f"got {dout.dtype} {tuple(dout.shape)}")


_MNB_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def modulate_norm_bwd(x, dout, scale, norm_scale, eps: float = 1e-5):
    """(dx, A, B) of the adaLN backward, as `modulate_norm_bwd_plain`.

    CPU tensors run `modulate_norm_bwd_plain`. On CUDA, x and dout must be
    contiguous bf16 [R, S, D] with D % 128 == 0 and D <= 2048, scale [R, D]
    with a contiguous last dim and norm_scale [D] contiguous; anything else
    raises. One launch (counted in `modulate_norm_bwd.launches`) runs the row
    pass and the fixed-order sum of its chunks, so A and B are the same from
    run to run."""
    if x.device.type == "cpu":
        return modulate_norm_bwd_plain(x, dout, scale, norm_scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"modulate_norm_bwd: unsupported device {x.device}")
    _check_modulate_bwd(x, dout, scale, norm_scale)
    R, S, D = x.shape
    n_chunks = -(-S // BWD_CHUNK_ROWS)
    dx = torch.empty_like(x)
    part = torch.empty((R, n_chunks, 2, D), dtype=torch.float32, device=x.device)
    ab = torch.empty((R, 2, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_modulate_norm_bwd", _MNB_ARGS)(
            x.data_ptr(), dout.data_ptr(), scale.data_ptr(), scale.stride(0),
            norm_scale.data_ptr(), dx.data_ptr(), part.data_ptr(), ab.data_ptr(), R, S, D,
            BWD_CHUNK_ROWS, float(eps), int(scale.dtype == torch.bfloat16),
            int(norm_scale.dtype == torch.bfloat16), stream)
    _build.check(err, "modulate_norm_bwd")
    _build.count(modulate_norm_bwd)
    return dx, ab[:, 0], ab[:, 1]


modulate_norm_bwd.launches = 0


def gated_residual_bwd_plain(dout, y, gate):
    """The gated-residual backward tile (`_gr_bwd_kernel`, adaln.py:298) in
    plain PyTorch: dy = gate[r] * dout in f32, rounded to y's dtype, and
    dgate = sum_S dout * y, f32 [R, D]. Returns (dy, dgate)."""
    do = dout.float()
    return (do * gate.float()[:, None, :]).to(y.dtype), (do * y.float()).sum(1)


_GRB_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def gated_residual_bwd(dout, y, gate):
    """(dy, dgate f32) of the gated residual, as `gated_residual_bwd_plain`.

    CPU tensors run `gated_residual_bwd_plain`. On CUDA, dout and y must be
    contiguous bf16 of one shape [R, S, D] with D % 8 == 0 and gate [R, D]
    with a contiguous last dim; anything else raises. One launch (counted in
    `gated_residual_bwd.launches`) runs the row pass and the fixed-order sum
    of its chunks."""
    if dout.device.type == "cpu":
        return gated_residual_bwd_plain(dout, y, gate)
    if dout.device.type != "cuda":
        raise ValueError(f"gated_residual_bwd: unsupported device {dout.device}")
    _check_gated("gated_residual_bwd", dout, y, gate)
    R, S, D = y.shape
    n_chunks = -(-S // BWD_CHUNK_ROWS)
    dy = torch.empty_like(y)
    part = torch.empty((R, n_chunks, D), dtype=torch.float32, device=y.device)
    dgate = torch.empty((R, D), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_gated_residual_bwd", _GRB_ARGS)(
            dout.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), dy.data_ptr(),
            part.data_ptr(), dgate.data_ptr(), R, S, D, BWD_CHUNK_ROWS,
            int(gate.dtype == torch.bfloat16), stream)
    _build.check(err, "gated_residual_bwd")
    _build.count(gated_residual_bwd)
    return dy, dgate


gated_residual_bwd.launches = 0
