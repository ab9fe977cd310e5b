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

The Hopper kernels take bf16 x: the adaLN pair at D % 128 == 0 up to 4096,
the gated residual at D % 8 == 0 (its backward up to 16384). The general
kernels take the rest of what the JAX kernels take, f32 or bf16 at any
D % 8 == 0: `modulate_norm_general`, `modulate_norm_bwd_general` and
`gated_residual_bwd_general` (csrc/adaln_general.cu) and
`gated_residual_general` (the f32 instance of csrc/gated_residual.cu).
`plan_modulate_norm` and `plan_gated_residual` choose, from x's dtype and
shape before any launch; what neither takes raises. The int8-emitting
forward stays bf16.
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
    _check_vectors(name, x, *rows)


def _check_vectors(name, x, *rows):
    """rows: [R, D]-shaped tensors (bf16 or f32, last dim contiguous) on the
    device of x [R, S, D]."""
    R, _, D = x.shape
    for t in rows:
        if (t.device != x.device or t.dtype not in _PARAM_DTYPES or tuple(t.shape) != (R, D)
                or t.stride(-1) != 1):
            raise ValueError(f"{name} kernel takes [R,D]=({R},{D}) bf16/f32 vectors with a "
                             f"contiguous last dim on {x.device}; got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


_MN_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


# widest rows the adaLN kernels take, forward and backward: they hold at most
# 2048 columns of a row in registers and re-read the rest from shared memory
# (csrc/adaln_fwd_sm90.cuh, csrc/adaln_bwd_sm90.cuh)
MAX_D = 4096


def _check_modulate(name, x, scale, shift, norm_scale, norm_bias):
    """Raise unless the adaLN kernels take these operands (rows of D % 128 ==
    0 and D <= MAX_D)."""
    _check_rows(name, x, scale, shift)
    D = x.shape[2]
    if D % 128 != 0 or D > MAX_D:
        raise ValueError(f"{name} kernel takes D % 128 == 0 and D <= {MAX_D}; got D={D}")
    _check_params(name, x, scale, shift, norm_scale, norm_bias)


def _check_params(name, x, scale, shift, norm_scale, norm_bias):
    """Raise unless scale and shift share a dtype and a row stride and the
    norm params are contiguous [D] bf16/f32 vectors of one dtype on x's
    device."""
    if scale.stride(0) != shift.stride(0) or scale.dtype != shift.dtype:
        raise ValueError(f"{name} kernel takes scale and shift of one dtype and stride")
    for t in (norm_scale, norm_bias):
        if (t.device != x.device or t.dtype != norm_scale.dtype or t.dtype not in _PARAM_DTYPES
                or tuple(t.shape) != (x.shape[2],) or not t.is_contiguous()):
            raise ValueError(f"{name} kernel takes contiguous [D] bf16/f32 norm params; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


# the general kernels (csrc/adaln_general.cu, gated_residual.cu's f32
# instance) take any D % GENERAL_D_MULTIPLE == 0; the gated residual's
# backward sums over S by partials of GENERAL_CHUNK_ROWS rows in chunk order
# (part of the shape limits: ceil(S / GENERAL_CHUNK_ROWS) and R up to 65535 a
# launch)
GENERAL_D_MULTIPLE = 8
GENERAL_CHUNK_ROWS = 32
GENERAL_MAX_GRID = 65535


def _general_takes(x) -> bool:
    return (x.dim() == 3 and x.shape[2] % GENERAL_D_MULTIPLE == 0 and x.shape[2] > 0
            and x.shape[0] <= GENERAL_MAX_GRID
            and -(-x.shape[1] // GENERAL_CHUNK_ROWS) <= GENERAL_MAX_GRID)


def plan_modulate_norm(x) -> str:
    """The kernel that takes `modulate_norm` (and its backward) of x
    [R, S, D] on the card, from x's dtype and shape alone, before any
    launch: "hopper" (adaln_fwd_sm90.cuh / adaln_bwd_sm90.cuh: bf16 with
    D % 128 == 0 up to MAX_D), "general" (csrc/adaln_general.cu: f32 or bf16
    with D % 8 == 0), or a ValueError naming both limits."""
    D = x.shape[-1]
    if x.dtype == torch.bfloat16 and x.dim() == 3 and D % 128 == 0 and 0 < D <= MAX_D:
        return "hopper"
    if x.dtype in _PARAM_DTYPES and _general_takes(x):
        return "general"
    raise ValueError(
        f"modulate_norm on the card takes bf16 x [R,S,D] with D % 128 == 0 and D <= {MAX_D} "
        f"(the Hopper kernels) or f32 or bf16 x with D % {GENERAL_D_MULTIPLE} == 0 (the "
        f"general kernels); got {x.dtype} {tuple(x.shape)}")


def plan_gated_residual(x, backward: bool = False) -> str:
    """The kernel that takes `gated_residual` (or, with `backward`,
    `gated_residual_bwd`) of x [R, S, D] on the card, from x's dtype and
    shape alone: "hopper" (bf16 with D % 8 == 0; the backward's up to
    GR_BWD_MAX_D), "general" (the f32 instance of csrc/gated_residual.cu;
    the backward csrc/adaln_general.cu, f32 or bf16 with D % 8 == 0), or a
    ValueError naming both limits."""
    D = x.shape[-1]
    widest = GR_BWD_MAX_D if backward else None
    if (x.dtype == torch.bfloat16 and x.dim() == 3 and D % 8 == 0 and D > 0
            and (widest is None or D <= widest)):
        return "hopper"
    general = _PARAM_DTYPES if backward else (torch.float32,)
    if x.dtype in general and _general_takes(x):
        return "general"
    name = "gated_residual_bwd" if backward else "gated_residual"
    hopper = f"D % 8 == 0 and D <= {GR_BWD_MAX_D}" if backward else "D % 8 == 0"
    kinds = "f32 or bf16" if backward else "f32"
    raise ValueError(
        f"{name} on the card takes bf16 [R,S,D] with {hopper} (the Hopper kernel) or {kinds} "
        f"with D % {GENERAL_D_MULTIPLE} == 0 (the general kernel); got {x.dtype} "
        f"{tuple(x.shape)}")


def _check_general_x(name, x, *others):
    """Raise unless x [R, S, D] with R, S >= 1 and `others` (tensors like x)
    are contiguous, 16-byte aligned, of x's dtype and shape on x's device."""
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"{name} general kernel takes [R,S,D] with R, S, D >= 1; got "
                         f"{tuple(x.shape)}")
    for t in (x, *others):
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} general kernel takes contiguous, 16-byte aligned "
                             f"{x.dtype} {tuple(x.shape)} operands on {x.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")


def _check_general_modulate(name, x, scale, shift, norm_scale, norm_bias, *others):
    """Raise unless the general adaLN kernels take these operands."""
    _check_general_x(name, x, *others)
    _check_vectors(name, x, scale, shift)
    _check_params(name, x, scale, shift, norm_scale, norm_bias)


# the general adaLN forward (csrc/adaln_general.cu): a block of
# GENERAL_FWD_WARPS warps takes rows of one row group; a lane holds 16-byte
# chunks of a row in registers, up to GENERAL_COEF_COLS columns (past them,
# the widest instance re-reads); the gated residual's f32 instance
# (csrc/gated_residual.cu) runs blocks of GENERAL_GR_THREADS threads
GENERAL_FWD_WARPS = 4
GENERAL_COEF_COLS = 4096
GENERAL_GR_THREADS = 256


def modulate_norm_general_instance(D: int, dtype) -> tuple:
    """(lanes a row, 16-byte chunks a lane holds in registers) of the general
    adaLN forward's instance for rows of D elements of dtype (f32 or bf16),
    as csrc/adaln_general.cu's `mn_fwd_instance` picks it: rows of up to 16
    chunks (4 f32 or 8 bf16 elements each) take 4, 8 or 16 lanes and one
    chunk a lane (several rows a warp), wider ones a warp and the fewest
    chunks a lane, a power of two, that hold them, at most GENERAL_COEF_COLS
    columns' worth (that instance re-reads the rest)."""
    e = 4 if dtype == torch.float32 else 8
    n = D // e
    lanes = 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32
    held, most = 1, GENERAL_COEF_COLS // (32 * e)
    while lanes == 32 and held < most and 32 * held < n:
        held *= 2
    return lanes, held


def modulate_norm_general_plan(R: int, S: int, D: int, dtype) -> dict:
    """The general adaLN forward's grid at [R, S, D], as csrc/adaln_general.cu
    launches it: its instance's lanes and held chunks, the rows a block takes
    (tile_rows: a row a warp, or 32 / lanes), tiles_per_group = ceil(S /
    tile_rows) and blocks = R tiles_per_group."""
    lanes, held = modulate_norm_general_instance(D, dtype)
    tile = GENERAL_FWD_WARPS * 32 // lanes
    tiles = -(-S // tile)
    return dict(lanes=lanes, held=held, tile_rows=tile, tiles_per_group=tiles, blocks=R * tiles)


def gated_residual_f32_plan(R: int, S: int, D: int, resident: int) -> dict:
    """The gated residual's f32 launch at [R, S, D] on a card that holds
    `resident` threads at once, as csrc/gated_residual.cu's `gr_f32_plan`
    makes it: a thread owns a float4 column chunk of a row group and walks
    its rows in steps of rows_a_step (m); m * D / 4 threads a group, the
    fewest rows a thread (ceil(S / m)) that keep R m D / 4 within `resident`
    (one wave; a row a step where R D / 4 alone fills it). Returns
    rows_a_step, threads and blocks."""
    d4 = D // 4
    if R * d4 >= resident:
        m = 1
    else:
        k = -(-R * S * d4 // resident)
        m = -(-S // k)
        while k < S and R * m * d4 > resident:
            k += 1
            m = -(-S // k)
    threads = R * m * d4
    return dict(rows_a_step=m, threads=threads, blocks=-(-threads // GENERAL_GR_THREADS))


_MN_GENERAL_INFO_ARGS = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_GR_F32_INFO_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _info(query, n: int, what: str) -> list:
    out = torch.zeros(n, dtype=torch.int32)
    _build.check(query(out.data_ptr()), what)
    return [int(v) for v in out]


def modulate_norm_general_info(R: int, S: int, D: int, dtype) -> dict:
    """What a launch of the general adaLN forward at [R, S, D] in dtype takes
    on the current card (csrc/adaln_general.cu's info entry point): the
    instance's registers, local memory (spills and stack) a thread and
    dynamic shared memory a block in bytes, its lanes and held chunks, and
    the grid's tile_rows and blocks."""
    got = _info(lambda out: _build.kernel("orv_modulate_norm_general_info", _MN_GENERAL_INFO_ARGS)(
        R, S, D, int(dtype == torch.float32), out), 7, "modulate_norm_general info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "lanes", "held", "tile_rows",
                     "blocks"), got))


def gated_residual_general_info(R: int, S: int, D: int) -> dict:
    """What a launch of the gated residual's f32 instance at [R, S, D] takes
    on the current card (csrc/gated_residual.cu's info entry point): its
    registers, local memory a thread and shared memory a block in bytes, the
    blocks the card holds at once, and the plan's rows_a_step and blocks."""
    got = _info(lambda out: _build.kernel("orv_gated_residual_f32_info", _GR_F32_INFO_ARGS)(
        R, S, D, out), 6, "gated_residual_general info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "resident", "rows_a_step",
                     "blocks"), got))


_MN_GENERAL_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])


def modulate_norm_general(x, scale, shift, norm_scale, norm_bias, eps: float):
    """One launch of the general adaLN forward (csrc/adaln_general.cu) on
    checked CUDA operands, x f32 or bf16 (counted in
    `modulate_norm_general.launches`)."""
    if x.device.type != "cuda":
        raise ValueError(f"modulate_norm_general launches a CUDA kernel; x is on {x.device}")
    R, S, D = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_modulate_norm_general", _MN_GENERAL_ARGS)(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), scale.stride(0),
            norm_scale.data_ptr(), norm_bias.data_ptr(), out.data_ptr(), R, S, D, float(eps),
            int(scale.dtype == torch.bfloat16), int(norm_scale.dtype == torch.bfloat16),
            int(x.dtype == torch.float32), stream)
    _build.check(err, "modulate_norm_general")
    _build.count(modulate_norm_general)
    return out


modulate_norm_general.launches = 0


def _modulate_norm_forward(x, scale, shift, norm_scale, norm_bias, eps: float):
    """`modulate_norm_plain` on the CPU; on CUDA the kernel `plan_modulate_norm`
    picks (the Hopper one counted in `modulate_norm.launches`)."""
    if x.device.type == "cpu":
        return modulate_norm_plain(x, scale, shift, norm_scale, norm_bias, eps)
    if plan_modulate_norm(x) == "general":
        return modulate_norm_general(x, scale, shift, norm_scale, norm_bias, eps)
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
    backward). On CUDA, `plan_modulate_norm` picks the Hopper kernels
    (contiguous bf16 x with D % 128 == 0 and D <= 4096) or the general ones
    (f32 or bf16 with D % 8 == 0); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"modulate_norm: unsupported device {x.device}")
    if x.device.type == "cuda":
        if plan_modulate_norm(x) == "hopper":
            _check_modulate("modulate_norm", x, scale, shift, norm_scale, norm_bias)
        else:
            _check_general_modulate("modulate_norm", x, scale, shift, norm_scale, norm_bias)
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


def gated_residual_general(x, y, gate):
    """One launch of the gated residual's f32 instance (csrc/gated_residual.cu,
    `orv_gated_residual_f32`) on checked CUDA operands (counted in
    `gated_residual_general.launches`)."""
    if x.device.type != "cuda":
        raise ValueError(f"gated_residual_general launches a CUDA kernel; x is on {x.device}")
    R, S, D = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_gated_residual_f32", _GR_ARGS)(
            x.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), out.data_ptr(),
            R, S, D, int(gate.dtype == torch.bfloat16), stream)
    _build.check(err, "gated_residual_general")
    _build.count(gated_residual_general)
    return out


gated_residual_general.launches = 0


def _gated_residual_forward(x, y, gate):
    """`gated_residual_plain` on the CPU; on CUDA the kernel
    `plan_gated_residual` picks (the Hopper one counted in
    `gated_residual.launches`)."""
    if x.device.type == "cpu":
        return gated_residual_plain(x, y, gate)
    if plan_gated_residual(x) == "general":
        return gated_residual_general(x, y, gate)
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
    backward). On CUDA, x and y must be contiguous, of one shape and dtype,
    with D % 8 == 0: bf16 goes to the Hopper kernel, f32 to its f32 instance
    (`plan_gated_residual`); anything else raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gated_residual: unsupported device {x.device}")
    if x.device.type == "cuda":
        if plan_gated_residual(x) == "hopper":
            _check_gated("gated_residual", x, y, gate)
        else:
            _check_general_x("gated_residual", x, y)
            _check_vectors("gated_residual", x, gate)
    return _GatedResidual.apply(x, y, gate)


gated_residual.launches = 0


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------

# widest rows gated_residual_bwd takes: a consumer thread of
# csrc/adaln_bwd_sm90.cuh owns at most 8 vectors of 8 columns in each 2048
GR_BWD_MAX_D = 16384


def bwd_plan(R: int, S: int, max_rows: int, resident: int):
    """The tiling of a backward kernel's launch (csrc/adaln_bwd_sm90.cuh, and
    the general adaLN backward in csrc/adaln_general.cu) over R row groups of
    S rows: (rows a tile, grid, partial slots). max_rows and
    resident are the kernel's limits for the width on the device (the widest
    tile its shared memory holds, the blocks that fit at once). A tile is
    `rows` rows of one row group: max_rows, or fewer where whole tiles would
    leave resident blocks idle (the text stream's 226 rows: 2 a tile on 113
    blocks timed 10% faster than 8 on 29 on an NVIDIA H100 80GB HBM3 at
    700 W). Block b of the grid walks tiles
    [b T / grid, (b + 1) T / grid) of the T = R * ceil(S / rows) in
    row-group order and writes one partial of sums for each row group it
    touches, into slot b + r; so group r's partials fill consecutive slots
    and there are grid + R - 1."""
    rows = max(1, min(max_rows, -(-R * S // resident)))
    grid = min(R * -(-S // rows), resident)
    return rows, grid, grid + R - 1


_LIMITS_ARGS = [ctypes.c_int, ctypes.c_void_p]
_limits = {}  # (kernel, device index, D) -> (max_rows, resident)


def _bwd_limits(name: str, device, D: int, query):
    """A backward kernel's (max rows a tile, resident blocks) at width D on
    device, from the C side (`query(D, out)` fills out), once per device and
    width: the query also lifts the kernel's shared-memory limit there."""
    key = (name, device.index, D)
    if key not in _limits:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            err = query(D, ctypes.addressof(out))
        _build.check(err, f"{name} limits")
        _limits[key] = (out[0], out[1])
    return _limits[key]


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
    forwards', R and S >= 1, and dout like x (contiguous and 16-byte
    aligned: it is copied in by 1-D bulk copies)."""
    _check_modulate("modulate_norm_bwd", x, scale, scale, norm_scale, norm_scale)
    if (dout.shape != x.shape or dout.dtype != x.dtype or dout.device != x.device
            or not dout.is_contiguous() or dout.data_ptr() % 16):
        raise ValueError(f"modulate_norm_bwd takes a contiguous, 16-byte aligned dout like x "
                         f"{tuple(x.shape)} {x.dtype}; got {dout.dtype} {tuple(dout.shape)} "
                         f"on {dout.device}")
    if min(x.shape[:2]) < 1:
        raise ValueError(f"modulate_norm_bwd kernel takes R, S >= 1; got {tuple(x.shape)}")


_MNB_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def modulate_norm_bwd(x, dout, scale, norm_scale, eps: float = 1e-5):
    """(dx, A, B) of the adaLN backward, as `modulate_norm_bwd_plain`.

    CPU tensors run `modulate_norm_bwd_plain`. On CUDA, x and dout must be
    contiguous [R, S, D] of one dtype with R, S >= 1, scale [R, D] with a
    contiguous last dim and norm_scale [D] contiguous: bf16 with D % 128 == 0
    and D <= 4096 goes to the Hopper kernel, one launch (counted in
    `modulate_norm_bwd.launches`) of the row pass and the fixed-order sum
    over S; f32 or bf16 with D % 8 == 0 to `modulate_norm_bwd_general`;
    anything else raises. A and B are the same from run to run."""
    if x.device.type == "cpu":
        return modulate_norm_bwd_plain(x, dout, scale, norm_scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"modulate_norm_bwd: unsupported device {x.device}")
    if plan_modulate_norm(x) == "general":
        _check_general_modulate("modulate_norm_bwd", x, scale, scale, norm_scale, norm_scale,
                                dout)
        return modulate_norm_bwd_general(x, dout, scale, norm_scale, eps)
    _check_modulate_bwd(x, dout, scale, norm_scale)
    R, S, D = x.shape
    rows, grid, n_part = bwd_plan(R, S, *_bwd_limits(
        "modulate_norm_bwd", x.device, D,
        lambda d, out: _build.kernel("orv_modulate_norm_bwd_limits", _LIMITS_ARGS)(d, out)))
    dx = torch.empty_like(x)
    part = torch.empty((n_part, 2, D), dtype=torch.float32, device=x.device)
    ab = torch.empty((R, 2, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_modulate_norm_bwd", _MNB_ARGS)(
            x.data_ptr(), dout.data_ptr(), scale.data_ptr(), scale.stride(0),
            norm_scale.data_ptr(), dx.data_ptr(), part.data_ptr(), ab.data_ptr(), R, S, D,
            rows, grid, float(eps), int(scale.dtype == torch.bfloat16),
            int(norm_scale.dtype == torch.bfloat16), stream)
    _build.check(err, "modulate_norm_bwd")
    _build.count(modulate_norm_bwd)
    return dx, ab[:, 0], ab[:, 1]


modulate_norm_bwd.launches = 0


_MNB_GENERAL_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
_MNB_GENERAL_LIMITS_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def modulate_norm_bwd_general(x, dout, scale, norm_scale, eps: float = 1e-5):
    """(dx, A, B) of the adaLN backward by the general kernel
    (csrc/adaln_general.cu) on checked CUDA operands, x f32 or bf16: one
    cooperative launch (counted in `modulate_norm_bwd_general.launches`) of
    the row passes, the sums over S a block and their sum in a fixed order,
    over `bwd_plan`'s tiles and grid from the kernel's limits on x's card."""
    if x.device.type != "cuda":
        raise ValueError(f"modulate_norm_bwd_general launches a CUDA kernel; x is on "
                         f"{x.device}")
    R, S, D = x.shape
    is_f32 = int(x.dtype == torch.float32)
    rows, grid, n_part = bwd_plan(R, S, *_bwd_limits(
        f"modulate_norm_bwd_general {x.dtype}", x.device, D,
        lambda d, out: _build.kernel("orv_modulate_norm_bwd_general_limits",
                                     _MNB_GENERAL_LIMITS_ARGS)(d, is_f32, out)))
    dx = torch.empty_like(x)
    part = torch.empty((n_part, 2, D), dtype=torch.float32, device=x.device)
    ab = torch.empty((R, 2, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_modulate_norm_bwd_general", _MNB_GENERAL_ARGS)(
            x.data_ptr(), dout.data_ptr(), scale.data_ptr(), scale.stride(0),
            norm_scale.data_ptr(), dx.data_ptr(), part.data_ptr(), ab.data_ptr(), R, S, D,
            rows, grid, float(eps), int(scale.dtype == torch.bfloat16),
            int(norm_scale.dtype == torch.bfloat16), is_f32, stream)
    _build.check(err, "modulate_norm_bwd_general")
    _build.count(modulate_norm_bwd_general)
    return dx, ab[:, 0], ab[:, 1]


modulate_norm_bwd_general.launches = 0


def gated_residual_bwd_plain(dout, y, gate):
    """The gated-residual backward tile (`_gr_bwd_kernel`, adaln.py:298) in
    plain PyTorch: dy = gate[r] * dout in f32, rounded to y's dtype, and
    dgate = sum_S dout * y, f32 [R, D]. Returns (dy, dgate)."""
    do = dout.float()
    return (do * gate.float()[:, None, :]).to(y.dtype), (do * y.float()).sum(1)


def _check_gated_bwd(dout, y, gate):
    """Raise unless the gated-residual backward kernel takes these operands:
    as the forward's, with R, S >= 1 and D <= GR_BWD_MAX_D."""
    _check_gated("gated_residual_bwd", dout, y, gate)
    R, S, D = dout.shape
    if min(R, S) < 1 or D > GR_BWD_MAX_D:
        raise ValueError(f"gated_residual_bwd kernel takes R, S >= 1 and D <= {GR_BWD_MAX_D}; "
                         f"got {tuple(dout.shape)}")


_GRB_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def gated_residual_bwd(dout, y, gate):
    """(dy, dgate f32) of the gated residual, as `gated_residual_bwd_plain`.

    CPU tensors run `gated_residual_bwd_plain`. On CUDA, dout and y must be
    contiguous, of one shape [R, S, D] and dtype with R, S >= 1 and D % 8 ==
    0, and gate [R, D] with a contiguous last dim: bf16 with D <= 16384 goes
    to the Hopper kernel, one launch (counted in
    `gated_residual_bwd.launches`) of the row pass and the fixed-order sum
    over S; f32, or wider bf16, to `gated_residual_bwd_general`; anything
    else raises."""
    if dout.device.type == "cpu":
        return gated_residual_bwd_plain(dout, y, gate)
    if dout.device.type != "cuda":
        raise ValueError(f"gated_residual_bwd: unsupported device {dout.device}")
    if plan_gated_residual(dout, backward=True) == "general":
        _check_general_x("gated_residual_bwd", dout, y)
        _check_vectors("gated_residual_bwd", dout, gate)
        return gated_residual_bwd_general(dout, y, gate)
    _check_gated_bwd(dout, y, gate)
    R, S, D = y.shape
    rows, grid, n_part = bwd_plan(R, S, *_bwd_limits(
        "gated_residual_bwd", y.device, D,
        lambda d, out: _build.kernel("orv_gated_residual_bwd_limits", _LIMITS_ARGS)(d, out)))
    dy = torch.empty_like(y)
    part = torch.empty((n_part, D), dtype=torch.float32, device=y.device)
    dgate = torch.empty((R, D), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_gated_residual_bwd", _GRB_ARGS)(
            dout.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), dy.data_ptr(),
            part.data_ptr(), dgate.data_ptr(), R, S, D, rows, grid,
            int(gate.dtype == torch.bfloat16), stream)
    _build.check(err, "gated_residual_bwd")
    _build.count(gated_residual_bwd)
    return dy, dgate


gated_residual_bwd.launches = 0


_GRB_GENERAL_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def gated_residual_bwd_general(dout, y, gate):
    """(dy, dgate f32) of the gated residual by the general kernels
    (csrc/adaln_general.cu) on checked CUDA operands, f32 or bf16: dy and the
    column sums of GENERAL_CHUNK_ROWS-row chunks, then their sum in chunk
    order, one call (counted once in `gated_residual_bwd_general.launches`)."""
    if dout.device.type != "cuda":
        raise ValueError(f"gated_residual_bwd_general launches CUDA kernels; dout is on "
                         f"{dout.device}")
    R, S, D = y.shape
    dy = torch.empty_like(y)
    part = torch.empty((R, -(-S // GENERAL_CHUNK_ROWS), D), dtype=torch.float32,
                       device=y.device)
    dgate = torch.empty((R, D), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_gated_residual_bwd_general", _GRB_GENERAL_ARGS)(
            dout.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), dy.data_ptr(),
            part.data_ptr(), dgate.data_ptr(), R, S, D, GENERAL_CHUNK_ROWS,
            int(gate.dtype == torch.bfloat16), int(y.dtype == torch.float32), stream)
    _build.check(err, "gated_residual_bwd_general")
    _build.count(gated_residual_bwd_general)
    return dy, dgate


gated_residual_bwd_general.launches = 0
