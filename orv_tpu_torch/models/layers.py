"""DiT building blocks in PyTorch.

Counterpart of `orv_tpu/models/layers.py`. Module and parameter names follow
the diffusers CogVideoX checkpoint keys (`norm1.linear`, `attn1.to_out.0`,
`ff.net.0.proj`, ...), so a state dict from `models/weights.py` or a real
checkpoint loads without renaming. Numerics follow the JAX package: bf16
activations, f32 normalization and modulation math, parameters stored in
`param_dtype` and cast to the compute dtype at use.

The video stream always takes the fused adaLN semantics (norm and modulate
in f32 with one rounding; `ops.adaln.modulate_norm`), and every gated
residual takes the fused `ops.adaln.gated_residual`. The text stream's
modulation rounds the norm to the compute dtype first, as in the reference.
The bf16 model trains: `modulate_norm`, `gated_residual` and
`flash_attention` are autograd Functions with backward kernels, so no
gradient is lost at a kernel's output.

Sequence parallelism (`sp`, the JAX package's `sp_mesh`): a communicator of
size > 1 rings every joint attention over its ranks, forward and backward;
every other layer runs on the full sequence on every rank.

W8A8 serving (`quant=True`, the JAX package's `quant` flag): the block
projections and feed-forward matmuls are `Int8Dense`, the video stream's
adaLN emits the int8 activation directly (`ops.adaln.modulate_norm_q8`), and
the text stream is quantized by `quantize_tokens` and concatenated in int8
before the video stream (`concat_q8`), and the joint attention runs the
int8-QK^T kernel (`ops.attention.flash_attention_q8`).

The rest of the DiT's surface: RoPE on the video part of q and k
(`JointAttention(rope=...)`), the multiview cross-view block (`MVBlock`),
the CogVideoX 1.5 linear patch embed over `patch_size_t` frames
(`PatchEmbed`, `ActionEmbed`), and PAB attention broadcast
(`DiTBlock(cached_attn=..., return_attn=...)`, `AdaLNZero(gates_only=True)`).

Tensor parallelism (`tp`, a communicator of the mesh's tp axis,
`parallel/mesh.py`), Megatron's layout as the JAX package's
`param_shardings` gives it: `JointAttention` holds heads/tp heads, its q,
k and v projections the rank's columns (rows of the torch weight) and
`to_out` the rank's input columns; `FeedForward` holds its hidden columns
in `net.0.proj` and the same input columns of `net.2`. The biases stay
whole, as the JAX plan keeps them: a column-parallel layer adds its slice
of its bias, and a row-parallel one adds its bias once, after the sum.
Every other layer runs whole on every rank. The row-parallel products are
partial sums: each rank's is computed in f32 from the compute dtype's
inputs, the sums reduced in f32 in rank order and rounded once, after the
bias (`_row_parallel`); an `Int8Dense` reduces its exact int32
accumulators instead, after quantizing each token by the absmax of its
whole row (`all_reduce_max`), so its W8A8 output is the resident one bit
for bit. The qk-LayerNorm works per head and needs no communication. The
collectives carry `shard_map`'s transpose rules (`parallel/sp.py`): a
whole tensor entering rank-partial code (the block's input to the
column-parallel projections, a whole bias or the qk-norm's weights used on
the rank's heads) is a `replicated_input`, whose cotangent is summed over
the ranks; the row-parallel sum is `sum_partials`. Where tp does not
divide the heads (or the hidden width) that attention (or feed-forward)
stays whole on every rank, which computes the same function.

Off the main path, as in the JAX package: `FloatGroupNorm`, `Fuser` and
`ConditioningEmbedding`, which the reference defines and never calls.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F
from torch import nn

from orv_tpu_torch.ops.adaln import gated_residual, modulate_norm, modulate_norm_q8
from orv_tpu_torch.ops.attention import QK_NORM_LOGIT_BOUND, flash_attention, flash_attention_q8
from orv_tpu_torch.ops.quant import quantize_tokens, refuse_grad
from orv_tpu_torch.ops.ring_attention import joint_ring_attention, ring_attention
from orv_tpu_torch.parallel.sp import all_reduce_max, replicated_input, sum_partials
from orv_tpu_torch.utils.embeddings import apply_rotary_emb, get_3d_sincos_pos_embed


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Affine LayerNorm over the last axis, computed in f32, cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """`layer` applied in the compute dtype (parameters cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def concat_q8(text: torch.Tensor, video):
    """[text | video] along the sequence as one (xq, xscale) pair: the float
    text stream [B, S_txt, D] is quantized per token (`quantize_tokens`); the
    video stream arrives as the int8-emitting adaLN's pair, or as a float
    tensor (the MVBlock's), which is quantized the same way."""
    tq, tscale = quantize_tokens(text)
    vq, vscale = video if isinstance(video, tuple) else quantize_tokens(video)
    return torch.cat([tq, vq], dim=1), torch.cat([tscale, vscale], dim=1)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times w [N, K] int8, transposed -> [M, N] int32, exact
    (`torch._int_mm`; the reference leaves this product to XLA). On CUDA it
    takes M > 16 and K, N multiples of 8, and raises on anything else."""
    M, K = a.shape
    N = w.shape[0]
    if a.device.type == "cuda" and (M <= 16 or K % 8 or N % 8):
        raise ValueError(f"int8_matmul on CUDA takes M > 16 and K, N multiples of 8; "
                         f"got M={M}, K={K}, N={N}")
    return torch._int_mm(a, w.t())


class Int8Dense(nn.Module):
    """W8A8 dynamically quantized linear, inference only (orv_tpu
    layers.py:347).

    Buffers `weight_q8` int8 [out, in] and `weight_scale` f32 [out] (one
    absmax/127 scale per output channel, from `models/quantize.py`), and the
    parameter `bias` [out] in `param_dtype`. The input is quantized per token
    (`quantize_tokens`) unless it arrives as an (xq int8, xscale f32) pair.
    The output is `f32(xq @ weight_q8^T) * xscale * weight_scale + bias`,
    computed in that order in f32 and rounded once to `dtype`. The layer
    refuses to run until it holds int8 weights: load a state dict that
    carries `weight_q8` (`models/quantize.py:quantize_linear_params`, or
    `models/weights.py:dit_params_from_jax` of a quantized JAX tree).
    Inference only: raises under grad mode when x requires grad."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device=None, param_dtype=torch.float32):
        super().__init__()
        self.in_features, self.out_features, self.dtype = in_features, out_features, dtype
        self.register_buffer("weight_q8", torch.zeros(out_features, in_features,
                                                      dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device, dtype=param_dtype))
                     if bias else None)
        self.has_int8_weights = False

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if prefix + "weight_q8" in state_dict:
            self.has_int8_weights = True

    def forward(self, x, bias=None, tp=None):
        """`bias` stands in for the layer's own (a column-parallel layer's
        slice). `tp`: this layer is row-parallel over that communicator
        (module docstring): x holds the rank's input columns, each token is
        quantized by the absmax of its whole row and the int32 products
        are summed over the ranks before the epilogue."""
        refuse_grad("Int8Dense", x)
        if not self.has_int8_weights:
            raise RuntimeError("Int8Dense holds no int8 weights: load a quantized state dict "
                               "(models.quantize.quantize_linear_params) first")
        if isinstance(x, tuple):
            xq, xscale = x
        else:
            xq, xscale = quantize_tokens(x, None if tp is None else
                                         lambda amax: all_reduce_max(tp, amax))
        lead = xq.shape[:-1]
        acc = int8_matmul(xq.reshape(-1, self.in_features), self.weight_q8)
        if tp is not None:
            acc = tp.all_reduce_sum(acc)
        y = acc.float() * xscale.reshape(-1, 1) * self.weight_scale
        bias = self.bias if bias is None else bias
        if bias is not None:
            y = y + bias.float()
        return y.to(self.dtype).reshape(*lead, self.weight_q8.shape[0])


def _dense(in_features: int, out_features: int, bias: bool, quant: bool, dtype, device,
           param_dtype) -> nn.Module:
    """An `Int8Dense` for the W8A8 model, else an `nn.Linear` in param_dtype."""
    if quant:
        return Int8Dense(in_features, out_features, bias, dtype, device, param_dtype)
    return nn.Linear(in_features, out_features, bias=bias, device=device, dtype=param_dtype)


def _apply(layer: nn.Module, x, dtype: torch.dtype) -> torch.Tensor:
    """`layer` on x in the compute dtype: an Int8Dense takes x (or its
    pre-quantized pair) as it is, an nn.Linear through `_linear`."""
    return layer(x) if isinstance(layer, Int8Dense) else _linear(x, layer, dtype)


def _tp_dense(in_features: int, out_features: int, bias: bool, quant: bool, dtype, device,
              param_dtype, n: int, column: bool) -> nn.Module:
    """The rank's part of a tp-split layer (`_dense`) of whole size
    [out, in]: column-parallel, the weight's out/n rows; row-parallel, its
    in/n columns; the bias whole either way."""
    if column:
        layer = _dense(in_features, out_features // n, False, quant, dtype, device, param_dtype)
        if bias:
            layer.bias = nn.Parameter(torch.zeros(out_features, device=device, dtype=param_dtype))
        return layer
    return _dense(in_features // n, out_features, bias, quant, dtype, device, param_dtype)


def _column_parallel(layer: nn.Module, x, tp, dtype: torch.dtype) -> torch.Tensor:
    """A column-parallel layer on the whole input x: the rank's output
    columns, with the rank's slice of the whole bias."""
    bias = layer.bias
    if bias is not None:
        n = layer.weight_q8.shape[0] if isinstance(layer, Int8Dense) else layer.weight.shape[0]
        bias = replicated_input(tp, bias).narrow(0, tp.rank * n, n)
    if isinstance(layer, Int8Dense):
        return layer(x, bias=bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype), None if bias is None else bias.to(dtype))


def _row_parallel(layer: nn.Module, x: torch.Tensor, tp, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel layer on the rank's input columns x: the partial
    products summed over the ranks in f32, the whole bias added once, one
    rounding (module docstring)."""
    if isinstance(layer, Int8Dense):
        return layer(x, tp=tp)
    y = F.linear(x.to(dtype).float(), layer.weight.to(dtype).float())
    y = sum_partials(tp, y)
    if layer.bias is not None:
        y = y + layer.bias.to(dtype).float()
    return y.to(dtype)


def _active_tp(tp, n: int):
    """`tp` when it has more than one rank and divides `n`, else None."""
    return tp if tp is not None and tp.size > 1 and n % tp.size == 0 else None


class LayerNorm(nn.Module):
    """Affine LayerNorm with f32 math (parameters `weight`, `bias`)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, param_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=param_dtype))

    def forward(self, x):
        return _layer_norm(x, self.weight, self.bias, self.eps)


class AdaLNZero(nn.Module):
    """Action-aware adaLN-Zero (CogVideoXLayerNormZero; orv_tpu layers.py:69).

    3-chunk (`modulate_enc=False`): video gets (shift, scale, gate); the text
    stream is left alone (the block never reads it). 6-chunk: text gets its
    own (shift, scale, gate) from silu(temb); with per-frame actions the
    video chunks come from silu(temb + action) [B, F, D_cond] and apply per
    frame (rows R = B·F of the fused kernel). `emit_q8` returns the video
    stream as the (xq int8 [B, S, D], xscale f32 [B, S]) pair of
    `modulate_norm_q8`, for the Int8Dense layers of the W8A8 block."""

    def __init__(self, conditioning_dim: int, embedding_dim: int, modulate_enc: bool = False,
                 eps: float = 1e-5, emit_q8: bool = False, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.dim = embedding_dim
        self.modulate_enc = modulate_enc
        self.eps = eps
        self.emit_q8 = emit_q8
        self.dtype = dtype
        n_chunks = 6 if modulate_enc else 3
        self.linear = nn.Linear(conditioning_dim, n_chunks * embedding_dim, device=device,
                                dtype=param_dtype)
        self.norm = LayerNorm(embedding_dim, eps, device=device, param_dtype=param_dtype)

    def _text(self, enc, temb):
        """Text-stream modulation: (normed enc rounded, then modulated; gate [B,1,D])."""
        D = self.dim
        lin = self.linear
        txt = F.linear(F.silu(temb.float()).to(self.dtype), lin.weight[3 * D:].to(self.dtype),
                       lin.bias[3 * D:].to(self.dtype))
        enc_shift, enc_scale, enc_gate = txt.chunk(3, dim=-1)
        normed = self.norm(enc).float()
        enc = (normed * (1.0 + enc_scale[:, None, :].float())
               + enc_shift[:, None, :].float()).to(enc.dtype)
        return enc, enc_gate[:, None, :]

    def forward(self, hidden, enc, temb, action_emb=None, gates_only: bool = False):
        """Returns (normed hidden, normed enc or None, gate, enc_gate or None).
        gate is [B, F, 1, D] with actions, else [B, 1, D]; enc_gate [B, 1, D].
        `gates_only` (PAB's reuse steps): only the gate column slices of the
        modulation linear are computed and no stream is normed; returns
        (None, None, gate, enc_gate or None)."""
        D = self.dim
        lin = self.linear
        if action_emb is not None:  # per-frame video modulation, rows R = B*F
            cond = F.silu(temb[:, None, :].float() + action_emb.float()).to(self.dtype)
        else:  # one modulation per sample, rows R = B
            cond = F.silu(temb.float()).to(self.dtype)
        if gates_only:
            gate = F.linear(cond, lin.weight[2 * D:3 * D].to(self.dtype),
                            lin.bias[2 * D:3 * D].to(self.dtype))[..., None, :]
            enc_gate = None
            if self.modulate_enc:
                enc_gate = F.linear(F.silu(temb.float()).to(self.dtype),
                                    lin.weight[5 * D:].to(self.dtype),
                                    lin.bias[5 * D:].to(self.dtype))[:, None, :]
            return None, None, gate, enc_gate
        vid = F.linear(cond, lin.weight[:3 * D].to(self.dtype), lin.bias[:3 * D].to(self.dtype))
        shift, scale, gate = vid.chunk(3, dim=-1)
        B, S, _ = hidden.shape
        R = cond.shape[:-1].numel()
        args = (hidden.reshape(R, B * S // R, D), scale.reshape(R, D), shift.reshape(R, D),
                self.norm.weight, self.norm.bias, self.eps)
        if self.emit_q8:
            xq, xscale = modulate_norm_q8(*args)
            hidden = (xq.reshape(B, S, D), xscale.reshape(B, S))
        else:
            hidden = modulate_norm(*args).reshape(B, S, D)
        gate = gate[..., None, :]
        if not self.modulate_enc:
            return hidden, None, gate, None
        enc, enc_gate = self._text(enc, temb)
        return hidden, enc, gate, enc_gate


def gate_residual_add(base: torch.Tensor, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """`base + gate * y` through the fused kernel (f32 math, one rounding).
    gate is [B, F, 1, D] (per frame: rows R = B*F) or [B, 1, D] (R = B)."""
    B, S, D = base.shape
    R = gate.numel() // D
    out = gated_residual(base.reshape(R, B * S // R, D),
                         y.reshape(R, B * S // R, D).contiguous(), gate.reshape(R, D))
    return out.reshape(B, S, D)


class AdaLayerNormOut(nn.Module):
    """Output AdaLN (orv_tpu layers.py:286); chunk order is (shift, scale)."""

    def __init__(self, embedding_dim: int, inner_dim: int, eps: float = 1e-5,
                 dtype=torch.bfloat16, device=None, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(embedding_dim, 2 * inner_dim, device=device, dtype=param_dtype)
        self.norm = LayerNorm(inner_dim, eps, device=device, param_dtype=param_dtype)

    def forward(self, x, temb, action_emb=None):
        if action_emb is not None:
            temb = temb[:, None, :].float() + action_emb.float()
        out = _linear(F.silu(temb.float()).to(self.dtype), self.linear, self.dtype)
        shift, scale = out.chunk(2, dim=-1)
        y = self.norm(x).float()
        if action_emb is not None:
            B, S, D = x.shape
            F_ = action_emb.shape[1]
            y = y.reshape(B, F_, S // F_, D)
            y = y * (1.0 + scale[:, :, None, :].float()) + shift[:, :, None, :].float()
            return y.reshape(B, S, D).to(x.dtype)
        return (y * (1.0 + scale[:, None, :].float()) + shift[:, None, :].float()).to(x.dtype)


class JointAttention(nn.Module):
    """Joint [text, video] self-attention (orv_tpu layers.py:392). With
    `qk_norm` (the DiT's default) every head is LayerNormed (eps 1e-6) and
    the bf16 flash forward runs with a static max (logit bound 24.0);
    without it there are no `norm_q`/`norm_k` and the online softmax runs
    (`static_max=None`). `quant=True` is the W8A8 attention: the four
    projections are Int8Dense, the video stream arrives as an (xq, xscale)
    pair, the text stream is quantized and concatenated before it, and the
    int8-QK^T kernel runs the attention.

    `sp`, a communicator of size > 1 (`parallel/sp.py`), rings the attention
    over its ranks (`ops/ring_attention.py`): video tokens split over the
    ranks, text replicated. The ring merges (out, lse) pairs, so it runs the
    bf16 flash kernel even with `quant` (`attention_with_lse` maps flash_q8
    to it). Everything outside the attention runs on the full sequence on
    every rank.

    `tp`, a communicator whose size divides `heads`: this rank's heads/tp
    heads (module docstring); with a size that does not divide them the
    attention stays whole."""

    def __init__(self, heads: int, head_dim: int, bias: bool = True, out_bias: bool = True,
                 quant: bool = False, qk_norm: bool = True, sp=None, dtype=torch.bfloat16,
                 device=None, param_dtype=torch.float32, tp=None):
        super().__init__()
        self.tp = _active_tp(tp, heads)
        n = 1 if self.tp is None else self.tp.size
        self.heads, self.head_dim, self.dtype = heads // n, head_dim, dtype
        self.quant, self.qk_norm, self.sp = quant, qk_norm, sp
        inner = heads * head_dim
        kw = dict(quant=quant, dtype=dtype, device=device, param_dtype=param_dtype)
        if self.tp is None:
            self.to_q = _dense(inner, inner, bias, **kw)
            self.to_k = _dense(inner, inner, bias, **kw)
            self.to_v = _dense(inner, inner, bias, **kw)
        else:
            self.to_q, self.to_k, self.to_v = (_tp_dense(inner, inner, bias, n=n, column=True,
                                                         **kw) for _ in range(3))
        if qk_norm:
            self.norm_q = LayerNorm(head_dim, eps=1e-6, device=device, param_dtype=param_dtype)
            self.norm_k = LayerNorm(head_dim, eps=1e-6, device=device, param_dtype=param_dtype)
        out = (_dense(inner, inner, out_bias, **kw) if self.tp is None
               else _tp_dense(inner, inner, out_bias, n=n, column=False, **kw))
        self.to_out = nn.ModuleList([out])

    def forward(self, hidden, enc=None, rope=None):
        """hidden [B, S, D] (with `quant`, its (xq, xscale) pair or a float
        tensor that the Int8Dense layers quantize). `rope`: the (cos, sin)
        tables [S_video, head_dim], applied to the video part of q and k
        after the qk-LayerNorm (with `enc` None, to the whole sequence).
        Returns (video out, text out or None)."""
        text_len = 0 if enc is None else enc.shape[1]
        if enc is None:
            x = hidden
        elif self.quant:
            x = concat_q8(enc, hidden)
        else:
            x = torch.cat([enc, hidden], dim=1)
        B, S, _ = (x[0] if isinstance(x, tuple) else x).shape
        tp = self.tp
        if tp is not None and not isinstance(x, tuple):
            x = replicated_input(tp, x)

        def heads(layer, norm=None):
            if tp is None:
                t = _apply(layer, x, self.dtype)
            else:
                t = _column_parallel(layer, x, tp, self.dtype)
            t = t.reshape(B, S, self.heads, self.head_dim)
            if norm is not None and tp is None:
                t = norm(t)
            elif norm is not None:
                t = _layer_norm(t, replicated_input(tp, norm.weight),
                                replicated_input(tp, norm.bias), norm.eps)
            return t.transpose(1, 2).contiguous()  # [B, H, S, Dh]

        norm_q, norm_k = (self.norm_q, self.norm_k) if self.qk_norm else (None, None)
        q, k, v = heads(self.to_q, norm_q), heads(self.to_k, norm_k), heads(self.to_v)
        if rope is not None:
            cos, sin = rope
            q = torch.cat([q[:, :, :text_len], apply_rotary_emb(q[:, :, text_len:], cos, sin)],
                          dim=2)
            k = torch.cat([k[:, :, :text_len], apply_rotary_emb(k[:, :, text_len:], cos, sin)],
                          dim=2)
        static_max = QK_NORM_LOGIT_BOUND if self.qk_norm else None
        sp_size = 1 if self.sp is None else self.sp.size
        if sp_size > 1:
            if (S - text_len) % sp_size:
                raise ValueError(
                    f"sequence-parallel sp={sp_size} needs the video token count "
                    f"({S - text_len}) divisible by sp: pick frame/resolution so "
                    f"(F*H*W/patch^2) % sp == 0")
            if text_len > 0:
                out = joint_ring_attention(q, k, v, text_len, self.sp, impl="flash",
                                           static_max=static_max)
            else:
                out = ring_attention(q, k, v, self.sp, impl="flash", static_max=static_max)
        elif self.quant:
            out = flash_attention_q8(q, k, v, static_max=QK_NORM_LOGIT_BOUND)
        else:
            out, _ = flash_attention(q, k, v, static_max=static_max)
        out = out.transpose(1, 2).reshape(B, S, self.heads * self.head_dim)
        if tp is None:
            out = _apply(self.to_out[0], out, self.dtype)
        else:
            out = _row_parallel(self.to_out[0], out, tp, self.dtype)
        if enc is None:
            return out, None
        return out[:, text_len:], out[:, :text_len]


class _GELUProj(nn.Module):
    """diffusers `GELU(approximate="tanh")`: `proj` then tanh-GELU (`tp`:
    `proj` column-parallel)."""

    def __init__(self, dim_in: int, dim_out: int, quant: bool, dtype, device, param_dtype,
                 tp=None):
        super().__init__()
        self.dtype, self.tp = dtype, tp
        if tp is None:
            self.proj = _dense(dim_in, dim_out, True, quant, dtype, device, param_dtype)
        else:
            self.proj = _tp_dense(dim_in, dim_out, True, quant, dtype, device, param_dtype,
                                  tp.size, column=True)

    def forward(self, x):
        if self.tp is None:
            return F.gelu(_apply(self.proj, x, self.dtype), approximate="tanh")
        if not isinstance(x, tuple):
            x = replicated_input(self.tp, x)
        return F.gelu(_column_parallel(self.proj, x, self.tp, self.dtype), approximate="tanh")


class FeedForward(nn.Module):
    """tanh-GELU MLP, 4x expansion (keys ff.net.0.proj, ff.net.2; net.1 is
    the checkpoint's dropout slot). `quant=True`: both matmuls Int8Dense, and
    x may arrive as an (xq, xscale) pair. `tp` (a size dividing the hidden
    width): `net.0.proj` column-parallel and `net.2` row-parallel."""

    def __init__(self, dim: int, mult: int = 4, quant: bool = False, dtype=torch.bfloat16,
                 device=None, param_dtype=torch.float32, tp=None):
        super().__init__()
        self.dtype = dtype
        self.tp = _active_tp(tp, dim * mult)
        out = (_dense(dim * mult, dim, True, quant, dtype, device, param_dtype)
               if self.tp is None else
               _tp_dense(dim * mult, dim, True, quant, dtype, device, param_dtype,
                         self.tp.size, column=False))
        self.net = nn.ModuleList([
            _GELUProj(dim, dim * mult, quant, dtype, device, param_dtype, self.tp),
            nn.Identity(),
            out,
        ])

    def forward(self, x):
        if self.tp is None:
            return _apply(self.net[2], self.net[0](x), self.dtype)
        return _row_parallel(self.net[2], self.net[0](x), self.tp, self.dtype)


class DiTBlock(nn.Module):
    """Attention + FF block with action-aware adaLN gates (CogVideoXBlock).
    3-chunk: attention and FF see video tokens only. 6-chunk: text and video
    attend jointly and pass the FF jointly. `quant=True` is the W8A8 block
    (Int8Dense projections and FF, int8-emitting adaLN, int8-QK^T
    attention). `qk_norm` and `sp` go to the `JointAttention`, `tp` to it
    and to the `FeedForward`."""

    def __init__(self, dim: int, heads: int, head_dim: int, time_embed_dim: int,
                 modulate_enc: bool = False, attention_bias: bool = True,
                 norm_eps: float = 1e-5, quant: bool = False, qk_norm: bool = True, sp=None,
                 dtype=torch.bfloat16, device=None, param_dtype=torch.float32, tp=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.modulate_enc, self.quant = modulate_enc, quant
        self.norm1 = AdaLNZero(time_embed_dim, dim, modulate_enc, norm_eps, quant, **kw)
        self.attn1 = JointAttention(heads, head_dim, attention_bias, True, quant, qk_norm, sp,
                                    tp=tp, **kw)
        self.norm2 = AdaLNZero(time_embed_dim, dim, modulate_enc, norm_eps, quant, **kw)
        self.ff = FeedForward(dim, quant=quant, tp=tp, **kw)

    def forward(self, hidden, enc, temb, action_emb=None, rope=None, cached_attn=None,
                return_attn: bool = False):
        """Returns (hidden, enc), and with `return_attn` also this block's
        pre-gate attention outputs (attn_h, attn_e or None) for PAB's cache.
        `cached_attn` (PAB's reuse steps): such a pair from an earlier step
        stands in for the attention, whose norm, projections and kernel are
        skipped; norm1 computes the gates only."""
        if cached_attn is not None:
            _, _, gate, enc_gate = self.norm1(hidden, enc, temb, action_emb, gates_only=True)
            attn_h, attn_e = cached_attn
        else:
            n_hidden, n_enc, gate, enc_gate = self.norm1(hidden, enc, temb, action_emb)
            attn_h, attn_e = self.attn1(n_hidden, n_enc, rope)
        hidden = gate_residual_add(hidden, attn_h, gate)
        if self.modulate_enc:
            enc = gate_residual_add(enc, attn_e, enc_gate)

        n_hidden, n_enc, gate_ff, enc_gate_ff = self.norm2(hidden, enc, temb, action_emb)
        if not self.modulate_enc:
            hidden = gate_residual_add(hidden, self.ff(n_hidden), gate_ff)
        else:
            text_len = enc.shape[1]
            if self.quant:
                ff_out = self.ff(concat_q8(n_enc, n_hidden))
            else:
                ff_out = self.ff(torch.cat([n_enc, n_hidden], dim=1))
            hidden = gate_residual_add(hidden, ff_out[:, text_len:], gate_ff)
            enc = gate_residual_add(enc, ff_out[:, :text_len], enc_gate_ff)
        if return_attn:
            return hidden, enc, (attn_h, attn_e)
        return hidden, enc


class MVBlock(nn.Module):
    """Cross-view attention before each DiT block (orv_tpu layers.py:596):
    the normed video stream is rearranged (b v)(f s) -> (b f)(v s) so that
    each frame's tokens attend across views, then the zero-init `proj_out`
    and a gated residual. Under `modulate_enc` the views' modulated text
    streams join, (b v) n -> b (v n), repeated for every frame. Its adaLN
    never emits int8, so under `quant` the Int8Dense layers quantize the
    bf16 tokens themselves and the attention runs the int8-QK^T kernel;
    `proj_out` stays a float linear. `cam_encoder` is a zero-init
    Linear(12, dim) the reference defines but never calls, kept for
    checkpoint parity. `tp` splits its attention as the DiT block's (the
    JAX plan matches the projections by name)."""

    def __init__(self, dim: int, heads: int, head_dim: int, time_embed_dim: int,
                 modulate_enc: bool = False, attention_bias: bool = True,
                 norm_eps: float = 1e-5, quant: bool = False, dtype=torch.bfloat16,
                 device=None, param_dtype=torch.float32, tp=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.modulate_enc, self.dtype = modulate_enc, dtype
        self.norm1 = AdaLNZero(time_embed_dim, dim, modulate_enc, norm_eps, False, **kw)
        self.attn1 = JointAttention(heads, head_dim, attention_bias, True, quant, True, tp=tp,
                                    **kw)
        self.proj_out = nn.Linear(dim, dim, device=device, dtype=param_dtype)
        self.cam_encoder = nn.Linear(12, dim, device=device, dtype=param_dtype)
        for p in (*self.proj_out.parameters(), *self.cam_encoder.parameters()):
            nn.init.zeros_(p)

    def forward(self, hidden, enc, temb, rope_view=None, n_view: int = 1, n_frame: int = 1):
        n_hidden, n_enc, gate, _ = self.norm1(hidden, enc, temb)
        BV, FS, D = hidden.shape
        b, s = BV // n_view, FS // n_frame
        n_hidden = (n_hidden.reshape(b, n_view, n_frame, s, D).transpose(1, 2)
                    .reshape(b * n_frame, n_view * s, D))
        if self.modulate_enc:
            n_enc = n_enc.reshape(b, n_view * n_enc.shape[1], D).repeat_interleave(n_frame, 0)
        attn_h, _ = self.attn1(n_hidden, n_enc if self.modulate_enc else None, rope_view)
        attn_h = _linear(attn_h, self.proj_out, self.dtype)
        attn_h = attn_h.reshape(b, n_frame, n_view, s, D).transpose(1, 2).reshape(BV, FS, D)
        return gate_residual_add(hidden, attn_h, gate)


class PatchEmbed(nn.Module):
    """Shared text+video patch embedding (CogVideoXPatchEmbed). Without
    `patch_size_t`, `proj` keeps the checkpoint's conv weight [D, C, p, p]
    and applies it as a matmul over (c p1 p2)-flattened patches; with it
    (CogVideoX 1.5), `proj` is the checkpoint's linear [D, C*pt*p*p] over
    (c pt p1 p2)-flattened patches of pt frames. The sin-cos table is built
    for the actual (T, H, W) token grid, unless `use_positional_embeddings`
    is off (RoPE models)."""

    def __init__(self, embed_dim: int, in_channels: int, text_embed_dim: int,
                 patch_size: int = 2, patch_bias: bool = True,
                 spatial_interpolation_scale: float = 1.875,
                 temporal_interpolation_scale: float = 1.0, patch_size_t=None,
                 use_positional_embeddings: bool = True, dtype=torch.bfloat16,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.embed_dim, self.patch_size, self.dtype = embed_dim, patch_size, dtype
        self.patch_size_t, self.use_positional_embeddings = patch_size_t, use_positional_embeddings
        self.spatial_interpolation_scale = spatial_interpolation_scale
        self.temporal_interpolation_scale = temporal_interpolation_scale
        self._pos_tables = {}
        self.text_proj = nn.Linear(text_embed_dim, embed_dim, device=device, dtype=param_dtype)
        if patch_size_t is None:
            self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size,
                                  bias=patch_bias, device=device, dtype=param_dtype)
        else:
            self.proj = nn.Linear(in_channels * patch_size_t * patch_size ** 2, embed_dim,
                                  bias=patch_bias, device=device, dtype=param_dtype)

    def embed_video(self, video):
        """video [B, F, C, H, W] -> [B, (F/pt)*(H/p)*(W/p), D] with positions."""
        B, F_, C, H, W = video.shape
        p, pt = self.patch_size, self.patch_size_t or 1
        f, h, w = F_ // pt, H // p, W // p
        patches = (video.to(self.dtype).reshape(B, f, pt, C, h, p, w, p)
                   .permute(0, 1, 4, 6, 3, 2, 5, 7).reshape(B, f * h * w, C * pt * p * p))
        bias = None if self.proj.bias is None else self.proj.bias.to(self.dtype)
        out = F.linear(patches, self.proj.weight.reshape(self.embed_dim, -1).to(self.dtype), bias)
        if not self.use_positional_embeddings:
            return out
        key = (f, h, w, out.device, out.dtype)
        pos = self._pos_tables.get(key)
        if pos is None:  # the numpy table is built once per grid, not per step
            table = get_3d_sincos_pos_embed(self.embed_dim, (w, h), f,
                                            self.spatial_interpolation_scale,
                                            self.temporal_interpolation_scale)
            # a normal tensor even under a sampler's inference mode, so that a
            # training step after an inline validation can use the cached table
            with torch.inference_mode(False):
                pos = torch.from_numpy(table).to(out.device, out.dtype).reshape(
                    1, -1, self.embed_dim)
            self._pos_tables[key] = pos
        return out + pos

    def forward(self, text_embeds, video):
        text = _linear(text_embeds, self.text_proj, self.dtype)
        return torch.cat([text, self.embed_video(video)], dim=1)


class TimestepEmbedding(nn.Module):
    """Sinusoidal proj -> 2-layer SiLU MLP (keys linear_1, linear_2)."""

    def __init__(self, in_dim: int, time_embed_dim: int, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = nn.Linear(in_dim, time_embed_dim, device=device, dtype=param_dtype)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim, device=device,
                                  dtype=param_dtype)

    def forward(self, t_emb):
        h = F.silu(_linear(t_emb, self.linear_1, self.dtype))
        return _linear(h, self.linear_2, self.dtype)


class ActionEmbed(nn.Module):
    """7-DoF action sequence -> per-latent-frame embedding (orv_tpu
    layers.py:724). Pads one leading zero frame, groups `compress_ratio`
    frames (and with `patch_size_t` pt such groups), MLP (keys mlp.0, mlp.3,
    mask_embed). Training's action-CFG mask:
    given `mask_u` [B] uniforms, the rows with `mask_u < MASK_PROB` are
    replaced by `mask_embed` (the JAX module draws the uniforms itself from
    its 'action_mask' stream). Returns (h [B, F', hidden], is_mask [B] bool)."""

    MASK_PROB = 0.1  # share of a training batch trained without actions

    def __init__(self, state_dim: int, hidden_size: int, compress_ratio: int = 4,
                 patch_size_t=None, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.state_dim, self.compress_ratio, self.dtype = state_dim, compress_ratio, dtype
        self.patch_size_t = patch_size_t or 1
        kw = dict(device=device, dtype=param_dtype)
        self.mlp = nn.ModuleList([
            nn.Linear(state_dim * compress_ratio * self.patch_size_t, hidden_size * 4, **kw),
            nn.Identity(), nn.Identity(),  # activation and dropout slots of the checkpoint
            nn.Linear(hidden_size * 4, hidden_size, **kw),
        ])
        self.mask_embed = nn.Embedding(1, hidden_size, **kw)

    def forward(self, x, mask_u=None):
        B, F_, sd = x.shape
        if sd != self.state_dim:
            raise ValueError(f"action dim {sd} != {self.state_dim}")
        x = torch.cat([torch.zeros_like(x[:, :1]), x], dim=1)  # pad first frame
        if self.compress_ratio > 1:
            x = x.reshape(B, (F_ + 1) // self.compress_ratio, -1)
        if self.patch_size_t > 1:
            x = x.reshape(B, x.shape[1] // self.patch_size_t, -1)
        h = F.gelu(_linear(x, self.mlp[0], self.dtype), approximate="tanh")
        h = _linear(h, self.mlp[3], self.dtype)
        if mask_u is None:
            return h, torch.zeros(B, dtype=torch.bool, device=h.device)
        is_mask = mask_u < self.MASK_PROB
        h = torch.where(is_mask[:, None, None], self.mask_embed.weight[0].to(h.dtype), h)
        return h, is_mask


class ActionRecon(nn.Module):
    """Inverse-dynamics head (orv_tpu layers.py:772): per-frame embedding
    [B, F, hidden] -> [B, F*compress_ratio - 1, state_dim] actions, the
    padded first frame dropped (keys mlp.0, mlp.2)."""

    def __init__(self, state_dim: int, hidden_size: int, compress_ratio: int = 4,
                 dtype=torch.bfloat16, device=None, param_dtype=torch.float32):
        super().__init__()
        self.state_dim, self.compress_ratio, self.dtype = state_dim, compress_ratio, dtype
        kw = dict(device=device, dtype=param_dtype)
        self.mlp = nn.ModuleList([
            nn.Linear(hidden_size, hidden_size * 4, **kw),
            nn.Identity(),  # the checkpoint's activation slot
            nn.Linear(hidden_size * 4, state_dim * compress_ratio, **kw),
        ])

    def forward(self, x):
        B, F_, _ = x.shape
        h = F.gelu(_linear(x, self.mlp[0], self.dtype), approximate="tanh")
        h = _linear(h, self.mlp[2], self.dtype)
        if self.compress_ratio > 1:
            h = h.reshape(B, F_ * self.compress_ratio, self.state_dim)
        return h[:, 1:]


class FloatGroupNorm(nn.Module):
    """GroupNorm in f32, cast back to the input's dtype (orv_tpu
    layers.py:799; reference components.py:107-109), over channels last.
    For x of 3 or more dims the statistics of each group run over the
    channels in the group and the third axis from the end of the grouped
    tensor (the tokens of [B, F, P, D], the frames of [B, F, D]); for 2-dim
    x over the group's channels alone (layers.py:816-817). Keys `weight`,
    `bias` (flax `scale`, `bias`)."""

    def __init__(self, groups: int, channels: int, device=None, param_dtype=torch.float32):
        super().__init__()
        if channels % groups:
            raise ValueError(f"FloatGroupNorm: {channels} channels in {groups} groups")
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        g = xf.reshape(*xf.shape[:-1], self.groups, xf.shape[-1] // self.groups)
        dims = (-3, -1) if xf.dim() >= 3 else (-1,)
        mean = g.mean(dim=dims, keepdim=True)
        var = (g - mean).pow(2).mean(dim=dims, keepdim=True)
        g = (g - mean) * torch.rsqrt(var + 1e-5)
        return (g.reshape(xf.shape) * self.weight + self.bias).to(x.dtype)


class Fuser(nn.Module):
    """Spatio-temporal FiLM of hidden states by action hidden states (orv_tpu
    layers.py:822; reference components.py:121-162): h + GroupNorm(h) *
    gamma + beta, gamma and beta projected from the action states to
    out_channels // 4 (`gamma_spatial`, `beta_spatial`) and then to
    out_channels (`gamma_temporal`, `beta_temporal`, zero-initialised, so
    the module starts as the identity). The reference defines it and its
    main path never calls it. h [B, F, P, D], action_hidden_states [B, F, P,
    action_in_channel]; D == out_channels."""

    def __init__(self, action_in_channel: int = 128, out_channels: int = 1152,
                 dtype=torch.bfloat16, device=None, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, dtype=param_dtype)
        self.gamma_spatial = nn.Linear(action_in_channel, out_channels // 4, **kw)
        self.beta_spatial = nn.Linear(action_in_channel, out_channels // 4, **kw)
        self.gamma_temporal = nn.Linear(out_channels // 4, out_channels, **kw)
        self.beta_temporal = nn.Linear(out_channels // 4, out_channels, **kw)
        with torch.no_grad():
            for layer in (self.gamma_spatial, self.beta_spatial):
                layer.bias.zero_()
            for layer in (self.gamma_temporal, self.beta_temporal):
                layer.weight.zero_()
                layer.bias.zero_()
        self.traj_cond_norm = FloatGroupNorm(min(32, out_channels), out_channels, device,
                                             param_dtype)

    def forward(self, h: torch.Tensor, action_hidden_states: torch.Tensor) -> torch.Tensor:
        # the temporal projections act on the channels of each (b p) f row, as
        # the JAX package's rearranges leave them
        gamma = _linear(_linear(action_hidden_states, self.gamma_spatial, self.dtype),
                        self.gamma_temporal, self.dtype)
        beta = _linear(_linear(action_hidden_states, self.beta_spatial, self.dtype),
                       self.beta_temporal, self.dtype)
        return h + self.traj_cond_norm(h) * gamma + beta


class ConditioningEmbedding(nn.Module):
    """ControlNet-style conv encoder of raw condition images (orv_tpu
    layers.py:856; reference components.py:165-197, which defines it and
    never calls it): 3x3 convs with padding 1, SiLU after each but the
    last, every second block of stride 2. Takes and returns NHWC, as the
    JAX module does ([B, H, W, C] -> [B, H/8, W/8, embedding_channels] with
    the default 4 widths); the convs run in NCHW inside. Keys conv_in,
    blocks.{j} (flax `block_{j}`), conv_out; flax HWIO kernels transpose to
    OIHW."""

    def __init__(self, embedding_channels: int, block_out_channels=(16, 32, 96, 256),
                 in_channels: int = 3, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = tuple(block_out_channels)
        conv = lambda i, o, stride: nn.Conv2d(i, o, 3, stride=stride, padding=1, device=device,
                                              dtype=param_dtype)
        self.conv_in = conv(in_channels, ch[0], 1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks += [conv(ch[i], ch[i], 1), conv(ch[i], ch[i + 1], 2)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = conv(ch[-1], embedding_channels, 1)

    def _conv(self, layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), layer.weight.to(self.dtype), layer.bias.to(self.dtype),
                        layer.stride, layer.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self._conv(self.conv_in, x.permute(0, 3, 1, 2)))
        for layer in self.blocks:
            h = F.silu(self._conv(layer, h))
        return self._conv(self.conv_out, h).permute(0, 2, 3, 1)
