"""ControlDiT — the action/image/occupancy-conditioned video diffusion
transformer, in PyTorch.

Counterpart of `orv_tpu/models/dit.py`:
  patch_embed(text, video latents) -> [text | video] token sequence
  + multiview positional embedding (per frame across views)
  + ActionEmbed conditioning (adds to temb per frame inside adaLN)
  + visual-control injection: depth/label latents through the *shared*
    patch_embed, combine linear, single residual add
  -> num_layers x [MVBlock? -> DiTBlock] (nn.ModuleLists `mv_blocks` and
     `transformer_blocks`; the JAX package scans them)
  -> final LayerNorm -> AdaLN out -> proj_out -> unpatchify (over
     patch_size_t frames in the 1.5 family)

RoPE models take the rotary tables as `image_rotary_emb` (built by
`utils/embeddings.py:prepare_rotary_positional_embeddings`); their patch
embed adds no sin-cos table. A multiview model (`multiview=True`) takes
`num_views` V and latents [B, V*F, C, H, W], views stacked on the frame
axis; the views share the text, timestep and actions. PAB attention
broadcast: `collect_attn=True` also returns every block's pre-gate
attention outputs, and `attn_cache` (that list) stands in for them on a
later step (not with multiview, as in the JAX package).

`quant=True` builds the W8A8 serving model of the JAX package
(`ControlDiT(quant=True)`): every block's projections and feed-forward
matmuls are `Int8Dense`, its adaLN emits int8 and its joint attention runs
the int8-QK^T kernel. Such a model runs only once it holds int8 weights
(`models/quantize.py`). `attn_impl` mirrors the JAX constructor but has no
choice left in it: it must be "flash" for the bf16 model and "flash_q8" for
the W8A8 one, the pairing the JAX package serves with
(orv_tpu/pipelines/evaluate.py:170); the port's kernels exist for no other.

Training: `forward(..., deterministic=False, action_mask_u=...)` returns
(v_pred, is_action_mask, actions_recon) as the JAX model's training call
does (orv_tpu/models/dit.py:326-349, :419); `recon_action=True` adds the
`ActionRecon` head. The bf16 model's kernels all have backward kernels
(`ops/`), so `loss.backward()` reaches every parameter.

Sequence parallelism: `ControlDiT(sp=comm)` (the JAX package's `sp_mesh`,
dit.py:166-170) threads a communicator (`parallel/sp.py`) into every block,
whose joint attention then rings over the ranks (`ops/ring_attention.py`);
every rank runs the rest of the model on the full sequence, so every rank
returns the whole prediction. Run it on every rank, e.g. under
`LocalRing(n).run`. It trains: the ring's collectives are differentiable
(`parallel/sp.py`), every rank's gradients come out the same bit for bit,
and remat recomputes the ring, collectives included, in the backward. On
CUDA the ranks of a training run are processes (`ProcessGroupRing`).

Per-block remat (`remat=True`, the JAX package's `gradient_checkpointing`,
dit.py:385-394): under grad mode each cell of the block loop (the MVBlock,
if any, then its DiTBlock: JAX's `_BlockCell`) runs under
`torch.utils.checkpoint` (non-reentrant), so the backward recomputes its
forward, kernels included: a micro-step launches every forward kernel of
the blocks twice and every backward kernel once. `remat_policy="dots"`
(`dots_with_no_batch_dims_saveable`) keeps the matmuls' outputs (`mm` and
`addmm`, the linears) and recomputes the rest. The sampler's inference mode
never remats.

Data and model parallelism (`parallel/mesh.py`): `ControlDiT(tp=comm)`
splits every block's attention heads and feed-forward columns over the
communicator's ranks (`models/layers.py`), plumbed as `sp=` is;
`layers=range(a, b)` builds only those blocks (a pipeline stage's: the
other entries of `transformer_blocks` and `mv_blocks` are empty
placeholders, so the held blocks keep their global names); and a
`parallel/fsdp.py:Zero` set on the model gathers each block's fsdp shards
for its forward (`_unit`). The forward is three parts, as the JAX model's
`stage="pre"`, `_BlockCell` and `stage="post"` (orv_tpu/models/dit.py:382,
:122, :274), which the pipeline runs apart: `embed` (the embeddings and the
action conditioning), `run_blocks` (a range of block cells) and `head`
(the final norm, the output adaLN, the projection and the unpatchify).

Refused by name: `use_learned_positional_embeddings`, which the JAX config
carries but none of its modules reads (ROADMAP.md C).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from orv_tpu_torch.models.layers import (
    ActionEmbed,
    ActionRecon,
    AdaLayerNormOut,
    DiTBlock,
    LayerNorm,
    MVBlock,
    PatchEmbed,
    TimestepEmbedding,
    _linear,
)
from orv_tpu_torch.utils.device import DeviceLike, resolve_device
from orv_tpu_torch.utils.embeddings import get_3d_sincos_pos_embed, get_timestep_embedding


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Mirrors the reference model config surface
    (cogvideox_control.py:452-494); field names preserved."""

    num_attention_heads: int = 30
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 30
    attention_bias: bool = True
    sample_width: int = 90
    sample_height: int = 60
    sample_frames: int = 49
    patch_size: int = 2
    patch_size_t: Optional[int] = None
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = False
    use_learned_positional_embeddings: bool = False
    patch_bias: bool = True
    # conditioning extensions (reference additional arguments)
    modulate_encoder_hidden_states: bool = False
    recon_action: bool = False
    visual_guidance: bool = False
    num_control_keys: int = 2
    multiview: bool = False
    max_n_view: int = 3
    joint_final_norm: bool = False  # 5b family norms [text|video] jointly
    action_dim: int = 7

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


_ATTN_IMPL = {False: "flash", True: "flash_q8"}  # the attention kernel each model runs
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)  # the linears' products


class Embedded(NamedTuple):
    """What `ControlDiT.embed` hands to the blocks and the head: the video
    and text tokens, the time embedding, the per-frame action embedding,
    the training call's action mask and reconstruction, and the geometry
    the head unpatchifies with (B counts every view as a sample)."""

    hidden: torch.Tensor
    enc: torch.Tensor
    temb: torch.Tensor
    action_emb: Optional[torch.Tensor]
    is_action_mask: Optional[torch.Tensor]
    actions_recon: Optional[torch.Tensor]
    num_views: int
    num_frames: int
    height: int
    width: int


def _save_dots(ctx, op, *args, **kwargs):
    """`remat_policy="dots"`: keep the outputs of the 2-D matmuls the linears
    run (JAX's `dots_with_no_batch_dims_saveable`), recompute the rest."""
    CP = torch.utils.checkpoint.CheckpointPolicy
    return CP.MUST_SAVE if op in _DOTS else CP.PREFER_RECOMPUTE


class ControlDiT(nn.Module):
    """The DiT. Parameters live on `device` (CUDA unless `device="cpu"`) in
    `param_dtype`; activations run in `dtype`. Weights start from PyTorch's
    default initialisers; load real or bridged ones with `load_state_dict`
    (keys as `models/weights.py:dit_params_from_jax` emits them). A
    `quant=True` model loads a state dict from
    `models/quantize.py:quantize_linear_params`; `quantize_model_` turns a
    bf16 model into one in place. `attn_impl` must be the one `quant` picks:
    "flash" (bf16 kernel) without it, "flash_q8" (int8-QK^T kernel) with it.
    `sp`: a communicator whose ranks ring every block's joint attention
    (None or size 1: the sequence stays resident). `tp`: a communicator
    whose ranks split every block's heads and feed-forward columns.
    `layers`: the block layers this model holds (default: all). `remat`,
    `remat_policy`: per-block recompute under grad (module docstring)."""

    def __init__(self, config: DiTConfig, dtype=torch.bfloat16, param_dtype=torch.float32,
                 device: DeviceLike = None, quant: bool = False, attn_impl: str = "flash",
                 sp=None, remat: bool = False, remat_policy: Optional[str] = None, tp=None,
                 layers: Optional[Sequence[int]] = None):
        super().__init__()
        if remat_policy not in (None, "dots"):
            raise ValueError(f"remat_policy={remat_policy!r}: None (recompute everything) "
                             "or 'dots' (keep the linears' outputs)")
        if config.use_learned_positional_embeddings:
            raise NotImplementedError(
                "ControlDiT port: use_learned_positional_embeddings=True is refused: the JAX "
                "package reads the field but no module uses it (ROADMAP.md C)")
        if attn_impl != _ATTN_IMPL[quant]:
            raise ValueError(f"attn_impl={attn_impl!r} with quant={quant}: the port builds "
                             f"quant={quant} with attn_impl={_ATTN_IMPL[quant]!r} only")
        device = resolve_device(device)
        c = self.config = config
        self.dtype, self.param_dtype = dtype, param_dtype
        self.quant, self.attn_impl, self.sp, self.tp = quant, attn_impl, sp, tp
        self.remat, self.remat_policy = remat, remat_policy
        self.layers = range(c.num_layers) if layers is None else range(layers[0],
                                                                        layers[-1] + 1)
        self.zero = None  # parallel/fsdp.py:Zero, when the parameters are fsdp shards
        self._view_pos_tables = {}
        inner = c.inner_dim
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.patch_embed = PatchEmbed(
            inner, c.in_channels, c.text_embed_dim, c.patch_size, c.patch_bias,
            c.spatial_interpolation_scale, c.temporal_interpolation_scale, c.patch_size_t,
            not c.use_rotary_positional_embeddings, **kw)
        self.time_embedding = TimestepEmbedding(inner, c.time_embed_dim, **kw)
        self.action_embed = ActionEmbed(c.action_dim, c.time_embed_dim, compress_ratio=4,
                                        patch_size_t=c.patch_size_t, **kw)
        if c.recon_action:
            self.action_recon = ActionRecon(c.action_dim, c.time_embed_dim, compress_ratio=4,
                                            **kw)
        if c.visual_guidance:
            self.initial_combine_linear = nn.Linear(inner * c.num_control_keys, inner,
                                                    device=device, dtype=param_dtype)
        held = lambda make: nn.ModuleList([make(quant, device) if i in self.layers
                                           else nn.Module() for i in range(c.num_layers)])
        if c.multiview:
            self.mv_blocks = held(self.make_mv_block)
        self.transformer_blocks = held(self.make_block)
        self.norm_final = LayerNorm(inner, c.norm_eps, device=device, param_dtype=param_dtype)
        self.norm_out = AdaLayerNormOut(c.time_embed_dim, inner, c.norm_eps, **kw)
        self.proj_out = nn.Linear(inner, c.out_channels * c.patch_size ** 2 * (c.patch_size_t or 1),
                                  device=device, dtype=param_dtype)

    def make_block(self, quant: bool, device) -> DiTBlock:
        """One transformer block of this model's config and dtypes."""
        c = self.config
        return DiTBlock(c.inner_dim, c.num_attention_heads, c.attention_head_dim,
                        c.time_embed_dim, c.modulate_encoder_hidden_states, c.attention_bias,
                        c.norm_eps, quant, sp=self.sp, dtype=self.dtype, device=device,
                        param_dtype=self.param_dtype, tp=self.tp)

    def make_mv_block(self, quant: bool, device) -> MVBlock:
        """One cross-view block of this model's config and dtypes."""
        c = self.config
        return MVBlock(c.inner_dim, c.num_attention_heads, c.attention_head_dim,
                       c.time_embed_dim, c.modulate_encoder_hidden_states, c.attention_bias,
                       c.norm_eps, quant, dtype=self.dtype, device=device,
                       param_dtype=self.param_dtype, tp=self.tp)

    def set_sp(self, sp) -> "ControlDiT":
        """Ring every block's joint attention over the communicator `sp` from
        now on (None: resident); the weights stay as they are."""
        self.sp = sp
        for i in self.layers:
            self.transformer_blocks[i].attn1.sp = sp
        return self

    def _unit(self, key):
        """The fsdp gather of one unit's parameters around its use: a block
        layer (int), "pre" (the embeddings) or "post" (the head)."""
        return contextlib.nullcontext() if self.zero is None else self.zero.gathered(key)

    def _embed_controls(self, depths: Optional[torch.Tensor], labels: Optional[torch.Tensor],
                        num_views: int = 1) -> Optional[torch.Tensor]:
        """Visual-control patch embeds [B*V, S_vid, K*D] (None without
        controls; views stacked on the frame axis are split per view). They
        depend only on (depths, labels), so a sampler computes them once and
        passes them back as `control_cache`."""
        per_view = lambda c: c.reshape(c.shape[0] * num_views, c.shape[1] // num_views,
                                       *c.shape[2:])
        controls = [self.patch_embed.embed_video(per_view(ctrl))
                    for ctrl in (depths, labels) if ctrl is not None]
        if not controls:
            return None
        if len(controls) != self.config.num_control_keys:
            raise ValueError(f"got {len(controls)} controls but "
                             f"num_control_keys={self.config.num_control_keys}")
        return torch.cat(controls, dim=-1)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, V*F, C, H, W] latents (+image latents on C)
        encoder_hidden_states: torch.Tensor,  # [B, S_txt, text_embed_dim]
        timestep: torch.Tensor,  # [B]
        actions: Optional[torch.Tensor] = None,  # [B, F_raw, action_dim]
        depths: Optional[torch.Tensor] = None,  # [B, V*F, C_in, H, W]
        labels: Optional[torch.Tensor] = None,
        control_cache: Optional[torch.Tensor] = None,
        controls_only: bool = False,
        deterministic: bool = True,
        action_mask_u: Optional[torch.Tensor] = None,  # [B] uniforms, training only
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        image_rotary_emb_view: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        num_views: int = 1,
        attn_cache: Optional[List] = None,
        collect_attn: bool = False,
    ):
        """Returns the prediction [B, V*F, out_channels, H, W] in `dtype`, or,
        with `controls_only`, the control embeds (see `_embed_controls`).
        `image_rotary_emb` ([S_video, head_dim] cos and sin of one view) goes
        to every block's joint attention, `image_rotary_emb_view` to every
        MVBlock's. With `collect_attn` the return value gains a last element,
        the per-block (attn_h, attn_e) list that `attn_cache` takes back.

        The training call (`deterministic=False`) returns (prediction,
        is_action_mask [B] bool, actions_recon [B, F_raw, action_dim]), the
        last two None without actions and actions_recon None without
        `recon_action`. With actions it takes `action_mask_u`: the rows with
        u < 0.1 get the learned mask embedding (action CFG)."""
        c = self.config
        if controls_only:
            if not c.visual_guidance:
                return None
            with self._unit("pre"):
                return self._embed_controls(depths, labels, num_views)
        e = self.embed(hidden_states, encoder_hidden_states, timestep, actions, depths, labels,
                       control_cache, deterministic, action_mask_u, num_views)
        if (attn_cache is not None or collect_attn) and c.multiview:
            raise NotImplementedError("PAB attention broadcast does not "
                                      "cover the multiview MVBlock path")
        hidden, enc, collected = self.run_blocks(
            e.hidden, e.enc, e.temb, e.action_emb, image_rotary_emb, image_rotary_emb_view,
            e.num_views, e.num_frames, self.layers, attn_cache, collect_attn)
        out = self.head(hidden, e)
        if collect_attn:
            return (out, collected) if deterministic else (
                out, e.is_action_mask, e.actions_recon, collected)
        return out if deterministic else (out, e.is_action_mask, e.actions_recon)

    def embed(self, hidden_states, encoder_hidden_states, timestep, actions=None, depths=None,
              labels=None, control_cache=None, deterministic: bool = True,
              action_mask_u=None, num_views: int = 1) -> Embedded:
        """The part before the blocks (the JAX model's stage="pre"): the
        time and patch embeddings, the multiview positions, the action
        conditioning and the visual controls."""
        with self._unit("pre"):
            return self._embed(hidden_states, encoder_hidden_states, timestep, actions, depths,
                               labels, control_cache, deterministic, action_mask_u, num_views)

    def _embed(self, hidden_states, encoder_hidden_states, timestep, actions, depths, labels,
               control_cache, deterministic, action_mask_u, num_views) -> Embedded:
        c = self.config
        V = num_views
        if V > 1:  # b (v f) -> (b v) f: every view a sample of its own
            hidden_states = hidden_states.reshape(
                hidden_states.shape[0] * V, hidden_states.shape[1] // V, *hidden_states.shape[2:])
            encoder_hidden_states = encoder_hidden_states.repeat_interleave(V, dim=0)
        B, num_frames, _, height, width = hidden_states.shape

        # 1. time embedding (the views share the noise level)
        t_proj = get_timestep_embedding(timestep, c.inner_dim, flip_sin_to_cos=c.flip_sin_to_cos,
                                        downscale_freq_shift=float(c.freq_shift))
        temb = self.time_embedding(t_proj)
        if V > 1:
            temb = temb.repeat_interleave(V, dim=0)

        # 2. patch embedding
        text_len = encoder_hidden_states.shape[1]
        embeds = self.patch_embed(encoder_hidden_states.to(self.dtype), hidden_states)
        enc = embeds[:, :text_len].contiguous()
        hidden = embeds[:, text_len:].contiguous()

        # 2.1 multiview positional embedding, added per frame across views
        if V > 1:
            hidden = self._add_view_positions(hidden, V, num_frames, height, width)

        # 3. action conditioning: front-pad to 4n-1 frames (ActionEmbed adds one more)
        action_emb = is_action_mask = actions_recon = None
        if actions is not None:
            if not deterministic and action_mask_u is None:
                raise ValueError("the training call (deterministic=False) with actions needs "
                                 "action_mask_u, the [B] uniforms of the action-CFG mask")
            pad_frames = (4 - (actions.shape[1] + 1) % 4) % 4
            if pad_frames > 0:
                actions = torch.cat([torch.zeros_like(actions[:, :pad_frames]), actions], dim=1)
            action_emb, is_action_mask = self.action_embed(
                actions, None if deterministic else action_mask_u)
            if V > 1:
                action_emb = action_emb.repeat_interleave(V, dim=0)
            if c.recon_action and not deterministic:
                actions_recon = self.action_recon(action_emb)[:, pad_frames:]

        # 4. visual-control injection (shared patch embed, combine linear)
        if c.visual_guidance:
            controls = control_cache if control_cache is not None else \
                self._embed_controls(depths, labels, V)
            if controls is not None:
                tiled = hidden.repeat(1, 1, c.num_control_keys)
                hidden = hidden + _linear(tiled + controls, self.initial_combine_linear,
                                          self.dtype)
        return Embedded(hidden, enc, temb, action_emb, is_action_mask, actions_recon, V,
                        num_frames, height, width)

    def run_blocks(self, hidden, enc, temb, action_emb, rope=None, rope_view=None,
                   num_views: int = 1, num_frames: int = 1, layers: Sequence[int] = (),
                   attn_cache=None, collect_attn: bool = False):
        """Block cells `layers` in order (the JAX model's `_BlockCell`s, each
        under remat when asked): returns (hidden, enc, the collected PAB
        attention outputs)."""
        collected = []
        remat = self.remat and torch.is_grad_enabled()
        for i in layers:
            args = (i, hidden, enc, temb, action_emb, rope, rope_view, num_views, num_frames,
                    None if attn_cache is None else attn_cache[i], collect_attn)
            if remat:
                out = torch.utils.checkpoint.checkpoint(
                    self._cell, *args, use_reentrant=False, context_fn=self._remat_context)
            else:
                out = self._cell(*args)
            hidden, enc = out[:2]
            if collect_attn:
                collected.append(out[2])
        return hidden, enc, collected

    def head(self, hidden, e: Embedded, enc=None) -> torch.Tensor:
        """The part after the blocks (the JAX model's stage="post"): final
        norm, AdaLN out, projection, unpatchify. The 5b family's
        joint_final_norm norms [text | video] together; the LayerNorm is per
        token, so that equals norming the video tokens alone, and `enc` is
        not read."""
        c = self.config
        with self._unit("post"):
            hidden = self.norm_final(hidden)
            hidden = self.norm_out(hidden, e.temb, e.action_emb)
            hidden = _linear(hidden, self.proj_out, self.dtype)
        B, V, num_frames = hidden.shape[0], e.num_views, e.num_frames
        p, pt = c.patch_size, c.patch_size_t or 1
        h, w = e.height // p, e.width // p
        return (hidden.reshape(B, num_frames // pt, h, w, c.out_channels, pt, p, p)
                .permute(0, 1, 5, 4, 2, 6, 3, 7)
                .reshape(B // V, V * num_frames, c.out_channels, e.height, e.width))

    def _cell(self, i: int, hidden, enc, temb, action_emb, rope, rope_view, V: int,
              num_frames: int, cached_attn, collect_attn: bool):
        """One step of the block loop, the unit of remat and of the fsdp
        gather: the MVBlock (of a multiview model), then the DiTBlock."""
        with self._unit(i):
            if self.config.multiview:
                hidden = self.mv_blocks[i](hidden, enc, temb, rope_view, V, num_frames)
            return self.transformer_blocks[i](hidden, enc, temb, action_emb, rope, cached_attn,
                                              collect_attn)

    def _remat_context(self):
        """The checkpoint's context: everything recomputed, or with
        `remat_policy="dots"` the matmuls' outputs kept."""
        if self.remat_policy != "dots":
            return torch.utils.checkpoint.noop_context_fn()
        return torch.utils.checkpoint.create_selective_checkpoint_contexts(_save_dots)

    def _add_view_positions(self, hidden, V: int, num_frames: int, height: int, width: int):
        """hidden [(b v), (f s), D] plus the sin-cos table over (view, h, w),
        the same for every frame: (b v)(f s) -> (b f)(v s), add, and back."""
        c = self.config
        BV, FS, D = hidden.shape
        b, s = BV // V, FS // num_frames
        key = (V, height, width, hidden.device, hidden.dtype)
        pos = self._view_pos_tables.get(key)
        if pos is None:
            table = get_3d_sincos_pos_embed(D, (width // c.patch_size, height // c.patch_size), V,
                                            c.spatial_interpolation_scale, 1.0)
            with torch.inference_mode(False):  # as PatchEmbed's own table
                pos = torch.from_numpy(table).to(hidden.device, hidden.dtype).reshape(1, -1, D)
            self._view_pos_tables[key] = pos
        hidden = hidden.reshape(b, V, num_frames, s, D).transpose(1, 2).reshape(
            b * num_frames, V * s, D) + pos
        return hidden.reshape(b, num_frames, V, s, D).transpose(1, 2).reshape(BV, FS, D)
