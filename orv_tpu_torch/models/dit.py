"""ControlDiT — the action/image/occupancy-conditioned video diffusion
transformer, in PyTorch.

Counterpart of `orv_tpu/models/dit.py`:
  patch_embed(text, video latents) -> [text | video] token sequence
  + ActionEmbed conditioning (adds to temb per frame inside adaLN)
  + visual-control injection: depth/label latents through the *shared*
    patch_embed, combine linear, single residual add
  -> num_layers x DiTBlock (an nn.ModuleList; the JAX package scans them)
  -> final LayerNorm -> AdaLN out -> proj_out -> unpatchify

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
`LocalRing(n).run`. Inference only: the ring raises under grad mode.

Not ported yet (the constructor raises on them): multiview, RoPE, learned
positions, `patch_size_t` (CogVideoX 1.5), the joint final norm (5b).
Pipeline stages, remat and the PAB attention cache are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from orv_tpu_torch.models.layers import (
    ActionEmbed,
    ActionRecon,
    AdaLayerNormOut,
    DiTBlock,
    LayerNorm,
    PatchEmbed,
    TimestepEmbedding,
    _linear,
)
from orv_tpu_torch.utils.device import DeviceLike, resolve_device
from orv_tpu_torch.utils.embeddings import get_timestep_embedding


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
_UNPORTED = ("multiview", "use_rotary_positional_embeddings",
             "use_learned_positional_embeddings", "joint_final_norm")


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
    (None or size 1: the sequence stays resident)."""

    def __init__(self, config: DiTConfig, dtype=torch.bfloat16, param_dtype=torch.float32,
                 device: DeviceLike = None, quant: bool = False, attn_impl: str = "flash",
                 sp=None):
        super().__init__()
        for name in _UNPORTED:
            if getattr(config, name):
                raise NotImplementedError(f"ControlDiT port: {name}=True is not ported yet")
        if config.patch_size_t is not None:
            raise NotImplementedError("ControlDiT port: patch_size_t is not ported yet")
        if attn_impl != _ATTN_IMPL[quant]:
            raise ValueError(f"attn_impl={attn_impl!r} with quant={quant}: the port builds "
                             f"quant={quant} with attn_impl={_ATTN_IMPL[quant]!r} only")
        device = resolve_device(device)
        c = self.config = config
        self.dtype, self.param_dtype = dtype, param_dtype
        self.quant, self.attn_impl, self.sp = quant, attn_impl, sp
        inner = c.inner_dim
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.patch_embed = PatchEmbed(
            inner, c.in_channels, c.text_embed_dim, c.patch_size, c.patch_bias,
            c.spatial_interpolation_scale, c.temporal_interpolation_scale, **kw)
        self.time_embedding = TimestepEmbedding(inner, c.time_embed_dim, **kw)
        self.action_embed = ActionEmbed(c.action_dim, c.time_embed_dim, compress_ratio=4, **kw)
        if c.recon_action:
            self.action_recon = ActionRecon(c.action_dim, c.time_embed_dim, compress_ratio=4,
                                            **kw)
        if c.visual_guidance:
            self.initial_combine_linear = nn.Linear(inner * c.num_control_keys, inner,
                                                    device=device, dtype=param_dtype)
        self.transformer_blocks = nn.ModuleList([
            self.make_block(quant, device) for _ in range(c.num_layers)])
        self.norm_final = LayerNorm(inner, c.norm_eps, device=device, param_dtype=param_dtype)
        self.norm_out = AdaLayerNormOut(c.time_embed_dim, inner, c.norm_eps, **kw)
        self.proj_out = nn.Linear(inner, c.out_channels * c.patch_size ** 2, device=device,
                                  dtype=param_dtype)

    def make_block(self, quant: bool, device) -> DiTBlock:
        """One transformer block of this model's config and dtypes."""
        c = self.config
        return DiTBlock(c.inner_dim, c.num_attention_heads, c.attention_head_dim,
                        c.time_embed_dim, c.modulate_encoder_hidden_states, c.attention_bias,
                        c.norm_eps, quant, sp=self.sp, dtype=self.dtype, device=device,
                        param_dtype=self.param_dtype)

    def set_sp(self, sp) -> "ControlDiT":
        """Ring every block's joint attention over the communicator `sp` from
        now on (None: resident); the weights stay as they are."""
        self.sp = sp
        for block in self.transformer_blocks:
            block.attn1.sp = sp
        return self

    def _embed_controls(self, depths: Optional[torch.Tensor],
                        labels: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Visual-control patch embeds [B, S_vid, K*D] (None without
        controls). They depend only on (depths, labels), so a sampler
        computes them once and passes them back as `control_cache`."""
        controls = [self.patch_embed.embed_video(ctrl)
                    for ctrl in (depths, labels) if ctrl is not None]
        if not controls:
            return None
        if len(controls) != self.config.num_control_keys:
            raise ValueError(f"got {len(controls)} controls but "
                             f"num_control_keys={self.config.num_control_keys}")
        return torch.cat(controls, dim=-1)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, F, C, H, W] latents (+image latents on C)
        encoder_hidden_states: torch.Tensor,  # [B, S_txt, text_embed_dim]
        timestep: torch.Tensor,  # [B]
        actions: Optional[torch.Tensor] = None,  # [B, F_raw, action_dim]
        depths: Optional[torch.Tensor] = None,  # [B, F, C_in, H, W]
        labels: Optional[torch.Tensor] = None,
        control_cache: Optional[torch.Tensor] = None,
        controls_only: bool = False,
        deterministic: bool = True,
        action_mask_u: Optional[torch.Tensor] = None,  # [B] uniforms, training only
    ):
        """Returns the prediction [B, F, out_channels, H, W] in `dtype`, or,
        with `controls_only`, the control embeds (see `_embed_controls`).

        The training call (`deterministic=False`) returns (prediction,
        is_action_mask [B] bool, actions_recon [B, F_raw, action_dim]), the
        last two None without actions and actions_recon None without
        `recon_action`. With actions it takes `action_mask_u`: the rows with
        u < 0.1 get the learned mask embedding (action CFG)."""
        c = self.config
        if c.visual_guidance and controls_only:
            return self._embed_controls(depths, labels)
        if controls_only:
            return None
        B, num_frames, _, height, width = hidden_states.shape

        # 1. time embedding
        t_proj = get_timestep_embedding(timestep, c.inner_dim, flip_sin_to_cos=c.flip_sin_to_cos,
                                        downscale_freq_shift=float(c.freq_shift))
        temb = self.time_embedding(t_proj)

        # 2. patch embedding
        text_len = encoder_hidden_states.shape[1]
        embeds = self.patch_embed(encoder_hidden_states.to(self.dtype), hidden_states)
        enc = embeds[:, :text_len].contiguous()
        hidden = embeds[:, text_len:].contiguous()

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
            if c.recon_action and not deterministic:
                actions_recon = self.action_recon(action_emb)[:, pad_frames:]

        # 4. visual-control injection (shared patch embed, combine linear)
        if c.visual_guidance:
            controls = control_cache if control_cache is not None else \
                self._embed_controls(depths, labels)
            if controls is not None:
                tiled = hidden.repeat(1, 1, c.num_control_keys)
                hidden = hidden + _linear(tiled + controls, self.initial_combine_linear,
                                          self.dtype)

        # 5. blocks
        for block in self.transformer_blocks:
            hidden, enc = block(hidden, enc, temb, action_emb)

        # 6. final norm, AdaLN out, projection, unpatchify
        hidden = self.norm_final(hidden)
        hidden = self.norm_out(hidden, temb, action_emb)
        hidden = _linear(hidden, self.proj_out, self.dtype)
        p = c.patch_size
        h, w = height // p, width // p
        out = (hidden.reshape(B, num_frames, h, w, c.out_channels, p, p)
               .permute(0, 1, 4, 2, 5, 3, 6)
               .reshape(B, num_frames, c.out_channels, height, width))
        if deterministic:
            return out
        return out, is_action_mask, actions_recon
