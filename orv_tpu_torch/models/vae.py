"""Causal 3D VAE (CogVideoX family), decode side, in PyTorch.

Counterpart of `orv_tpu/models/vae.py`. Semantics reproduced:

  * causal conv3d: temporal front-pad replicates the FIRST frame (k_t - 1
    copies); in streaming (chunked) decode the pad is the previous chunk's
    last k_t - 1 frames of the *padded* input (the conv cache)
  * decoder resnets normalize with SpatialNorm3D conditioned on the latent
    zq, nearest-resized with the odd-first-frame split
  * temporal x4 upsampling via two "first frame spatial-only, the rest
    doubled in time" upsamplers; spatial x8 via three nearest-2x + conv

Layout is PyTorch's channels-first [B, C, T, H, W] throughout. Convolutions
are `torch.nn.functional.conv3d` (cuDNN on the card), as the JAX package
leaves them to XLA: this path has no Pallas kernel. Module names follow the
diffusers keys (`decoder.up_blocks.{i}.resnets.{j}.norm1.conv_y.conv`...).

The encoder, `encode_chunked` and `tiled_decode` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from orv_tpu_torch.utils.device import DeviceLike, check_module_device, resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """CogVideoX-2b VAE config (HF vae/config.json values)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    scaling_factor: float = 1.15258426
    invert_scale_latents: bool = False

    @property
    def temporal_compress_level(self) -> int:
        return int(math.log2(self.temporal_compression_ratio))


class GroupNorm(nn.Module):
    """GroupNorm with f32 statistics per sample over (C/groups, T, H, W)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=param_dtype))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class CausalConv3d(nn.Module):
    """conv3d with first-frame-replicate temporal front pad and zero spatial
    SAME pad. Every call with k_t > 1 keeps the last k_t - 1 frames of its
    padded input in `conv_cache`; a call with `first_chunk=False` pads from
    that cache instead, so chunked decode is causally continuous."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3), device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv3d(in_channels, out_channels, kernel, device=device,
                              dtype=param_dtype)
        self.conv_cache: Optional[torch.Tensor] = None

    def forward(self, x, first_chunk: bool = True):
        kt, kh, kw = self.kernel
        if kt > 1:
            if first_chunk:
                pad = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
            else:
                if self.conv_cache is None:
                    raise ValueError("first_chunk=False requires a primed conv cache")
                pad = self.conv_cache.to(x.dtype)
            x = torch.cat([pad, x], dim=2)
            self.conv_cache = x[:, :, -(kt - 1):].clone()
        return F.conv3d(x, self.conv.weight.to(x.dtype), self.conv.bias.to(x.dtype),
                        padding=(0, (kh - 1) // 2, (kw - 1) // 2))


def _nearest(z, size):
    """Nearest resize with half-pixel centres (jax.image.resize "nearest")."""
    if tuple(z.shape[2:]) == tuple(size):
        return z
    return F.interpolate(z, size=size, mode="nearest-exact")


class SpatialNorm3D(nn.Module):
    """Decoder norm conditioned on the latent zq: GroupNorm(f) * conv_y(zq)
    + conv_b(zq), zq nearest-resized with the odd-first-frame split."""

    def __init__(self, f_channels: int, zq_channels: int, groups: int = 32, eps: float = 1e-6,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        self.norm_layer = GroupNorm(f_channels, groups, eps, **kw)
        self.conv_y = CausalConv3d(zq_channels, f_channels, (1, 1, 1), **kw)
        self.conv_b = CausalConv3d(zq_channels, f_channels, (1, 1, 1), **kw)

    def forward(self, f, zq, first_chunk: bool = True):
        T, H, W = f.shape[2:]
        if first_chunk and T > 1 and T % 2 == 1:
            # the leading single frame resizes separately (full-clip layout)
            zq = torch.cat([_nearest(zq[:, :, :1], (1, H, W)),
                            _nearest(zq[:, :, 1:], (T - 1, H, W))], dim=2)
        else:
            zq = _nearest(zq, (T, H, W))
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, zq_channels: int = 16,
                 groups: int = 32, eps: float = 1e-6, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        self.norm1 = SpatialNorm3D(in_channels, zq_channels, groups, eps, **kw)
        self.conv1 = CausalConv3d(in_channels, out_channels, (3, 3, 3), **kw)
        self.norm2 = SpatialNorm3D(out_channels, zq_channels, groups, eps, **kw)
        self.conv2 = CausalConv3d(out_channels, out_channels, (3, 3, 3), **kw)
        self.conv_shortcut = (CausalConv3d(in_channels, out_channels, (1, 1, 1), **kw)
                              if in_channels != out_channels else None)

    def forward(self, x, zq, first_chunk: bool = True):
        h = self.conv1(F.silu(self.norm1(x, zq, first_chunk)), first_chunk)
        h = self.conv2(F.silu(self.norm2(h, zq, first_chunk)), first_chunk)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Upsample3D(nn.Module):
    """Nearest 2x spatial upsample + 3x3 conv (the literal lowering, not the
    JAX package's opt-in phase decomposition); with compress_time the first
    frame of a first chunk upsamples spatially only and the rest also double
    in time."""

    def __init__(self, channels: int, compress_time: bool = False, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device,
                              dtype=param_dtype)

    def forward(self, x, first_chunk: bool = True):
        T = x.shape[2]

        def up(z, t_scale):
            t, h, w = z.shape[2:]
            return _nearest(z, (t * t_scale, 2 * h, 2 * w))

        if self.compress_time:
            if first_chunk and T > 1 and T % 2 == 1:
                x = torch.cat([up(x[:, :, :1], 1), up(x[:, :, 1:], 2)], dim=2)
            elif T > 1 or not first_chunk:
                x = up(x, 2)
            else:
                x = up(x, 1)
        else:
            x = up(x, 1)
        # the 2D conv over every frame, as a (1, 3, 3) conv3d
        return F.conv3d(x, self.conv.weight.to(x.dtype)[:, :, None],
                        self.conv.bias.to(x.dtype), padding=(0, 1, 1))


class _Stage(nn.Module):
    """Container matching the checkpoint's `mid_block` / `up_blocks.{i}`."""

    def __init__(self, resnets, upsampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsampler is not None:
            self.upsamplers = nn.ModuleList([upsampler])


class Decoder3D(nn.Module):
    def __init__(self, config: VAEConfig, device=None, param_dtype=torch.float32):
        super().__init__()
        c = config
        kw = dict(device=device, param_dtype=param_dtype)
        res = lambda i, o: ResnetBlock3D(i, o, c.latent_channels, c.norm_num_groups,
                                         c.norm_eps, **kw)
        reversed_ch = tuple(reversed(c.block_out_channels))
        ch = reversed_ch[0]
        self.conv_in = CausalConv3d(c.latent_channels, ch, (3, 3, 3), **kw)
        self.mid_block = _Stage([res(ch, ch) for _ in range(2)])
        stages = []
        for i, out_ch in enumerate(reversed_ch):
            resnets = [res(ch if j == 0 else out_ch, out_ch)
                       for j in range(c.layers_per_block + 1)]
            ch = out_ch
            up = (Upsample3D(out_ch, compress_time=i < c.temporal_compress_level, **kw)
                  if i < len(reversed_ch) - 1 else None)
            stages.append(_Stage(resnets, up))
        self.up_blocks = nn.ModuleList(stages)
        self.norm_out = SpatialNorm3D(ch, c.latent_channels, c.norm_num_groups, c.norm_eps, **kw)
        self.conv_out = CausalConv3d(ch, c.out_channels, (3, 3, 3), **kw)

    def forward(self, z, first_chunk: bool = True):
        h = self.conv_in(z, first_chunk)
        for r in self.mid_block.resnets:
            h = r(h, z, first_chunk)
        for stage in self.up_blocks:
            for r in stage.resnets:
                h = r(h, z, first_chunk)
            if hasattr(stage, "upsamplers"):
                h = stage.upsamplers[0](h, first_chunk)
        h = self.norm_out(h, z, first_chunk)
        return self.conv_out(F.silu(h), first_chunk)


class CausalVAE(nn.Module):
    """decode(latents [B, C_lat, T', H', W']) -> video [B, 3, T, H, W] f32.
    Parameters live on `device` (CUDA unless `device="cpu"`) in
    `param_dtype`; activations run in `dtype`."""

    def __init__(self, config: VAEConfig = VAEConfig(), dtype=torch.bfloat16,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.decoder = Decoder3D(config, resolve_device(device), param_dtype)

    def decode(self, latents, first_chunk: bool = True):
        return self.decoder(latents.to(self.dtype), first_chunk).float()

    def clear_cache(self) -> None:
        """Drop every conv cache (frees the streaming state)."""
        for m in self.modules():
            if isinstance(m, CausalConv3d):
                m.conv_cache = None


@torch.inference_mode()
def decode_chunked(vae: CausalVAE, latents: torch.Tensor, chunk_latent_frames: int = 2,
                   device: DeviceLike = None) -> torch.Tensor:
    """Frame-chunked streaming decode of latents [B, C, T', H, W]: chunks of
    [1, k, k, ...] latent frames with conv caches; the first chunk carries
    the single leading frame so temporal upsampling matches the full-clip
    layout. GroupNorm statistics are per chunk, as in the JAX package."""
    device = resolve_device(device)
    check_module_device(vae, device, "decode_chunked: the VAE")
    latents = latents.to(device)
    T = latents.shape[2]
    bounds = [(0, 1)] + [(i, min(i + chunk_latent_frames, T))
                         for i in range(1, T, chunk_latent_frames)]
    vae.clear_cache()
    try:
        outs = [vae.decode(latents[:, :, s:e], first_chunk=(ci == 0))
                for ci, (s, e) in enumerate(bounds)]
    finally:
        vae.clear_cache()
    return torch.cat(outs, dim=2)
