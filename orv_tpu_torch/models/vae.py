"""Causal 3D VAE (CogVideoX family), in PyTorch.

Counterpart of `orv_tpu/models/vae.py`. Semantics reproduced:

  * causal conv3d: temporal front-pad replicates the FIRST frame (k_t - 1
    copies); in streaming (chunked) decode the pad is the previous chunk's
    last k_t - 1 frames of the *padded* input (the conv cache)
  * temporal x4 compression via two "keep the first frame of a first chunk
    with odd T, average pairs of the rest" downsamples; spatial x8 via
    three stride-2 convs with an asymmetric (0, 1) pad
  * encode returns MOMENTS [B, 2C, T', H', W'] f32 (mean and logvar)
  * decoder resnets normalize with SpatialNorm3D conditioned on the latent
    zq, nearest-resized with the odd-first-frame split
  * temporal x4 upsampling via two "first frame spatial-only, the rest
    doubled in time" upsamplers; spatial x8 via three nearest-2x + conv

Layout is PyTorch's channels-first [B, C, T, H, W] throughout. Convolutions
are `torch.nn.functional.conv3d` (cuDNN on the card), as the JAX package
leaves them to XLA: this path has no Pallas kernel. Module names follow the
diffusers keys (`encoder.down_blocks.{i}.downsamplers.0.conv`,
`decoder.up_blocks.{i}.resnets.{j}.norm1.conv_y.conv`...).

`encode_chunked` and `encode_auto` chunk exactly as the JAX package does
(GroupNorm statistics are per chunk), so their numbers follow it whatever
the card could hold at once. `tiled_decode` is the JAX package's spatially
tiled decode with its linear-ramp overlap-add, around any decode function.
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
    """Two norm-SiLU-conv stages and a residual. The decoder's norms are
    SpatialNorm3D on the latent zq, the encoder's (`zq_channels=None`)
    plain GroupNorm."""

    def __init__(self, in_channels: int, out_channels: int, zq_channels: Optional[int] = 16,
                 groups: int = 32, eps: float = 1e-6, device=None, param_dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, param_dtype=param_dtype)
        if zq_channels is None:
            norm = lambda ch: GroupNorm(ch, groups, eps, **kw)
        else:
            norm = lambda ch: SpatialNorm3D(ch, zq_channels, groups, eps, **kw)
        self.norm1 = norm(in_channels)
        self.conv1 = CausalConv3d(in_channels, out_channels, (3, 3, 3), **kw)
        self.norm2 = norm(out_channels)
        self.conv2 = CausalConv3d(out_channels, out_channels, (3, 3, 3), **kw)
        self.conv_shortcut = (CausalConv3d(in_channels, out_channels, (1, 1, 1), **kw)
                              if in_channels != out_channels else None)

    def _norm(self, norm, h, zq, first_chunk):
        return norm(h) if isinstance(norm, GroupNorm) else norm(h, zq, first_chunk)

    def forward(self, x, zq=None, first_chunk: bool = True):
        h = self.conv1(F.silu(self._norm(self.norm1, x, zq, first_chunk)), first_chunk)
        h = self.conv2(F.silu(self._norm(self.norm2, h, zq, first_chunk)), first_chunk)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample3D(nn.Module):
    """Optional temporal compression (the first frame of a first chunk with
    odd T > 1 kept, pairs of the rest averaged), then a stride-2 3x3 conv
    over every frame after a (0, 1) pad of H and W."""

    def __init__(self, channels: int, compress_time: bool = False, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, device=device,
                              dtype=param_dtype)

    def forward(self, x, first_chunk: bool = True):
        T = x.shape[2]
        if self.compress_time:
            if first_chunk and T % 2 == 1 and T > 1:
                rest = x[:, :, 1:]
                x = torch.cat([x[:, :, :1], 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])], dim=2)
            elif T > 1:
                x = 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])
        x = F.pad(x, (0, 1, 0, 1))
        return F.conv3d(x, self.conv.weight.to(x.dtype)[:, :, None],
                        self.conv.bias.to(x.dtype), stride=(1, 2, 2))


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
    """Container matching the checkpoint's `mid_block`, `down_blocks.{i}`
    and `up_blocks.{i}`."""

    def __init__(self, resnets, upsampler=None, downsampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsampler is not None:
            self.upsamplers = nn.ModuleList([upsampler])
        if downsampler is not None:
            self.downsamplers = nn.ModuleList([downsampler])


class Encoder3D(nn.Module):
    def __init__(self, config: VAEConfig, device=None, param_dtype=torch.float32):
        super().__init__()
        c = config
        kw = dict(device=device, param_dtype=param_dtype)
        res = lambda i, o: ResnetBlock3D(i, o, None, c.norm_num_groups, c.norm_eps, **kw)
        ch = c.block_out_channels[0]
        self.conv_in = CausalConv3d(c.in_channels, ch, (3, 3, 3), **kw)
        stages = []
        nb = len(c.block_out_channels)
        for i, out_ch in enumerate(c.block_out_channels):
            resnets = [res(ch if j == 0 else out_ch, out_ch) for j in range(c.layers_per_block)]
            ch = out_ch
            down = (Downsample3D(out_ch, compress_time=i < c.temporal_compress_level, **kw)
                    if i < nb - 1 else None)
            stages.append(_Stage(resnets, downsampler=down))
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = _Stage([res(ch, ch) for _ in range(2)])
        self.norm_out = GroupNorm(ch, c.norm_num_groups, c.norm_eps, **kw)
        self.conv_out = CausalConv3d(ch, 2 * c.latent_channels, (3, 3, 3), **kw)

    def forward(self, x, first_chunk: bool = True):
        h = self.conv_in(x, first_chunk)
        for stage in self.down_blocks:
            for r in stage.resnets:
                h = r(h, first_chunk=first_chunk)
            if hasattr(stage, "downsamplers"):
                h = stage.downsamplers[0](h, first_chunk)
        for r in self.mid_block.resnets:
            h = r(h, first_chunk=first_chunk)
        return self.conv_out(F.silu(self.norm_out(h)), first_chunk)


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
            stages.append(_Stage(resnets, upsampler=up))
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
    """encode(video [B, 3, T, H, W] in [-1, 1]) -> moments [B, 2C_lat, T',
    H', W'] f32; decode(latents [B, C_lat, T', H', W']) -> video [B, 3, T,
    H, W] f32. T is 8n+1. Parameters live on `device` (CUDA unless
    `device="cpu"`) in `param_dtype`; activations run in `dtype`."""

    def __init__(self, config: VAEConfig = VAEConfig(), dtype=torch.bfloat16,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        device = resolve_device(device)
        self.encoder = Encoder3D(config, device, param_dtype)
        self.decoder = Decoder3D(config, device, param_dtype)

    def encode(self, video, first_chunk: bool = True):
        return self.encoder(video.to(self.dtype), first_chunk).float()

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
    return _chunked(vae, vae.decode, latents, chunk_latent_frames, "decode_chunked", device)


def _chunked(vae: CausalVAE, method, x: torch.Tensor, chunk: int, what: str,
             device: DeviceLike) -> torch.Tensor:
    """`method` over frame chunks [0, 1), [1, 1 + chunk), ... of x [B, C, T,
    H, W] with the conv caches carried across chunks (cleared before and
    after)."""
    device = resolve_device(device)
    check_module_device(vae, device, f"{what}: the VAE")
    x = x.to(device)
    T = x.shape[2]
    bounds = [(0, 1)] + [(i, min(i + chunk, T)) for i in range(1, T, chunk)]
    vae.clear_cache()
    try:
        outs = [method(x[:, :, s:e], first_chunk=(ci == 0)) for ci, (s, e) in enumerate(bounds)]
    finally:
        vae.clear_cache()
    return torch.cat(outs, dim=2)


@torch.inference_mode()
def encode_chunked(vae: CausalVAE, video: torch.Tensor, chunk_frames: int = 8,
                   device: DeviceLike = None) -> torch.Tensor:
    """Frame-chunked streaming encode of video [B, C, T, H, W] (T = 8n+1)
    in raw-frame chunks [1, k, k, ...]: memory scales with the chunk. The
    conv caches keep the causal convs exact across chunk bounds; GroupNorm
    statistics are per chunk, as in the JAX package."""
    return _chunked(vae, vae.encode, video, chunk_frames, "encode_chunked", device)


@torch.inference_mode()
def encode_auto(vae: CausalVAE, video: torch.Tensor, chunk_frames: int = 8,
                device: DeviceLike = None) -> torch.Tensor:
    """Encode [B, C, T, H, W] to moments: streamed through `encode_chunked`
    when T > chunk_frames + 1, one-shot otherwise, as the JAX package
    decides (the numbers differ between the two, so the rule is kept
    whatever the card could hold)."""
    if video.shape[2] > chunk_frames + 1:
        return encode_chunked(vae, video, chunk_frames, device)
    device = resolve_device(device)
    check_module_device(vae, device, "encode_auto: the VAE")
    vae.clear_cache()
    try:
        return vae.encode(video.to(device))
    finally:
        vae.clear_cache()


def tiled_decode(decode_fn, latents: torch.Tensor, tile_latent_h: int = 24,
                 tile_latent_w: int = 32, overlap: int = 8, out_channels: int = 3,
                 temporal_expand: int = 4) -> torch.Tensor:
    """Spatially tiled decode with normalised linear-ramp overlap-add
    (orv_tpu/models/vae.py:493-580; the reference's `enable_tiling`).

    latents [B, C, T, H, W] are zero-padded so that every tile has the same
    th x tw latent size (th = min(tile_latent_h, H), likewise tw); tiles
    start every th - overlap rows and tw - overlap columns (one tile, no
    overlap, where the latents fit in one). `decode_fn` maps a tile [B, C,
    T, th, tw] to video [B, out_channels, T_out, 8 th, 8 tw] (for example a
    closure over `decode_chunked`); each decoded tile is weighted by the
    outer product of two ramps that rise over the overlap's 8 * overlap
    pixels ((1..n) / (n + 1), never 0) and fall back at the far edge, added
    into an f32 canvas, and the canvas is divided by the summed weights.
    Returns f32 [B, out_channels, T_out, 8 H, 8 W], T_out = (T - 1) *
    temporal_expand + 1 (1 for T = 1), on the latents' device."""
    B, C, T, H, W = latents.shape
    sf = 8
    th, tw = min(tile_latent_h, H), min(tile_latent_w, W)
    overlap = min(overlap, max(0, min(th, tw) - 1))
    if H <= th and W <= tw:
        overlap = 0  # one tile: no seams to blend
    step_h, step_w = max(1, th - overlap), max(1, tw - overlap)
    n_th = 1 if H <= th else -(-(H - th) // step_h) + 1
    n_tw = 1 if W <= tw else -(-(W - tw) // step_w) + 1
    pad_h = (n_th - 1) * step_h + th - H
    pad_w = (n_tw - 1) * step_w + tw - W
    z = F.pad(latents, (0, pad_w, 0, pad_h))

    def ramp(n_px: int, ov_px: int) -> torch.Tensor:
        w = torch.ones(n_px, dtype=torch.float64)
        if ov_px > 0:
            r = (torch.arange(ov_px, dtype=torch.float64) + 1.0) / (ov_px + 1.0)
            w[:ov_px] = r
            w[-ov_px:] = r.flip(0)
        return w

    ov_px = overlap * sf
    w_tile = torch.outer(ramp(th * sf, ov_px), ramp(tw * sf, ov_px)).to(
        device=latents.device, dtype=torch.float32)
    T_out = (T - 1) * temporal_expand + 1 if T > 1 else 1
    canvas = torch.zeros((B, out_channels, T_out, z.shape[3] * sf, z.shape[4] * sf),
                         dtype=torch.float32, device=latents.device)
    weight = torch.zeros(canvas.shape[3:], dtype=torch.float32, device=latents.device)
    for ti in range(n_th):
        for tj in range(n_tw):
            r, c = ti * step_h, tj * step_w
            tile = decode_fn(z[:, :, :, r:r + th, c:c + tw]).float()
            canvas[..., r * sf:(r + th) * sf, c * sf:(c + tw) * sf] += tile * w_tile
            weight[r * sf:(r + th) * sf, c * sf:(c + tw) * sf] += w_tile
    return (canvas / weight)[..., :H * sf, :W * sf]
