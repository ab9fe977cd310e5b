"""Timestep, sin-cos and rotary positional embedding tables.

Counterpart of `orv_tpu/utils/embeddings.py` (diffusers
`get_timestep_embedding` / `get_3d_sincos_pos_embed` /
`get_3d_rotary_pos_embed` semantics). The sin-cos and rotary tables are
float64 numpy, copied verbatim and cast to f32 at the end, as in the JAX
package; `prepare_rotary_positional_embeddings` turns the rotary pair into
tensors on the caller's device. The rotary layout is interleaved pairs
(`np.repeat(..., 2, axis=1)`): channels (2i, 2i+1) rotate together.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from orv_tpu_torch.utils.device import DeviceLike, resolve_device


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, [B] -> [B, embedding_dim] f32:
    frequencies exp(-ln(max_period) * i / (half - shift)), sin block then
    cos block, flipped to cos-first when `flip_sin_to_cos`."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _sincos_1d_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[S] -> [S, embed_dim]; first half sin, second half cos."""
    if embed_dim % 2 != 0:
        raise ValueError("embed_dim must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("s,d->sd", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _sincos_2d_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    """grid [2, ...] -> [N, embed_dim]; h-embedding first, then w."""
    emb_h = _sincos_1d_from_grid(embed_dim // 2, grid[0])
    emb_w = _sincos_1d_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_3d_sincos_pos_embed(
    embed_dim: int,
    spatial_size: Tuple[int, int],
    temporal_size: int,
    spatial_interpolation_scale: float = 1.0,
    temporal_interpolation_scale: float = 1.0,
) -> np.ndarray:
    """3D (t, h, w) sin-cos table -> [T, H*W, D].

    Layout: temporal sin-cos occupies the leading D/4 channels, spatial 2D
    sin-cos the trailing 3D/4. spatial_size is (W, H) following the call
    convention of the reference.
    """
    if embed_dim % 4 != 0:
        raise ValueError("embed_dim must be divisible by 4")
    embed_dim_spatial = 3 * embed_dim // 4
    embed_dim_temporal = embed_dim // 4

    # spatial grid: meshgrid(w_coords, h_coords) -> grid[0] varies along w
    grid_h = np.arange(spatial_size[1], dtype=np.float64) / spatial_interpolation_scale
    grid_w = np.arange(spatial_size[0], dtype=np.float64) / spatial_interpolation_scale
    grid = np.meshgrid(grid_w, grid_h)  # here w goes first
    grid = np.stack(grid, axis=0).reshape(2, 1, spatial_size[1], spatial_size[0])
    pos_embed_spatial = _sincos_2d_from_grid(embed_dim_spatial, grid)  # [H*W, 3D/4]

    grid_t = np.arange(temporal_size, dtype=np.float64) / temporal_interpolation_scale
    pos_embed_temporal = _sincos_1d_from_grid(embed_dim_temporal, grid_t)  # [T, D/4]

    pos_embed_temporal = np.repeat(
        pos_embed_temporal[:, np.newaxis, :], spatial_size[0] * spatial_size[1], axis=1
    )
    pos_embed_spatial = np.repeat(
        pos_embed_spatial[np.newaxis, :, :], temporal_size, axis=0
    )
    pos = np.concatenate([pos_embed_temporal, pos_embed_spatial], axis=-1)
    return pos.astype(np.float32)  # [T, H*W, D]


def get_resize_crop_region_for_grid(src: Tuple[int, int], tgt_width: int, tgt_height: int):
    """Aspect-preserving center-crop region of the (h, w) grid inside the
    base grid: ((top, left), (bottom, right))."""
    th, tw = tgt_height, tgt_width
    h, w = src
    r = h / w
    if r > (th / tw):
        resize_height = th
        resize_width = int(round(th / h * w))
    else:
        resize_width = tw
        resize_height = int(round(tw / w * h))
    crop_top = int(round((th - resize_height) / 2.0))
    crop_left = int(round((tw - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height, crop_left + resize_width)


def _rotary_1d(dim: int, pos: np.ndarray, theta: float = 10000.0):
    """cos/sin tables for 1D RoPE, interleave-repeated to [S, dim]."""
    freqs = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim)
    freqs = np.einsum("s,d->sd", pos.astype(np.float64), freqs)  # [S, dim/2]
    cos = np.repeat(np.cos(freqs), 2, axis=1)  # interleaved pair layout
    sin = np.repeat(np.sin(freqs), 2, axis=1)
    return cos, sin


def get_3d_rotary_pos_embed(
    embed_dim: int,
    crops_coords: Optional[Tuple[Tuple[int, int], Tuple[int, int]]],
    grid_size: Tuple[int, int],
    temporal_size: int,
    theta: float = 10000.0,
    grid_type: str = "linspace",
    max_size: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """3D RoPE cos/sin tables -> each [T*H*W, embed_dim] f32 numpy.

    Per-axis split: dim_t = D/4, dim_h = dim_w = 3D/8 (head_dim 64 ->
    16/24/24), concatenated per position in (t, h, w) order. `linspace`
    (CogVideoX 1.0) samples the (h, w) grid inside the base-resolution crop
    region; `slice` (CogVideoX 1.5) takes integer positions up to `max_size`
    and slices the table."""
    if grid_type == "linspace":
        start, stop = crops_coords  # ((top, left), (bottom, right))
        grid_size_h, grid_size_w = grid_size
        grid_t = np.linspace(0, temporal_size, temporal_size, endpoint=False)
        grid_h = np.linspace(start[0], stop[0], grid_size_h, endpoint=False)
        grid_w = np.linspace(start[1], stop[1], grid_size_w, endpoint=False)
    elif grid_type == "slice":
        if max_size is None:
            raise ValueError("slice grid_type needs max_size")
        max_h, max_w = max_size
        grid_size_h, grid_size_w = grid_size
        grid_t = np.arange(temporal_size, dtype=np.float64)
        grid_h = np.arange(max_h, dtype=np.float64)
        grid_w = np.arange(max_w, dtype=np.float64)
    else:
        raise ValueError(f"unknown grid_type {grid_type}")

    dim_t = embed_dim // 4
    dim_h = embed_dim // 8 * 3
    dim_w = embed_dim // 8 * 3

    t_cos, t_sin = _rotary_1d(dim_t, grid_t, theta)
    h_cos, h_sin = _rotary_1d(dim_h, grid_h, theta)
    w_cos, w_sin = _rotary_1d(dim_w, grid_w, theta)

    if grid_type == "slice":
        t_cos, t_sin = t_cos[:temporal_size], t_sin[:temporal_size]
        h_cos, h_sin = h_cos[:grid_size_h], h_sin[:grid_size_h]
        w_cos, w_sin = w_cos[:grid_size_w], w_sin[:grid_size_w]

    def combine(ft, fh, fw):
        T, H, W = temporal_size, grid_size_h, grid_size_w
        ft = np.broadcast_to(ft[:, None, None, :], (T, H, W, ft.shape[-1]))
        fh = np.broadcast_to(fh[None, :, None, :], (T, H, W, fh.shape[-1]))
        fw = np.broadcast_to(fw[None, None, :, :], (T, H, W, fw.shape[-1]))
        return np.concatenate([ft, fh, fw], axis=-1).reshape(T * H * W, -1)

    cos = combine(t_cos, h_cos, w_cos).astype(np.float32)
    sin = combine(t_sin, h_sin, w_sin).astype(np.float32)
    return cos, sin


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs: x[..., (0,1),(2,3),...] treated as complex.
    x [..., S, D]; cos/sin [S, D] (interleave-repeated). Computed in f32,
    then cast back to x's dtype."""
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos.float() + rotated * sin.float()).to(x.dtype)


def prepare_rotary_positional_embeddings(
    height: int,
    width: int,
    num_frames: int,
    vae_scale_factor_spatial: int = 8,
    patch_size: int = 2,
    patch_size_t: Optional[int] = None,
    attention_head_dim: int = 64,
    base_height: int = 480,
    base_width: int = 720,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 tensors [T*H*W, head_dim] on `device` (CUDA unless
    "cpu" is asked) for the video token grid: the 1.0 crop-grid tables, or
    with `patch_size_t` the 1.5 slice tables over ceil(F / patch_size_t)
    frames. Never inference tensors."""
    grid_height = height // (vae_scale_factor_spatial * patch_size)
    grid_width = width // (vae_scale_factor_spatial * patch_size)
    base_size_width = base_width // (vae_scale_factor_spatial * patch_size)
    base_size_height = base_height // (vae_scale_factor_spatial * patch_size)

    if patch_size_t is None:
        grid_crops_coords = get_resize_crop_region_for_grid(
            (grid_height, grid_width), base_size_width, base_size_height
        )
        cos, sin = get_3d_rotary_pos_embed(
            embed_dim=attention_head_dim,
            crops_coords=grid_crops_coords,
            grid_size=(grid_height, grid_width),
            temporal_size=num_frames,
        )
    else:
        base_num_frames = (num_frames + patch_size_t - 1) // patch_size_t
        cos, sin = get_3d_rotary_pos_embed(
            embed_dim=attention_head_dim,
            crops_coords=None,
            grid_size=(grid_height, grid_width),
            temporal_size=base_num_frames,
            grid_type="slice",
            max_size=(base_size_height, base_size_width),
        )
    device = resolve_device(device)
    # normal tensors even under a sampler's inference mode, so that a training
    # step may take tables an inline validation built (as PatchEmbed's table)
    with torch.inference_mode(False):
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)
