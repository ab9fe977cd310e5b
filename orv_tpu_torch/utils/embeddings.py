"""Timestep and sin-cos positional embedding builders.

Counterpart of `orv_tpu/utils/embeddings.py` (diffusers
`get_timestep_embedding` / `get_3d_sincos_pos_embed` semantics). The
sin-cos table is numpy, copied verbatim. RoPE is not ported: the CogVideoX-2b
family the port serves has `use_rotary_positional_embeddings=False`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


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
