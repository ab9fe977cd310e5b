"""Sampling pipeline — the CFG denoise loop, in PyTorch.

Counterpart of `orv_tpu/pipelines/sample.py`. The JAX package runs the
denoise as one `lax.scan` over per-step tables; the port runs a Python loop
over the same tables (`ts`, `back`, `prev`, `have_old`, `gs`):

  * the visual-control embeds are computed once, before the loop
  * CFG: uncond/cond batched; dynamic-CFG cosine schedule; guidance_scale
    <= 1 skips the uncond half entirely
  * scheduler: CogVideoX DPM (stochastic noise from the caller's
    `torch.Generator`, old-pred threading) or DDIM

Raw reference pixels go through `preprocess_video` (resize, normalize) and
the VAE encode (`encode_reference_pixels`).

PAB attention broadcast (`pab_skip > 0`, the JAX package's opt-in
approximation): `pab_full_flags` marks the full steps; a full step runs the
model with `collect_attn=True` and keeps every block's pre-gate attention
outputs, a reuse step runs it on that cache (`attn_cache`), skipping the
attention's norm, projections and kernel. The step's flag is a Python
bool here, where the JAX scan needs a `lax.cond`. The cache lives only
inside one `sample` call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from orv_tpu_torch.schedulers import DiffusionSchedule, get_inference_timesteps
from orv_tpu_torch.schedulers.scheduling import ddim_step, dpm_step_scan
from orv_tpu_torch.utils.device import DeviceLike, check_module_device, resolve_device


@dataclasses.dataclass
class SamplerConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 1.0  # reference eval configs run CFG off
    use_dynamic_cfg: bool = False
    scheduler: str = "dpm"  # "dpm" | "ddim"
    stochastic_dpm: bool = True  # reference DPM step always injects noise
    # PAB attention broadcast: full attention every (pab_skip+1)-th step inside
    # [pab_start, pab_end)*n, the cached per-block outputs in between; 0: off
    pab_skip: int = 0
    pab_start: float = 0.1
    pab_end: float = 0.85


def sample_from_moments(moments: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample(): moments [B, 2C, ...] ->
    latents [B, C, ...] f32 (logvar clamped to [-30, 20]). The standard
    normal `noise` [B, C, ...] is drawn from `generator` unless given."""
    mean, logvar = moments.float().chunk(2, dim=1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + std * noise


def preprocess_video(
    image,  # [B, C, F, H, W] / [B, C, H, W] tensors, or [F, H, W, 3] frames
    height: Optional[int] = None,
    width: Optional[int] = None,
    vae_latent_channels: int = 16,
) -> torch.Tensor:
    """The reference VideoProcessor.preprocess semantics:

      * channel == vae_latent_channels (or 2x: unsampled moments): the input
        IS latents and passes through untouched;
      * otherwise raw pixels: resized to (height, width) bilinearly, with
        antialiasing when it shrinks (as `jax.image.resize` does), and
        [0, 1] normalized to [-1, 1] (input already in [-1, 1] left alone).

    Accepts 4D [B, C, H, W], 5D [B, C, F, H, W], or channels-last uint8 or
    float frames [F, H, W, C] (numpy arrays or tensors)."""
    x = torch.as_tensor(image)
    if x.dim() == 4 and x.shape[-1] in (1, 3):  # [F, H, W, C] frames
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        x = x.permute(3, 0, 1, 2)[None]  # -> [1, C, F, H, W]
    if x.dim() == 4:
        x = x[:, :, None]  # [B, C, H, W] -> single frame
    C = x.shape[1]
    if C in (vae_latent_channels, 2 * vae_latent_channels):
        return x  # latents / moments: no pixel preprocess
    if height is not None and width is not None and tuple(x.shape[-2:]) != (height, width):
        B, C, F_, H, W = x.shape
        # F.interpolate's antialiasing takes 4-D input: frames join the channels
        x = torch.nn.functional.interpolate(
            x.reshape(B, C * F_, H, W), size=(height, width), mode="bilinear",
            align_corners=False, antialias=True).reshape(B, C, F_, height, width)
    if float(x.min()) >= 0.0:
        x = x * 2.0 - 1.0  # normalize [0,1] -> [-1,1]
    return x


def encode_reference_pixels(encode_fn: Callable[[torch.Tensor], torch.Tensor], image,
                            height: Optional[int] = None, width: Optional[int] = None,
                            latent_channels: int = 16) -> torch.Tensor:
    """Raw reference frames -> VAE moments [B, 2C, F', h, w], through
    `encode_fn` (e.g. `lambda x: encode_auto(vae, x)`); latents or moments
    pass through."""
    pixels = preprocess_video(image, height, width, latent_channels)
    if pixels.shape[1] in (latent_channels, 2 * latent_channels):
        return pixels
    return encode_fn(pixels)


def _on(noise: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if noise is None else noise.to(like.device, torch.float32)


def prepare_image_latents(
    image_moments_or_latents: torch.Tensor,  # [B, 2C or C, F_img, H, W]
    num_latent_frames: int,
    generator: Optional[torch.Generator] = None,
    latent_channels: int = 16,
    num_views: int = 1,
    scaling_factor: float = 1.15258426,
    invert_scale_latents: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample moments if 2C (with `noise`, else from `generator`), scale,
    zero-pad per view to num_latent_frames. Returns [B, V*F_lat, C, H, W]."""
    x = image_moments_or_latents
    if x.shape[1] == 2 * latent_channels:
        x = sample_from_moments(x, generator, _on(noise, x))
    x = x / scaling_factor if invert_scale_latents else x * scaling_factor
    x = x.permute(0, 2, 1, 3, 4)  # [B, F, C, H, W]
    B, VF = x.shape[0], x.shape[1]
    f_img = VF // num_views
    x = x.reshape(B, num_views, f_img, *x.shape[2:])
    pad = x.new_zeros((B, num_views, num_latent_frames - f_img, *x.shape[3:]))
    x = torch.cat([x, pad], dim=2)
    return x.reshape(B, num_views * num_latent_frames, *x.shape[3:])


def prepare_control_latents(
    moments: torch.Tensor, generator: Optional[torch.Generator] = None,
    latent_channels: int = 16, scaling_factor: float = 1.15258426,
    invert_scale_latents: bool = False, noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Depth/label moments -> sampled (with `noise`, else from `generator`) +
    scaled + channel-duplicated 2C input."""
    x = moments
    if x.shape[1] == 2 * latent_channels:
        x = sample_from_moments(x, generator, _on(noise, x))
    x = x / scaling_factor if invert_scale_latents else x * scaling_factor
    x = x.permute(0, 2, 1, 3, 4)
    return torch.cat([x, x], dim=2)


def pab_full_flags(n: int, skip: int, start_frac: float, end_frac: float) -> np.ndarray:
    """Per-step full-attention flags for PAB: outside [w0, w1) every step
    is full; inside, full every (skip+1)-th step. Step 0 is always full
    (the cache must be populated before the first reuse)."""
    w0 = max(1, int(round(start_frac * n)))
    w1 = min(n, int(round(end_frac * n)))
    flags = np.ones(n, dtype=bool)
    for i in range(w0, w1):
        flags[i] = (i - w0) % (skip + 1) == 0
    flags[0] = True
    return flags


def make_sampler(
    model: torch.nn.Module,
    schedule: DiffusionSchedule,
    config: SamplerConfig = SamplerConfig(),
    device: DeviceLike = None,
):
    """Returns `sample(latents, image_latents, prompt_embeds, generator=None,
    negative_prompt_embeds=None, actions=None, depths=None, labels=None,
    image_rotary_emb=None, num_views=1, rows=None)` that runs the full
    denoise on `device` (CUDA unless `device="cpu"`) and returns clean
    latents [B, V*F, C, H, W] f32. `generator` feeds the stochastic DPM
    noise. `rows` (a data-parallel serving rank's rows of the batch): the
    inputs are the whole batch's, the rank denoises `rows` of them, and
    draws each step's noise for the whole batch and keeps its rows, so its
    rows come out as the whole batch's run gives them."""
    if config.scheduler not in ("dpm", "ddim"):
        raise ValueError(f"unknown scheduler {config.scheduler}")
    device = resolve_device(device)
    check_module_device(model, device, "make_sampler: the model")
    ts = get_inference_timesteps(schedule, config.num_inference_steps)
    n = len(ts)
    prev = np.append(ts[1:], -1)
    back = np.concatenate([[ts[0]], ts[:-1]])
    have_old = np.arange(n) > 0
    do_cfg = config.guidance_scale > 1.0
    if config.use_dynamic_cfg:
        gs = 1.0 + config.guidance_scale * (
            (1.0 - np.cos(np.pi * ((n - ts.astype(np.float64)) / n) ** 5.0)) / 2.0
        )
    else:
        gs = np.full((n,), config.guidance_scale)
    gs = gs.astype(np.float32)
    full = (pab_full_flags(n, config.pab_skip, config.pab_start, config.pab_end)
            if config.pab_skip > 0 else None)

    @torch.inference_mode()
    def sample(
        latents: torch.Tensor,  # [B, F, C, H, W] init noise
        image_latents: torch.Tensor,  # [B, F, C, H, W]
        prompt_embeds: torch.Tensor,  # [B, S, D]
        generator: Optional[torch.Generator] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        actions: Optional[torch.Tensor] = None,
        depths: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        num_views: int = 1,
        rows: Optional[slice] = None,
    ) -> torch.Tensor:
        whole_shape = tuple(latents.shape)
        if rows is not None:
            cut = lambda x: None if x is None else x[rows]
            latents, image_latents, prompt_embeds = cut(latents), cut(image_latents), \
                cut(prompt_embeds)
            negative_prompt_embeds, actions = cut(negative_prompt_embeds), cut(actions)
            depths, labels = cut(depths), cut(labels)
        if full is not None and num_views > 1:
            raise NotImplementedError("PAB attention broadcast is "
                                      "single-view (MVBlock not covered)")
        to = lambda x: None if x is None else x.to(device)
        rope = None if image_rotary_emb is None else tuple(map(to, image_rotary_emb))
        image_in, prompt_in = to(image_latents), to(prompt_embeds)
        actions_in, depths_in, labels_in = to(actions), to(depths), to(labels)
        if do_cfg:
            neg = (torch.zeros_like(prompt_in) if negative_prompt_embeds is None
                   else to(negative_prompt_embeds))
            prompt_in = torch.cat([neg, prompt_in], dim=0)
            dup = lambda x: None if x is None else torch.cat([x, x], dim=0)
            image_in, actions_in = dup(image_in), dup(actions_in)
            depths_in, labels_in = dup(depths_in), dup(labels_in)

        lat = latents.to(device, torch.float32)
        B = lat.shape[0] * (2 if do_cfg else 1)
        control_cache = None
        if depths_in is not None or labels_in is not None:
            control_cache = model(None, prompt_in, None, depths=depths_in, labels=labels_in,
                                  controls_only=True, num_views=num_views)

        old = torch.zeros_like(lat)
        attn_cache = None
        for i in range(n):
            model_in = torch.cat([lat, lat], dim=0) if do_cfg else lat
            model_in = torch.cat([model_in.to(image_in.dtype), image_in], dim=2)
            t_b = torch.full((B,), int(ts[i]), dtype=torch.int64, device=device)
            kwargs = dict(
                actions=actions_in,
                depths=None if control_cache is not None else depths_in,
                labels=None if control_cache is not None else labels_in,
                control_cache=control_cache, image_rotary_emb=rope, num_views=num_views)
            if full is None:
                v_pred = model(model_in, prompt_in, t_b, **kwargs)
            elif full[i]:  # full attention, refreshing the cache (the old one freed first)
                attn_cache = None
                v_pred, attn_cache = model(model_in, prompt_in, t_b, collect_attn=True, **kwargs)
            else:
                v_pred = model(model_in, prompt_in, t_b, attn_cache=attn_cache, **kwargs)
            v_pred = v_pred.float()
            if do_cfg:
                v_uncond, v_text = v_pred.chunk(2, dim=0)
                v_pred = v_uncond + torch.tensor(gs[i]) * (v_text - v_uncond)
            if config.scheduler == "dpm":
                noise = None
                if config.stochastic_dpm:
                    noise = torch.randn(whole_shape, generator=generator, device=device)
                    if rows is not None:
                        noise = noise[rows]
                lat, old = dpm_step_scan(schedule, v_pred, old, bool(have_old[i]), int(ts[i]),
                                         int(back[i]), int(prev[i]), lat, noise=noise)
            else:
                lat = ddim_step(schedule, v_pred, int(ts[i]), int(prev[i]), lat)
        return lat

    return sample


def decode_latents(decode_fn: Callable[[torch.Tensor], torch.Tensor], latents: torch.Tensor,
                   scaling_factor: float = 1.15258426) -> torch.Tensor:
    """[B, F, C, H, W] latents -> video [B, C, T, H, W] (unscale, then
    `decode_fn`, e.g. `lambda z: decode_chunked(vae, z, 6)`)."""
    return decode_fn(latents.permute(0, 2, 1, 3, 4) / scaling_factor)
