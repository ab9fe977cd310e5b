#!/usr/bin/env python
"""PAB quality on a synthetic overfit model, for the PyTorch port.

The method, cells, report and decision rule of scripts/pab_quality_synthetic.py,
run through orv_tpu_torch: overfit a tiny scratch ControlDiT on ONE structured
synthetic clip with the port's train step (v-prediction + image conditioning),
then sample from the same noise with the exact sampler and with PAB attention
broadcast, and report per (pab_skip, window) cell, over n_clips noise seeds:

  - recon_psnr_exact / recon_psnr_pab: PSNR of the sampled latents vs the
    overfit target;
  - pab_vs_exact_psnr: PSNR between the two renders from identical noise;
  - frechet_rp: Frechet distance between the exact and PAB render sets under
    a fixed random feature projection (a weights-free stand-in for FVD).

A cell is SAFE when pab_vs_exact_psnr >= recon_psnr_exact + 6 dB.

The device follows the port's rule (`utils/device.py:resolve_device`): the
CUDA card unless `device="cpu"` is asked for. On both the model is the JAX
script's, in f32 (two 16-wide heads, rows 32 wide); on the card every step
runs the general kernels (ops/csrc/flash_attn_general*.cu,
ops/csrc/adaln_general.cu and gated_residual.cu's f32 instance), which take f32
at any head dim that is a multiple of 8; nothing falls back to the CPU. The
report names the device, the compute dtype, the head width and the card (its
name and power limit, as nvidia-smi prints them).

Usage: python scripts/pab_quality_synthetic_torch.py [--train-steps 600]
           [--sample-steps 50] [--n-clips 8] [--out report.json]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SCALE = 1.15258426  # diffusion_loss multiplies sampled latents by this


def _psnr(a, b, peak: float) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def _make_clip(F=3, C=16, H=8, W=16):
    """Structured latent clip: a gaussian blob translating across frames on
    per-channel sinusoidal carriers — smooth, reconstructible content."""
    f, y, x, c = np.meshgrid(np.arange(F), np.arange(H), np.arange(W),
                             np.arange(C), indexing="ij")
    blob = np.exp(-(((x - 3 - 4 * f) % W - W / 2) ** 2 / 8.0
                    + (y - H / 2) ** 2 / 4.0))
    waves = 0.4 * np.sin(2 * np.pi * (x / W + 0.13 * c)) * np.cos(
        2 * np.pi * (y / H + 0.07 * c))
    clip = (blob + waves).transpose(0, 3, 1, 2)  # [F, C, H, W]
    return clip[None].astype(np.float32)  # [1, F, C, H, W]


def model_setup(device):
    """(DiTConfig, compute dtype) of the overfit model on `device`: the JAX
    script's config (scripts/pab_quality_synthetic.py:75-80) in f32, on the
    CPU and on the card alike."""
    import torch

    from orv_tpu_torch.models import DiTConfig

    cfg = DiTConfig(
        num_attention_heads=2, attention_head_dim=16, num_layers=4,
        in_channels=32, out_channels=16, text_embed_dim=32, time_embed_dim=64,
        max_text_seq_length=8, sample_width=16, sample_height=8,
        modulate_encoder_hidden_states=True,
    )
    return cfg, torch.float32


def build_overfit_model(train_steps: int = 600, lr: float = 2e-3, seed: int = 0, device=None,
                        state_dict=None, prompt_embeds=None, draws=None):
    """Tiny scratch ControlDiT overfit on the synthetic clip. Returns
    (model, clip, img_latents, enc, losses), the parameters in `model`.

    The initial weights come from PyTorch's initialisers under
    `torch.manual_seed(seed)`, the text embeds from a generator seeded 7 and
    each step's loss draws from one on the device seeded `seed + 1`. A test
    passes `state_dict` (initial weights), `prompt_embeds` [1, 8, 32] and
    `draws` (one `LossDraws` a step) to replay another run's."""
    import torch

    from orv_tpu_torch.models import ControlDiT
    from orv_tpu_torch.parallel import (TrainState, make_lr_schedule, make_optimizer,
                                        make_train_step)
    from orv_tpu_torch.schedulers import make_schedule
    from orv_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg, dtype = model_setup(device)
    if state_dict is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            state_dict = ControlDiT(cfg, dtype=torch.float32, device="cpu").state_dict()
    model = ControlDiT(cfg, dtype=dtype, device=device)
    model.load_state_dict(state_dict, strict=True)

    clip = _make_clip()
    # deterministic moments: mean = clip/scale, logvar = -30 (std ~ 0)
    mean = (clip / SCALE).transpose(0, 2, 1, 3, 4)  # [B, C, F, H, W]
    moments = np.concatenate([mean, np.full_like(mean, -30.0)], axis=1)
    if prompt_embeds is None:
        prompt_embeds = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(7)) * 0.3
    enc = prompt_embeds.to(device, torch.float32)
    batch = {"latents": torch.tensor(moments, device=device),
             "image_latents": torch.tensor(moments[:, :, :1], device=device),
             "prompt_embeds": enc}
    tx = make_optimizer(make_lr_schedule("cosine", learning_rate=lr,
                                         warmup_steps=min(20, train_steps // 10),
                                         total_steps=train_steps),
                        weight_decay=0.0)
    state = TrainState.create(model, tx)
    step = make_train_step(tx, make_schedule())
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    losses = []
    for i in range(train_steps):
        state, m = step(state, batch, gen if draws is None else draws[i])
        if i % max(1, train_steps // 10) == 0 or i == train_steps - 1:
            losses.append(float(m["loss"]))
            print(f"overfit step {i}: loss {losses[-1]:.5f}", flush=True)
    # sampler-side conditioning: scaled first-frame latents, zero-padded
    img_lat = np.zeros_like(clip)
    img_lat[:, :1] = clip[:, :1]
    return model, clip, torch.tensor(img_lat, device=device), enc, losses


def render(model, schedule, sampler_cfg, img_lat, enc, n_clips: int, latents=None):
    """One sampled clip [1, F, C, H, W] f32 (numpy) per noise seed 100 + i: a
    generator with that seed on the latents' device draws the initial
    latents (unless `latents[i]` is given), then feeds the stochastic DPM
    steps, so two sampler configs render from identical noise."""
    import torch

    from orv_tpu_torch.pipelines.sample import make_sampler

    device = img_lat.device
    sample = make_sampler(model, schedule, sampler_cfg, device=device)
    outs = []
    for i in range(n_clips):
        g = torch.Generator(device=device).manual_seed(100 + i)
        lat0 = (torch.randn(img_lat.shape, generator=g, device=device) if latents is None
                else latents[i].to(device))
        outs.append(sample(lat0, img_lat, enc, generator=g).cpu().numpy())
    return outs


def card_name(device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them; None on the CPU."""
    if device.type == "cpu":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def run(train_steps=600, sample_steps=50, n_clips=8, out=None,
        skips=(2, 3), windows=((0.1, 0.85), (0.0, 1.0)), device=None):
    import torch

    from orv_tpu_torch.pipelines.metrics import frechet_distance, gaussian_stats
    from orv_tpu_torch.pipelines.sample import SamplerConfig
    from orv_tpu_torch.schedulers import make_schedule
    from orv_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    model, clip, img_lat, enc, losses = build_overfit_model(train_steps, device=device)
    sync()
    train_s = time.perf_counter() - t0
    schedule = make_schedule()
    peak = float(np.max(clip) - np.min(clip))

    # fixed random projection for the distributional (FVD-stand-in) metric
    rp = np.random.default_rng(0).normal(
        0, 1 / np.sqrt(clip.size), (clip.size, 16)).astype(np.float32)
    feats = lambda vids: np.stack([v.reshape(-1) @ rp for v in vids])

    report = {
        "train_steps": train_steps, "sample_steps": sample_steps,
        "n_clips": n_clips, "final_train_loss": losses[-1],
        "device": device.type, "compute_dtype": str(model.dtype).replace("torch.", ""),
        "attention_head_dim": model.config.attention_head_dim, "card": card_name(device),
    }
    # two sampler groups: the production config (stochastic DPM) and the
    # deterministic variant (recon error is the model's error)
    t0 = time.perf_counter()
    for group, stochastic in [("stochastic_dpm", True), ("deterministic", False)]:
        exact = render(model, schedule, SamplerConfig(num_inference_steps=sample_steps,
                                                      stochastic_dpm=stochastic),
                       img_lat, enc, n_clips)
        mu_e, sig_e = gaussian_stats(feats(exact))
        g = {
            "recon_psnr_exact": float(np.mean(
                [_psnr(v, clip, peak) for v in exact])),
            "cells": [],
        }
        for skip in skips:
            for (lo, hi) in windows:
                pab = render(model, schedule, SamplerConfig(
                    num_inference_steps=sample_steps, stochastic_dpm=stochastic,
                    pab_skip=skip, pab_start=lo, pab_end=hi), img_lat, enc, n_clips)
                mu_p, sig_p = gaussian_stats(feats(pab))
                cell = {
                    "pab_skip": skip, "window": [lo, hi],
                    "recon_psnr_pab": float(np.mean(
                        [_psnr(v, clip, peak) for v in pab])),
                    "pab_vs_exact_psnr": float(np.mean(
                        [_psnr(p, e, peak) for p, e in zip(pab, exact)])),
                    "frechet_rp": float(frechet_distance(mu_e, sig_e,
                                                         mu_p, sig_p)),
                }
                cell["safe"] = bool(cell["pab_vs_exact_psnr"]
                                    >= g["recon_psnr_exact"] + 6.0)
                g["cells"].append(cell)
                print(json.dumps({"group": group, **cell}), flush=True)
        report[group] = g
    sync()
    print(f"seconds: overfit {train_s:.1f} ({train_steps} steps), sampling "
          f"{time.perf_counter() - t0:.1f}", flush=True)
    # top-level fields = the production (stochastic) group
    report["recon_psnr_exact"] = report["stochastic_dpm"]["recon_psnr_exact"]
    report["cells"] = report["stochastic_dpm"]["cells"]
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("cells", "stochastic_dpm", "deterministic")}),
          flush=True)
    if out:
        Path(out).write_text(json.dumps(report, indent=1) + "\n")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=600)
    ap.add_argument("--sample-steps", type=int, default=50)
    ap.add_argument("--n-clips", type=int, default=8)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    run(a.train_steps, a.sample_steps, a.n_clips, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
