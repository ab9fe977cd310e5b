"""Single-episode demo inference, in PyTorch.

Counterpart of `orv_tpu/pipelines/inference.py`: generates an
action-conditioned video from one reference frame and a trajectory, via
DemoRobotDataset (folder-per-episode raw frames):

  python -m orv_tpu_torch.pipelines.inference --demo_root data/demo \\
      --transformer_path <diffusers transformer folder> --vae_path <diffusers vae folder>

Without a transformer it runs the JAX package's tiny random model (smoke
mode: 4 heads of 16, which the card runs on the general attention kernels);
without a VAE, a random full-size VAE.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from orv_tpu_torch.data import DatasetConfig, DemoRobotDataset
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.vae import CausalVAE, VAEConfig, decode_chunked, encode_auto
from orv_tpu_torch.parallel.train_step import EvalDraws
from orv_tpu_torch.pipelines.evaluate import load_vae, rotary_tables, save_video, to_uint8
from orv_tpu_torch.pipelines.sample import SamplerConfig, make_sampler
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils.checkpoint import has_pretrained, load_pretrained
from orv_tpu_torch.utils.device import DeviceLike, resolve_device
from orv_tpu_torch.utils.logging import CONSOLE

# the smoke mode's random model: the JAX package's (orv_tpu/pipelines/inference.py)
SMOKE_DIT = DiTConfig(num_attention_heads=4, attention_head_dim=16, num_layers=2,
                      in_channels=32, out_channels=16, text_embed_dim=32, time_embed_dim=64,
                      max_text_seq_length=8)


def generate_video(
    model: ControlDiT,
    vae: CausalVAE,
    ref_image: np.ndarray,  # [H, W, 3] in [-1, 1]
    actions: Optional[np.ndarray],  # [F_raw, 7]
    prompt_embeds: np.ndarray,  # [S, D]
    num_frames: int = 17,
    num_inference_steps: int = 50,
    guidance_scale: float = 1.0,
    scaling_factor: float = 1.15258426,
    seed: int = 42,
    pab_skip: int = 0,
    draws: Optional[EvalDraws] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """-> video [C, T, H, W] f32 in [-1, 1]. The reference frame's latent is
    its posterior mean; `draws` (only `noise` [1, F_lat, C, h, w] and
    `generator` are read) default to a torch.Generator seeded with `seed`.
    `pab_skip > 0` turns on PAB attention broadcast (approximate); a RoPE
    model gets its rotary tables."""
    device = resolve_device(device)
    cfg = model.config
    H, W = ref_image.shape[:2]
    F_lat = (num_frames - 1) // 4 + 1
    h, w = H // 8, W // 8
    if draws is None:
        draws = EvalDraws.draw(torch.Generator(device).manual_seed(seed),
                               (1, F_lat, cfg.out_channels, h, w))

    ref = torch.from_numpy(np.ascontiguousarray(ref_image.transpose(2, 0, 1)))[None, :, None]
    moments = encode_auto(vae, ref.float(), device=device)  # [1, 2C, 1, h, w]
    img_lat = (moments.chunk(2, dim=1)[0] * scaling_factor).permute(0, 2, 1, 3, 4)
    pad = img_lat.new_zeros((1, F_lat - 1, *img_lat.shape[2:]))
    image_latents = torch.cat([img_lat, pad], dim=1).to(torch.bfloat16)

    sampler = make_sampler(model, make_schedule(),
                           SamplerConfig(num_inference_steps=num_inference_steps,
                                         guidance_scale=guidance_scale, pab_skip=pab_skip),
                           device=device)
    kwargs = {}
    if actions is not None:
        kwargs["actions"] = torch.as_tensor(np.asarray(actions))[None].to(device, torch.bfloat16)
    prompt = torch.as_tensor(np.asarray(prompt_embeds))[None].to(device, torch.bfloat16)
    latents = sampler(draws.noise, image_latents, prompt, generator=draws.generator,
                      image_rotary_emb=rotary_tables(cfg, F_lat, h, w, device), **kwargs)
    z = latents.permute(0, 2, 1, 3, 4) / scaling_factor
    video = decode_chunked(vae, z, chunk_latent_frames=6, device=device)
    return video[0].cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--demo_root", required=True)
    p.add_argument("--transformer_path", default=None)
    p.add_argument("--vae_path", default=None)
    p.add_argument("--output_dir", default="demo_outputs")
    p.add_argument("--num_frames", type=int, default=17)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--pab_skip", type=int, default=0,
                   help="PAB attention broadcast (0=off, approximate)")
    p.add_argument("--episode", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the CUDA device")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.transformer_path and has_pretrained(args.transformer_path):
        dit_cfg, sd = load_pretrained(args.transformer_path, DiTConfig)
        model = ControlDiT(dit_cfg, dtype=torch.bfloat16, device=device)
        model.load_state_dict(sd, strict=True)
    else:
        CONSOLE.log("[yellow]no transformer checkpoint — tiny random model (smoke)")
        torch.manual_seed(0)
        model = ControlDiT(SMOKE_DIT, dtype=torch.bfloat16, device=device)
    dit_cfg = model.config

    if args.vae_path and Path(args.vae_path).exists():
        vae = load_vae(args.vae_path, device)
    else:
        CONSOLE.log("[yellow]no VAE checkpoint — random VAE (smoke)")
        torch.manual_seed(0)
        vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16, device=device)

    ds = DemoRobotDataset(DatasetConfig(
        data_root=args.demo_root, sequence_length=args.num_frames - 1,
        start_frame_interval=10**6,
    ))
    item = ds[args.episode]
    prompt_embeds = np.zeros(
        (dit_cfg.max_text_seq_length, dit_cfg.text_embed_dim), np.float32
    )
    video = generate_video(
        model, vae, item["ref_image"], item.get("actions"), prompt_embeds,
        num_frames=args.num_frames, num_inference_steps=args.num_inference_steps,
        pab_skip=args.pab_skip, device=device,
    )
    name = item["metainfo"]["episode_id"]
    save_video(str(out_dir / f"{name}.mp4"), to_uint8(video))
    CONSOLE.log(f"wrote {out_dir / f'{name}.mp4'}")
    return str(out_dir / f"{name}.mp4")


if __name__ == "__main__":
    main()
