"""Offline VAE latent encoder: raw episodes -> the latents `train` reads.

Counterpart of `orv_tpu/pipelines/encode_dataset.py`. Reads raw episode
videos and annotations and writes MOMENTS latents (2 x 16 channels: the
sampling is left to train time), one file per view, the condition latents
and the empty-prompt embedding; the work list is sharded by rank, and every
output is skipped where it exists, so a stage restarts where it stopped.

Outputs (read by `orv_tpu_torch.data.RobotDataset`):
  {data_root}/{embeddings_folder}/{split}/latents/{ep:05d}_{start:02d}_{n:02d}[_{view}].npz
  .../image_latents/...[_ref{r}]   .../depth_latents/...  .../label_latents/...
  .../prompt_embeds/empty.npz

Usage:
  python -m orv_tpu_torch.pipelines.encode_dataset --dataset_type bridgev2 \\
      dataset.data_root=<dir> [--split train] [--vae_path <diffusers VAE folder>] \\
      [--ref_nums 1,5] [--encode_conds] [--max_samples N] [--device cpu]

Without `--vae_path` the VAE is random (from a seed), as in the JAX
package. With several ranks (`torch.distributed` initialized) each takes
every world_size-th sample from its rank on.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from orv_tpu_torch.configs import default_config_dir, load_config
from orv_tpu_torch.data import DatasetConfig, RobotDataset
from orv_tpu_torch.models.vae import CausalVAE, VAEConfig, encode_auto
from orv_tpu_torch.utils.device import DeviceLike, resolve_device
from orv_tpu_torch.utils.logging import CONSOLE


def read_video_frames(path: str, frame_ids: List[int], size_hw,
                      ori_size=None) -> np.ndarray:
    """video file -> [F, H, W, 3] float32 in [-1, 1] through the same
    aspect-preserving resize and center crop the raw-frame dataset loader
    applies (`data/dataset.py:video_transform`), so the video latents line
    up with the condition latents and the raw-pixel eval path."""
    from orv_tpu_torch.data.dataset import video_transform
    from orv_tpu_torch.utils.video import read_video

    frames = read_video(path, frame_ids)  # [F, H, W, 3] uint8
    out = video_transform(frames, ori_size, size_hw)  # [F, 3, H', W']
    return out.transpose(0, 2, 3, 1)


def _rank():
    """(rank, world size) of torch.distributed, or (0, 1) without it."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def encode_split(
    cfg,
    vae: CausalVAE,
    split: str = "train",
    overwrite: bool = False,
    max_samples: Optional[int] = None,
    ref_nums: Optional[List[int]] = None,
    encode_conds: Optional[bool] = None,
    device: DeviceLike = None,
) -> List[str]:
    """Encode this rank's share of `split` (torch.distributed's rank and
    world size, 0 of 1 without it); returns the paths written."""
    device = resolve_device(device)
    d = cfg.dataset
    control_keys = tuple(d.get("control_keys", ("depth", "label")))
    ds_cfg = DatasetConfig(
        data_root=d.data_root, split=split,
        sequence_interval=d.get("sequence_interval", 1),
        sequence_length=d.get("sequence_length", 16),
        start_frame_interval=d.get("start_frame_interval", 4),
        video_size=tuple(d.get("video_size", (320, 480))),
        ori_size=tuple(d["ori_size"]) if d.get("ori_size") else None,
        embeddings_folder=d.get("embeddings_folder", "embeddings_full"),
        annotations_folder=d.get("annotations_folder", "annotations"),
        renderings_folder=d.get("renderings_folder", "renderings"),
        control_keys=control_keys,
        load_tensors=False,
    )
    ds = RobotDataset(ds_cfg)
    if encode_conds is None:
        encode_conds = bool(d.get("use_cond", False))
    ref_nums = sorted(set(int(r) for r in (ref_nums or [1])))
    out_root = Path(d.data_root) / ds_cfg.embeddings_folder / split
    subs = ["latents", "image_latents", "prompt_embeds"]
    if encode_conds:
        subs += [f"{k}_latents" for k in control_keys]
    for sub in subs:
        (out_root / sub).mkdir(parents=True, exist_ok=True)

    rank, world_size = _rank()
    work = ds.samples[rank::world_size]
    if max_samples:
        work = work[:max_samples]

    chunk_frames = int(d.get("encode_chunk_frames", 8))

    def save(path: Path, x: np.ndarray) -> None:
        """x [F, C, H, W] in [-1, 1] -> its moments, as in `encode_auto`
        (streamed in chunks past chunk_frames + 1 frames)."""
        clip = torch.tensor(x.transpose(1, 0, 2, 3))[None]  # [1, C, F, H, W]
        moments = encode_auto(vae, clip, chunk_frames=chunk_frames, device=device)
        np.savez(path, moments[0].float().cpu().numpy())
        written.append(str(path))

    H, W = ds_cfg.video_size
    written: List[str] = []
    done = skipped = 0
    for sample in work:
        with open(sample["ann_file"]) as f:
            ann = json.load(f)
        # every camera's stream, each view's files with a _{view} suffix
        videos = ann.get("videos", [None])
        for view, video_file in enumerate(videos):
            name = ds._sample_name(sample, view=view)
            lat_path = out_root / "latents" / f"{name}.npz"
            img_path = out_root / "image_latents" / f"{name}.npz"
            # the observations: the first r raw frames; r > 1 files carry a
            # _ref{r} suffix on the view's name (view 0 unsuffixed)
            ref_name = (ds._sample_name(sample) if view == 0
                        else ds._sample_name(sample, view=view))
            ref_paths = {r: (img_path if r <= 1 else out_root / "image_latents"
                             / f"{ref_name}_ref{r}.npz") for r in ref_nums}
            # per-output skip-if-exists: a re-run with more flags backfills
            # exactly the missing files
            need_lat = overwrite or not lat_path.exists()
            need_refs = {r: p for r, p in ref_paths.items()
                         if overwrite or not p.exists()}
            cond_paths = {k: out_root / f"{k}_latents" / f"{name}.npz"
                          for k in control_keys} if encode_conds else {}
            need_conds = {k: p for k, p in cond_paths.items()
                          if overwrite or not p.exists()}
            if not (need_lat or need_refs or need_conds):
                skipped += 1
                continue
            if isinstance(video_file, dict):
                video_file = video_file.get("video_path")
            if video_file is None:
                continue
            if need_lat or need_refs:
                video_path = str(Path(d.data_root) / video_file)
                frames = read_video_frames(video_path, sample["frame_ids"],
                                           (H, W), ori_size=ds_cfg.ori_size)
                frames = frames.transpose(0, 3, 1, 2)  # [F, 3, H, W]
            if need_lat:
                save(lat_path, frames)
            for r, rp in need_refs.items():
                save(rp, frames[:r])
            if need_conds:
                # depth (the clamped map repeated to 3 channels) and label
                # (the color map) condition latents, from the dataset's raw
                # condition loader
                conds = ds._get_cond_raw(sample, view_ids=(view,))
                if "depths" in conds and "depth" in need_conds:
                    save(need_conds["depth"], np.repeat(conds["depths"], 3, axis=1))
                if "labels" in conds and "label" in need_conds:
                    save(need_conds["label"], conds["labels"])
        done += 1
        if done % 20 == 0:
            CONSOLE.log(f"[{split}] encoded {done}/{len(work)} (skipped {skipped})")
    CONSOLE.log(f"[{split}] done: {done} encoded, {skipped} skipped")
    return written


def encode_empty_prompt(cfg, out_root: Path, device: DeviceLike = None) -> None:
    """T5 embedding of the empty prompt; zeros [max_text_seq_length,
    text_embed_dim] where no T5 folder is given."""
    from orv_tpu_torch.models.text_encoder import encode_prompts, t5_available

    (out_root / "prompt_embeds").mkdir(parents=True, exist_ok=True)
    path = out_root / "prompt_embeds" / "empty.npz"
    max_len = cfg.transformer.get("max_text_seq_length", 226)
    dim = cfg.transformer.get("text_embed_dim", 4096)
    if t5_available(cfg.get("text_encoder_path")):
        emb = encode_prompts([""], max_len, model_path=cfg.get("text_encoder_path"),
                             device=device)[0]
    else:
        CONSOLE.log("[yellow]T5 weights unavailable — writing zero empty-prompt embedding")
        emb = np.zeros((max_len, dim), dtype=np.float32)
    np.savez(path, emb)
    CONSOLE.log(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", default=str(default_config_dir() / "base_train.yaml"))
    p.add_argument("--dataset_type", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--vae_path", default=None, help="HF VAE folder (safetensors)")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--ref_nums", default="1",
                   help="comma list of observation counts, e.g. 1,5,9")
    p.add_argument("--encode_conds", action="store_true",
                   help="also write depth/label condition latents from render.npz")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    cfg = load_config(args.base, None, args.dataset_type, None, args.overrides)
    device = resolve_device(args.device)

    if args.vae_path and Path(args.vae_path).exists():
        from orv_tpu_torch.pipelines.evaluate import load_vae

        vae = load_vae(args.vae_path, device=device)
    else:
        CONSOLE.log("[yellow]no --vae_path — random VAE (synthetic/dev mode)")
        torch.manual_seed(0)
        vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16, device=device)

    encode_split(cfg, vae, args.split, args.overwrite, args.max_samples,
                 ref_nums=[int(r) for r in str(args.ref_nums).split(",") if r],
                 encode_conds=args.encode_conds or None, device=device)
    out_root = (Path(cfg.dataset.data_root)
                / cfg.dataset.get("embeddings_folder", "embeddings_full") / args.split)
    encode_empty_prompt(cfg, out_root, device=device)


if __name__ == "__main__":
    main()
