"""Batch evaluation entry, in PyTorch.

Counterpart of `orv_tpu/pipelines/evaluate.py`: one sampler reused across
batches; work-list sharding by `torch.distributed` rank when a process
group is up; artifact export on a thread pool; the cascaded long-horizon
rollout chains chunk latents through next_start_frame_idx. Outputs carry
the JAX package's file names and layouts.

Every random number goes through `EvalDraws` (`parallel/train_step.py`):
by default a `torch.Generator` seeded with `cfg.seed`; a caller may pass
its own `draws` function.

Multiview configs (`runtime.multiview`) read `MultiViewRobotDataset`, whose
views stack on the frame axis; RoPE models get their rotary tables for one
view's frames; `evaluation.pab_skip > 0` turns on PAB attention broadcast
(single-view only, as in the JAX package).

Sequence-parallel serving (`evaluation.mesh.sp = n`, the JAX package's
`sp_mesh`): one model on each of n ranks, the sampler ringing every block's
joint attention over them, the same draws on every rank (the default
generator is seeded alike), and rank 0 alone writing; the work list is not
split over those ranks. The ranks are the communicator passed in as
`comm` (`LocalRing(n)`, whose `run` calls `evaluate` on every rank) or the
`torch.distributed` group of world size n (`torchrun --nproc_per_node n`).
As in JAX, sp is exclusive with dp/fsdp/tp (a ValueError).

Sharded serving (`evaluation.mesh` dp, fsdp, tp; the JAX package's
`serve_mesh`, orv_tpu/pipelines/evaluate.py:207-232, :313-325): a mesh over
the ranks (`comm`, or the torch.distributed group), or over its first
dp x fsdp x tp ranks when it names fewer (the others return at once). Each
rank builds the whole model, quantizes it with `evaluation.quant`, and
keeps its part (`parallel/fsdp.py:build_rank_model`): tp splits the heads
and feed-forward columns (the W8A8 row-parallel layers quantize each token
by its whole row's absmax), fsdp shards the parameters and gathers each
block's for its use. dp splits a batch's rows over the dp ranks when dp
divides them (every rank drawing the whole batch's noise and keeping its
rows), else the batch runs whole on every rank; the rows are gathered back
for rank 0. Every rank walks the same work list, as JAX's one process does,
and rank 0 alone writes.

Usage:
  python -m orv_tpu_torch.pipelines.evaluate --dataset_type rt1 \\
      evaluation.mode=traj-image [key=value ...]
"""

from __future__ import annotations

import argparse
import functools
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from orv_tpu_torch.configs import Config, default_config_dir, load_config
from orv_tpu_torch.data import collate_control
from orv_tpu_torch.models import ControlDiT
from orv_tpu_torch.models.quantize import quantize_model_
from orv_tpu_torch.models.vae import CausalVAE, VAEConfig, decode_chunked, encode_auto
from orv_tpu_torch.models.weights import ensure_mv_blocks, load_diffusers_folder
from orv_tpu_torch.parallel.fsdp import build_rank_model
from orv_tpu_torch.parallel.mesh import MeshConfig, initialize_distributed, make_mesh
from orv_tpu_torch.parallel.sp import SOLO, resolve_ranks, seeded_init
from orv_tpu_torch.parallel.train_step import EvalDraws
from orv_tpu_torch.pipelines.sample import (
    SamplerConfig, make_sampler, prepare_control_latents, prepare_image_latents,
)
from orv_tpu_torch.pipelines.train import build_dataset, build_dit_config
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils.checkpoint import has_pretrained, load_pretrained
from orv_tpu_torch.utils.device import DeviceLike, resolve_device
from orv_tpu_torch.utils.embeddings import prepare_rotary_positional_embeddings
from orv_tpu_torch.utils.logging import CONSOLE

DrawFn = Callable[..., EvalDraws]


def prefetch_eval_batches(dataset, indices, bs: int, num_workers: int = 0):
    """Yield (idxs, collated_batch) in order. With `num_workers > 0`
    batches load and collate on a thread pool while the device denoises the
    current one, at most num_workers+1 batches ahead. num_workers=0 loads
    synchronously."""
    chunks = [list(indices[bi:bi + bs]) for bi in range(0, len(indices), bs)]

    def load(ix):
        return collate_control([dataset[i] for i in ix])

    if num_workers <= 0:
        for ix in chunks:
            yield ix, load(ix)
        return
    from collections import deque

    ex = ThreadPoolExecutor(num_workers)
    try:
        pending = deque()
        it = iter(chunks)
        for ix in it:
            pending.append((ix, ex.submit(load, ix)))
            if len(pending) > num_workers:
                break
        while pending:
            ix, fut = pending.popleft()
            yield ix, fut.result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, ex.submit(load, nxt)))
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def save_video(path: str, video: np.ndarray, fps: int = 8, gif: bool = True):
    """video [T, H, W, 3] uint8 -> mp4 (imageio/OpenCV) and a gif beside it."""
    from orv_tpu_torch.utils.video import write_gif, write_video

    written = write_video(str(path), video, fps=fps)
    if gif and not str(written).endswith(".gif"):
        write_gif(str(path), video, fps=fps)


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[C, T, H, W] in [-1, 1] -> [T, H, W, C] uint8 (clip, then round)."""
    v = np.clip((video.transpose(1, 2, 3, 0) + 1.0) / 2.0, 0, 1)
    return (v * 255).round().astype(np.uint8)


def _encode_raw(batch: Dict[str, Any], vae: Optional[CausalVAE], dit_cfg,
                chunk_frames: int = 8, device: DeviceLike = None) -> Dict[str, Any]:
    """`load_tensors: false` items carry raw pixels (videos/image, raw cond
    maps): VAE-encode them (`encode_auto`) into the moments the sampler path
    expects. Items that already hold latents pass through."""
    if "latents" in batch:
        return batch
    if vae is None:
        raise ValueError(
            "dataset.load_tensors=false needs a VAE to encode raw frames — "
            "pass vae.pretrained_name_or_path"
        )

    def enc(x):
        return encode_auto(vae, torch.from_numpy(np.ascontiguousarray(x)),
                           chunk_frames=chunk_frames, device=device).cpu().numpy()

    batch = dict(batch)
    batch["latents"] = enc(np.asarray(batch["videos"]).transpose(0, 2, 1, 3, 4))
    batch["image_latents"] = enc(np.asarray(batch["image"]).transpose(0, 2, 1, 3, 4))
    if batch.get("depths") is not None:
        d = np.repeat(np.asarray(batch["depths"]), 3, axis=2)  # [B,F,3,H,W]
        batch["latents_depth"] = enc(d.transpose(0, 2, 1, 3, 4))
    if batch.get("labels") is not None:
        batch["latents_label"] = enc(np.asarray(batch["labels"]).transpose(0, 2, 1, 3, 4))
    if batch.get("prompt_embeds") is None:
        B = batch["latents"].shape[0]
        # a zero fill silently degrades real runs, so make it loud
        CONSOLE.log(
            "[yellow]raw-pixel batch has no prompt_embeds — substituting "
            "ZEROS. Real runs should point dataset.embeddings_folder at an "
            "encoded dataset's output (prompt_embeds/empty.npz)."
        )
        batch["prompt_embeds"] = np.zeros(
            (B, dit_cfg.max_text_seq_length, dit_cfg.text_embed_dim), np.float32)
    return batch


def _check_supported(ev):
    """`evaluation.mesh` as (sp, MeshConfig of dp, fsdp, tp or None when
    none is above 1); sp with dp/fsdp/tp is JAX's ValueError
    (orv_tpu/pipelines/evaluate.py:153-155)."""
    mesh = ev.get("mesh", {}) or {}
    sp = int(mesh.get("sp", 1))
    if sp > 1 and any(int(mesh.get(a, 1)) > 1 for a in ("dp", "fsdp", "tp")):
        raise ValueError("evaluation.mesh.sp is exclusive with dp/fsdp/tp")
    if not any(int(mesh.get(a, 1)) > 1 for a in ("dp", "fsdp", "tp")):
        return sp, None
    return sp, MeshConfig(dp=int(mesh.get("dp", -1)), fsdp=int(mesh.get("fsdp", 1)),
                          tp=int(mesh.get("tp", 1)))


def serving_mesh(config: MeshConfig, comm):
    """The serving mesh over `comm` (or the torch.distributed group): over
    its first dp x fsdp x tp ranks when the config names fewer than there
    are (JAX builds it over the first devices); None on a rank outside it,
    which builds the mesh's groups with the others all the same."""
    from orv_tpu_torch.pipelines.train import world_mesh

    if comm is None:
        comm = initialize_distributed() if _dist()[0] > 1 else None
    need = config.dp * config.fsdp * config.tp
    if comm is not None and config.dp > 0 and need < comm.size:
        mesh = make_mesh(config, comm, members=range(need))
        return mesh if mesh.inside else None
    return world_mesh(config, comm, "evaluation.mesh")


def _dist():
    """(world size, rank) of the torch.distributed group, else (1, 0)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size(), torch.distributed.get_rank()
    return 1, 0


def build_serving_model(cfg: Config, device: DeviceLike = None, sp=None,
                        mesh=None) -> ControlDiT:
    """The config's ControlDiT (`build_dit_config`) with f32 parameters and
    bf16 compute, loaded from `transformer.pretrained_name_or_path` (a
    diffusers folder) or, with none, a random init from `seed` (smoke mode);
    with `evaluation.quant` turned into the W8A8 model (int8 block linears,
    int8-QK^T attention) in place. `sp`: the communicator every block's
    joint attention rings over (None: resident). `mesh`: a serving mesh,
    of which this rank keeps its part (module docstring)."""
    dit_cfg = build_dit_config(cfg)
    device = resolve_device(device)
    with seeded_init(int(cfg.get("seed", 42)), device):
        model = ControlDiT(dit_cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                           device=device, sp=sp)
    pretrained = cfg.transformer.get("pretrained_name_or_path")
    if pretrained and has_pretrained(pretrained):
        _, sd = load_pretrained(pretrained)
        model.load_state_dict(ensure_mv_blocks(sd, dit_cfg), strict=True)
        CONSOLE.log(f"loaded transformer from {pretrained}")
    else:
        CONSOLE.log("[yellow]no pretrained transformer — random init (smoke mode)")
    quant = bool(cfg.evaluation.get("quant", False))
    if quant:
        quantize_model_(model)
        CONSOLE.log("int8 serving: block linears quantized (W8A8)")
    if mesh is not None and mesh.size > 1:
        whole = model.state_dict()
        seed = int(cfg.get("seed", 42))

        def make_model(tp, layers):
            with seeded_init(seed, device):
                return ControlDiT(dit_cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                                  device=device, quant=quant,
                                  attn_impl="flash_q8" if quant else "flash", tp=tp,
                                  layers=layers)

        model, _ = build_rank_model(make_model, whole, mesh, dit_cfg.num_layers)
        CONSOLE.log(f"inference sharding: mesh {mesh.shape}")
    return model.eval()


def load_vae(path, device: DeviceLike = None) -> CausalVAE:
    """A diffusers VAE folder -> CausalVAE (f32 parameters, bf16 compute)."""
    vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16, device=device)
    _, sd = load_diffusers_folder(path)
    vae.load_state_dict(sd, strict=True)
    return vae


def rotary_tables(dit_cfg, num_frames: int, height: int, width: int, device):
    """The RoPE model's (cos, sin) for `num_frames` latent frames of
    height x width latents (one view's), else None."""
    if not dit_cfg.use_rotary_positional_embeddings:
        return None
    return prepare_rotary_positional_embeddings(
        height=height * 8, width=width * 8, num_frames=num_frames,
        patch_size=dit_cfg.patch_size, patch_size_t=dit_cfg.patch_size_t,
        attention_head_dim=dit_cfg.attention_head_dim, device=device)


def _moment_shape(moments, C: int):
    """The noise shape that samples `moments` [B, 2C, ...], or None when
    they are latents already (or absent)."""
    return None if moments is None or moments.shape[1] != 2 * C else (
        moments.shape[0], C, *moments.shape[2:])


def _denoise_inputs(batch, mode: str, dit_cfg, scaling: float, draws: DrawFn, device,
                    with_image: bool = True):
    """A batch's draws, image latents (None unless `with_image`) and the
    sampler's kwargs: the view count, the RoPE tables of one view's frames,
    and the actions, depth and label controls as the mode asks."""
    B, _, F_lat, H, W = batch["latents"].shape
    C = dit_cfg.out_channels
    nv = int(batch.get("num_views", 1))  # views stack on the frame axis
    depth = batch.get("latents_depth") if "depth" in mode else None
    label = batch.get("latents_label") if "label" in mode else None
    d = draws((B, F_lat, C, H, W),
              _moment_shape(batch["image_latents"], C) if with_image else None,
              _moment_shape(depth, C), _moment_shape(label, C))
    on = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    image_latents = None
    if with_image:
        image_latents = prepare_image_latents(
            on(batch["image_latents"]), F_lat // nv, latent_channels=C, num_views=nv,
            scaling_factor=scaling, noise=d.image_noise).to(torch.bfloat16)
    kwargs: Dict[str, Any] = dict(
        num_views=nv, image_rotary_emb=rotary_tables(dit_cfg, F_lat // nv, H, W, device))
    if "actions" in batch and "traj" in mode:
        kwargs["actions"] = on(batch["actions"]).to(torch.bfloat16)
    if depth is not None:
        kwargs["depths"] = prepare_control_latents(
            on(depth), None, C, scaling, noise=d.depth_noise).to(torch.bfloat16)
    if label is not None:
        kwargs["labels"] = prepare_control_latents(
            on(label), None, C, scaling, noise=d.label_noise).to(torch.bfloat16)
    return d, image_latents, kwargs


def evaluate(cfg: Config, max_batches: Optional[int] = None, vae: Optional[CausalVAE] = None,
             device: DeviceLike = None, draws: Optional[DrawFn] = None, comm=None):
    """Generate every clip of the config's dataset (this rank's share), write
    `{episode}_{start:03d}_latents.npz`, and with a VAE the decoded `.mp4`
    and `.gif`, then `manifest.json`. `vae` may be passed directly (library
    embedding, tests); otherwise it loads from cfg.vae.pretrained_name_or_path.
    `draws(noise_shape, image_shape, depth_shape, label_shape)` supplies each
    denoise's EvalDraws; by default they come from one torch.Generator
    seeded with cfg.seed. Runs on `device`, CUDA unless "cpu" is asked.
    With `evaluation.mesh.sp = n > 1`, call it on every rank: `comm` is the
    communicator of n ranks, or None for the torch.distributed group
    (module docstring); every rank returns the clip names. With dp, fsdp or
    tp above 1, call it on every rank: `comm` is the communicator of the
    ranks, or None for the torch.distributed group; a rank outside a mesh
    smaller than the ranks returns [] at once."""
    device = resolve_device(device)
    ev = cfg.evaluation
    n_sp, mesh_cfg = _check_supported(ev)
    mesh = None
    if mesh_cfg is not None:
        mesh = serving_mesh(mesh_cfg, comm)
        if mesh is None:
            return []
        comm, writer = None, mesh.rank == 0
    else:
        comm = resolve_ranks(n_sp, comm, "evaluation.mesh.sp") if n_sp > 1 or comm is not None \
            else None
        writer = comm is None or comm.rank == 0
    out_dir = Path(ev.get("output_dir", "eval_outputs"))
    out_dir.mkdir(parents=True, exist_ok=True)

    model = build_serving_model(cfg, device, sp=comm, mesh=mesh)
    dit_cfg = model.config

    vae_path = cfg.get("vae", {}).get("pretrained_name_or_path")
    if vae is None and vae_path and Path(str(vae_path)).exists():
        vae = load_vae(str(vae_path), device)
        CONSOLE.log(f"loaded VAE from {vae_path}")

    cascaded = bool(ev.get("cascaded", False))
    dataset = build_dataset(cfg, split=cfg.dataset.get("split", "test"), cascaded=cascaded)

    # sp and mesh ranks share one work list
    n_proc, pid = _dist() if comm is None and mesh is None else (1, 0)
    indices = list(range(len(dataset)))[pid::n_proc]
    if max_batches is not None:
        indices = indices[: max_batches * int(ev.get("batch_size", 1))]

    sampler = make_sampler(
        model, make_schedule(),
        SamplerConfig(
            num_inference_steps=int(ev.get("num_inference_steps", 50)),
            guidance_scale=float(ev.get("guidance_scale", 1.0)),
            use_dynamic_cfg=bool(ev.get("use_dynamic_cfg", False)),
            scheduler=ev.get("scheduler", "dpm"),
            # opt-in PAB attention broadcast (evaluation.pab_skip > 0)
            pab_skip=int(ev.get("pab_skip", 0)),
            pab_start=float(ev.get("pab_start", 0.1)),
            pab_end=float(ev.get("pab_end", 0.85)),
        ),
        device=device,
    )
    mode = ev.get("mode", "traj-image")
    scaling = float(cfg.get("vae", {}).get("scaling_factor", 1.15258426))
    if draws is None:
        gen = torch.Generator(device).manual_seed(int(cfg.get("seed", 42)))
        draws = functools.partial(EvalDraws.draw, gen)
    chunk_frames = int(cfg.dataset.get("encode_chunk_frames", 8))
    save_fps, save_gif = int(ev.get("save_fps", 8)), bool(ev.get("save_gif", True))

    if cascaded:
        return _cascaded_rollout(cfg, dataset, dit_cfg, sampler, mode, scaling, draws, vae,
                                 out_dir, device, chunk_frames, save_fps, save_gif,
                                 n_proc, pid, writer)

    bs = int(ev.get("batch_size", 1))
    results = []
    pool = ThreadPoolExecutor(2)
    try:
        for bnum, (idxs, batch) in enumerate(prefetch_eval_batches(
                dataset, indices, bs, int(ev.get("num_workers", 0)))):
            batch = _encode_raw(batch, vae, dit_cfg, chunk_frames, device)
            d, image_latents, kwargs = _denoise_inputs(batch, mode, dit_cfg, scaling, draws,
                                                       device)
            prompt_embeds = torch.as_tensor(batch["prompt_embeds"]).to(device, torch.bfloat16)
            dp = SOLO if mesh is None else mesh.dp
            B = prompt_embeds.shape[0]
            if dp.size > 1 and B % dp.size == 0:  # this dp rank's rows, gathered after
                k = B // dp.size
                latents = sampler(d.noise, image_latents, prompt_embeds, generator=d.generator,
                                  rows=slice(dp.rank * k, (dp.rank + 1) * k), **kwargs)
                latents = dp.all_gather_seq(latents.contiguous(), 0)
            else:
                if dp.size > 1:
                    CONSOLE.log(f"[yellow]batch {B} not divisible by mesh dp={dp.size} — "
                                "running this batch replicated")
                latents = sampler(d.noise, image_latents, prompt_embeds, generator=d.generator,
                                  **kwargs)

            for j, i in enumerate(idxs):
                meta = batch["metainfos"][j]
                name = f"{meta['episode_id']}_{meta['start_frame_idx']:03d}"
                results.append(name)
                if not writer:
                    continue
                lat_np = latents[j].float().cpu().numpy()
                np.savez(out_dir / f"{name}_latents.npz", lat_np)
                if vae is not None:
                    z = torch.from_numpy(lat_np)[None].permute(0, 2, 1, 3, 4) / scaling
                    video = decode_chunked(vae, z, chunk_latent_frames=6, device=device)
                    pool.submit(save_video, str(out_dir / f"{name}.mp4"),
                                to_uint8(video[0].cpu().numpy()), save_fps, save_gif)
            CONSOLE.log(f"eval batch {bnum + 1}: {len(idxs)} episodes done")
    finally:
        pool.shutdown(wait=True)
    if not writer:
        return results
    with open(out_dir / f"manifest_{pid}.json", "w") as f:
        json.dump(results, f)
    _merge_manifests(out_dir, n_proc, pid)
    CONSOLE.log(f"evaluation complete: {len(results)} clips -> {out_dir}")
    return results


def _merge_manifests(out_dir: Path, n_proc: int, pid: int, stem: str = "manifest") -> None:
    """Rank 0 merges exactly this run's per-process manifests into one
    {stem}.json; with several processes a barrier first puts every shard
    on disk."""
    if n_proc > 1:
        torch.distributed.barrier()
    if pid != 0:
        return
    merged: List[str] = []
    for k in range(n_proc):
        mf = out_dir / f"{stem}_{k}.json"
        if mf.exists():
            with open(mf) as f:
                merged.extend(json.load(f))
    with open(out_dir / f"{stem}.json", "w") as f:
        json.dump(sorted(set(merged)), f)


def _cascaded_rollout(cfg, dataset, dit_cfg, sampler, mode, scaling, draws, vae, out_dir,
                      device, chunk_frames, save_fps, save_gif, n_proc: int, pid: int,
                      writer: bool = True):
    """Long-horizon generation: per episode, run chunks in order; each chunk
    after the first is conditioned on the GENERATED frame at the previous
    chunk's next_start_frame_idx. With a VAE the chaining frame is
    re-encoded from pixels; without one the matching latent frame carries
    over directly. Every sp rank chains; only the `writer` writes."""
    from collections import defaultdict

    episodes = defaultdict(list)
    for i, s in enumerate(dataset.samples):
        episodes[str(s["episode_id"])].append((s["sample_index"], i))
    # work-list sharding by EPISODE (a chunk chain stays on one process)
    ep_keys = sorted(episodes)[pid::n_proc]
    results = []
    decode = lambda lat: decode_chunked(vae, lat.permute(0, 2, 1, 3, 4) / scaling,
                                        chunk_latent_frames=6, device=device)
    for ep in ep_keys:
        chunk_list = sorted(episodes[ep])
        image_latents = None
        chunks_out = []
        chunk_starts = []  # episode-frame start of each chunk (stitch dedup)
        for _, idx in chunk_list:
            sample = dataset.samples[idx]
            item = {k: (v[None] if isinstance(v, np.ndarray) else v)
                    for k, v in dataset[idx].items()}
            item = _encode_raw(item, vae, dit_cfg, chunk_frames, device)
            F_lat = item["latents"].shape[2]
            first = image_latents is None
            d, image, kwargs = _denoise_inputs(item, mode, dit_cfg, scaling, draws, device,
                                               with_image=first)
            if first:  # the first chunk starts from the dataset's reference image
                image_latents = image
            if item.get("prompt_embeds") is not None:
                prompt = torch.as_tensor(item["prompt_embeds"]).to(device, torch.bfloat16)
            else:
                CONSOLE.log("[yellow]cascaded chunk has no prompt_embeds — "
                            "substituting ZEROS (see _encode_raw note)")
                prompt = torch.zeros((1, dit_cfg.max_text_seq_length, dit_cfg.text_embed_dim),
                                     dtype=torch.bfloat16, device=device)
            latents = sampler(d.noise, image_latents, prompt, generator=d.generator, **kwargs)
            chunks_out.append(latents[0].float().cpu().numpy())
            chunk_starts.append(int(sample.get("start_frame_idx", 0)))

            nxt = sample.get("next_start_frame_idx")
            if nxt is not None:
                # raw-frame offset -> latent frame (8n+1 causal structure)
                f_lat_idx = min((int(nxt) + 3) // 4, F_lat - 1)
                if vae is not None:
                    video = decode(latents)
                    raw_idx = min(int(nxt), video.shape[2] - 1)
                    frame = video[:, :, raw_idx: raw_idx + 1]  # [1, 3, 1, H, W]
                    moments = encode_auto(vae, frame, chunk_frames=chunk_frames, device=device)
                    ref = moments.chunk(2, dim=1)[0] * scaling
                    ref = ref.permute(0, 2, 1, 3, 4)  # [1, 1, C, h, w]
                else:
                    ref = latents[:, f_lat_idx: f_lat_idx + 1]
                pad = ref.new_zeros((1, F_lat - 1, *ref.shape[2:]))
                image_latents = torch.cat([ref, pad], dim=1).to(torch.bfloat16)

        results.append(ep)
        if not writer:
            continue
        stitched = np.concatenate(chunks_out, axis=0)  # [sum F_lat, C, H, W]
        np.savez(out_dir / f"{ep}_cascaded_latents.npz", stitched,
                 chunk_starts=np.asarray(chunk_starts))
        if vae is not None:
            videos = [decode(torch.from_numpy(ch)[None])[0].cpu().numpy() for ch in chunks_out]
            # chunks overlap in episode time: chunk j's prepended reference
            # frame repeats the chaining frame, and the regrown last chunk can
            # rewind by up to span-1 frames — drop every leading frame the
            # previous chunk covered (frame k of a chunk sits at raw index
            # start + k*interval)
            interval = max(1, int(cfg.dataset.get("sequence_interval", 1)))
            keep = [videos[0]]
            prev_end = chunk_starts[0] + (videos[0].shape[1] - 1) * interval
            for start, v in zip(chunk_starts[1:], videos[1:]):
                dup = max(0, -(-(prev_end + 1 - start) // interval))  # ceil
                keep.append(v[:, min(dup, v.shape[1]):])
                prev_end = start + (v.shape[1] - 1) * interval
            video = np.concatenate([v for v in keep if v.shape[1]], axis=1)
            save_video(str(out_dir / f"{ep}_cascaded.mp4"), to_uint8(video), save_fps, save_gif)
        CONSOLE.log(f"cascaded episode {ep}: {len(chunks_out)} chunks")
    if not writer:
        return results
    with open(out_dir / f"manifest_cascaded_{pid}.json", "w") as f:
        json.dump(results, f)
    _merge_manifests(out_dir, n_proc, pid, stem="manifest_cascaded")
    CONSOLE.log(f"cascaded evaluation complete: {len(results)} episodes -> {out_dir}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", default=str(default_config_dir() / "base_eval.yaml"))
    p.add_argument("--experiment", default=None)
    p.add_argument("--dataset_type", default=None)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--device", default=None, help="default: the CUDA device")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    exp = args.experiment
    if exp and not exp.endswith(".yaml"):
        for sub in ("eval", "experiments"):
            cand = default_config_dir() / sub / f"{exp}.yaml"
            if cand.exists():
                exp = str(cand)
                break
        else:
            raise SystemExit(
                f"no eval/experiment config named {exp!r} — looked for "
                f"{default_config_dir()}/{{eval,experiments}}/{exp}.yaml"
            )
    cfg = load_config(args.base, exp, args.dataset_type, None, args.overrides)
    initialize_distributed()  # under torchrun: the group of the ranks
    return evaluate(cfg, max_batches=args.max_batches, device=args.device)


if __name__ == "__main__":
    main()
