"""Training entry point.

Counterpart of `orv_tpu/pipelines/train.py`, on one GPU:

  python -m orv_tpu_torch.pipelines.train --experiment traj_image_2b_finetune \\
      --dataset_type bridgev2 dataset.data_root=... [--debug] [key.path=value ...]

Pipeline: layered config -> ControlDiT (a diffusers folder through the
JAX package's init surgery, or a random init from `seed`) -> RobotDataset
+ BucketSampler + threaded prefetch (or `train.loader=grain`) ->
`make_train_step` (one call a micro-step; `max_train_steps` counts
micro-steps, as in JAX) ->
step-indexed checkpoints with rotation and resume -> inline validation
through the real sampler -> the diffusers export `checkpoint/` (and
`checkpoint_ema/` with `train.ema_decay`).

Every random number of a micro-step goes through `LossDraws`, by default
from a generator seeded from (seed, micro-step), the way JAX folds the
step into its key, so a resumed run draws what an unbroken one would; a
caller may pass `draws(step, batch)`. Validation's come through
`EvalDraws` the same way (`val_draws`).

The rest of the model surface trains as in the JAX package: a multiview
model (the stage-3 recipes) reads each batch's view count and trains its
`mv_blocks` only (the other parameters frozen by the optimizer's
`trainable_predicate`), a RoPE model takes tables built from the first
batch's grid, and the 1.5 family's loss pads the frames to a multiple of
`patch_size_t`; `train.gradient_checkpointing` remats every block,
`train.remat_policy` as in the JAX package; `train.optimizer.type` is adam,
adamw, came or prodigy. A stage-3 run starts from a stage-2 export whose
`mv_blocks` are seeded (`ensure_mv_blocks`).

Data, model and context parallelism (`train.mesh`: dp, fsdp, tp, pp, sp,
n_micro; `parallel/mesh.py`): the ranks are the communicator passed in
(`comm`, e.g. `LocalRing(n)`, whose `run` calls `train` on every rank) or
the `torch.distributed` group that `main` starts under `torchrun
--nproc_per_node n` (`ProcessGroupRing`; gloo when the ranks share a
card). The mesh lays them out row-major over (dp, fsdp, pp, tp, sp), and
`dp: -1` takes the ranks the other axes leave. Every rank builds the whole
model from the same seed (or folder) and keeps its part
(`parallel/fsdp.py:build_rank_model`): its pp stage's blocks, its tp
columns, its fsdp shards. Every rank takes rank 0's global batch (the
threaded loader's order is not fixed): the resident mesh step
(`make_train_step`) gives each (dp, fsdp) shard its rows of the batch and
of the global draws, and computes the single-device step's function; with
pp > 1 the pipeline step (`parallel/pp.py`) runs, each data shard on its
rows with draws of its own (`draws(step, batch, shard=index)`, the JAX
package's per-shard fold). The batch arithmetic is JAX's: `train_batch_size`
is the global batch, and neither `scaled_lr` nor the step count takes a
replica factor. Checkpoints, the export and the inline validation gather
every shard back into whole tensors (every rank takes part); rank 0 writes
them, and a run resumes from them at any mesh. Only rank 0 writes
validation videos and tracker lines. sp rings every block's joint attention
(`ControlDiT(sp=...)`) inside each (dp, fsdp) group; as in JAX, sp with tp
or pp is a ValueError, and the pipeline's refusals are JAX's.

`train.loader=grain` reads the batches in the order JAX's grain loader
reads them (`data/grain_loader.py`, computed without grain), with
`train.loader_workers` spawned reader processes; as in JAX it takes fixed
(ref_num, n_view) configs only, and a resumed run restarts it from its
first record (neither package checkpoints the loader).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import yaml

from orv_tpu_torch.configs import Config, default_config_dir, load_config
from orv_tpu_torch.data import (BucketSampler, CascadedRobotDataset, DatasetConfig,
                                MultiViewRobotDataset, RobotDataset, collate_control)
from orv_tpu_torch.data.grain_loader import make_grain_loader
from orv_tpu_torch.models.dit import ControlDiT, DiTConfig
from orv_tpu_torch.models.weights import dit_state_dict_from_diffusers, gather_state_dict
from orv_tpu_torch.parallel.fsdp import MeshLayout, build_rank_model
from orv_tpu_torch.parallel.mesh import MeshConfig, batch_sharding, initialize_distributed, make_mesh
from orv_tpu_torch.parallel.pp import check_pp_mesh, make_pp_train_step
from orv_tpu_torch.parallel.sp import seeded_init
from orv_tpu_torch.parallel.train_step import (EvalDraws, LossDraws, TrainState, batch_rows,
                                               make_lr_schedule, make_optimizer,
                                               make_train_step)
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils.checkpoint import TrainCheckpointer, export_pretrained, load_pretrained
from orv_tpu_torch.utils.device import DeviceLike, resolve_device
from orv_tpu_torch.utils.embeddings import prepare_rotary_positional_embeddings
from orv_tpu_torch.utils.logging import CONSOLE
from orv_tpu_torch.utils.tracker import Tracker

DrawFn = Callable[[int, Dict[str, torch.Tensor]], LossDraws]

# keys the yamls carry inside `transformer:` that are NOT model architecture
# fields (checkpoint/loader plumbing and pipeline flags). Everything else
# must map onto a DiTConfig field or raise.
_NON_MODEL_TRANSFORMER_KEYS = frozenset({
    "config_path", "pretrained_name_or_path", "from_t2v",
    "control_keys", "empty_prompt", "filter_by_cond", "guidance_scale",
    "logging_dir", "no_traj", "num_observation", "seed", "tracker_name",
    "use_cond",
})

# fields whose defaults here differ from the DiTConfig dataclass defaults:
# the train entry defaults to the visual-control variant
_TRAIN_FIELD_DEFAULTS = {
    "in_channels": 32,
    "modulate_encoder_hidden_states": True,
}


def build_dit_config(cfg: Config) -> DiTConfig:
    t = cfg.transformer
    if t.get("config_path"):
        # scratch-model config file (config/transformer/*.yaml); relative
        # paths resolve against the port's config dir
        path = Path(str(t["config_path"]))
        if not path.exists():
            path = default_config_dir() / path
        with open(path) as f:
            base = yaml.safe_load(f) or {}
        merged = dict(base)
        merged.update({k: v for k, v in dict(t).items() if k != "config_path"})
        t = Config(merged)
    t = dict(t)
    field_names = {f.name for f in dataclasses.fields(DiTConfig)}
    unknown = set(t) - field_names - _NON_MODEL_TRANSFORMER_KEYS
    if unknown:
        raise ValueError(
            f"unknown transformer config key(s) {sorted(unknown)} — every key "
            "must map to a DiTConfig field (or be listed in "
            "_NON_MODEL_TRANSFORMER_KEYS if it is loader/pipeline plumbing)"
        )
    kwargs = {k: v for k, v in t.items() if k in field_names}
    for key, default in _TRAIN_FIELD_DEFAULTS.items():
        kwargs.setdefault(key, default)
    # conditioning flags live at the top level of experiment yamls; a
    # transformer-section value wins if present
    for key in ("recon_action", "visual_guidance", "multiview"):
        if key not in kwargs:
            kwargs[key] = bool(cfg.get(key, False))
    return DiTConfig(**kwargs)


def build_dataset(cfg: Config, split: str = "train", cascaded: bool = False):
    """Construct the dataset the config describes; `cascaded=True` builds a
    CascadedRobotDataset (chunk-chained long-horizon index)."""
    d = cfg.dataset
    ds_cfg = DatasetConfig(
        data_root=d.data_root,
        split=split,
        num_samples=int(d.get("num_samples", -1)),
        camera_ids=tuple(d.get("camera_ids", (0,))),
        max_n_view=d.get("max_n_view", 1),
        n_view=d.get("max_n_view", 1) if cfg.get("multiview") else None,
        action_dim=d.get("action_dim", 7),
        sequence_interval=d.get("sequence_interval", 1),
        sequence_length=d.get("sequence_length", 16),
        sample_frames=d.get("sample_frames", 17),
        start_frame_interval=d.get("start_frame_interval", 4),
        video_size=tuple(d.get("video_size", (320, 480))),
        sample_size=tuple(d.get("sample_size", (40, 60))),
        embeddings_folder=d.get("embeddings_folder", "embeddings_full"),
        annotations_folder=d.get("annotations_folder", "annotations"),
        load_tensors=d.get("load_tensors", True),
        load_actions=d.get("load_actions", True),
        load_video=d.get("load_video", False),
        slice_frame=d.get("slice_frame", True),
        vae_has_first_single_frame=d.get("vae_has_first_single_frame", True),
        use_cond=cfg.get("use_cond", False),
        filter_by_cond=cfg.get("filter_by_cond", False),
        no_traj=cfg.get("no_traj", False),
        empty_prompt=cfg.get("empty_prompt", True),
        control_keys=tuple(cfg.get("control_keys", ("depth", "label"))),
        ref_num=cfg.get("num_observation", 1),
        ori_size=tuple(d["ori_size"]) if d.get("ori_size") else None,
        renderings_folder=d.get("renderings_folder", "renderings"),
        load_condGT=d.get("load_condGT", False),
    )
    if cascaded:
        if cfg.get("multiview"):
            raise ValueError("cascaded multiview evaluation is not supported "
                             "(matches the reference: cascaded mode is single-view)")
        return CascadedRobotDataset(ds_cfg)
    if cfg.get("multiview"):
        return MultiViewRobotDataset(ds_cfg)
    return RobotDataset(ds_cfg)


def prefetch_batches(dataset, sampler, num_threads: int = 2, depth: int = 4) -> Iterator[Dict]:
    """Threaded loader: index batches -> collated numpy batches.

    A batch that raises (resample exhaustion, collate shape mismatch) is
    logged and skipped instead of killing its worker thread. Every worker
    posts one sentinel when the sampler ends; the last one ends the
    iteration. Closing the generator stops the workers. With more than one
    thread, which collated batch comes next is not fixed."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    it = iter(sampler)
    lock = threading.Lock()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        while not stop.is_set():
            with lock:
                try:
                    idxs = next(it)
                except StopIteration:
                    put(None)
                    return
            try:
                batch = collate_control([dataset[i] for i in idxs])
            except Exception as e:  # noqa: BLE001 — skip the bad batch
                CONSOLE.log(f"[yellow]prefetch: dropping batch {idxs}: {type(e).__name__}: {e}")
                continue
            if not put(batch):
                return

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(num_threads)]
    for t in threads:
        t.start()
    try:
        done = 0
        while done < num_threads:
            b = q.get()
            if b is None:
                done += 1
                continue
            yield b
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)


def init_params(cfg: Config, dit_cfg: DiTConfig, dtype=torch.bfloat16,
                device: DeviceLike = None, sp=None) -> ControlDiT:
    """The config's ControlDiT with f32 parameters, remat as
    `train.gradient_checkpointing` and `train.remat_policy` ask: from
    `transformer.pretrained_name_or_path` when that folder exists (a
    diffusers folder, through `dit_state_dict_from_diffusers` with
    `transformer.from_t2v`, which seeds the `mv_blocks` of a multiview model
    from a folder without them; a folder of the JAX package's `model.msgpack`
    alone is refused, naming its conversion), else a random init from
    `seed`, logged. `sp`: the communicator every block's joint attention
    rings over (None: resident)."""
    device = resolve_device(device)
    tcfg = cfg.get("train", {}) or {}
    with seeded_init(int(cfg.get("seed", 42)), device):
        model = ControlDiT(dit_cfg, dtype=dtype, param_dtype=torch.float32, device=device,
                           remat=bool(tcfg.get("gradient_checkpointing", False)),
                           remat_policy=tcfg.get("remat_policy"), sp=sp)
    pretrained = cfg.transformer.get("pretrained_name_or_path")
    if pretrained and Path(str(pretrained)).exists():
        _, sd = load_pretrained(str(pretrained))
        sd = dit_state_dict_from_diffusers(
            sd, dit_cfg, from_t2v=bool(cfg.transformer.get("from_t2v", False)))
        model.load_state_dict(sd, strict=True)
        CONSOLE.log(f"loaded pretrained transformer from {pretrained}")
    elif pretrained:
        CONSOLE.log(f"[yellow]pretrained path '{pretrained}' not found — random init")
    return model


@contextlib.contextmanager
def _params_swapped(state: TrainState, tensors):
    """Inside the block the state's parameters hold `tensors` (no copy:
    their storage is swapped), then their own again."""
    params = [p for _, p in state.named_params()]
    own = [p.data for p in params]
    try:
        for p, t in zip(params, tensors):
            p.data = t
        yield
    finally:
        for p, t in zip(params, own):
            p.data = t


def whole_params(state: TrainState, ema: bool = False) -> Dict[str, torch.Tensor]:
    """The model's whole state dict (with `ema`, the EMA in place of the
    trained parameters), gathered from the mesh's ranks: every rank must
    call it."""
    layout = state.mesh
    leaves = dict(state.named_params())
    if ema:
        leaves = dict(zip(leaves, state.opt_state.ema))
    local = {k: leaves.get(k, v).detach() for k, v in state.model.state_dict().items()}
    with torch.no_grad():
        return gather_state_dict(local, layout.placements, layout.mesh, layout.num_layers)


ValDrawFn = Callable[[int, tuple, Optional[tuple]], EvalDraws]


@torch.no_grad()
def run_validation(cfg: Config, model: ControlDiT, batch: Dict, out_dir: Path, step: int,
                   tracker: Optional[Tracker] = None, vae=None, device: DeviceLike = None,
                   draws: Optional[ValDrawFn] = None, write: bool = True) -> Optional[Path]:
    """Inline validation through the real sampler on the model's current
    weights: denoise the first `train.num_validation_videos` clips of
    `batch` (actions and the image condition, as JAX does) and write each
    decoded mp4 under `validation/` when a VAE is given, else one `.npz` of
    the latents. `draws(step, noise_shape, image_shape)` gives the
    EvalDraws (default: a generator seeded with seed + step, which also
    feeds the stochastic DPM steps). A RoPE model takes tables for the
    batch's grid. As in the JAX package, the sampler takes no `num_views`:
    a multiview model denoises its batch's V x F latent frames as one view
    (ROADMAP.md C, "noted in the reference"), and a `patch_size_t` model
    needs a frame count it divides. Returns the last path written. With
    `write=False` (an sp rank other than 0) it denoises, since the model
    rings over every rank, and writes and decodes nothing: returns None."""
    from orv_tpu_torch.pipelines.sample import (SamplerConfig, make_sampler,
                                                prepare_image_latents)

    device = resolve_device(device)
    dit_cfg = model.config
    inf = cfg.get("inference", {}) or {}
    sampler = make_sampler(model, make_schedule(), SamplerConfig(
        num_inference_steps=int(inf.get("num_inference_steps", 50)),
        guidance_scale=float(inf.get("guidance_scale", 1.0)),
        use_dynamic_cfg=bool(inf.get("use_dynamic_cfg", False))), device=device)
    scaling = float(cfg.get("vae", {}).get("scaling_factor", 1.15258426))
    n_val = max(1, int(cfg.get("train", {}).get("num_validation_videos", 1)))
    n_val = min(n_val, int(np.asarray(batch["latents"]).shape[0]))
    C = dit_cfg.out_channels
    F_lat, H, W = np.asarray(batch["latents"]).shape[2:]
    pt = dit_cfg.patch_size_t
    if pt and F_lat % pt:
        raise ValueError(
            f"run_validation samples the batch's {F_lat} latent frames unpadded, which "
            f"patch_size_t={pt} does not divide (the JAX package's run_validation fails on "
            "them too); train such clips with NO_INIT_VAL=1 and validation_steps past "
            "max_train_steps")
    img = batch.get("image_latents")
    img_shape = None if img is None or img.shape[1] != 2 * C else (n_val, C, *img.shape[2:])
    if draws is None:
        gen = torch.Generator(device).manual_seed(int(cfg.get("seed", 42)) + step)
        d = EvalDraws.draw(gen, (n_val, F_lat, C, H, W), img_shape)
    else:
        d = draws(step, (n_val, F_lat, C, H, W), img_shape)
    on = lambda a: torch.as_tensor(np.asarray(a[:n_val])).to(device)
    if img is not None:
        image_latents = prepare_image_latents(on(img), F_lat, latent_channels=C,
                                              scaling_factor=scaling, noise=d.image_noise)
    else:  # a latents dataset may carry no image latents; validation runs on
        image_latents = torch.zeros(n_val, F_lat, C, H, W, device=device)
    kwargs = {}
    if "actions" in batch:
        kwargs["actions"] = on(batch["actions"]).to(torch.bfloat16)
    if dit_cfg.use_rotary_positional_embeddings:
        kwargs["image_rotary_emb"] = prepare_rotary_positional_embeddings(
            height=H * 8, width=W * 8, num_frames=F_lat, patch_size=dit_cfg.patch_size,
            patch_size_t=pt, attention_head_dim=dit_cfg.attention_head_dim, device=device)
    if batch.get("prompt_embeds") is not None:
        prompt = on(batch["prompt_embeds"]).to(torch.bfloat16)
    else:
        prompt = torch.zeros(n_val, dit_cfg.max_text_seq_length, dit_cfg.text_embed_dim,
                             dtype=torch.bfloat16, device=device)
    latents = sampler(d.noise, image_latents.to(torch.bfloat16), prompt,
                      generator=d.generator, **kwargs)
    if not write:
        return None
    val_dir = Path(out_dir) / "validation"
    val_dir.mkdir(parents=True, exist_ok=True)
    if vae is not None:
        from orv_tpu_torch.models.vae import decode_chunked
        from orv_tpu_torch.utils.video import write_video

        fps = int(inf.get("save_fps", 8))
        for i in range(n_val):
            z = latents[i:i + 1].permute(0, 2, 1, 3, 4) / scaling
            video = decode_chunked(vae, z, chunk_latent_frames=6, device=device)[0]
            video = video.float().cpu().numpy()
            frames = np.clip((video.transpose(1, 2, 3, 0) + 1.0) / 2.0, 0, 1)
            frames = (frames * 255).round().astype(np.uint8)
            suffix = f"_{i}" if n_val > 1 else ""
            path = Path(write_video(str(val_dir / f"step_{step:06d}{suffix}.mp4"), frames,
                                    fps=fps))
            if tracker is not None:
                tracker.log_video("validation", str(path), step)
    else:
        path = val_dir / f"step_{step:06d}_latents.npz"
        np.savez(path, *(latents[i].float().cpu().numpy() for i in range(n_val)))
        if tracker is not None:
            tracker.log_video("validation_latents", str(path), step)
    CONSOLE.log(f"validation @ step {step} -> {path}")
    return path


def total_train_steps(tcfg, dataset_len: int, batch_size: int) -> int:
    """Total micro-steps. `max_train_steps` wins when set; with it null or
    absent, `num_train_epochs` x steps-per-epoch, where one epoch is
    ceil(len(dataset) / (batch x grad-accum)); 20000 with neither.
    `train_batch_size` is the global batch."""
    explicit = tcfg.get("max_train_steps")
    if explicit is not None:
        return int(explicit)
    epochs = tcfg.get("num_train_epochs")
    if epochs is None:
        return 20000
    global_batch = max(1, batch_size * int(tcfg.get("gradient_accumulation_steps", 1)))
    steps_per_epoch = max(1, -(-dataset_len // global_batch))
    return int(epochs) * steps_per_epoch


def scaled_lr(tcfg, batch_size: int) -> float:
    """Base learning rate, times grad-accum x the global batch when
    `train.scale_lr` is set."""
    lr = float(tcfg.get("learning_rate", 2e-4))
    if not tcfg.get("scale_lr"):
        return lr
    return lr * int(tcfg.get("gradient_accumulation_steps", 1)) * batch_size


def build_optimizer(tcfg, total_steps: int, batch_size: int, multiview: bool = False):
    """`train.optimizer` and the lr schedule of `tcfg` -> the `Optimizer`
    (`make_optimizer`), over `total_steps` micro-steps as JAX passes them; a
    multiview model trains its `mv_blocks` only (JAX's `"mv_block" in path`)."""
    opt = tcfg.get("optimizer", {}) or {}
    base_lr = scaled_lr(tcfg, batch_size)
    if tcfg.get("scale_lr"):
        CONSOLE.log(f"scale_lr: learning rate {base_lr:.3g}")
    lr = make_lr_schedule(tcfg.get("lr_scheduler", "cosine_with_restarts"), base_lr,
                          int(tcfg.get("lr_warmup_steps", 1000)), total_steps,
                          int(tcfg.get("lr_num_cycles", 1)), power=float(tcfg.get("lr_power", 1.0)))
    return make_optimizer(
        lr, opt.get("type", "adamw"), opt.get("beta1", 0.9), opt.get("beta2", 0.95),
        opt.get("epsilon", 1e-8), opt.get("weight_decay", 1e-3), opt.get("max_grad_norm", 1.0),
        int(tcfg.get("gradient_accumulation_steps", 1)),
        trainable_predicate=mv_blocks_only if multiview else None,
        beta3=opt.get("beta3") or 0.98,  # the yaml ships beta3: null
        prodigy_safeguard_warmup=bool(opt.get("prodigy_safeguard_warmup", False)),
        prodigy_decouple=bool(opt.get("prodigy_decouple", False)),
        prodigy_use_bias_correction=bool(opt.get("prodigy_use_bias_correction", False)),
        ema_decay=tcfg.get("ema_decay"))


def mv_blocks_only(name: str) -> bool:
    """The multiview stage's `trainable_predicate`: the cross-view blocks."""
    return name.startswith("mv_blocks.")


def _check_supported(cfg: Config) -> MeshConfig:
    """`train.mesh` as a MeshConfig; tp or pp with sp is JAX's ValueError
    (orv_tpu/pipelines/train.py:373-375), and so is grain with a multiview
    or several-`ref_num` config (orv_tpu/pipelines/train.py:418-420), here
    before anything is written."""
    tcfg = cfg.train
    mesh = dict(tcfg.get("mesh", {}) or {})
    sp = int(mesh.get("sp", 1))
    if sp > 1 and any(int(mesh.get(a, 1)) > 1 for a in ("tp", "pp")):
        raise ValueError("train.mesh.sp composes with dp/fsdp only (tp=pp=1)")
    if tcfg.get("loader") == "grain" and (
            cfg.get("multiview")
            or len(DatasetConfig(ref_num=cfg.get("num_observation", 1)).ref_num_choices()) > 1):
        raise ValueError("train.loader=grain supports fixed (ref_num, "
                         "n_view) configs; bucketed runs use the default loader")
    return MeshConfig(dp=int(mesh.get("dp", -1)), fsdp=int(mesh.get("fsdp", 1)),
                      tp=int(mesh.get("tp", 1)), pp=int(mesh.get("pp", 1)), sp=sp)


def world_mesh(config: MeshConfig, comm, what: str):
    """The mesh of `config` over the ranks: `comm` when given, else the
    `torch.distributed` group when one is up, else this process alone.
    Raises, naming the cause, when the ranks do not fill the mesh."""
    import torch.distributed as dist

    sizes = {a: getattr(config, a) for a in ("dp", "fsdp", "pp", "tp", "sp")}
    need = int(np.prod([n for n in sizes.values() if n > 0]))
    wide = " x ".join(f"{what}.{a}={n}" for a, n in sizes.items() if n > 1) or f"{what}.dp=1"
    if comm is None and dist.is_available() and dist.is_initialized():
        comm = initialize_distributed()
    world = 1 if comm is None else comm.size
    fits = world == need if config.dp > 0 else world % need == 0
    if comm is not None and not fits:
        raise ValueError(f"{wide} needs {need} ranks but the communicator passed has "
                         f"{world} ranks")
    if not fits:
        raise ValueError(
            f"{wide} needs {need} ranks, and this process has {world}: pass a communicator "
            f"of {need} ranks (comm=LocalRing({need}) inside its run, or a ProcessGroupRing), "
            f"or start {need} processes under a torch.distributed group of world size "
            f"{need} (torchrun --nproc_per_node {need}); dp: -1 takes any multiple")
    return make_mesh(config, comm)


def seeded_draws(seed: int, device: DeviceLike, num_train_timesteps: int = 1000,
                 patch_size_t: Optional[int] = None) -> DrawFn:
    """The default `draws(step, batch)`: micro-step `step`'s LossDraws from
    a generator on `device` seeded from (seed, step) alone (the diffusion
    noise over the frames the loss pads to a multiple of `patch_size_t`);
    a pipeline's data shard `shard` seeds from (seed, step, shard)."""
    device = resolve_device(device)

    def draws(step: int, batch: Dict[str, torch.Tensor], shard: Optional[int] = None
              ) -> LossDraws:
        key = [seed, step] if shard is None else [seed, step, shard]
        s = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
        return LossDraws.draw(torch.Generator(device).manual_seed(s), batch, num_train_timesteps,
                              patch_size_t)

    return draws


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device` (metainfo lists stay behind)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def _rank0_batches(batches: Optional[Iterator[Dict]], comm) -> Iterator[Dict]:
    """Rank 0's batches on every rank: rank 0 draws from `batches` and
    broadcasts each; the other ranks (whose `batches` is None) receive."""
    while True:
        yield comm.broadcast(next(batches) if comm.rank == 0 else None)


def train(cfg: Config, vae=None, device: DeviceLike = None, draws: Optional[DrawFn] = None,
          val_draws: Optional[ValDrawFn] = None, comm=None) -> TrainState:
    """Train the config's ControlDiT; return the final TrainState (under a
    mesh, this rank's). `vae` may be passed directly (library embedding,
    tests), else it loads from `vae.pretrained_name_or_path`; it renders the
    validation videos. `draws(step, batch)` gives micro-step `step`'s
    LossDraws (default in the module docstring; a pipeline's data shard
    calls `draws(step, batch, shard=index)` on its rows). Runs on `device`,
    CUDA unless "cpu" is asked. Under `train.mesh` call it on every rank:
    `comm` is the communicator of every rank, or None for the
    torch.distributed group (module docstring)."""
    mesh_cfg = _check_supported(cfg)
    tcfg = cfg.train
    mesh = world_mesh(mesh_cfg, comm, "train.mesh")
    shape = mesh.shape
    writer = mesh.rank == 0
    device = resolve_device(device)
    seed = int(cfg.get("seed", 42))
    out_dir = Path(tcfg.get("output_path", "outputs")) / (tcfg.get("output_dir") or "run")
    out_dir.mkdir(parents=True, exist_ok=True)

    dit_cfg = build_dit_config(cfg)
    if shape["pp"] > 1:
        check_pp_mesh(shape, dit_cfg.num_layers)
    if mesh.size > 1:
        CONSOLE.log(f"mesh: {mesh.shape}")
    dtype = torch.bfloat16 if tcfg.get("mixed_precision", "bf16") == "bf16" else torch.float32
    # train.overfit: train on the small 'val' split, so the loss should collapse
    dataset = build_dataset(cfg, split="val" if tcfg.get("overfit") else "train")
    bs = int(tcfg.get("train_batch_size", 4))
    loader = None
    if writer and tcfg.get("loader") == "grain":
        loader = make_grain_loader(dataset, bs, seed=seed,
                                   worker_count=int(tcfg.get("loader_workers") or 0))
    elif writer:
        loader = prefetch_batches(dataset, BucketSampler(dataset, batch_size=bs, seed=seed,
                                                         infinite=True))
    batches = loader if mesh.size == 1 else _rank0_batches(loader, mesh.comm)
    tracker = None
    try:
        first = next(batches)
        sp_comm = mesh.sp if shape["sp"] > 1 else None
        model = init_params(cfg, dit_cfg, dtype, device, sp=sp_comm)
        CONSOLE.log(f"model params: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B")
        # held whole (one rank, or dp and sp alone) or the rank's parts
        layout = MeshLayout.whole({k: v.shape for k, v in model.state_dict().items()}, mesh,
                                  dit_cfg.num_layers)
        if layout.split:
            whole = model.state_dict()

            def make_model(tp, layers):
                with seeded_init(seed, device):
                    return ControlDiT(dit_cfg, dtype=dtype, param_dtype=torch.float32,
                                      device=device, remat=model.remat,
                                      remat_policy=model.remat_policy, sp=sp_comm, tp=tp,
                                      layers=layers)

            model, layout = build_rank_model(make_model, whole, mesh, dit_cfg.num_layers)
            del whole

        total_steps = total_train_steps(tcfg, len(dataset), bs)
        multiview = bool(cfg.get("multiview"))
        tx = build_optimizer(tcfg, total_steps, bs, multiview)
        lr = tx.schedule
        state = TrainState.create(model, tx, layout)

        ckpt = TrainCheckpointer(str(out_dir / "checkpoints"),
                                 max_to_keep=int(tcfg.get("checkpoints_total_limit", 2)))
        start_step = 0
        if tcfg.get("resume_from_checkpoint") and ckpt.latest_step() is not None:
            ckpt.restore(state)
            start_step = state.step
            CONSOLE.log(f"resumed from step {start_step}")

        schedule = make_schedule()
        image_rotary_emb = None
        if dit_cfg.use_rotary_positional_embeddings:  # tables for the first batch's grid
            F_lat, h_lat, w_lat = first["latents"].shape[2:]
            image_rotary_emb = prepare_rotary_positional_embeddings(
                height=h_lat * 8, width=w_lat * 8, num_frames=F_lat,
                patch_size=dit_cfg.patch_size, patch_size_t=dit_cfg.patch_size_t,
                attention_head_dim=dit_cfg.attention_head_dim, device=device)
        step_kwargs = dict(
            vae_scaling_factor=float(cfg.get("vae", {}).get("scaling_factor", 1.15258426)),
            noised_image_dropout=float(tcfg.get("noised_image_dropout", 0.05)),
            recon_action=bool(cfg.get("recon_action", False)),
            image_rotary_emb=image_rotary_emb, patch_size_t=dit_cfg.patch_size_t)
        pipelined = shape["pp"] > 1
        n_micro = (tcfg.get("mesh", {}) or {}).get("n_micro")

        def make_step(**kw):
            if pipelined:
                return make_pp_train_step(tx, schedule, mesh, dit_cfg.num_layers, n_micro, **kw)
            return make_train_step(tx, schedule, **kw)

        # a step per view count: multiview batches are homogeneous in it, and
        # the frame padding is single-view
        steps = {1: make_step(**step_kwargs)}

        def step_for(nv: int):
            if nv not in steps:
                steps[nv] = make_step(**{**step_kwargs, "num_views": nv, "patch_size_t": None})
            return steps[nv]

        draws = draws or seeded_draws(seed, device, schedule.num_train_timesteps,
                                      dit_cfg.patch_size_t)
        if writer:
            tracker = Tracker(str(out_dir / "logs"), cfg.get("tracker_name"), config=dict(cfg))

        vae_path = cfg.get("vae", {}).get("pretrained_name_or_path")
        if vae is None and vae_path and Path(str(vae_path)).exists():
            from orv_tpu_torch.pipelines.evaluate import load_vae

            vae = load_vae(str(vae_path), device)
            CONSOLE.log(f"loaded VAE from {vae_path} (validation video rendering)")

        def validate(batch, step):
            # with train.ema_decay, validate the EMA weights, the ones a user serves
            ema = state.opt_state.ema
            if layout.split:  # the whole weights, gathered; rank 0 denoises
                whole = whole_params(state, ema=ema is not None)
                if writer:
                    with seeded_init(seed, device):
                        full = ControlDiT(dit_cfg, dtype=dtype, device=device)
                    full.load_state_dict(whole, strict=True)
                    run_validation(cfg, full, batch, out_dir, step, tracker, vae, device,
                                   val_draws)
                return
            with _params_swapped(state, ema) if ema is not None else contextlib.nullcontext():
                run_validation(cfg, model, batch, out_dir, step, tracker, vae, device, val_draws,
                               write=writer)

        def save(step):
            ckpt.save(step, state, write=writer)  # every rank gathers, rank 0 writes

        val_every = int(tcfg.get("validation_steps", 2000))
        if not os.environ.get("NO_INIT_VAL"):
            validate(first, start_step)
            if os.environ.get("ONLY_INIT_VAL"):
                return state

        log_every = int(tcfg.get("log_every", 10))
        ckpt_every = int(tcfg.get("checkpointing_steps", 500))
        t_last = time.time()
        batch = first
        for step in range(start_step, total_steps):
            nv = int(batch.get("num_views", 1)) if multiview else 1
            b = to_device(batch, device)
            if pipelined and mesh.data_size > 1:  # a data shard's rows and draws
                b = batch_rows(b, batch_sharding(mesh, b["latents"].shape[0]))
                d = draws(step, b, shard=mesh.data_index)
            else:
                d = draws(step, b)
            state, metrics = step_for(nv)(state, b, d)
            if writer and ((step + 1) % log_every == 0 or step == start_step):
                m = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t_last) / (log_every if step > start_step else 1)
                t_last = time.time()
                CONSOLE.log(f"step {step + 1}/{total_steps} loss={m['loss']:.4f} "
                            f"gnorm={m.get('grad_norm', 0):.3f} lr={lr(step):.2e} {dt:.2f}s/it")
                tracker.log({**m, "lr": lr(step), "s_per_it": dt}, step + 1)
            if (step + 1) % ckpt_every == 0:
                save(step + 1)
            if (step + 1) % val_every == 0:
                validate(batch, step + 1)
            batch = next(batches)

        save(total_steps)
        exports = {"checkpoint": whole_params(state)}
        if state.opt_state.ema is not None:
            exports["checkpoint_ema"] = whole_params(state, ema=True)
        if not writer:
            return state
        for folder, sd in exports.items():
            export_pretrained(str(out_dir / folder), sd, dit_cfg)
        CONSOLE.log(f"training done -> {out_dir}")
        return state
    finally:
        if loader is not None:
            loader.close()
        if tracker is not None:
            tracker.close()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", default=str(default_config_dir() / "base_train.yaml"))
    p.add_argument("--experiment", default=None,
                   help="experiment name (under config/experiments) or yaml path")
    p.add_argument("--dataset_type", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    p.add_argument("overrides", nargs="*", help="key.path=value overrides")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    exp = args.experiment
    if exp and not exp.endswith(".yaml"):
        exp = str(default_config_dir() / "experiments" / f"{exp}.yaml")
    cfg = load_config(
        args.base, exp, args.dataset_type,
        str(default_config_dir() / "debug.yaml") if args.debug else None,
        args.overrides,
    )
    initialize_distributed()  # under torchrun: the group of the mesh's ranks
    return train(cfg, device=args.device)


if __name__ == "__main__":
    main()
