"""Training entry point: `build_dit_config` and `build_dataset`.

Counterpart of `orv_tpu/pipelines/train.py:build_dit_config` and
`build_dataset`, which the serving entry points read too. The training
loop (loader, checkpoint writing, tracker, validation) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import yaml

from orv_tpu_torch.configs import Config, default_config_dir
from orv_tpu_torch.data import CascadedRobotDataset, DatasetConfig, RobotDataset
from orv_tpu_torch.models.dit import DiTConfig

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
    if cfg.get("multiview"):
        raise NotImplementedError(
            "multiview datasets are not ported yet (ROADMAP.md A6: multiview)")
    if cascaded:
        return CascadedRobotDataset(ds_cfg)
    return RobotDataset(ds_cfg)
