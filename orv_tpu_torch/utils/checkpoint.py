"""Pretrained folders: the load side of the port's inference artifact.

Counterpart of `orv_tpu/utils/checkpoint.py:load_pretrained`. The port's
artifact is a diffusers folder (`config.json` plus safetensors weights, as
`orv_tpu.models.weights.export_torch_pretrained` writes it), read by
`models/weights.py:load_diffusers_folder`. The JAX package's own folder
(`config.json` plus flax `model.msgpack`) needs flax or msgpack to read and
is refused with the conversion to run. Writing training checkpoints (with
rotation and `latest`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from orv_tpu_torch.models.weights import load_diffusers_folder


def has_pretrained(folder) -> bool:
    """Whether `folder` holds weights of either kind: a diffusers folder or
    the JAX package's `model.msgpack` (which `load_pretrained` refuses)."""
    folder = Path(str(folder))
    return folder.is_dir() and (any(folder.glob("*.safetensors"))
                                or (folder / "model.msgpack").exists())


def load_pretrained(folder, config_cls=None) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """-> (config, state dict). `config` is `config_cls(**fields)` built from
    the folder's config.json keys that are fields of the dataclass (lists
    become tuples, "None" strings None), or the raw dict without one."""
    folder = Path(str(folder))
    if not any(folder.glob("*.safetensors")) and (folder / "model.msgpack").exists():
        raise ValueError(
            f"{folder} holds only the JAX package's flax model.msgpack, which the port "
            "does not read. Convert it once where JAX is installed, with "
            "orv_tpu.models.weights.export_torch_pretrained(folder, params, config), and "
            "point the port at that diffusers folder")
    cfg_dict, sd = load_diffusers_folder(folder)
    if config_cls is None:
        return cfg_dict, sd
    fields = {f.name for f in dataclasses.fields(config_cls)}
    kwargs = {}
    for k, v in cfg_dict.items():
        if k not in fields:
            continue
        if isinstance(v, str) and v in ("None", "null"):
            v = None
        if isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return config_cls(**kwargs), sd
