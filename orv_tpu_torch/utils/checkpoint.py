"""Checkpointing: training state with rotation, and pretrained folders.

Counterpart of `orv_tpu/utils/checkpoint.py`.

`TrainCheckpointer` keeps step-indexed training checkpoints with rotation
to `max_to_keep` and `latest_step` for resume, as the JAX package's orbax
manager does. Its format is the port's own: one directory per step,
`<directory>/<step>/`, holding `state.safetensors` (the model's state dict
and the optimizer's state, named by `parallel/train_step.py:state_tensors`:
the rule's tensors for the trainable parameters only, Adam's moments,
CAME's per-leaf m, factored rows and columns or full second moment (a
field a leaf does not use is absent), prodigy's four tensors and its two
scalars as 0-d tensors; the accumulator between micro-steps; the EMA of
every parameter) and `state.json` (step, count, mini_step). The port cannot read an orbax checkpoint, and the JAX package
cannot read this one: a run resumes in the package that wrote it.

The port's inference artifact is a diffusers folder (`config.json` plus
safetensors weights, as `export_pretrained` here and
`orv_tpu.models.weights.export_torch_pretrained` write it), read by
`models/weights.py:load_diffusers_folder`. The JAX package's own folder
(`config.json` plus flax `model.msgpack`) needs flax or msgpack to read and
is refused with the conversion to run.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from orv_tpu_torch.models.weights import (export_diffusers_folder, iter_safetensors,
                                          load_diffusers_folder, write_safetensors)
from orv_tpu_torch.parallel.train_step import TrainState, load_state_tensors, state_tensors
from orv_tpu_torch.utils.logging import CONSOLE


class TrainCheckpointer:
    """Step-indexed training checkpoints with rotation (module docstring).
    `save` skips a step at or below the latest saved one, as orbax's
    manager does; a step's directory appears whole or not at all (it is
    written under a temporary name, then renamed)."""

    STATE, SCALARS = "state.safetensors", "state.json"

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.last_save_bytes = 0

    def all_steps(self):
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / self.SCALARS).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, write: bool = True) -> bool:
        """Write `state`'s whole tensors (`state_tensors`). Under a mesh
        every rank calls it and gathers, and the one with `write` writes."""
        tensors, scalars = state_tensors(state)
        latest = self.latest_step()
        if not write or (latest is not None and step <= latest):
            return False
        tmp = self.directory / f"{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        self.last_save_bytes = write_safetensors(tmp / self.STATE, tensors)
        (tmp / self.SCALARS).write_text(json.dumps(scalars))
        tmp.rename(self.directory / str(step))
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self.directory / str(old))
        CONSOLE.log(f"saved checkpoint step {step} -> {self.directory}")
        return True

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load step `step` (default: the latest) into `state` in place."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        folder = self.directory / str(step)
        scalars = json.loads((folder / self.SCALARS).read_text())
        return load_state_tensors(state, iter_safetensors(folder / self.STATE), scalars)


def export_pretrained(folder: str, state_dict: Mapping[str, torch.Tensor], config) -> int:
    """Write the diffusers folder `load_pretrained` (and the JAX package's
    `load_torch_state_dict` + `convert_dit_state_dict`) reads: config.json
    and `diffusion_pytorch_model.safetensors`. Returns the weights' bytes."""
    n = export_diffusers_folder(folder, state_dict, config)
    CONSOLE.log(f"exported pretrained folder: {folder}")
    return n


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
