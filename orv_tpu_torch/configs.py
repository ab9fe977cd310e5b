"""Layered YAML config system.

Counterpart of `orv_tpu/configs.py`, with the same merge order: base yaml
-> experiment yaml -> per-dataset-type sub-block -> optional debug overlay
-> CLI dotted overrides; the `runtime` block merges into every section via
YAML anchors (`<<: *runtime`, which PyYAML resolves) and into the root.
Plain dict deep-merge with attribute access. The config files are the
port's own copy, `orv_tpu_torch/config/`.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """dict with attribute access, recursive."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; override wins; lists replace wholesale."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(s: str):
    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    # YAML 1.1 leaves '1e-5' (no dot) as a string; accept scientific floats
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return v
    return v


def apply_dotted_overrides(cfg: Dict, overrides: List[str]) -> Dict:
    """['train.learning_rate=1e-4', ...] CLI overrides, YAML-typed."""
    cfg = copy.deepcopy(cfg)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' must be key.path=value")
        key, val = item.split("=", 1)
        cur = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_value(val)
    return cfg


def _read_yaml(path: str) -> Dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(
    base_yaml: str,
    experiment_yaml: Optional[str] = None,
    dataset_type: Optional[str] = None,
    debug_yaml: Optional[str] = None,
    overrides: Optional[List[str]] = None,
) -> Config:
    """cfg = base <- experiment; cfg.dataset <- cfg.dataset[dataset_type]
    over the dataset block's scalar keys; cfg <- debug; cfg <- CLI
    overrides; cfg <- cfg.runtime (root merge)."""
    cfg = _read_yaml(base_yaml)
    if experiment_yaml:
        cfg = deep_merge(cfg, _read_yaml(experiment_yaml))
    if dataset_type:
        ds = cfg.get("dataset", {})
        if dataset_type not in ds:
            raise KeyError(f"dataset type '{dataset_type}' not in config")
        # keep the scalar dataset keys, overlay the chosen type's block
        scalars = {k: v for k, v in ds.items()
                   if not (isinstance(v, dict) and "data_root" in v)}
        cfg["dataset"] = deep_merge(scalars, ds[dataset_type])
        cfg["dataset"]["type"] = dataset_type
    if debug_yaml:
        cfg = deep_merge(cfg, _read_yaml(debug_yaml))
    if overrides:
        cfg = apply_dotted_overrides(cfg, overrides)
    if "runtime" in cfg:
        cfg = deep_merge(cfg, cfg["runtime"])
    return Config(cfg)


def default_config_dir() -> Path:
    return Path(__file__).parent / "config"
