"""Experiment tracking: JSONL metrics, and wandb where it is installed.

Counterpart of `orv_tpu/utils/tracker.py`. The default tracker appends
metrics to `<log_dir>/metrics.jsonl` and writes the run's config to
`<log_dir>/config.json`; when wandb is importable and a project
(`tracker_name`) is set, it logs there too, through the same interface.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class Tracker:
    def __init__(self, log_dir: str, project: Optional[str] = None, config: Optional[Dict] = None):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        self._wandb = None
        if project:
            try:
                import wandb

                self._wandb = wandb.init(project=project, config=config, dir=str(self.dir))
            except Exception:  # noqa: BLE001 — wandb is optional; JSONL still logs
                pass
        if config is not None:
            with open(self.dir / "config.json", "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict[str, Any], step: int):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_video(self, name: str, path: str, step: int):
        self.log({f"video/{name}": str(path)}, step)

    def close(self):
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
