"""Profiling and observability helpers.

Counterpart of `orv_tpu/utils/profiling.py` (reference utils.py:166-331):
the card's memory counters (`torch.cuda.memory_stats`) and a
`torch.profiler` trace where the JAX package reads its device's memory
stats and writes a jax.profiler trace.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, Mapping, Union

import torch

from orv_tpu_torch.utils.device import DeviceLike, resolve_device
from orv_tpu_torch.utils.logging import CONSOLE


def device_memory_stats(device: DeviceLike = None) -> Dict[str, float]:
    """Device memory in GB: in use now, the peak since the last reset and
    the card's total. The CPU keeps no such counters, and gives zeros, as
    JAX's CPU device does. `None` is the CUDA device (module policy)."""
    device = resolve_device(device)
    gb = 1024 ** 3
    if device.type != "cuda":
        return {"bytes_in_use_gb": 0.0, "peak_bytes_in_use_gb": 0.0, "bytes_limit_gb": 0.0}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / gb,
        "peak_bytes_in_use_gb": stats.get("allocated_bytes.all.peak", 0) / gb,
        "bytes_limit_gb": torch.cuda.get_device_properties(device).total_memory / gb,
    }


def print_memory(device: DeviceLike = None, tag: str = "") -> None:
    s = device_memory_stats(device)
    CONSOLE.log(
        f"[mem{':' + tag if tag else ''}] in_use={s['bytes_in_use_gb']:.3f}GB "
        f"peak={s['peak_bytes_in_use_gb']:.3f}GB limit={s['bytes_limit_gb']:.3f}GB"
    )


@contextlib.contextmanager
def profile_trace(log_dir: str = "torch_trace") -> Iterator[torch.profiler.profile]:
    """A torch.profiler trace of the block (the host, and the card where
    there is one), written as a Chrome trace to `log_dir`/trace.json (view
    it in chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    CONSOLE.log(f"profiler trace -> {out / 'trace.json'}")


def flatten_dict(d: Dict[str, Any], parent: str = "", sep: str = "/") -> Dict[str, Any]:
    """Nested dict -> flat {a/b/c: v} (reference utils.flatten_dict)."""
    out = {}
    for k, v in d.items():
        key = f"{parent}{sep}{k}" if parent else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


def _leaves(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def global_grad_norm(grads: Union[torch.Tensor, Mapping, Iterable]) -> float:
    """The square root of the sum of squares of every gradient (tensors,
    nested in dicts, lists or tuples), each squared and summed in f32, the
    sum taken on the host (reference get_gradient_norm)."""
    total = 0.0
    for leaf in _leaves(grads):
        total += float(leaf.detach().float().square().sum())
    return total ** 0.5
