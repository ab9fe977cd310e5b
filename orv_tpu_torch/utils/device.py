"""Device policy: the port runs on the GPU unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA device, and raises where there is none; the CPU
    is used only when the caller names it (it then runs each kernel's plain
    PyTorch version)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: orv_tpu_torch runs on the GPU by default; "
                               "pass device='cpu' to run its plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def check_module_device(module: torch.nn.Module, device: torch.device, what: str) -> None:
    """Raise unless `module`'s parameters live on `device` (an index-less
    'cuda' matches any card)."""
    got = next(module.parameters()).device
    if got.type != device.type or (device.index is not None and got.index != device.index):
        raise ValueError(f"{what} lives on {got}, but the call asks for {device}")
