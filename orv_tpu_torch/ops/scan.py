"""The device-wide exclusive prefix sum of `csrc/scan.cuh`, on its own.

The data factory's kernels run this scan inside their own entry points
(`csrc/voxelize.cu`, `csrc/gaussian_raster.cu`); `exclusive_scan` exposes it
so that it can be held against `torch.cumsum` at every tile boundary. On a
CPU tensor it is `torch.cumsum` itself.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from orv_tpu_torch.ops import _build

# elements a block scans (csrc/scan.cuh: kScanTile = 256 threads x 8)
SCAN_TILE = 2048


def scan_blocks(n: int) -> int:
    """Tiles, and block sums, of a scan of n elements (scan.cuh:scan_blocks)."""
    return -(-n // SCAN_TILE)


def exclusive_scan_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, total): out[i] = sum of x[0..i) and total [1], int32."""
    incl = torch.cumsum(x, 0, dtype=torch.int32)
    out = torch.zeros_like(incl)
    out[1:] = incl[:-1]
    total = incl[-1:].clone() if len(x) else torch.zeros(1, dtype=torch.int32, device=x.device)
    return out, total


_SCAN_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4


def exclusive_scan(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, total) of an int32 vector on its device: the kernel on CUDA
    (counted in `exclusive_scan.launches`), `exclusive_scan_plain` on the
    CPU."""
    if x.dim() != 1 or x.dtype != torch.int32:
        raise ValueError(f"exclusive_scan takes an int32 vector; got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return exclusive_scan_plain(x)
    x = x.contiguous()
    n = x.shape[0]
    out = torch.empty_like(x)
    total = torch.empty(1, dtype=torch.int32, device=x.device)
    block_sums = torch.empty(max(scan_blocks(n), 1), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.kernel("orv_exclusive_scan", _SCAN_ARGS)(
            x.data_ptr(), n, out.data_ptr(), total.data_ptr(), block_sums.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "exclusive_scan")
    _build.count(exclusive_scan)
    return out, total


exclusive_scan.launches = 0
