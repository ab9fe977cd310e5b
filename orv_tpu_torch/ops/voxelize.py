"""Point-cloud voxelization: CUDA kernels (`csrc/voxelize.cu`) and their
plain PyTorch version.

Counterpart of `orv_tpu/ops/voxelize.py` over `ops/native/voxelize.cpp`.
`voxelization(points, voxel_size, coors_range, max_points, max_voxels)`
returns `(voxels [M, max_points, F], coors [M, 3] (z, y, x),
num_points_per_voxel [M])` truncated to the filled count M, or, with
`max_points == -1` (dynamic mode), each point's coordinates [N, 3] (-1
outside the grid). Semantics of the C++ op:

  * a point's cell is floor((p - lo) / vs) computed in f32, and the grid
    round((hi - lo) / vs) in f32 with C's round (half away from zero). The
    JAX package's `voxelization_np` computes the cell in f64 and can
    disagree at a cell boundary; the port follows the C++ op, which is what
    the JAX factory runs;
  * voxel ids are first come, first served in input order, `max_voxels`
    drops later new voxels, and a voxel keeps its first `max_points` points.

Outputs lie on the points' device. On CUDA the kernels run and the outputs
are allocated by the filled count (the JAX wrapper zero-fills max_voxels x
max_points x F, 512 MB at the factory's defaults); on the CPU
`voxelization_plain` runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from orv_tpu_torch.ops import _build
from orv_tpu_torch.ops.scan import scan_blocks

_INVALID = torch.iinfo(torch.int64).max


def _f32(x: Sequence[float]) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(-1)


def _grid(voxel_size: Sequence[float], coors_range: Sequence[float]):
    """Cells along x, y, z: round((hi - lo) / vs) in f32, half away from
    zero (std::round, voxelize.cpp:63-66)."""
    vs, cr = _f32(voxel_size), _f32(coors_range)
    g = (cr[3:] - cr[:3]) / vs  # f32 arithmetic, as the C++ does it
    return [int(math.copysign(math.floor(abs(float(x)) + 0.5), float(x))) for x in g]


def _check_points(name: str, points: torch.Tensor) -> None:
    if points.dim() != 2 or points.shape[1] < 3 or points.dtype != torch.float32:
        raise ValueError(f"{name} takes points [N, F >= 3] float32; got {points.dtype} "
                         f"{tuple(points.shape)}")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {points.device}")


def _cells_plain(points: torch.Tensor, voxel_size, coors_range):
    """(coors [N, 3] int32 (z, y, x) or -1, valid [N]) in f32 arithmetic."""
    vs = torch.from_numpy(_f32(voxel_size)).to(points.device)
    lo = torch.from_numpy(_f32(coors_range)[:3]).to(points.device)
    grid = torch.tensor(_grid(voxel_size, coors_range), device=points.device)
    c = torch.floor((points[:, :3] - lo) / vs)
    ok = ((c >= 0) & (c < grid.float())).all(dim=1)
    ci = torch.where(ok[:, None], c, torch.zeros_like(c)).long()
    coors = torch.where(ok[:, None], ci.flip(1), torch.full_like(ci, -1)).int()
    return coors, ok, grid


def voxelization_plain(points: torch.Tensor, voxel_size, coors_range, max_points: int = 35,
                       max_voxels: int = 20000):
    """Plain PyTorch version of `voxelization`, same semantics and outputs:
    the keys sorted stably, voxel ids by the rank of each run's first point."""
    _check_points("voxelization_plain", points)
    coors_pp, ok, grid = _cells_plain(points, voxel_size, coors_range)
    if max_points == -1:
        return coors_pp
    n, nf = points.shape
    dev = points.device
    c = coors_pp.long()
    keys = torch.where(ok, (c[:, 0] * grid[1] + c[:, 1]) * grid[0] + c[:, 2],
                       torch.full_like(c[:, 0], _INVALID))
    skeys, perm = torch.sort(keys, stable=True)
    valid = skeys != _INVALID
    start = valid.clone()
    start[1:] &= skeys[1:] != skeys[:-1]
    starts = torch.nonzero(start).flatten()  # sorted positions of the runs' first points
    firsts = perm[starts]  # their input indices
    n_runs = len(starts)
    if n_runs == 0:
        return (points.new_zeros((0, max_points, nf)),
                torch.zeros((0, 3), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    vid_of_run = torch.empty(n_runs, dtype=torch.long, device=dev)
    vid_of_run[torch.argsort(firsts)] = torch.arange(n_runs, device=dev)
    run = torch.cumsum(start.long(), 0) - 1
    slot = torch.arange(n, device=dev) - starts[run.clamp(min=0)]
    vid = vid_of_run[run.clamp(min=0)]
    keep = valid & (vid < max_voxels) & (slot < max_points)
    m = min(n_runs, max_voxels)
    voxels = torch.zeros((m, max_points, nf), dtype=points.dtype, device=dev)
    voxels[vid[keep], slot[keep]] = points[perm[keep]]
    coors = torch.zeros((m, 3), dtype=torch.int32, device=dev)
    nppv = torch.zeros((m,), dtype=torch.int32, device=dev)
    first_kept = vid_of_run < m
    coors[vid_of_run[first_kept]] = coors_pp[firsts[first_kept]]
    run_len = torch.diff(torch.cat([starts, valid.sum().reshape(1)]))
    nppv[vid_of_run[first_kept]] = run_len[first_kept].clamp(max=max_points).int()
    return voxels, coors, nppv


_CELLS_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
               + [ctypes.c_void_p] * 2)
_GROUP_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
               + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 8)
_SCATTER_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p] * 4)
_SLOT_BYTES = 16  # csrc/voxelize.cu: Slot


def table_size(n: int) -> int:
    """Slots of hard voxelization's hash table for n points: 2n, at least 2
    (more slots than points, so a probe always ends at a free slot)."""
    return max(2 * n, 2)


def _grid_args(voxel_size, coors_range):
    """vs, lo (3 floats) and dim (3 ints) in host memory, as the kernels take them."""
    return ((ctypes.c_float * 3)(*_f32(voxel_size)), (ctypes.c_float * 3)(*_f32(coors_range)[:3]),
            (ctypes.c_int * 3)(*_grid(voxel_size, coors_range)))


def dynamic_voxelize(points: torch.Tensor, voxel_size, coors_range) -> torch.Tensor:
    """Each point's cell (z, y, x), -1 outside the grid (voxelize.cpp:59-91):
    voxel_cells_kernel on CUDA (counted in `dynamic_voxelize.launches`)."""
    _check_points("dynamic_voxelize", points)
    if points.device.type == "cpu":
        return voxelization_plain(points, voxel_size, coors_range, max_points=-1)
    points = points.contiguous()
    n, nf = points.shape
    coors = torch.empty((n, 3), dtype=torch.int32, device=points.device)
    vs, lo, dim = _grid_args(voxel_size, coors_range)
    with torch.cuda.device(points.device):
        err = _build.kernel("orv_voxel_cells", _CELLS_ARGS)(
            points.data_ptr(), n, nf, ctypes.addressof(vs), ctypes.addressof(lo),
            ctypes.addressof(dim), coors.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "voxel_cells")
    _build.count(dynamic_voxelize)
    return coors


dynamic_voxelize.launches = 0


def hard_voxelize(points: torch.Tensor, voxel_size, coors_range, max_points: int = 35,
                  max_voxels: int = 20000):
    """(voxels, coors, num_points_per_voxel) of the filled voxels
    (voxelize.cpp:94-137): on CUDA the grouping (a hash table of the cells,
    a device-wide scan for the voxel ids and buckets, the buckets' fill),
    one read of the voxel count to size the outputs, then the scatter, a
    warp a voxel (counted in `hard_voxelize.launches`)."""
    _check_points("hard_voxelize", points)
    if max_points < 1 or max_voxels < 0:
        raise ValueError(f"hard_voxelize takes max_points >= 1 and max_voxels >= 0; got "
                         f"{max_points}, {max_voxels}")
    if points.device.type == "cpu":
        return voxelization_plain(points, voxel_size, coors_range, max_points, max_voxels)
    points = points.contiguous()
    n, nf = points.shape
    size = table_size(n)
    if size > torch.iinfo(torch.int32).max:
        raise ValueError(f"hard_voxelize takes at most 2**30 points (its hash table has 2n "
                         f"int32-indexed slots); got {n}")
    dev = points.device
    i32 = dict(dtype=torch.int32, device=dev)
    coors_pp = torch.empty((n, 3), **i32)
    table = torch.empty((size, _SLOT_BYTES // 8), dtype=torch.int64, device=dev)
    slot_pos = torch.empty((2, n), **i32)
    start_of_slot = torch.empty((size,), **i32)
    vinfo = torch.empty((n, 4), **i32)
    bucket = torch.empty((n,), **i32)
    block_sums = torch.empty((max(scan_blocks(n), 1), 2), **i32)
    total = torch.empty((2,), **i32)
    vs, lo, dim = _grid_args(voxel_size, coors_range)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("orv_voxel_group", _GROUP_ARGS)(
            points.data_ptr(), n, nf, ctypes.addressof(vs), ctypes.addressof(lo),
            ctypes.addressof(dim), max_voxels, coors_pp.data_ptr(), table.data_ptr(), size,
            slot_pos[0].data_ptr(), slot_pos[1].data_ptr(), start_of_slot.data_ptr(),
            vinfo.data_ptr(), bucket.data_ptr(), block_sums.data_ptr(), total.data_ptr(), stream)
        _build.check(err, "voxel_group")
        m = min(_build.read_int(total[0], "hard_voxelize"), max_voxels)
        voxels = torch.empty((m, max_points, nf), dtype=torch.float32, device=dev)
        coors = torch.empty((m, 3), **i32)
        nppv = torch.empty((m,), **i32)
        err = _build.kernel("orv_voxel_scatter", _SCATTER_ARGS)(
            points.data_ptr(), nf, vinfo.data_ptr(), bucket.data_ptr(), coors_pp.data_ptr(), m,
            max_points, voxels.data_ptr(), coors.data_ptr(), nppv.data_ptr(), stream)
    _build.check(err, "voxel_scatter")
    _build.count(hard_voxelize)
    return voxels, coors, nppv


hard_voxelize.launches = 0


def voxelization(points: torch.Tensor, voxel_size: Sequence[float],
                 coors_range: Sequence[float], max_points: int = 35, max_voxels: int = 20000):
    """points [N, F >= 3] float32 on its device -> see the module docstring."""
    if max_points == -1:
        return dynamic_voxelize(points, voxel_size, coors_range)
    return hard_voxelize(points, voxel_size, coors_range, max_points, max_voxels)
