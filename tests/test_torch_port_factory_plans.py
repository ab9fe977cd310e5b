"""The host side of the data factory's kernels, held on the CPU.

`orv_tpu_torch/ops/csrc/scan.cuh` scans in tiles of SCAN_TILE elements: one
launch sums every tile but the last, a second adds the sums before each
tile, scans it and writes the total from the last. Hard voxelization's hash
table has `table_size(n)` slots of 16 bytes. The rasterizer's per-tile sort
(`tile_sort_kernel`) sorts a list of up to TILE_SORT_CAP keys in shared
memory and a longer one in `tile_sort_chunks` chunks merged by rank: each
key's place in its sorted chunk plus its lower bound in every other chunk.
These tests hold the Python constants to the CUDA sources, the plans at
their edges, the decompositions (emulated in numpy) against a plain scan
and a plain sort, and `bin_plain`, the card's binning oracle, against the
order the plain rasterizer blends in. They need no card.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from orv_tpu_torch.ops import _build, gaussian_raster, scan, voxelize

CSRC = Path(__file__).resolve().parents[1] / "orv_tpu_torch" / "ops" / "csrc"


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_scan_tile_matches_the_kernel():
    tile = _constant("scan.cuh", "kScanThreads") * _constant("scan.cuh", "kScanItems")
    assert tile == scan.SCAN_TILE == 2048


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 4096, 153_600, (1 << 20) + 3])
def test_scan_blocks_at_tile_edges(n):
    blocks = scan.scan_blocks(n)
    assert blocks == math.ceil(n / scan.SCAN_TILE)
    assert (blocks - 1) * scan.SCAN_TILE < n <= blocks * scan.SCAN_TILE or n == blocks == 0


def _scan_by_tiles(x: np.ndarray):
    """The kernels' two launches: tiles 0..B-2 summed, then each tile's
    elements get the sums of the tiles before plus their prefix in the tile;
    the last tile writes the total (one empty tile for n = 0)."""
    n, tile = len(x), scan.SCAN_TILE
    blocks = max(scan.scan_blocks(n), 1)
    block_sums = [int(x[b * tile:(b + 1) * tile].sum()) for b in range(blocks - 1)]
    out = np.empty(n, np.int64)
    total = None
    for b in range(blocks):
        carry = sum(block_sums[:b])
        part = x[b * tile:(b + 1) * tile]
        incl = np.cumsum(part)
        out[b * tile:b * tile + len(part)] = carry + incl - part
        if b == blocks - 1:
            total = carry + (int(incl[-1]) if len(part) else 0)
    return out, total


@pytest.mark.parametrize("n", [0, 1, 7, 2047, 2048, 2049, 6145, 153_600])
def test_scan_by_tiles_matches_cumsum(n):
    x = np.random.default_rng(n).integers(0, 9, n)
    out, total = _scan_by_tiles(x)
    want = np.concatenate([[0], np.cumsum(x)])
    assert np.array_equal(out, want[:-1]) and total == want[-1]


@pytest.mark.parametrize("n", [0, 1, 2049])
def test_exclusive_scan_on_the_cpu(n):
    x = torch.from_numpy(np.random.default_rng(n).integers(0, 9, n).astype(np.int32))
    before = scan.exclusive_scan.launches
    out, total = scan.exclusive_scan(x)
    want = np.concatenate([[0], np.cumsum(x.numpy())])
    assert out.dtype == total.dtype == torch.int32
    assert np.array_equal(out.numpy(), want[:-1]) and total.tolist() == [want[-1]]
    assert scan.exclusive_scan.launches == before  # the plain version: no launch
    with pytest.raises(ValueError):
        scan.exclusive_scan(x.long())


@pytest.mark.parametrize("n", [0, 1, 2, 153_600])
def test_voxel_table_has_more_slots_than_points(n):
    assert voxelize.table_size(n) > n and voxelize.table_size(n) >= 2
    assert voxelize.table_size(n) == max(2 * n, 2)


def test_voxel_table_slot_is_what_the_wrapper_allocates():
    text = (CSRC / "voxelize.cu").read_text()
    body = re.search(r"struct Slot \{(.*?)\};", text, re.S).group(1)
    fields = re.findall(r"^\s*(unsigned long long|unsigned) (\w+);", body, re.M)
    assert fields == [("unsigned long long", "key"), ("unsigned", "first"),
                      ("unsigned", "count")]
    assert voxelize._SLOT_BYTES == 8 + 4 + 4


def test_tile_sort_cap_matches_the_kernel():
    assert _constant("gaussian_raster.cu", "kSortCap") == gaussian_raster.TILE_SORT_CAP
    # the sort's shared memory: kSortCap 8-byte keys, within the 48 KB of static shared memory
    assert gaussian_raster.TILE_SORT_CAP * 8 <= 48 * 1024


@pytest.mark.parametrize("length,chunks", [(0, 1), (1, 1), (4095, 1), (4096, 1), (4097, 2),
                                           (8192, 2), (8193, 3), (100_000, 25)])
def test_tile_sort_chunks_at_the_cap(length, chunks):
    assert gaussian_raster.tile_sort_chunks(length) == chunks


def _merge_by_rank(keys: np.ndarray, cap: int) -> np.ndarray:
    """The long-list path: chunks of cap keys sorted, each key placed at its
    place in its chunk plus its lower bound in every other chunk."""
    chunks = [np.sort(keys[c:c + cap]) for c in range(0, len(keys), cap)]
    out = np.empty(len(keys), keys.dtype)
    placed = np.zeros(len(keys), bool)
    for c, chunk in enumerate(chunks):
        pos = np.arange(len(chunk))
        for c2, other in enumerate(chunks):
            if c2 != c:
                pos = pos + np.searchsorted(other, chunk, side="left")
        assert not placed[pos].any()
        placed[pos] = True
        out[pos] = chunk
    assert placed.all()
    return out


@pytest.mark.parametrize("length", [4097, 10_000, 12_289])
def test_merge_by_rank_orders_a_long_list(length):
    """Keys as the kernel packs them, (depth bits << 32 | gaussian), with many
    equal depths and the gaussians in no order: the merge equals one sort,
    equal depths in gaussian order."""
    rng = np.random.default_rng(length)
    depth = np.float32(0.5) + np.float32(0.01) * rng.integers(0, 50, length).astype(np.float32)
    idx = rng.permutation(50_000)[:length].astype(np.uint64)
    keys = (depth.view(np.uint32).astype(np.uint64) << np.uint64(32)) | idx
    got = _merge_by_rank(keys, gaussian_raster.TILE_SORT_CAP)
    order = np.lexsort((idx, depth))  # depth first, ties by index
    assert np.array_equal(got, keys[order])


def _slab_scene():
    """Voxel centres of a 40 x 40 x 2 slab seen straight down at 64 x 96:
    each layer's centres share one depth exactly."""
    from orv_tpu_torch.pipelines import prepare_dataset as tpd

    y, x = np.mgrid[180:220, 180:220]
    coors = np.concatenate([np.stack([np.full(x.size, z), y.ravel(), x.ravel()], 1)
                            for z in (200, 201)]).astype(np.int32)
    centers, _, rot, scales, _ = tpd.occupancy_to_gaussians(coors, np.ones(len(coors), np.int32),
                                                             device="cpu")
    pose = np.eye(4)
    pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
    pose[2, 3] = 0.5
    K = np.array([[300.0, 0, 48], [0, 300.0, 32], [0, 0, 1]])
    return gaussian_raster.view_settings(pose, K, (64, 96)), centers, scales, rot


def _random_scene(n: int, H: int, W: int, seed: int):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.1, 3.0, n)
    cam = np.stack([rng.uniform(-0.8, 0.8, n) * z, rng.uniform(-0.6, 0.6, n) * z, z], 1)
    K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]])
    settings = gaussian_raster.view_settings(np.eye(4), K, (H, W))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return (settings, f32(cam), f32(rng.uniform(0.004, 0.08, (n, 3)) * z[:, None]),
            f32(rng.normal(size=(n, 4))))


@pytest.mark.parametrize("scene", ["random", "ties"])
def test_bin_plain_lists_follow_the_blend_order(scene):
    """Each tile's list is the gaussians touching it in the plain
    rasterizer's blend order (by depth, equal depths by index), and slot_of
    sends each gaussian's keys, tile by tile in row order, to its place."""
    settings, means, scales, rot = (_random_scene(400, 45, 70, 3) if scene == "random"
                                    else _slab_scene())
    got = gaussian_raster.bin_plain(settings, means, scales, rot)
    geo = gaussian_raster._geometry_plain(settings, means, scales, rot)
    idx = torch.nonzero(geo["valid"]).flatten()
    order = idx[torch.sort(geo["depth"][idx], stable=True).indices]
    rect = geo["rect"][order]
    tiles_x = -(-settings.image_width // 16)
    n_tiles = tiles_x * -(-settings.image_height // 16)
    assert got["ranges"].shape == (n_tiles, 2) and int(got["ranges"][-1, 1]) == len(
        got["point_list"]) == int(got["touched"].sum())
    for t in range(n_tiles):
        tx, ty = t % tiles_x, t // tiles_x
        sel = order[(rect[:, 0] <= tx) & (tx <= rect[:, 1]) & (rect[:, 2] <= ty)
                    & (ty <= rect[:, 3])]
        s, e = got["ranges"][t].tolist()
        assert torch.equal(got["point_list"][s:e].long(), sel), t
    if scene == "ties":
        assert len(torch.unique(geo["depth"][idx])) <= 2 and len(idx) > 1000
    for i in torch.nonzero(got["touched"]).flatten().tolist():
        r = geo["rect"][i].tolist()
        for j in range(int(got["touched"][i])):
            p = int(got["slot_of"][int(got["offsets"][i]) + j])
            t = (r[2] + j // (r[1] - r[0] + 1)) * tiles_x + r[0] + j % (r[1] - r[0] + 1)
            assert int(got["point_list"][p]) == i
            assert got["ranges"][t, 0] <= p < got["ranges"][t, 1]


def test_read_int_adds_its_wait():
    before = list(_build.host_waits.get("test", [0, 0.0]))
    assert _build.read_int(torch.tensor([41], dtype=torch.int32) + 1, "test") == 42
    reads, seconds = _build.host_waits["test"]
    assert reads == before[0] + 1 and seconds >= before[1]
