"""The launch plan of the adaLN backward kernels, held on the CPU.

`orv_tpu_torch.ops.adaln.bwd_plan` picks a backward kernel's tile rows and
persistent grid (orv_tpu_torch/ops/csrc/adaln_bwd_sm90.cuh) and the number
of partial-sum slots the wrapper allocates. The kernel walks the plan as
`walk` below does: block b takes tiles [b T / G, (b + 1) T / G) of the T
tiles in row-group order and writes one partial for each row group r it
touches into slot b + r; after the grid sync, group r's sums add the slots
from block_of(first tile of r) + r to block_of(last tile of r) + r. These
tests hold that every row of every group is covered exactly once, that
each slot is written once and lies in the allocation, and that each
group's slots are the ones the finish adds, at the model's shapes and
around them.
"""

import pytest

from orv_tpu_torch.ops.adaln import bwd_plan


def block_of(t: int, grid: int, n_tiles: int) -> int:
    """The block holding tile t, as the kernel's `block_of` computes it."""
    return ((t + 1) * grid - 1) // n_tiles


def walk(R: int, S: int, rows: int, grid: int):
    """(slot -> (group, rows covered), group -> slots) as the kernel's blocks
    walk their tiles."""
    tpg = -(-S // rows)
    n_tiles = R * tpg
    slots, by_group = {}, {}
    for b in range(grid):
        t0, t1 = b * n_tiles // grid, (b + 1) * n_tiles // grid
        assert t1 > t0, f"block {b} has no tile"
        for t in range(t0, t1):
            r, s0 = divmod(t, tpg)
            s0 *= rows
            slot = b + r
            group, covered = slots.setdefault(slot, (r, []))
            assert group == r, f"slot {slot} holds groups {group} and {r}"
            covered.extend(range(s0, min(s0 + rows, S)))
            if slot not in by_group.setdefault(r, []):
                by_group[r].append(slot)
    return slots, by_group


@pytest.mark.parametrize("S", [1, 226, 600, 3000])
@pytest.mark.parametrize("R", [1, 5, 13])
@pytest.mark.parametrize("max_rows,resident", [(12, 132), (8, 132), (4, 264), (1, 132), (5, 396)])
def test_bwd_plan_covers_every_row_once(R, S, max_rows, resident):
    rows, grid, n_part = bwd_plan(R, S, max_rows, resident)
    assert 1 <= rows <= max_rows and 1 <= grid <= resident
    n_tiles = R * -(-S // rows)
    assert grid <= n_tiles and n_part == grid + R - 1
    slots, by_group = walk(R, S, rows, grid)
    # a slot is written once (walk checks) and lies in the allocation; where a
    # block starts where a group starts, slot b + r skips one, never read
    assert max(slots) < n_part
    for r in range(R):
        covered = sorted(s for slot in by_group[r] for s in slots[slot][1])
        assert covered == list(range(S)), f"group {r}'s rows are not covered exactly once"
        tpg = n_tiles // R
        lo = block_of(r * tpg, grid, n_tiles) + r
        hi = block_of((r + 1) * tpg - 1, grid, n_tiles) + r
        assert by_group[r] == list(range(lo, hi + 1)), f"group {r}'s slots are not lo..hi"


@pytest.mark.parametrize("R,S,max_rows,resident,want", [
    (5, 600, 12, 132, (12, 132, 136)),  # the 2B recipe's adaLN backward: a block an SM
    (5, 600, 8, 132, (8, 132, 136)),    # its gated-residual backward, video stream
    (1, 226, 8, 132, (2, 113, 113)),    # text stream: 2 rows a tile fill 113 SMs
    (1, 3000, 12, 132, (12, 132, 132)),  # R = 1: one group, every block's partial in it
    (13, 1, 12, 132, (1, 13, 25)),      # one row a group: a tile, a block, a slot each
    (1, 1, 8, 132, (1, 1, 1)),
    (2, 5, 1, 132, (1, 10, 11)),        # the widest gated rows: one row a tile
])
def test_bwd_plan_sizes(R, S, max_rows, resident, want):
    assert bwd_plan(R, S, max_rows, resident) == want
