"""The launch plans of the general adaLN forward and the gated residual's
f32 instance, held on the CPU.

`modulate_norm_general_instance` and `modulate_norm_general_plan` mirror
csrc/adaln_general.cu's `mn_fwd_instance` and `mn_fwd_launch`: the instance
a row width takes (lanes a row, 16-byte chunks a lane holds in registers)
and the rows each block takes. `gated_residual_f32_plan` mirrors
csrc/gated_residual.cu's `gr_f32_plan`: the rows a step of the threads that
each own a column chunk of a row group. The walks below do what the kernels
do with a plan; these tests hold that every row and column is covered once,
and that the gated residual's grid is one wave where it can be and that no
smaller step count would do. The card tests hold the C side against these
functions (tests/test_torch_port_cuda.py).
"""

import numpy as np
import pytest
import torch

from orv_tpu_torch.ops.adaln import (GENERAL_COEF_COLS, GENERAL_FWD_WARPS, GENERAL_GR_THREADS,
                                     gated_residual_f32_plan, modulate_norm_general_instance,
                                     modulate_norm_general_plan)

F32, BF16 = torch.float32, torch.bfloat16
ELEMS = {F32: 4, BF16: 8}  # elements a 16-byte chunk


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_instance_holds_its_row_with_the_fewest_registers(dtype):
    """Every D % 8 up to past the card tests' widest: the instance holds the
    row (or, past GENERAL_COEF_COLS, is the widest one), and half its chunks
    (or the next narrower lane count) would not."""
    e = ELEMS[dtype]
    most = GENERAL_COEF_COLS // (32 * e)
    for D in range(8, 19376, 8):
        lanes, held = modulate_norm_general_instance(D, dtype)
        n = D // e
        assert lanes in (4, 8, 16, 32) and held >= 1 and held & (held - 1) == 0
        if D > GENERAL_COEF_COLS:
            assert (lanes, held) == (32, most), D
            continue
        assert lanes * held >= n, D
        if lanes < 32:
            assert held == 1 and (lanes == 4 or lanes // 2 < n), D
        else:
            assert n > 16 and (held == 1 or 32 * held // 2 < n), D


@pytest.mark.parametrize("D,dtype,want", [
    (8, F32, (4, 1)), (16, F32, (4, 1)), (24, F32, (8, 1)), (32, F32, (8, 1)),
    (40, F32, (16, 1)), (64, F32, (16, 1)), (72, F32, (32, 1)), (128, F32, (32, 1)),
    (136, F32, (32, 2)), (1920, F32, (32, 16)), (2048, F32, (32, 16)), (2056, F32, (32, 32)),
    (4096, F32, (32, 32)), (4104, F32, (32, 32)), (32, BF16, (4, 1)), (40, BF16, (8, 1)),
    (128, BF16, (16, 1)), (136, BF16, (32, 1)), (1920, BF16, (32, 8)), (4096, BF16, (32, 16)),
    (4224, BF16, (32, 16))])
def test_instance_at_the_edges(D, dtype, want):
    assert modulate_norm_general_instance(D, dtype) == want


def fwd_walk(R, S, plan):
    """rows[r] as the forward's blocks take them: block b takes tile b % T of
    group b // T, tile_rows rows from tile tile_rows on."""
    seen = [[0] * S for _ in range(R)]
    for b in range(plan["blocks"]):
        r, tile = divmod(b, plan["tiles_per_group"])
        for row in range(tile * plan["tile_rows"], min(S, (tile + 1) * plan["tile_rows"])):
            seen[r][row] += 1
    return seen


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("D", [8, 32, 64, 1920, 4096, 19368])
@pytest.mark.parametrize("R,S", [(1, 1), (1, 5), (2, 96), (1, 226), (5, 600), (13, 600),
                                 (300, 5), (1, 40000)])
def test_fwd_plan_covers_every_row_once(R, S, D, dtype):
    """A block takes a row a warp (32 / lanes rows a warp in the narrow
    instances); the tiles cover every row of every group once."""
    plan = modulate_norm_general_plan(R, S, D, dtype)
    lanes, held = modulate_norm_general_instance(D, dtype)
    assert (plan["lanes"], plan["held"]) == (lanes, held)
    assert plan["tile_rows"] == GENERAL_FWD_WARPS * 32 // lanes
    assert plan["blocks"] == R * plan["tiles_per_group"]
    assert (plan["tiles_per_group"] - 1) * plan["tile_rows"] < S
    assert all(c == 1 for row in fwd_walk(R, S, plan) for c in row)


def test_fwd_plan_at_the_training_shape():
    """[5,600,1920] f32: four rows a block, 150 a group, 750 blocks."""
    plan = modulate_norm_general_plan(5, 600, 1920, F32)
    assert (plan["tile_rows"], plan["tiles_per_group"], plan["blocks"]) == (4, 150, 750)


def gr_walk(R, S, D, m):
    """How often each (row, column chunk) of a row group is written as the f32
    instance's threads walk them: thread j of a group owns chunk j % (D / 4)
    from row j // (D / 4) on, in steps of m (the groups walk alike)."""
    d4 = D // 4
    seen = np.zeros((S, d4), np.int64)
    row0, c4 = np.divmod(np.arange(m * d4), d4)
    for t in range(-(-S // m)):
        rows = row0 + t * m
        ok = rows < S
        np.add.at(seen, (rows[ok], c4[ok]), 1)
    return seen


@pytest.mark.parametrize("R,S,D", [(1, 1, 8), (1, 226, 1920), (2, 226, 1920), (5, 600, 1920),
                                   (1, 601, 1920), (3, 37, 40), (1, 300, 1920), (64, 7, 4096),
                                   (300, 3, 4096)])
@pytest.mark.parametrize("resident", [132 * 1024, 132 * 2048, 4096])
def test_gr_plan_covers_every_row_once_in_one_wave(R, S, D, resident):
    plan = gated_residual_f32_plan(R, S, D, resident)
    m = plan["rows_a_step"]
    d4 = D // 4
    assert 1 <= m <= S and plan["threads"] == R * m * d4
    assert plan["blocks"] == -(-plan["threads"] // GENERAL_GR_THREADS)
    assert (gr_walk(R, S, D, m) == 1).all()
    if R * d4 < resident:
        assert plan["threads"] <= resident
        k = -(-S // m)  # rows a thread at most
        if k > 1:  # a thread walking one row fewer would not fit in one wave
            assert R * -(-S // (k - 1)) * d4 > resident
    else:
        assert m == 1


def test_gr_plan_at_the_training_and_text_shapes():
    """132 multiprocessors holding four blocks of 256 threads each: 11 rows a
    thread at [5,600,1920] (132,000 threads, 516 blocks, one wave); one row a
    thread at the text stream's [1,226,1920]."""
    resident = 132 * 4 * GENERAL_GR_THREADS
    assert gated_residual_f32_plan(5, 600, 1920, resident) == dict(
        rows_a_step=55, threads=132000, blocks=516)
    assert gated_residual_f32_plan(1, 226, 1920, resident) == dict(
        rows_a_step=226, threads=108480, blocks=424)
