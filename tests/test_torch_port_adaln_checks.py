"""What the adaLN kernels' wrappers accept, held on the CPU.

The two forwards (`modulate_norm`, `modulate_norm_q8`) launch
orv_tpu_torch/ops/csrc/adaln_fwd_sm90.cuh's kernel and the backward
(`modulate_norm_bwd`) adaln_bwd_sm90.cuh's; each holds at most 2048 columns
of a row in registers, re-reads the rest from shared memory and takes any
D % 128 == 0 up to 4096, as the JAX kernels take any D. The gated-residual
backward (`gated_residual_bwd`) takes D % 8 == 0 up to 16384. The checks
run here on CPU tensors, called directly, with the library and the kernels
replaced by a function that fails the test: nothing is built or launched.
The kernels themselves are held against their plain versions on the card by
tests/test_torch_port_cuda.py; the backwards' launch plan (`bwd_plan`) by
tests/test_torch_port_adaln_bwd_plan.py.
"""

import pytest
import torch

from orv_tpu_torch.ops import _build, adaln

FORWARDS = ("modulate_norm", "modulate_norm_q8")


def _no_launch(monkeypatch):
    def no_launch(*args):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(_build, "kernel", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)


def _operands(D, R=2, S=9):
    """x [R, S, D] bf16; scale and shift row-strided bf16 chunks of [R, 3D],
    as the modulation linear leaves them; ns, nb f32 [D]."""
    g = torch.Generator().manual_seed(D)
    x = torch.randn(R, S, D, generator=g).bfloat16()
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, generator=g)).bfloat16().chunk(3, dim=-1)
    return x, scale, shift, 1 + 0.1 * torch.randn(D, generator=g), 0.1 * torch.randn(D, generator=g)


@pytest.mark.parametrize("name", FORWARDS)
@pytest.mark.parametrize("D", [128, 2048, 3072, 4096])
def test_adaln_forward_check_takes_rows_up_to_4096(D, name, monkeypatch):
    _no_launch(monkeypatch)
    adaln._check_modulate(name, *_operands(D))


@pytest.mark.parametrize("name", FORWARDS)
@pytest.mark.parametrize("D", [4224, 8192, 200, 64])
def test_adaln_forward_check_refuses_other_widths(D, name, monkeypatch):
    _no_launch(monkeypatch)
    with pytest.raises(ValueError, match=f"{name} kernel takes D % 128 == 0 and D <= 4096"):
        adaln._check_modulate(name, *_operands(D))


@pytest.mark.parametrize("D", [4224, 8192, 200])
def test_adaln_backward_check_refuses_rows_past_4096(D, monkeypatch):
    _no_launch(monkeypatch)
    x, scale, _, ns, _ = _operands(D)
    with pytest.raises(ValueError, match="modulate_norm_bwd kernel takes D % 128 == 0 and "
                                         "D <= 4096"):
        adaln._check_modulate_bwd(x, x.clone(), scale, ns)


@pytest.mark.parametrize("D", [1920, 2048, 2176, 3072, 4096])
def test_adaln_backward_check_takes_rows_up_to_4096(D, monkeypatch):
    _no_launch(monkeypatch)
    x, scale, _, ns, _ = _operands(D)
    adaln._check_modulate_bwd(x, x.clone(), scale, ns)


def test_adaln_backward_check_refuses_a_dout_unlike_x(monkeypatch):
    """dout is copied in by 1-D bulk copies: the check wants it of x's shape
    and dtype, contiguous and 16-byte aligned."""
    _no_launch(monkeypatch)
    x, scale, _, ns, _ = _operands(256)
    unaligned = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape).copy_(x)
    for dout in (x.float(), x[:, :-1].clone(), x.transpose(0, 1).contiguous().transpose(0, 1),
                 unaligned):
        with pytest.raises(ValueError, match="modulate_norm_bwd takes a contiguous"):
            adaln._check_modulate_bwd(x, dout, scale, ns)


def _gated_operands(D, R=2, S=9):
    """dout, y [R, S, D] bf16 and a gate as the modulation linear leaves it,
    a row-strided bf16 chunk of [R, 3D]."""
    g = torch.Generator().manual_seed(D)
    do, y = (torch.randn(R, S, D, generator=g).bfloat16() for _ in range(2))
    return do, y, torch.randn(R, 3 * D, generator=g).bfloat16()[:, 2 * D:]


@pytest.mark.parametrize("D", [8, 64, 1920, 3072, 4104, 16384])
def test_gated_residual_backward_check_takes_rows_up_to_16384(D, monkeypatch):
    _no_launch(monkeypatch)
    adaln._check_gated_bwd(*_gated_operands(D))


@pytest.mark.parametrize("shape", [(2, 9, 16392), (2, 9, 32768), (2, 0, 64), (0, 9, 64)])
def test_gated_residual_backward_check_refuses_rows_past_16384(shape, monkeypatch):
    """The ring holds at least one row of two operands up to 16384 columns;
    an empty [R, S] is refused too (the kernel tiles rows)."""
    _no_launch(monkeypatch)
    R, S, D = shape
    do, y, gate = _gated_operands(D, R=max(R, 1), S=max(S, 1))
    do, y, gate = do[:R, :S].contiguous(), y[:R, :S].contiguous(), gate[:R]
    with pytest.raises(ValueError, match="gated_residual_bwd kernel takes R, S >= 1 and "
                                         "D <= 16384"):
        adaln._check_gated_bwd(do, y, gate)


def test_adaln_cpu_tensors_run_the_plain_versions_at_3072(monkeypatch):
    """On CPU tensors the wrappers run the plain versions, at any width, and
    launch nothing: the forwards, and the backward through autograd."""
    _no_launch(monkeypatch)
    x, scale, shift, ns, nb = _operands(3072)
    counts = (adaln.modulate_norm.launches, adaln.modulate_norm_q8.launches,
              adaln.modulate_norm_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (x, scale, shift, ns, nb)]
    out = adaln.modulate_norm(*leaves)
    torch.testing.assert_close(out, adaln.modulate_norm_plain(x, scale, shift, ns, nb), atol=0,
                               rtol=0)
    out.float().sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape for t in leaves)
    xq, xs = adaln.modulate_norm_q8(x, scale, shift, ns, nb)
    assert xq.shape == x.shape and xq.dtype == torch.int8 and xs.shape == x.shape[:2]
    assert counts == (adaln.modulate_norm.launches, adaln.modulate_norm_q8.launches,
                      adaln.modulate_norm_bwd.launches)
