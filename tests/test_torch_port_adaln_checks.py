"""What the adaLN kernels' wrappers accept, held on the CPU.

The two forwards (`modulate_norm`, `modulate_norm_q8`) launch
orv_tpu_torch/ops/csrc/adaln_fwd_sm90.cuh's kernel, which re-reads each row
from shared memory and takes any D % 128 == 0 up to 4096, as the JAX
kernels take any D. The backward (`modulate_norm_bwd`) holds a row in a
warp's registers and takes D up to 2048. The checks run here on CPU
tensors, called directly, with the library and the kernels replaced by a
function that fails the test: nothing is built or launched. The kernels
themselves are held against their plain versions on the card by
tests/test_torch_port_cuda.py.
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


@pytest.mark.parametrize("D", [3072, 4096, 2176])
def test_adaln_backward_check_refuses_rows_past_2048(D, monkeypatch):
    _no_launch(monkeypatch)
    x, scale, _, ns, _ = _operands(D)
    with pytest.raises(ValueError, match="modulate_norm_bwd kernel takes D % 128 == 0 and "
                                         "D <= 2048"):
        adaln._check_modulate_bwd(x, x, scale, ns)


@pytest.mark.parametrize("D", [1920, 2048])
def test_adaln_backward_check_takes_rows_up_to_2048(D, monkeypatch):
    _no_launch(monkeypatch)
    x, scale, _, ns, _ = _operands(D)
    adaln._check_modulate_bwd(x, x, scale, ns)


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
