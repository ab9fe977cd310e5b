"""What the flash backward's dk/dv wrapper refuses, held on the CPU.

`flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale)` launches
`orv_tpu_torch/ops/csrc/flash_attn_bwd.cu`'s dk/dv kernel, which reads
delta = rowsum(o * dO) - dlse as the dq kernel wrote it: f32 [B, H, Sq],
contiguous, on q's device. The kernel cannot check what it is given, so
the wrapper refuses any other delta, and tensors that are not on a CUDA
device, before the library is built or a kernel launched. The kernels
themselves are held against the plain backward on the card by
tests/test_torch_port_cuda.py.
"""

import pytest
import torch

from orv_tpu_torch.ops import _build, attention

B, H, SQ, SKV = 1, 2, 300, 226


def _operands():
    g = torch.Generator().manual_seed(0)
    q, dout = (torch.randn(B, H, SQ, 64, generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, H, SKV, 64, generator=g).bfloat16() for _ in range(2))
    return q, k, v, dout, torch.randn(B, H, SQ, generator=g)


def _no_launch(monkeypatch):
    def no_launch(*args):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(_build, "kernel", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)


_BAD_DELTA = {
    "shape": lambda: torch.zeros(B, H, SKV),  # Skv rows: the keys' count, not the queries'
    "dtype": lambda: torch.zeros(B, H, SQ, dtype=torch.bfloat16),
    "device": lambda: torch.zeros(B, H, SQ, device="meta"),
    "strided": lambda: torch.zeros(B, H, 2 * SQ)[..., ::2],
    "missing": lambda: None,
}


@pytest.mark.parametrize("what", sorted(_BAD_DELTA))
def test_flash_attention_bwd_dkv_refuses_a_foreign_delta(what, monkeypatch):
    _no_launch(monkeypatch)
    q, k, v, dout, lse = _operands()
    before = attention.flash_attention_bwd_dkv.launches
    with pytest.raises(ValueError, match="delta"):
        attention.flash_attention_bwd_dkv(q, k, v, dout, lse, _BAD_DELTA[what](), 0.125)
    assert attention.flash_attention_bwd_dkv.launches == before


def test_flash_attention_bwd_dkv_refuses_cpu_tensors(monkeypatch):
    """A right delta on the CPU still raises: the CPU path is
    `flash_attention_bwd`, which runs the plain backward and launches
    nothing."""
    _no_launch(monkeypatch)
    q, k, v, dout, lse = _operands()
    delta = torch.zeros(B, H, SQ)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, 0.125)
    counts = (attention.flash_attention_bwd_dq.launches, attention.flash_attention_bwd_dkv.launches)
    out, lse = attention.flash_attention_plain(q, k, v, 0.125)
    dq, dk, dv = attention.flash_attention_bwd(q, k, v, out, lse, dout, 0.125)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert (attention.flash_attention_bwd_dq.launches,
            attention.flash_attention_bwd_dkv.launches) == counts
