"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor orv_tpu, so they run where the port runs; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py configures JAX). Tolerances: attention
out atol 1e-2 (bf16 outputs below 1), lse atol 1e-4; adaLN kernels one bf16
rounding (atol 1e-2, rtol 1e-2; 2e-2 for the normalized outputs).
"""

import pytest
import torch

from orv_tpu_torch.ops import adaln, attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 64), (2, 3, 300), (1, 1, 1)])
def test_cuda_flash_attention_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(*shape, 64, device=cuda, generator=g).bfloat16() for _ in range(3))
    before = attention.flash_attention.launches
    out, lse = attention.flash_attention(q, k, v)
    assert attention.flash_attention.launches == before + 1
    ref, ref_lse = attention.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        attention.flash_attention(q.float(), k.float(), v.float())


@pytest.mark.cuda
def test_cuda_adaln_kernels_match_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    R, S, D = 3, 37, 256
    x = torch.randn(R, S, D, device=cuda, generator=g).bfloat16()
    y = torch.randn(R, S, D, device=cuda, generator=g).bfloat16()
    shift, scale, gate = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).bfloat16(
    ).chunk(3, dim=-1)  # row-strided views, as the modulation linear gives them
    ns = 1 + 0.1 * torch.randn(D, device=cuda, generator=g)
    nb = 0.1 * torch.randn(D, device=cuda, generator=g)
    out = adaln.modulate_norm(x, scale, shift, ns, nb)
    ref = adaln.modulate_norm_plain(x, scale, shift, ns, nb)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=1e-2)
    out = adaln.gated_residual(x, y, gate)
    torch.testing.assert_close(out.float(), adaln.gated_residual_plain(x, y, gate).float(),
                               atol=1e-2, rtol=1e-2)
    with pytest.raises(ValueError):
        adaln.modulate_norm(x[:, :, :100].contiguous(), scale[:, :100], shift[:, :100],
                            ns[:100], nb[:100])
