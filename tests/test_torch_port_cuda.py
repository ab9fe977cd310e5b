"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor orv_tpu, so they run where the port runs; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py configures JAX). Tolerances: attention
out atol 1e-2 (bf16 outputs below 1), lse atol 1e-4; the int8-QK^T attention,
whose outputs shrink as keys grow, against its output's own scale: max error
<= 0.1 RMS(ref) and RMS error <= 1e-2 RMS(ref) (the bf16 rounding of the
output alone gives about 1.7e-3; a wrong k scale about 0.1); adaLN kernels one bf16
rounding (atol 1e-2, rtol 1e-2; 2e-2 for the normalized outputs). The
int8-emitting adaLN: |xq - plain| <= 1 and != 0 in at most 1e-3 of the
entries (the f32 value is summed in another order and may round the other
way at a midpoint), xscale to rtol 1e-6. The int8 product: exact.
"""

import pytest
import torch

from orv_tpu_torch.models.layers import int8_matmul
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


def _q8_attention_agrees(out, ref):
    d, r = out.float() - ref.float(), ref.float()
    rms = r.pow(2).mean().sqrt()
    return bool(d.abs().max() <= 0.1 * rms and d.pow(2).mean().sqrt() <= 1e-2 * rms)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2, 64), (2, 3, 300), (1, 2, 1100), (1, 1, 1)])
def test_cuda_flash_attention_q8_matches_plain(cuda, shape):
    """300: S not a multiple of the 64-key tile; 1100: keys in two 1024-key
    scale blocks, the second one ragged. There the check must also reject
    the kernel run with block 0's k scale for both blocks."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(*shape, 64, device=cuda, generator=g).bfloat16() for _ in range(3))
    k = k + 0.5  # a token mean for the smoothing to take out
    before = attention.flash_attention_q8.launches
    out = attention.flash_attention_q8(q, k, v)
    assert attention.flash_attention_q8.launches == before + 1
    ref = attention.flash_attention_q8_plain(q, k, v)
    assert _q8_attention_agrees(out, ref)
    k8, sk_r, block_k = attention.prepare_k_q8(k)
    if sk_r.shape[1] > 1:
        bad = attention.flash_attention_q8_kernel(
            q, (k8, sk_r[:, :1].expand_as(sk_r).contiguous(), block_k), v, shape[2], 0.125)
        assert not _q8_attention_agrees(bad, ref)
    with pytest.raises(ValueError):
        attention.flash_attention_q8(q.float(), k.float(), v.float())


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,D", [(3, 37, 256), (2, 600, 1920)])
def test_cuda_modulate_norm_q8_matches_plain(cuda, R, S, D):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (2 * torch.randn(R, S, D, device=cuda, generator=g)).bfloat16()
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    ns = (1 + 0.1 * torch.randn(D, device=cuda, generator=g)).bfloat16()
    nb = (0.1 * torch.randn(D, device=cuda, generator=g)).bfloat16()
    before = adaln.modulate_norm_q8.launches
    xq, xs = adaln.modulate_norm_q8(x, scale, shift, ns, nb)
    assert adaln.modulate_norm_q8.launches == before + 1
    ref_q, ref_s = adaln.modulate_norm_q8_plain(x, scale, shift, ns, nb)
    assert xq.dtype == torch.int8 and xs.dtype == torch.float32 and xs.shape == (R, S)
    diff = (xq.int() - ref_q.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(xs, ref_s, atol=0, rtol=1e-6)
    with pytest.raises(ValueError):
        adaln.modulate_norm_q8(x.float(), scale, shift, ns, nb)


@pytest.mark.cuda
def test_cuda_int8_matmul_exact_and_raises_on_small_shapes(cuda):
    g = torch.Generator().manual_seed(4)
    a = torch.randint(-127, 128, (40, 96), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (128, 96), generator=g, dtype=torch.int8)
    torch.testing.assert_close(int8_matmul(a.to(cuda), w.to(cuda)).cpu(), int8_matmul(a, w),
                               atol=0, rtol=0)
    with pytest.raises(ValueError):
        int8_matmul(a[:16].to(cuda), w.to(cuda))
