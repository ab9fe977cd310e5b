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

Backward kernels, each output against its own scale: max error <= 0.1
RMS(ref) and RMS error <= 1e-2 RMS(ref) (bf16 rounding of an output alone
gives about 1e-3; the flash dk/dv kernel also rounds p to bf16 for dv).
The f32 row sums of the adaLN backward (A, B, dgate), which only the
summation order separates from the plain version: RMS error <= 1e-4
RMS(ref). The flash check must reject the dq/dk/dv of a run that ignores
dlse.
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


def _agree(got, want, max_rel: float = 0.1, rms_rel: float = 1e-2) -> bool:
    d, r = got.float() - want.float(), want.float()
    rms = r.pow(2).mean().sqrt()
    return bool(d.abs().max() <= max_rel * rms and d.pow(2).mean().sqrt() <= rms_rel * rms)


@pytest.mark.cuda
@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 64), (1, 2, 300), (2, 3, 1100), (1, 1, 1)])
def test_cuda_flash_attention_bwd_matches_plain(cuda, shape, with_dlse):
    """300 and 1100: S not a multiple of the 64-row tile, so both kernels
    meet padded queries and keys. Through autograd, the Function launches
    the forward, dq and dk/dv kernels once each."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(*shape, 64, device=cuda, generator=g).bfloat16()
                   for _ in range(4))
    out, lse = attention.flash_attention(q, k, v)
    dlse = torch.randn(*shape, device=cuda, generator=g) if with_dlse else None
    got = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    want = attention.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse=dlse)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert _agree(a, b), name
    if with_dlse and shape[2] > 1:
        bad = attention.flash_attention_bwd(q, k, v, out, lse, do)  # dlse ignored
        assert not all(_agree(a, b) for a, b in zip(bad[:2], want[:2]))

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (attention.flash_attention.launches, attention.flash_attention_bwd_dq.launches,
              attention.flash_attention_bwd_dkv.launches)
    o2, l2 = attention.flash_attention(*leaves)
    loss = (o2.float() * do.float()).sum() + ((l2 * dlse).sum() if with_dlse else 0.0)
    loss.backward()
    after = (attention.flash_attention.launches, attention.flash_attention_bwd_dq.launches,
             attention.flash_attention_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    for leaf, ref in zip(leaves, want):
        assert _agree(leaf.grad, ref)
    with pytest.raises(ValueError):
        attention.flash_attention_bwd(q, k, v, out, lse.bfloat16(), do)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,D", [(3, 300, 256), (5, 600, 1920), (1, 1, 128)])
def test_cuda_modulate_norm_bwd_matches_plain(cuda, R, S, D):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = (2 * torch.randn(R, S, D, device=cuda, generator=g) + 0.3).bfloat16()
    do = torch.randn(R, S, D, device=cuda, generator=g).bfloat16()
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    ns = 1 + 0.1 * torch.randn(D, device=cuda, generator=g)  # f32, as under f32 params
    nb = 0.1 * torch.randn(D, device=cuda, generator=g)
    before = adaln.modulate_norm_bwd.launches
    dx, a, b = adaln.modulate_norm_bwd(x, do, scale, ns)
    assert adaln.modulate_norm_bwd.launches == before + 1
    ref_dx, ref_a, ref_b = adaln.modulate_norm_bwd_plain(x, do, scale, ns)
    assert dx.dtype == torch.bfloat16 and a.shape == (R, D) and b.shape == (R, D)
    assert _agree(dx, ref_dx)
    assert _agree(a, ref_a, rms_rel=1e-4) and _agree(b, ref_b, rms_rel=1e-4)
    again = adaln.modulate_norm_bwd(x, do, scale, ns)
    assert torch.equal(again[1], a) and torch.equal(again[2], b)  # no atomics: same sums

    leaves = [t.clone().requires_grad_() for t in (x, scale, shift, ns, nb)]
    out = adaln.modulate_norm(*leaves)
    (out.float() * do.float()).sum().backward()
    cpu = [t.detach().cpu().requires_grad_() for t in (x, scale, shift, ns, nb)]
    (adaln.modulate_norm(*cpu).float() * do.cpu().float()).sum().backward()
    for leaf, c in zip(leaves, cpu):
        assert leaf.grad.dtype == leaf.dtype
        assert _agree(leaf.grad.cpu(), c.grad, rms_rel=2e-2)
    with pytest.raises(ValueError):
        adaln.modulate_norm_bwd(x, do.float(), scale, ns)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S,D", [(5, 600, 1920), (1, 226, 1920), (3, 37, 64)])
def test_cuda_gated_residual_bwd_matches_plain(cuda, R, S, D):
    g = torch.Generator(device=cuda).manual_seed(7)
    do, y = (torch.randn(R, S, D, device=cuda, generator=g).bfloat16() for _ in range(2))
    gate = torch.randn(R, 3 * D, device=cuda, generator=g).bfloat16()[:, 2 * D:]
    before = adaln.gated_residual_bwd.launches
    dy, dgate = adaln.gated_residual_bwd(do, y, gate)
    assert adaln.gated_residual_bwd.launches == before + 1
    ref_dy, ref_dgate = adaln.gated_residual_bwd_plain(do, y, gate)
    torch.testing.assert_close(dy, ref_dy, atol=0, rtol=0)  # one rounding of one product
    assert dgate.dtype == torch.float32 and _agree(dgate, ref_dgate, rms_rel=1e-4)
    assert torch.equal(adaln.gated_residual_bwd(do, y, gate)[1], dgate)

    x = torch.randn(R, S, D, device=cuda, generator=g).bfloat16()
    leaves = [t.clone().requires_grad_() for t in (x, y, gate)]
    (adaln.gated_residual(*leaves).float() * do.float()).sum().backward()
    assert torch.equal(leaves[0].grad, do)
    torch.testing.assert_close(leaves[1].grad, ref_dy, atol=0, rtol=0)
    assert _agree(leaves[2].grad, ref_dgate.bfloat16(), rms_rel=1e-2)
