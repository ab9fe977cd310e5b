"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor orv_tpu, so they run where the port runs; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py configures JAX). Tolerances: attention
out atol 1e-2 (bf16 outputs below 1), lse atol 1e-4 (static max; 1e-3 for
the online kernel, whose running max and the plain version's row max
round p differently; with heads whose k and v are 10^h apart, out in units
of each head's v scale), the joint ring against resident attention atol 2e-2
(two more bf16 roundings of the merged partials); the int8-QK^T attention,
whose outputs shrink as keys grow, against its output's own scale: max error
<= 0.1 RMS(ref) and RMS error <= 1e-2 RMS(ref) (the bf16 rounding of the
output alone gives about 1.7e-3; a wrong k scale about 0.1; heads 10^h
apart in units of each head's v scale); adaLN kernels one bf16
rounding (atol 1e-2, rtol 1e-2; 2e-2 for the normalized outputs). The
int8-emitting adaLN: |xq - plain| <= 1 and != 0 in at most 1e-3 of the
entries (the f32 value is summed in another order and may round the other
way at a midpoint), xscale to rtol 1e-6; both adaLN forwards give the
same bits on a second run. The int8 product: exact.

Backward kernels, each output against its own scale: max error <= 0.1
RMS(ref) and RMS error <= 1e-2 RMS(ref) (bf16 rounding of an output alone
gives about 1e-3; the flash dk/dv kernel also rounds p to bf16 for dv;
with heads whose k, v and dO are 10^h apart, head by head). The f32 row
sums of the adaLN backward (A, B, dgate), which only the summation order
separates from the plain version: RMS error <= 1e-4 RMS(ref). The flash
check must reject the dq/dk/dv of a run that ignores dlse, and two
runs of the flash backward, and of each adaLN backward, must give the same
bits.

The last two tests run `chip_smoke.tiny_train_check` (a tiny train step
with depth and label latents, card against CPU) and
`chip_smoke.tiny_resume_check` (the training entry point's resume round
trip, bitwise) on the card.
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
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
    assert attention.flash_attention.launches == before + 1
    ref, ref_lse = attention.flash_attention_plain(q, k, v, static_max=24.0)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    # f32 goes to the general kernel before any launch; a head dim that no
    # kernel takes raises
    general = attention.flash_attention_general_kernel.launches
    attention.flash_attention(q.float(), k.float(), v.float(), static_max=24.0)
    assert attention.flash_attention.launches == before + 1
    assert attention.flash_attention_general_kernel.launches == general + 1
    with pytest.raises(ValueError, match="head dim 64 .* multiple of 8 up to 128"):
        attention.flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                                  v[..., :12].contiguous(), static_max=24.0)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,logit_scale", [(64, 64, 1.0), (300, 300, 1.0), (1, 1, 1.0),
                                                (226, 1950, 1.0), (1950, 226, 1.0),
                                                (300, 1100, 6.0)])
def test_cuda_flash_attention_online_matches_plain(cuda, sq, skv, logit_scale):
    """The online-softmax kernel (the default, static_max=None): ragged S,
    the ring's Sq != Skv shapes, and q, k scaled until logits pass 150, where
    the static-max kernel overflows. Through autograd, the online forward's
    out and lse feed the dq and dk/dv kernels, held against the plain
    backward on those same out and lse."""
    g = torch.Generator(device=cuda).manual_seed(8)
    rand = lambda s: torch.randn(1, 2, s, 64, device=cuda, generator=g)
    q, k = ((logit_scale * rand(n)).bfloat16() for n in (sq, skv))
    v = rand(skv).bfloat16()
    before = (attention.flash_attention_online_kernel.launches, attention.flash_attention.launches)
    out, lse = attention.flash_attention(q, k, v)
    assert (attention.flash_attention_online_kernel.launches,
            attention.flash_attention.launches) == (before[0] + 1, before[1])
    ref, ref_lse = attention.flash_attention_plain(q, k, v)
    assert out.shape == q.shape and lse.shape == (1, 2, sq)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-6)
    static, static_lse = attention.flash_attention(q, k, v, static_max=24.0)
    if logit_scale > 1.0:
        assert ref_lse.max() > 150
        assert not (torch.isfinite(static.float()).all()
                    and torch.allclose(static.float(), ref.float(), atol=1e-2))
    else:  # bounded logits: the two kernels agree
        torch.testing.assert_close(static_lse, lse, atol=1e-3, rtol=0)
        torch.testing.assert_close(static.float(), out.float(), atol=1e-2, rtol=0)
    do = torch.randn(q.shape, device=cuda, generator=g).bfloat16()
    dlse = torch.randn(lse.shape, device=cuda, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o2, l2 = attention.flash_attention(*leaves)
    ((o2.float() * do.float()).sum() + (l2 * dlse).sum()).backward()
    want = attention.flash_attention_bwd_plain(q, k, v, o2.detach(), l2.detach(), do, dlse=dlse)
    for leaf, w in zip(leaves, want):
        assert _agree(leaf.grad, w)


_TILE_EDGES = (1, 63, 64, 65, 127, 128, 129, 255, 257)  # around the 64-row and 128-row tiles


def _check_forwards(q, k, v, v_scale=1.0):
    """Both bf16 forwards (static max 24, online) against their plain
    versions, one launch each: out / v_scale to atol 1e-2 (the output's
    errors scale with v), lse to 1e-4 (static max) and 1e-3 + 1e-6|lse|
    (online)."""
    for static_max, counter, lse_tol in ((24.0, attention.flash_attention, (1e-4, 0.0)),
                                         (None, attention.flash_attention_online_kernel,
                                          (1e-3, 1e-6))):
        before = counter.launches
        out, lse = attention.flash_attention(q, k, v, static_max=static_max)
        assert counter.launches == before + 1
        ref, ref_lse = attention.flash_attention_plain(q, k, v, static_max=static_max)
        assert out.shape == q.shape and lse.shape == q.shape[:3]
        torch.testing.assert_close(out.float() / v_scale, ref.float() / v_scale, atol=1e-2,
                                   rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=lse_tol[0], rtol=lse_tol[1])


@pytest.mark.cuda
@pytest.mark.parametrize("skv", _TILE_EDGES)
@pytest.mark.parametrize("sq", _TILE_EDGES)
def test_cuda_flash_forwards_at_tile_edges(cuda, sq, skv):
    """Both bf16 forwards at every pair of lengths one short of, at and one
    past the kernels' tiles (64 query rows a warpgroup, 128 a block, 128
    keys a tile), Sq == Skv and Sq != Skv."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn(1, 2, sq, 64, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(1, 2, skv, 64, device=cuda, generator=g).bfloat16() for _ in range(2))
    _check_forwards(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,sq,skv", [(1, 3, 129, 65), (3, 1, 65, 200), (1, 4, 257, 255)])
def test_cuda_flash_forwards_keep_heads_apart(cuda, B, H, sq, skv):
    """Head h's k and v are scaled by 10^h and its q by 10^-h, so every
    head's logits keep one distribution while its keys and values differ
    from the next head's tenfold. A ragged tile that read the next head's
    rows as keys, a missing key mask, or a store past Sq into the next
    head's rows puts one head's values into another's output. Each head's
    output is compared in units of its v's scale."""
    g = torch.Generator(device=cuda).manual_seed(11)
    tens = 10.0 ** torch.arange(B * H, device=cuda, dtype=torch.float32).reshape(B, H, 1, 1)
    rand = lambda s: torch.randn(B, H, s, 64, device=cuda, generator=g)
    q = (rand(sq) / tens).bfloat16()
    k, v = ((rand(skv) * tens).bfloat16() for _ in range(2))
    _check_forwards(q, k, v, v_scale=tens)


@pytest.mark.cuda
def test_cuda_joint_ring_attention_local_ring(cuda):
    """The joint ring over `LocalRing(2)` on the card (both ranks on one
    device): 5 online launches a rank, none of the static-max kernel, the
    same bits on both ranks, and the resident online attention's result."""
    from orv_tpu_torch.ops.ring_attention import joint_ring_attention
    from orv_tpu_torch.parallel.sp import LocalRing

    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(1, 3, 12 + 256, 64, device=cuda, generator=g).bfloat16()
               for _ in range(3))
    comm = LocalRing(2, timeout=120.0)
    before = (attention.flash_attention_online_kernel.launches, attention.flash_attention.launches)
    outs = comm.run(lambda: joint_ring_attention(q, k, v, 12, comm))
    torch.cuda.synchronize()
    assert (attention.flash_attention_online_kernel.launches - before[0],
            attention.flash_attention.launches - before[1]) == (2 * 5, 0)
    assert torch.equal(outs[0], outs[1])
    ref, _ = attention.flash_attention_plain(q, k, v)
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=2e-2, rtol=0)


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


# S around the adaLN forwards' 4-row tiles (csrc/adaln_fwd_sm90.cuh), past two
# tiles, and the text stream's and the video stream's S
_ADALN_S = (1, 3, 4, 5, 9, 226, 600)


def _adaln_args(cuda, g, R, S, D, norm_f32):
    """x [R, S, D] bf16 with a mean to take out; scale and shift as the
    modulation linear leaves them, row-strided bf16 chunks of [R, 3D]; ns
    and nb bf16, or f32 as under f32 parameters."""
    x = (2 * torch.randn(R, S, D, device=cuda, generator=g) + 0.3).bfloat16()
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    ns = 1 + 0.1 * torch.randn(D, device=cuda, generator=g)
    nb = 0.1 * torch.randn(D, device=cuda, generator=g)
    return (x, scale, shift) + ((ns, nb) if norm_f32 else (ns.bfloat16(), nb.bfloat16()))


def _check_adaln_forwards(args):
    """Both adaLN forwards against their plain versions, one launch each;
    a second run of each gives the same bits."""
    R, S, D = args[0].shape
    before = (adaln.modulate_norm.launches, adaln.modulate_norm_q8.launches)
    out = adaln.modulate_norm(*args)
    xq, xs = adaln.modulate_norm_q8(*args)
    assert (adaln.modulate_norm.launches, adaln.modulate_norm_q8.launches) == (
        before[0] + 1, before[1] + 1)
    ref = adaln.modulate_norm_plain(*args)
    assert out.shape == (R, S, D) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=1e-2)
    ref_q, ref_s = adaln.modulate_norm_q8_plain(*args)
    assert xq.shape == (R, S, D) and xq.dtype == torch.int8 and xs.shape == (R, S)
    diff = (xq.int() - ref_q.int()).abs()
    assert diff.max().item() <= 1 and (diff != 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(xs, ref_s, atol=0, rtol=1e-6)
    assert torch.equal(adaln.modulate_norm(*args), out)
    again_q, again_s = adaln.modulate_norm_q8(*args)
    assert torch.equal(again_q, xq) and torch.equal(again_s, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("S", _ADALN_S)
@pytest.mark.parametrize("D", [128, 1920, 2048, 2176, 3072, 4096])
def test_cuda_adaln_forwards_at_tile_edges(cuda, D, S):
    """Both forwards at every S one short of, at and one past the 4-row
    tile, at the model's two S, and at the widths from one 128-column chunk
    to 4096, over 5 row groups: below 2048 each width is its own kernel
    instance; from 2048 on one instance holds 16 chunks and re-reads the
    rest (none at 2048, one at 2176). bf16 norm params at D <= 1920, f32
    above."""
    g = torch.Generator(device=cuda).manual_seed(20 + S)
    _check_adaln_forwards(_adaln_args(cuda, g, 5, S, D, norm_f32=D > 1920))


@pytest.mark.cuda
@pytest.mark.parametrize("norm_f32", [False, True])
@pytest.mark.parametrize("R", [1, 5, 13])
def test_cuda_adaln_forwards_across_row_groups(cuda, R, norm_f32):
    """At S = 600 a row group is 150 tiles and a block walks a contiguous
    range of them, so at R = 13 (1950 tiles, 7 or 8 a block with 2 blocks on
    each of 132 SMs) most blocks cross from one row group into the next and
    reload its scale and shift mid-range. The groups' scale and
    shift differ by 0.3 standard deviations, far past the tolerance, so a
    row modulated by a neighbouring group's coefficients fails."""
    g = torch.Generator(device=cuda).manual_seed(30 + R)
    _check_adaln_forwards(_adaln_args(cuda, g, R, 600, 1920, norm_f32))


@pytest.mark.cuda
def test_cuda_adaln_width_limits(cuda):
    """The Hopper forwards and backward take D up to 4096 in multiples of
    128, the gated-residual backward D up to 16384 in multiples of 8; past
    those the bf16 adaLN forward and both backwards go to the general
    kernels (any D % 8 == 0), chosen before any launch; the int8-emitting
    forward has no general kernel and raises."""
    g = torch.Generator(device=cuda).manual_seed(40)
    for D in (4224, 200):
        args = _adaln_args(cuda, g, 2, 9, D, norm_f32=False)
        before = (adaln.modulate_norm.launches, adaln.modulate_norm_general.launches,
                  adaln.modulate_norm_bwd.launches, adaln.modulate_norm_bwd_general.launches)
        torch.testing.assert_close(adaln.modulate_norm(*args).float(),
                                   adaln.modulate_norm_plain(*args).float(), atol=2e-2, rtol=1e-2)
        with pytest.raises(ValueError, match="D % 128 == 0 and D <= 4096"):
            adaln.modulate_norm_q8(*args)
        got = adaln.modulate_norm_bwd(args[0], args[0].clone(), args[1], args[3])
        want = adaln.modulate_norm_bwd_plain(args[0], args[0].clone(), args[1], args[3])
        assert _agree(got[0], want[0]) and _agree(got[1], want[1], rms_rel=1e-4)
        assert (adaln.modulate_norm.launches, adaln.modulate_norm_general.launches,
                adaln.modulate_norm_bwd.launches, adaln.modulate_norm_bwd_general.launches) == (
            before[0], before[1] + 1, before[2], before[3] + 1)
    _check_gated_residual_bwd(*_gated_bwd_args(cuda, g, 2, 5, 16384))
    before = (adaln.gated_residual_bwd.launches, adaln.gated_residual_bwd_general.launches)
    do, y, gate = _gated_bwd_args(cuda, g, 2, 5, 16392)
    dy, dgate = adaln.gated_residual_bwd(do, y, gate)
    ref_dy, ref_dgate = adaln.gated_residual_bwd_plain(do, y, gate)
    torch.testing.assert_close(dy, ref_dy, atol=0, rtol=0)
    assert _agree(dgate, ref_dgate, rms_rel=1e-4)
    assert (adaln.gated_residual_bwd.launches, adaln.gated_residual_bwd_general.launches) == (
        before[0], before[1] + 1)
    with pytest.raises(ValueError, match="D % 8 == 0 and D <= 16384 .* general kernel"):
        adaln.gated_residual_bwd(do[..., :-4].contiguous(), y[..., :-4].contiguous(),
                                 gate[:, :-4])


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


def _check_q8(q, k, v, v_scale=1.0):
    """The int8-QK^T kernel against its plain version, one launch, out and
    ref in units of v_scale (`_q8_attention_agrees`). Returns ref."""
    before = attention.flash_attention_q8.launches
    out = attention.flash_attention_q8(q, k, v)
    assert attention.flash_attention_q8.launches == before + 1
    ref = attention.flash_attention_q8_plain(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert _q8_attention_agrees(out.float() / v_scale, ref.float() / v_scale)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("skv", _TILE_EDGES)
@pytest.mark.parametrize("sq", _TILE_EDGES)
def test_cuda_flash_attention_q8_at_tile_edges(cuda, sq, skv):
    """The int8 kernel at every pair of lengths one short of, at and one past
    its tiles (64 query rows a warpgroup, 128 a block, 128 keys a tile)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(1, 2, sq, 64, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(1, 2, skv, 64, device=cuda, generator=g) for _ in range(2))
    _check_q8(q, (k + 0.5).bfloat16(), v.bfloat16())  # a token mean for the smoothing


@pytest.mark.cuda
@pytest.mark.parametrize("skv", [1023, 1024, 1025, 2049])
def test_cuda_flash_attention_q8_across_scale_blocks(cuda, skv):
    """Keys at and across the 1024-key scale-block edges. The keys past the
    first block are 4x larger, so their blocks' k scales differ from block
    0's and some queries attend mostly to them: the check must reject the
    kernel run with block 0's k scale for every block. With one block (1023
    and 1024 keys) that run is no fault, and the planted one is a halved k
    scale."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn(1, 2, 300, 64, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(1, 2, skv, 64, device=cuda, generator=g) for _ in range(2))
    k = k + 0.5
    k[:, :, 1024:] *= 4
    k, v = k.bfloat16(), v.bfloat16()
    ref = _check_q8(q, k, v)
    k8, sk_r, block_k = attention.prepare_k_q8(k)
    assert sk_r.shape[1] == -(-skv // 1024)
    bad_sk = sk_r[:, :1].expand_as(sk_r).contiguous() if sk_r.shape[1] > 1 else sk_r / 2
    bad = attention.flash_attention_q8_kernel(q, (k8, bad_sk, block_k), v, skv, 0.125)
    assert not _q8_attention_agrees(bad, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,sq,skv", [(1, 3, 129, 65), (3, 1, 65, 200), (1, 4, 257, 255)])
def test_cuda_flash_attention_q8_keeps_heads_apart(cuda, B, H, sq, skv):
    """As `test_cuda_flash_forwards_keep_heads_apart`, for the int8 kernel:
    head h's k and v are scaled by 10^h and its q by 10^-h (the per-token and
    per-block quantization scales cancel them), so a ragged tile or a store
    that crosses into the next head's rows shows tenfold in that head's
    output, compared in units of its v scale."""
    g = torch.Generator(device=cuda).manual_seed(14)
    tens = 10.0 ** torch.arange(B * H, device=cuda, dtype=torch.float32).reshape(B, H, 1, 1)
    rand = lambda s: torch.randn(B, H, s, 64, device=cuda, generator=g)
    q = (rand(sq) / tens).bfloat16()
    k = ((rand(skv) + 0.5) * tens).bfloat16()
    v = (rand(skv) * tens).bfloat16()
    _check_q8(q, k, v, v_scale=tens)


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
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
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
    o2, l2 = attention.flash_attention(*leaves, static_max=24.0)
    loss = (o2.float() * do.float()).sum() + ((l2 * dlse).sum() if with_dlse else 0.0)
    loss.backward()
    after = (attention.flash_attention.launches, attention.flash_attention_bwd_dq.launches,
             attention.flash_attention_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    for leaf, ref in zip(leaves, want):
        assert _agree(leaf.grad, ref)
    with pytest.raises(ValueError):
        attention.flash_attention_bwd(q, k, v, out, lse.bfloat16(), do)


def _check_bwd(q, k, v, do, dlse, per_head=False):
    """The backward kernels (one dq and one dk/dv launch) against the plain
    backward on the static-max forward's out and lse, with dlse: each output
    agrees (`_agree`), as a whole or head by head, each head in its own
    units."""
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
    before = (attention.flash_attention_bwd_dq.launches, attention.flash_attention_bwd_dkv.launches)
    got = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    assert (attention.flash_attention_bwd_dq.launches,
            attention.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = attention.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse=dlse)
    B, H = q.shape[:2]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        for h in [(i, j) for i in range(B) for j in range(H)] if per_head else [()]:
            assert _agree(a[h], b[h]), (name, h)


@pytest.mark.cuda
@pytest.mark.parametrize("skv", _TILE_EDGES)
@pytest.mark.parametrize("sq", _TILE_EDGES)
def test_cuda_flash_attention_bwd_at_tile_edges(cuda, sq, skv):
    """dq, dk and dv, with dlse, at every pair of lengths one short of, at
    and one past the kernels' tiles (64 rows a consumer warpgroup, 128 a
    block, 64-row streamed tiles), Sq == Skv and Sq != Skv: the dq kernel
    masks keys past Skv, the dk/dv kernel queries past Sq."""
    g = torch.Generator(device=cuda).manual_seed(15)
    q, do = (torch.randn(1, 2, sq, 64, device=cuda, generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(1, 2, skv, 64, device=cuda, generator=g).bfloat16() for _ in range(2))
    _check_bwd(q, k, v, do, torch.randn(1, 2, sq, device=cuda, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,sq,skv", [(1, 3, 129, 65), (3, 1, 65, 200), (1, 4, 257, 255)])
def test_cuda_flash_attention_bwd_keeps_heads_apart(cuda, B, H, sq, skv):
    """As `test_cuda_flash_forwards_keep_heads_apart`, for the backward: head
    h's k and v are scaled by 10^h, its q by 10^-h, its dO and dlse by 10^h,
    so its p is unchanged while dq grows 100^h and dk, dv stay of order 1. A
    ragged tile that read the next head's rows, a store past S into them, or
    delta, lse or dlse taken from another head's rows shows in that head's
    gradients, each compared in its own units."""
    g = torch.Generator(device=cuda).manual_seed(16)
    tens = 10.0 ** torch.arange(B * H, device=cuda, dtype=torch.float32).reshape(B, H, 1, 1)
    rand = lambda s: torch.randn(B, H, s, 64, device=cuda, generator=g)
    q = (rand(sq) / tens).bfloat16()
    k, v = ((rand(skv) * tens).bfloat16() for _ in range(2))
    do = (rand(sq) * tens).bfloat16()
    dlse = torch.randn(B, H, sq, device=cuda, generator=g) * tens[..., 0]
    _check_bwd(q, k, v, do, dlse, per_head=True)


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_is_deterministic(cuda):
    """No atomics: two calls on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v, do = (torch.randn(2, 3, 1100, 64, device=cuda, generator=g).bfloat16()
                   for _ in range(4))
    dlse = torch.randn(2, 3, 1100, device=cuda, generator=g)
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
    first = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    second = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


# S for the backward kernels at R = 5 (csrc/adaln_bwd_sm90.cuh): 1 and 3 (a
# row a tile: 5 S rows do not fill the card), the text stream's 226 (9-row
# tiles for modulate_norm_bwd, 8 for gated_residual_bwd, the last of a group
# ragged), and around the video stream's 600 (12- and 8-row tiles, the last
# 11 or 7, 12 or 8, 1 and 5 rows long)
_BWD_S = (1, 3, 226, 599, 600, 601, 605)


def _mn_bwd_args(cuda, g, R, S, D):
    """x with a mean to take out, dout, scale as the modulation linear leaves
    it (a row-strided bf16 chunk of [R, 3D]) and f32 ns, as under f32
    parameters."""
    x = (2 * torch.randn(R, S, D, device=cuda, generator=g) + 0.3).bfloat16()
    do = torch.randn(R, S, D, device=cuda, generator=g).bfloat16()
    _, scale, _ = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).bfloat16().chunk(3, -1)
    return x, do, scale, 1 + 0.1 * torch.randn(D, device=cuda, generator=g)


def _check_modulate_norm_bwd(x, do, scale, ns):
    """One launch against the plain version (dx by `_agree`, A and B to 1e-4
    RMS); a second run gives the same bits."""
    R, S, D = x.shape
    before = adaln.modulate_norm_bwd.launches
    got = adaln.modulate_norm_bwd(x, do, scale, ns)
    assert adaln.modulate_norm_bwd.launches == before + 1
    want = adaln.modulate_norm_bwd_plain(x, do, scale, ns)
    assert got[0].dtype == torch.bfloat16 and got[1].shape == got[2].shape == (R, D)
    assert _agree(got[0], want[0])
    assert _agree(got[1], want[1], rms_rel=1e-4) and _agree(got[2], want[2], rms_rel=1e-4)
    again = adaln.modulate_norm_bwd(x, do, scale, ns)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _gated_bwd_args(cuda, g, R, S, D):
    do, y = (torch.randn(R, S, D, device=cuda, generator=g).bfloat16() for _ in range(2))
    return do, y, torch.randn(R, 3 * D, device=cuda, generator=g).bfloat16()[:, 2 * D:]


def _check_gated_residual_bwd(do, y, gate):
    """One launch against the plain version (dy exactly, dgate to 1e-4 RMS);
    a second run gives the same bits."""
    before = adaln.gated_residual_bwd.launches
    dy, dgate = adaln.gated_residual_bwd(do, y, gate)
    assert adaln.gated_residual_bwd.launches == before + 1
    ref_dy, ref_dgate = adaln.gated_residual_bwd_plain(do, y, gate)
    torch.testing.assert_close(dy, ref_dy, atol=0, rtol=0)
    assert dgate.dtype == torch.float32 and _agree(dgate, ref_dgate, rms_rel=1e-4)
    again = adaln.gated_residual_bwd(do, y, gate)
    assert torch.equal(again[0], dy) and torch.equal(again[1], dgate)


@pytest.mark.cuda
@pytest.mark.parametrize("S", _BWD_S)
@pytest.mark.parametrize("D", [128, 1920, 2048, 2176, 3072, 4096])
def test_cuda_modulate_norm_bwd_at_tile_edges(cuda, D, S):
    """`_BWD_S` over 5 row groups; D from one 128-column chunk to 4096: below
    2048 each width is its own kernel instance, from 2048 on one instance
    holds 12 chunks and re-reads the rest (4 at 2048, 5 at 2176); at 3072
    and 4096 shared memory holds tiles of 7 and 5 rows."""
    g = torch.Generator(device=cuda).manual_seed(50 + S)
    _check_modulate_norm_bwd(*_mn_bwd_args(cuda, g, 5, S, D))


@pytest.mark.cuda
@pytest.mark.parametrize("S", _BWD_S)
@pytest.mark.parametrize("D", [64, 128, 1920, 2048, 2176, 3072, 4096])
def test_cuda_gated_residual_bwd_at_tile_edges(cuda, D, S):
    """As the adaLN backward's, and at D = 64: a thread owns one 8-column
    vector of each 2048 (D <= 2048), or two (2176 to 4096)."""
    g = torch.Generator(device=cuda).manual_seed(60 + S)
    _check_gated_residual_bwd(*_gated_bwd_args(cuda, g, 5, S, D))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 5, 13])
def test_cuda_adaln_backwards_across_row_groups(cuda, R):
    """At S = 600 and 226 most blocks of the persistent grid cross from one
    row group into the next, write a partial for each, and the grid's finish
    adds each group's partials: a partial summed into the wrong group moves
    its sums by their own size, far past 1e-4 RMS."""
    g = torch.Generator(device=cuda).manual_seed(70 + R)
    for S in (600, 226):
        _check_modulate_norm_bwd(*_mn_bwd_args(cuda, g, R, S, 1920))
        _check_gated_residual_bwd(*_gated_bwd_args(cuda, g, R, S, 1920))


# -- the general kernels: f32 or bf16 attention at head dims 8..128 (multiples of
# 8), the adaLN pair and the gated residual at any D % 8 == 0 ----------------------
#
# f32 outputs against the plain versions to 1e-4 of each output's range (the
# same f32 arithmetic summed in another order; no TF32 anywhere), lse to 1e-4;
# bf16 at the Hopper kernels' tolerances. Each call launches the general
# kernel once and no Hopper kernel; two runs of each backward give the same
# bits.

def _within_range(got, want, rel: float = 1e-4) -> bool:
    w = want.float()
    return bool((got.float() - w).abs().max() <= rel * (w.max() - w.min()))


def _attn_counts():
    return (attention.flash_attention_general_kernel.launches,
            attention.flash_attention_general_bwd_dq.launches,
            attention.flash_attention_general_bwd_dkv.launches,
            attention.flash_attention.launches, attention.flash_attention_online_kernel.launches,
            attention.flash_attention_bwd_dq.launches, attention.flash_attention_bwd_dkv.launches)


_GENERAL_ATTN = [(torch.float32, 8), (torch.float32, 16), (torch.float32, 32),
                 (torch.float32, 40), (torch.float32, 64), (torch.float32, 128),
                 (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 128)]


def _check_general_forward(q, k, v, static_max):
    """One launch of the general forward against its plain version (f32 out
    within 1e-4 of its range and lse 1e-4; bf16 1e-2 and 1e-3), and the
    same bits on a second run."""
    dtype = q.dtype
    before = _attn_counts()
    out, lse = attention.flash_attention(q, k, v, static_max=static_max)
    assert _attn_counts() == (before[0] + 1,) + before[1:]
    again = attention.flash_attention(q, k, v, static_max=static_max)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = attention.flash_attention_plain(q, k, v, static_max=static_max)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == q.shape[:3]
    if dtype == torch.float32:
        assert _within_range(out, ref)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("static_max", [24.0, None])
@pytest.mark.parametrize("dtype,dh", _GENERAL_ATTN)
@pytest.mark.parametrize("sq,skv,H", [(1, 1, 3), (77, 130, 3), (130, 77, 3), (300, 300, 3),
                                      (257, 65, 3), (65, 257, 3), (257, 65, 90), (65, 257, 90)])
def test_cuda_general_flash_forward_matches_plain(cuda, sq, skv, H, dtype, dh, static_max):
    """Both modes at every head-dim capacity (16, 32, 64, 128) and between
    them (8, 40), Sq != Skv and ragged against the row blocks and 64-key
    tiles: one past a block and a tile each way. With 2 x 3 heads the grid
    leaves multiprocessors idle and blocks take the few rows (4096 / Dh, 64
    at capacity 128); with 2 x 90 every multiprocessor has a block and
    blocks take the full 256 (128 at capacity 128). There v is a quarter of
    the other cases', so that the bf16 outputs stay below 2, where one bf16
    ulp (2^-7) is under the 1e-2 tolerance: of 2 x 90 x 257 x 128 outputs
    at full scale, one of 2.25 rounded to the neighbouring bf16 value (2^-6
    away) from the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(sq + 3 * skv + dh + H)
    q = (2 * torch.randn(2, H, sq, dh, device=cuda, generator=g)).to(dtype)
    k, v = (torch.randn(2, H, skv, dh, device=cuda, generator=g) for _ in range(2))
    _check_general_forward(q, k.to(dtype), (v / 4 if H > 3 else v).to(dtype), static_max)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", _GENERAL_ATTN)
@pytest.mark.parametrize("skv", [1, 193])
def test_cuda_general_flash_online_rescales(cuda, skv, dtype, dh):
    """The online mode where every key tile raises the row max: logits that
    rise with the key (up to about 8 sqrt(Dh), past any static bound), so
    that each of 193 keys' four tiles rescales the rows' sums, the last tile
    one key; and a single key."""
    g = torch.Generator(device=cuda).manual_seed(7 * skv + dh)
    u = torch.ones(dh, device=cuda)
    q = (u + 0.3 * torch.randn(1, 2, 129, dh, device=cuda, generator=g)).to(dtype)
    rise = 8.0 * torch.arange(skv, device=cuda, dtype=torch.float32)[:, None] / skv * u
    k = (rise + 0.3 * torch.randn(1, 2, skv, dh, device=cuda, generator=g)).to(dtype)
    v = torch.randn(1, 2, skv, dh, device=cuda, generator=g).to(dtype)
    _check_general_forward(q, k, v, None)


@pytest.mark.cuda
@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 16), (torch.float32, 32),
                                      (torch.float32, 40), (torch.float32, 64),
                                      (torch.float32, 128), (torch.bfloat16, 16),
                                      (torch.bfloat16, 128)])
@pytest.mark.parametrize("sq,skv", [(1, 1), (64, 65), (129, 63), (77, 130), (130, 77),
                                    (300, 300)])
def test_cuda_general_flash_backward_matches_plain(cuda, sq, skv, dtype, dh, with_dlse):
    """Every capacity (16, 32, 64, 128) and between them (40), Sq != Skv and
    ragged against the kernels' 64- and 128-row blocks and 64-row tiles:
    one row, one past a tile, one past two tiles against one short of one.
    With one key and no dlse, p = 1 and dp = delta, so dq and dk are 0 in
    exact arithmetic and both versions hold rounding noise: there each is
    held to 1e-4 of the term that cancels, max|dp| scale max|k| (dq) or
    max|q| (dk), instead of to the noise's range."""
    g = torch.Generator(device=cuda).manual_seed(sq + 5 * skv + dh)
    q, do = (torch.randn(1, 2, sq, dh, device=cuda, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(1, 2, skv, dh, device=cuda, generator=g).to(dtype) for _ in range(2))
    dlse = torch.randn(1, 2, sq, device=cuda, generator=g) if with_dlse else None
    out, lse = attention.flash_attention(q, k, v)
    before = _attn_counts()
    got = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    assert _attn_counts() == (before[0], before[1] + 1, before[2] + 1) + before[3:]
    want = attention.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse=dlse)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()).abs().max()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        if skv == 1 and dlse is None and name != "dv":
            other = k if name == "dq" else q
            cancelled = dp * dh ** -0.5 * other.float().abs().max()
            assert a.float().abs().max() <= 1e-4 * cancelled, name
        else:
            assert _within_range(a, b) if dtype == torch.float32 else _agree(a, b), name
    again = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 64])
def test_cuda_general_flash_keeps_heads_apart_through_autograd(cuda, dh):
    """f32 leaves under autograd: the forward, dq and dk/dv general kernels
    launch once each and no Hopper kernel; head h's k and v scaled by 10^h,
    q by 10^-h and dO by 10^h, each head's output and gradients against
    autograd through the plain version on the CPU in its own units."""
    g = torch.Generator(device=cuda).manual_seed(dh)
    B, H, sq, skv = 2, 3, 129, 65
    tens = 10.0 ** torch.arange(B * H, device=cuda, dtype=torch.float32).reshape(B, H, 1, 1)
    rand = lambda s: torch.randn(B, H, s, dh, device=cuda, generator=g)
    q = rand(sq) / tens
    k, v = rand(skv) * tens, rand(skv) * tens
    do = rand(sq) * tens
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = _attn_counts()
    out, _ = attention.flash_attention(*leaves, static_max=24.0)
    (out * do).sum().backward()
    assert _attn_counts() == (before[0] + 1, before[1] + 1, before[2] + 1) + before[3:]
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ref, _ = attention.flash_attention(*cpu, static_max=24.0)
    (ref * do.cpu()).sum().backward()
    for b in range(B):
        for h in range(H):
            assert _within_range(out[b, h].detach().cpu(), ref[b, h].detach()), (b, h)
            for leaf, c in zip(leaves, cpu):
                assert _within_range(leaf.grad[b, h].cpu(), c.grad[b, h]), (b, h)


def _adaln_counts():
    return (adaln.modulate_norm_general.launches, adaln.modulate_norm_bwd_general.launches,
            adaln.gated_residual_general.launches, adaln.gated_residual_bwd_general.launches,
            adaln.modulate_norm.launches, adaln.modulate_norm_bwd.launches,
            adaln.gated_residual.launches, adaln.gated_residual_bwd.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 8), (torch.float32, 16), (torch.float32, 24),
                                     (torch.float32, 32), (torch.float32, 40),
                                     (torch.float32, 64), (torch.float32, 72),
                                     (torch.float32, 128), (torch.float32, 136),
                                     (torch.float32, 256), (torch.float32, 264),
                                     (torch.float32, 1920), (torch.float32, 2048),
                                     (torch.float32, 2056), (torch.float32, 3072),
                                     (torch.float32, 4096), (torch.float32, 4104),
                                     (torch.float32, 19368), (torch.bfloat16, 32),
                                     (torch.bfloat16, 40), (torch.bfloat16, 64),
                                     (torch.bfloat16, 72), (torch.bfloat16, 136),
                                     (torch.bfloat16, 4104), (torch.bfloat16, 4224)])
@pytest.mark.parametrize("R,S", [(1, 1), (1, 5), (1, 9), (1, 17), (2, 33), (1, 37), (3, 37),
                                 (5, 65)])
def test_cuda_general_adaln_matches_plain(cuda, R, S, dtype, D):
    """The general adaLN forward and backward (f32 at any D % 8, bf16 where
    the Hopper kernels stop), and the gated residual's f32 instance and
    general backward, each one launch against its plain version; D on either
    side of each forward instance's edge (lanes 4 / 8 / 16 / 32, then 1, 2,
    ... chunks a lane) and past the widest (4096 columns); S one past a
    block's rows at 32, 16, 8 and 4 lanes a row (5, 9, 17, 33), and
    across the adaLN backward's 2-row tiles and the gated residual's 32-row
    chunks of the sums over S; at D 19368 the adaLN backward keeps its sums
    in device memory (12 D bytes no longer fit in shared memory); the
    backwards twice, bitwise."""
    g = torch.Generator(device=cuda).manual_seed(R * S + D)
    x = (2 * torch.randn(R, S, D, device=cuda, generator=g) + 0.3).to(dtype)
    do, y = (torch.randn(R, S, D, device=cuda, generator=g).to(dtype) for _ in range(2))
    shift, scale, gate = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).to(dtype).chunk(
        3, dim=-1)
    ns = 1 + 0.1 * torch.randn(D, device=cuda, generator=g)
    nb = 0.1 * torch.randn(D, device=cuda, generator=g)
    f32 = dtype == torch.float32

    before = _adaln_counts()
    out = adaln.modulate_norm(x, scale, shift, ns, nb)
    ref = adaln.modulate_norm_plain(x, scale, shift, ns, nb)
    assert out.dtype == dtype
    assert (_within_range(out, ref) if f32
            else torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=1e-2))
    got = adaln.modulate_norm_bwd(x, do, scale, ns)
    want = adaln.modulate_norm_bwd_plain(x, do, scale, ns)
    assert got[0].dtype == dtype and got[1].shape == got[2].shape == (R, D)
    assert _within_range(got[0], want[0]) if f32 else _agree(got[0], want[0])
    assert _within_range(got[1], want[1]) and _within_range(got[2], want[2])
    again = adaln.modulate_norm_bwd(x, do, scale, ns)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _adaln_counts()[:2] == (before[0] + 1, before[1] + 2)
    if f32:  # bf16 gated residuals are the Hopper kernels'
        res = adaln.gated_residual(x, y, gate)
        torch.testing.assert_close(res, adaln.gated_residual_plain(x, y, gate), atol=0, rtol=0)
        dy, dgate = adaln.gated_residual_bwd(do, y, gate)
        ref_dy, ref_dgate = adaln.gated_residual_bwd_plain(do, y, gate)
        torch.testing.assert_close(dy, ref_dy, atol=0, rtol=0)
        assert dgate.dtype == torch.float32 and _within_range(dgate, ref_dgate)
        again = adaln.gated_residual_bwd(do, y, gate)
        assert torch.equal(again[0], dy) and torch.equal(again[1], dgate)
        assert _adaln_counts()[2:4] == (before[2] + 1, before[3] + 2)
    assert _adaln_counts()[4:] == before[4:]


def _general_fwd_inputs(g, R, S, D, dtype, v_dtype=None):
    """x [R, S, D] in dtype; scale and shift row-strided chunks of [R, 3D]
    in v_dtype (dtype by default); f32 ns, nb."""
    x = (2 * torch.randn(R, S, D, device=g.device, generator=g) + 0.3).to(dtype)
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, device=g.device, generator=g)).to(
        v_dtype or dtype).chunk(3, dim=-1)
    ns = 1 + 0.1 * torch.randn(D, device=g.device, generator=g)
    nb = 0.1 * torch.randn(D, device=g.device, generator=g)
    return x, scale, shift, ns, nb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 1920), (torch.float32, 32),
                                     (torch.float32, 4096), (torch.float32, 4104),
                                     (torch.bfloat16, 128), (torch.bfloat16, 256),
                                     (torch.bfloat16, 2048), (torch.bfloat16, 2176),
                                     (torch.bfloat16, 4096), (torch.bfloat16, 4104)])
@pytest.mark.parametrize("R,S0", [(5, 600), (1, 226), (13, 600), (2, 96)])
def test_cuda_general_forward_plan_and_runs(cuda, R, S0, dtype, D):
    """The general adaLN forward called directly (bf16 also at D % 128 == 0,
    which `modulate_norm` sends to the Hopper kernel): the C side's instance
    and grid (`modulate_norm_general_info`) are `modulate_norm_general_plan`'s;
    the instance does not spill; at S0, at one row past a block's rows (a
    last tile of one row) and at S = 1, the output agrees with the plain
    version (f32 within 1e-4 of its range, bf16 one rounding) and a second
    run gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(R * S0 + D)
    tile = adaln.modulate_norm_general_plan(R, S0, D, dtype)["tile_rows"]
    for S in (S0, tile * (S0 // tile) + 1, 1):
        info = adaln.modulate_norm_general_info(R, S, D, dtype)
        plan = adaln.modulate_norm_general_plan(R, S, D, dtype)
        assert {k: info[k] for k in ("lanes", "held", "tile_rows", "blocks")} == {
            k: plan[k] for k in ("lanes", "held", "tile_rows", "blocks")}, (S, info, plan)
        assert info["local_bytes"] == 0, info
        x, scale, shift, ns, nb = _general_fwd_inputs(g, R, S, D, dtype)
        before = adaln.modulate_norm_general.launches
        out = adaln.modulate_norm_general(x, scale, shift, ns, nb, 1e-5)
        again = adaln.modulate_norm_general(x, scale, shift, ns, nb, 1e-5)
        assert adaln.modulate_norm_general.launches == before + 2
        ref = adaln.modulate_norm_plain(x, scale, shift, ns, nb)
        assert out.dtype == dtype and torch.equal(out, again), S
        assert (_within_range(out, ref) if dtype == torch.float32
                else torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=1e-2)), S


@pytest.mark.cuda
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,S,D", [(1, 226, 1920), (2, 226, 1920), (5, 600, 1920),
                                   (1, 300, 1920), (5, 601, 1920), (3, 37, 40), (1, 1, 8),
                                   (300, 3, 4096)])
def test_cuda_general_gated_residual_plan_and_runs(cuda, R, S, D, v_dtype):
    """The gated residual's f32 instance with a row-strided gate (a chunk of
    [R, 3D]) in f32 or bf16: the C side's plan (`gated_residual_general_info`)
    is `gated_residual_f32_plan`'s for the card's resident threads, the
    kernel does not spill, and its output equals the plain version's bits
    (the same two roundings), twice. The shapes: the text stream's, the
    training shape (11 rows a thread: two steps of 4 and a tail of 3), 300
    rows (2 a thread, a tail alone), S = 1, and R D / 4 past the card's
    threads (a row a step)."""
    g = torch.Generator(device=cuda).manual_seed(R * S + D)
    info = adaln.gated_residual_general_info(R, S, D)
    plan = adaln.gated_residual_f32_plan(R, S, D, info["resident"] * adaln.GENERAL_GR_THREADS)
    assert (info["rows_a_step"], info["blocks"]) == (plan["rows_a_step"], plan["blocks"]), (
        info, plan)
    assert info["local_bytes"] == 0, info
    x, y = (torch.randn(R, S, D, device=cuda, generator=g) for _ in range(2))
    gate = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).to(v_dtype)[:, D:2 * D]
    before = adaln.gated_residual_general.launches
    out = adaln.gated_residual(x, y, gate)
    again = adaln.gated_residual(x, y, gate)
    assert adaln.gated_residual_general.launches == before + 2
    torch.testing.assert_close(out, adaln.gated_residual_plain(x, y, gate), atol=0, rtol=0)
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_cuda_general_adaln_autograd_matches_cpu(cuda):
    """f32 leaves at D 40 under autograd: every gradient of modulate_norm
    and of the gated residual against autograd through the plain versions on
    the CPU, to 1e-4 of its range."""
    g = torch.Generator(device=cuda).manual_seed(41)
    R, S, D = 3, 70, 40
    x, do, y = (torch.randn(R, S, D, device=cuda, generator=g) for _ in range(3))
    shift, scale, gate = (0.3 * torch.randn(R, 3 * D, device=cuda, generator=g)).chunk(3, -1)
    ns = 1 + 0.1 * torch.randn(D, device=cuda, generator=g)
    nb = 0.1 * torch.randn(D, device=cuda, generator=g)
    for fn, args in ((adaln.modulate_norm, (x, scale, shift, ns, nb)),
                     (adaln.gated_residual, (x, y, gate))):
        leaves = [t.clone().requires_grad_() for t in args]
        (fn(*leaves) * do).sum().backward()
        cpu = [t.detach().cpu().requires_grad_() for t in args]
        (fn(*cpu) * do.cpu()).sum().backward()
        for leaf, c in zip(leaves, cpu):
            assert _within_range(leaf.grad.cpu(), c.grad), fn.__name__


@pytest.mark.cuda
def test_cuda_f32_train_matches_cpu(cuda):
    """chip_smoke.f32_train_check: pipelines/train.py:train with
    train.mixed_precision=no at 2 layers, on the card through the general
    kernels only and on the CPU through the plain versions, from the same
    weights and draws: each micro-step's loss to 1e-5 relative, its grad
    norm to 1e-4."""
    import chip_smoke

    chip_smoke.f32_train_check()


@pytest.mark.cuda
def test_cuda_tiny_train_step_with_control_latents_matches_cpu(cuda):
    """chip_smoke.tiny_train_check: one train step of a 2-layer recon_action,
    visual-guidance ControlDiT with depth and label moments in the batch,
    bf16 kernels on the card against f32 plain versions on the CPU from the
    same weights and draws (loss and grad norm to 2e-2 relative, no
    gradient dropped at a kernel's output, a micro-step's launch counts)."""
    import chip_smoke

    chip_smoke.tiny_train_check()


@pytest.mark.cuda
def test_cuda_train_resume_equals_an_unbroken_run(cuda, tmp_path):
    """chip_smoke.tiny_resume_check: pipelines/train.py:train at a tiny
    config on the card, cut before micro-step 2 and 3 and resumed from the
    latest checkpoint, ends bitwise where an unbroken run of 4 ends."""
    import chip_smoke

    chip_smoke.tiny_resume_check(tmp_path)


# -- the data factory's kernels: voxelization and the Gaussian-splat rasterizer --------
#
# Voxelization against its plain version bitwise (hard and dynamic), at
# point counts around the 256-thread block and past max_points and
# max_voxels. The rasterizer forward against its plain version on the card:
# radii bitwise, the images to 1e-5 absolute (the same f32 operations in the
# same order, expf in both; sums taken in another order), at H and W that
# are not multiples of 16, features on and off. The backward kernel against
# autograd through the plain version: each gradient to 1e-4 of its largest
# magnitude (its sums run over tiles and pixels in another order), and a
# second run bitwise equal to the first.

def _cloud(g, n, device):
    pts = torch.rand(n, 4, generator=g, device=device) * 0.5 - 0.1
    pts[: n // 3, :3] = torch.rand(n // 3, 3, generator=g, device=device) * 0.02  # dense corner
    pts[:, 3] = torch.randint(0, 12, (n,), generator=g, device=device).float()
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize("n,max_points,max_voxels", [(1, 4, 10), (255, 4, 10), (257, 35, 20000),
                                                     (5000, 3, 400), (100003, 16, 2_000_000)])
def test_cuda_voxelization_matches_plain(cuda, n, max_points, max_voxels):
    from orv_tpu_torch.ops import voxelize

    g = torch.Generator(device=cuda).manual_seed(n)
    pts = _cloud(g, n, cuda)
    vs, cr = (0.001, 0.002, 0.001), (-0.05, -0.05, 0.0, 0.2, 0.2, 0.3)
    before = (voxelize.hard_voxelize.launches, voxelize.dynamic_voxelize.launches)
    got = voxelize.voxelization(pts, vs, cr, max_points=max_points, max_voxels=max_voxels)
    want = voxelize.voxelization_plain(pts, vs, cr, max_points, max_voxels)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    again = voxelize.voxelization(pts, vs, cr, max_points=max_points, max_voxels=max_voxels)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dyn = voxelize.voxelization(pts, vs, cr, max_points=-1)
    assert torch.equal(dyn, voxelize.voxelization_plain(pts, vs, cr, max_points=-1))
    assert (voxelize.hard_voxelize.launches, voxelize.dynamic_voxelize.launches) == (
        before[0] + 2, before[1] + 1)
    with pytest.raises(ValueError):
        voxelize.voxelization(pts.double(), vs, cr)


def _scene_tensors(cuda, n, H, W, seed, features=True):
    import chip_smoke

    settings, arr = chip_smoke.raster_scene(n, H, W, seed)
    t = {k: torch.tensor(v, device=cuda) for k, v in arr.items()}
    if not features:
        t["features"] = None
    return settings, t


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,W,features", [(1, 16, 16, True), (300, 37, 53, True),
                                            (300, 37, 53, False), (3000, 64, 96, True),
                                            (20000, 240, 320, True)])
def test_cuda_rasterize_matches_plain(cuda, n, H, W, features):
    from orv_tpu_torch.ops import gaussian_raster as gr

    settings, t = _scene_tensors(cuda, n, H, W, seed=n + H, features=features)
    args = (t["means3d"], t["colors"], t["opacities"], t["scales"], t["rotations"], t["features"])
    before = gr.rasterize.launches
    got = gr.rasterize(settings, *args)
    assert gr.rasterize.launches == before + 1
    want = gr.rasterize_plain(settings, *args)
    assert torch.equal(got[2], want[2])
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,W,features", [(300, 37, 53, True), (300, 37, 53, False),
                                            (3000, 64, 96, True)])
def test_cuda_rasterize_backward_matches_autograd_of_plain(cuda, n, H, W, features):
    from orv_tpu_torch.ops import gaussian_raster as gr

    settings, t = _scene_tensors(cuda, n, H, W, seed=n + W, features=features)
    g = torch.Generator(device=cuda).manual_seed(1)
    grads = dict(grad_color=torch.randn(3, H, W, generator=g, device=cuda),
                 grad_depth=torch.randn(H, W, generator=g, device=cuda),
                 grad_alpha=torch.randn(H, W, generator=g, device=cuda),
                 grad_feature=torch.randn(12, H, W, generator=g, device=cuda))
    args = (t["means3d"], t["colors"], t["opacities"], t["scales"], t["rotations"])
    before = gr.rasterize_backward.launches
    got = gr.rasterize_backward(settings, *args, features=t["features"], **grads)
    assert gr.rasterize_backward.launches == before + 1
    want = gr.rasterize_backward_plain(settings, *args, features=t["features"], **grads)
    for k in want:
        scale = want[k].abs().max().item()
        err = (got[k] - want[k]).abs().max().item()
        assert err <= 1e-4 * max(scale, 1e-30), (k, err, scale)
    # autograd through rasterize runs the same backward kernel
    leaves = [a.clone().requires_grad_(True) for a in args]
    feat = None if t["features"] is None else t["features"].clone().requires_grad_(True)
    color, feature, _, depth, alpha = gr.rasterize(settings, *leaves, feat)
    loss = ((color * grads["grad_color"]).sum() + (depth * grads["grad_depth"]).sum()
            + (alpha * grads["grad_alpha"]).sum() + (feature * grads["grad_feature"]).sum())
    loss.backward()
    assert gr.rasterize_backward.launches == before + 2
    for k, leaf in zip(("means3d", "colors", "opacities", "scales", "rotations"), leaves):
        torch.testing.assert_close(leaf.grad, got[k], atol=1e-5 * got[k].abs().max().item(),
                                   rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,W,features", [(300, 37, 53, False), (3000, 61, 93, True),
                                            (20000, 240, 320, True)])
def test_cuda_rasterize_backward_repeats_its_bits(cuda, n, H, W, features):
    """Two runs of the backward give the same bits (each splat's gradients
    are summed in a fixed order, no atomics), and the gradients stay within
    1e-4 of each largest gradient of autograd through the plain version
    (checked below 20000 gaussians, where the plain version's graph stays
    small)."""
    from orv_tpu_torch.ops import gaussian_raster as gr

    settings, t = _scene_tensors(cuda, n, H, W, seed=n + H + W, features=features)
    g = torch.Generator(device=cuda).manual_seed(2)
    grads = dict(grad_color=torch.randn(3, H, W, generator=g, device=cuda),
                 grad_depth=torch.randn(H, W, generator=g, device=cuda),
                 grad_alpha=torch.randn(H, W, generator=g, device=cuda),
                 grad_feature=torch.randn(12, H, W, generator=g, device=cuda))
    args = (t["means3d"], t["colors"], t["opacities"], t["scales"], t["rotations"])
    first = gr.rasterize_backward(settings, *args, features=t["features"], **grads)
    second = gr.rasterize_backward(settings, *args, features=t["features"], **grads)
    for k in first:
        assert torch.equal(first[k], second[k]), k
    if n < 20000:
        want = gr.rasterize_backward_plain(settings, *args, features=t["features"], **grads)
        for k in want:
            scale = want[k].abs().max().item()
            err = (first[k] - want[k]).abs().max().item()
            assert err <= 1e-4 * max(scale, 1e-30), (k, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,W", [(300, 37, 53), (3000, 61, 93), (20000, 240, 320)])
def test_cuda_rasterize_saves_the_backward_state(cuda, n, H, W):
    """The forward under autograd saves each pixel's final transmittance and
    the list position of its last blended splat: against
    `forward_state_plain`, T to 1e-6 and the position equal off the pixels
    whose running T passes within 1e-5 of 1e-4 (rounding can move the stop
    there); its outputs are the no-grad forward's bits."""
    from orv_tpu_torch.ops import gaussian_raster as gr

    settings, t = _scene_tensors(cuda, n, H, W, seed=n + 11)
    names = ("means3d", "colors", "opacities", "scales", "rotations", "features")
    leaves = [t[k].clone().requires_grad_(True) for k in names]
    out = gr.rasterize(settings, *leaves)
    with torch.no_grad():
        bare = gr.rasterize(settings, *(t[k] for k in names))
    for a, b in zip(out, bare):
        assert torch.equal(a.detach(), b)
    state = out[0].grad_fn.state
    want = gr.forward_state_plain(settings, t["means3d"], t["opacities"], t["scales"],
                                  t["rotations"])
    torch.testing.assert_close(state["T"], want["T"], atol=1e-6, rtol=0)
    off = ~want["marginal"]
    assert torch.equal(state["last"][off], want["last"][off])
    assert int(want["marginal"].sum()) <= H * W // 100


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,W,features", [(300, 37, 53, False), (3000, 61, 93, True),
                                            (20000, 240, 320, True)])
def test_cuda_rasterize_autograd_backward_equals_the_standalone_bitwise(cuda, n, H, W, features):
    """Autograd's backward through `rasterize` (from the state its forward
    saved) gives the bits of the standalone `rasterize_backward` (which
    computes the state by the same blend)."""
    from orv_tpu_torch.ops import gaussian_raster as gr

    settings, t = _scene_tensors(cuda, n, H, W, seed=n + 13, features=features)
    g = torch.Generator(device=cuda).manual_seed(3)
    grads = dict(grad_color=torch.randn(3, H, W, generator=g, device=cuda),
                 grad_depth=torch.randn(H, W, generator=g, device=cuda),
                 grad_alpha=torch.randn(H, W, generator=g, device=cuda),
                 grad_feature=torch.randn(12, H, W, generator=g, device=cuda))
    names = ("means3d", "colors", "opacities", "scales", "rotations")
    args = [t[k] for k in names]
    want = gr.rasterize_backward(settings, *args, features=t["features"], **grads)
    leaves = [a.clone().requires_grad_(True) for a in args]
    feat = None if t["features"] is None else t["features"].clone().requires_grad_(True)
    color, feature, _, depth, alpha = gr.rasterize(settings, *leaves, feat)
    loss = ((color * grads["grad_color"]).sum() + (depth * grads["grad_depth"]).sum()
            + (alpha * grads["grad_alpha"]).sum() + (feature * grads["grad_feature"]).sum())
    got = torch.autograd.grad(loss, leaves + ([feat] if features else []))
    for k, grad in zip(names + ("features",), got):
        assert torch.equal(grad, want[k]), k


@pytest.mark.cuda
def test_cuda_local_ring_refuses_a_backward(cuda):
    """Autograd runs CUDA backward nodes on its own device thread, where a
    LocalRing rank is unknown: the ring refuses to record a backward on CUDA
    tensors by name, and still runs under no_grad."""
    from orv_tpu_torch.ops.ring_attention import joint_ring_attention
    from orv_tpu_torch.parallel.sp import LocalRing

    comm = LocalRing(2, timeout=60)
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 2, 8 + 64, 64, device=cuda, generator=g).bfloat16()
               .requires_grad_() for _ in range(3))
    with pytest.raises(RuntimeError, match="LocalRing cannot carry a backward on CUDA"):
        comm.run(lambda: joint_ring_attention(q, k, v, 8, comm))
    with torch.no_grad():
        outs = comm.run(lambda: joint_ring_attention(q, k, v, 8, comm))
    assert torch.equal(outs[0], outs[1])


# -- the factory kernels' device-wide scan, grouping and binning -------------------------
#
# The scan (csrc/scan.cuh, 2048 elements a block) against torch.cumsum,
# bitwise, at tile edges and past a thousand blocks; hard voxelization at
# the factory's shape and with one voxel of more than 10,000 points (the
# scatter's long-bucket path), bitwise; the rasterizer's binning (per-tile
# lists by depth, ties by index, and the backward's slot map) against
# `bin_plain`, bitwise, on seeded scenes, on voxel centres with exact depth
# ties, and on a tile whose list is longer than the shared-memory sort
# holds (sorted in chunks, merged by rank), with the forward and the
# backward there against their plain versions.

@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 2047, 2048, 2049, 4097, 153_600,
                               (1 << 20) + 3])
def test_cuda_exclusive_scan_matches_cumsum(cuda, n):
    from orv_tpu_torch.ops import scan

    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(0, 9, (n,), generator=g, device=cuda, dtype=torch.int32)
    before = scan.exclusive_scan.launches
    out, total = scan.exclusive_scan(x)
    assert scan.exclusive_scan.launches == before + 1
    want, want_total = scan.exclusive_scan_plain(x)
    assert torch.equal(out, want) and torch.equal(total, want_total)
    # an offset view (no 16-byte loads) and a run of zeros then ones
    if n > 5:
        out, total = scan.exclusive_scan(x[1:])
        want, want_total = scan.exclusive_scan_plain(x[1:])
        assert torch.equal(out, want) and torch.equal(total, want_total)
        y = (torch.arange(n, device=cuda) >= n // 2).int()
        assert torch.equal(scan.exclusive_scan(y)[0], scan.exclusive_scan_plain(y)[0])


def _factory_cloud(device):
    """Frame 0 of the factory's first episode (chip_smoke's scene), unprojected
    at 320x480 with its labels: [153600, 4]."""
    import numpy as np

    import chip_smoke

    pose = chip_smoke.factory_pose(0, 0)
    K = chip_smoke.FACTORY_K
    depth, label = chip_smoke.factory_cast(pose, K, chip_smoke.FACTORY_HW)
    v, u = np.mgrid[0:depth.shape[0], 0:depth.shape[1]]
    z = depth.reshape(-1)
    cam = np.stack([(u.reshape(-1) - K[0, 2]) / K[0, 0] * z,
                    (v.reshape(-1) - K[1, 2]) / K[1, 1] * z, z, np.ones_like(z)], 1)
    world = (pose @ cam.T).T[:, :3]
    return torch.tensor(np.concatenate([world, label.reshape(-1, 1)], 1), dtype=torch.float32,
                        device=device)


@pytest.mark.cuda
def test_cuda_hard_voxelization_at_the_factory_shape(cuda):
    from orv_tpu_torch.ops import voxelize
    from orv_tpu_torch.pipelines import prepare_dataset as pd

    cloud = _factory_cloud(cuda)
    assert cloud.shape == (153_600, 4)
    for max_voxels in (2_000_000, 30_000):
        got = voxelize.hard_voxelize(cloud, pd.VOXEL_SIZE, pd.POINT_CLOUD_RANGE, 16, max_voxels)
        want = voxelize.voxelization_plain(cloud, pd.VOXEL_SIZE, pd.POINT_CLOUD_RANGE, 16,
                                           max_voxels)
        assert len(want[1]) > 20_000
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("max_points", [16, 35])
def test_cuda_hard_voxelization_of_a_dense_cluster(cuda, max_points):
    """12,000 points in one 1 mm voxel among 5,000 scattered ones, shuffled:
    the scatter's long bucket keeps its first max_points in input order."""
    from orv_tpu_torch.ops import voxelize

    g = torch.Generator(device=cuda).manual_seed(max_points)
    n = 17_000
    pts = torch.rand(n, 5, generator=g, device=cuda) * 0.1
    pts[:12_000, :3] = 0.0503 + torch.rand(12_000, 3, generator=g, device=cuda) * 0.0009
    pts = pts[torch.randperm(n, generator=g, device=cuda)].contiguous()
    vs, cr = (0.001, 0.001, 0.001), (0.0, 0.0, 0.0, 0.1, 0.1, 0.1)
    got = voxelize.hard_voxelize(pts, vs, cr, max_points, 20_000)
    want = voxelize.voxelization_plain(pts, vs, cr, max_points, 20_000)
    assert int(want[2].max()) == max_points and len(want[1]) > 4000
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def _check_binning(settings, t):
    from orv_tpu_torch.ops import gaussian_raster as gr

    args = (t["means3d"], t["scales"], t["rotations"])
    binned = gr._bin(settings, *args, t["opacities"].reshape(-1))
    want = gr.bin_plain(settings, *args)
    for k in ("ranges", "point_list", "touched", "offsets", "slot_of"):
        assert torch.equal(binned[k], want[k]), k
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("n,H,W", [(300, 37, 53), (3000, 64, 96), (20000, 240, 320)])
def test_cuda_rasterize_binning_matches_plain(cuda, n, H, W):
    settings, t = _scene_tensors(cuda, n, H, W, seed=n + 7)
    _check_binning(settings, t)


@pytest.mark.cuda
def test_cuda_rasterize_binning_on_voxel_centres_with_depth_ties(cuda):
    """The depth-tie scene of test_torch_port_native_ops.py: a slab of 1 mm
    voxels in two layers seen straight down, every layer's centres at one
    depth: ties come out in index order, as the plain version blends them."""
    import numpy as np

    from orv_tpu_torch.ops import gaussian_raster as gr
    from orv_tpu_torch.pipelines import prepare_dataset as tpd

    y, x = np.mgrid[150:250, 150:250]
    coors = np.concatenate([np.stack([np.full(x.size, z), y.ravel(), x.ravel()], 1)
                            for z in (200, 201)]).astype(np.int32)
    labels = (1 + (coors[:, 2] >= 200) + 2 * (coors[:, 1] >= 200)).astype(np.int32)
    centers, feat, rot, scales, opac = tpd.occupancy_to_gaussians(coors, labels, device=cuda)
    pose = np.eye(4)
    pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
    pose[2, 3] = 0.5
    K = np.array([[300.0, 0, 48], [0, 300.0, 32], [0, 0, 1]])
    settings = gr.view_settings(pose, K, (64, 96))
    t = dict(means3d=centers, scales=scales, rotations=rot, opacities=opac)
    want = _check_binning(settings, t)
    assert (want["ranges"][:, 1] - want["ranges"][:, 0]).max() > 100
    rgb = torch.zeros_like(centers)
    got = gr.rasterize(settings, centers, rgb, opac, scales, rot, feat)
    plain = gr.rasterize_plain(settings, centers, rgb, opac, scales, rot, feat)
    assert torch.equal(got[2], plain[2])
    for a, b in zip(got[:2] + got[3:], plain[:2] + plain[3:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_rasterize_on_a_tile_past_the_shared_memory_sort(cuda):
    """10,000 splats before a 16 x 16 image: one tile whose list is longer
    than TILE_SORT_CAP (sorted in three chunks and merged by rank). The
    binning bitwise, the forward to 1e-5, the backward to 1e-4 of each
    largest gradient and bitwise on a second run."""
    import numpy as np

    from orv_tpu_torch.ops import gaussian_raster as gr

    rng = np.random.default_rng(5)
    n = 10_000
    z = 0.5 + 0.01 * rng.integers(0, 100, n)  # exact depth ties
    cam = np.stack([rng.uniform(-0.3, 0.3, n) * z, rng.uniform(-0.3, 0.3, n) * z, z], 1)
    settings = gr.view_settings(np.eye(4), np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]]),
                                (16, 16), bg_color=(0.1, 0.2, 0.3))
    arrays = dict(means3d=cam, colors=rng.uniform(0, 1, (n, 3)),
                  opacities=rng.uniform(0.05, 0.5, n),
                  scales=rng.uniform(0.002, 0.02, (n, 3)) * z[:, None],
                  rotations=rng.normal(size=(n, 4)), features=rng.uniform(0, 1, (n, 12)))
    t = {k: torch.tensor(v, dtype=torch.float32, device=cuda) for k, v in arrays.items()}
    want = _check_binning(settings, t)
    length = int(want["ranges"][0, 1] - want["ranges"][0, 0])
    assert gr.tile_sort_chunks(length) >= 2, length
    args = (t["means3d"], t["colors"], t["opacities"], t["scales"], t["rotations"], t["features"])
    got, plain = gr.rasterize(settings, *args), gr.rasterize_plain(settings, *args)
    assert torch.equal(got[2], plain[2])
    for a, b in zip(got[:2] + got[3:], plain[:2] + plain[3:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    g = torch.Generator(device=cuda).manual_seed(6)
    grads = dict(grad_color=torch.randn(3, 16, 16, generator=g, device=cuda),
                 grad_depth=torch.randn(16, 16, generator=g, device=cuda),
                 grad_alpha=torch.randn(16, 16, generator=g, device=cuda),
                 grad_feature=torch.randn(12, 16, 16, generator=g, device=cuda))
    first = gr.rasterize_backward(settings, *args[:5], features=t["features"], **grads)
    second = gr.rasterize_backward(settings, *args[:5], features=t["features"], **grads)
    want = gr.rasterize_backward_plain(settings, *args[:5], features=t["features"], **grads)
    for k in want:
        assert torch.equal(first[k], second[k]), k
        scale = want[k].abs().max().item()
        assert (first[k] - want[k]).abs().max().item() <= 1e-4 * max(scale, 1e-30), k
