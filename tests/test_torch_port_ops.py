"""The port's kernel modules against orv_tpu's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode (as tests/test_attention.py does).
Inputs come from a numpy seed and are rounded to the tested dtype on both
sides. Tolerances: f32 atol 2e-5 (same arithmetic, other summation order);
bf16 compared in f32 at atol 1e-2 (one bf16 rounding of outputs below ~2),
plus one bf16 ulp relative where outputs are larger.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models.layers import gate_residual_add as jax_gate_residual_add
from orv_tpu.ops.adaln import modulate_norm as jax_modulate_norm
from orv_tpu.ops.attention import attention as jax_attention
from orv_tpu.ops.attention import attention_with_lse
from orv_tpu.ops.attention import flash_attention as jax_flash_attention
from orv_tpu.ops.attention import mha_reference as jax_mha_reference
from orv_tpu_torch.models.layers import gate_residual_add
from orv_tpu_torch.ops import adaln, attention

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _pair(a, dtype):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq", [128, 200, 300])  # 200/300: ragged against 128-key blocks
def test_flash_attention_plain_matches_pallas_static_max(seq, dtype):
    rng = np.random.default_rng(seq)
    shape = (1, 2, seq, 64)
    qj, qt = _pair(rng.standard_normal(shape), dtype)
    kj, kt = _pair(rng.standard_normal(shape), dtype)
    vj, vt = _pair(rng.standard_normal(shape), dtype)
    ref_out, ref_lse = attention_with_lse(qj, kj, vj, impl="flash", static_max=24.0)
    before = attention.flash_attention.launches
    out, lse = attention.flash_attention(qt, kt, vt, static_max=24.0)
    assert attention.flash_attention.launches == before  # CPU: plain version, no launch
    assert out.dtype == qt.dtype and lse.shape == (1, 2, seq)
    _close(out, ref_out, DTYPES[dtype][2])
    _close(lse, ref_lse, 1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_default_matches_pallas_at_large_logits(dtype):
    """The default forward (no static_max) is JAX's: the online softmax.
    q and k scaled by 6 put the largest logit past 150, where exp(s - 24)
    overflows f32, so a static-max default would return non-finite values."""
    rng = np.random.default_rng(6)
    shape = (1, 2, 200, 64)
    q, k = (6.0 * rng.standard_normal(shape) for _ in range(2))
    assert (np.einsum("bhqd,bhkd->bhqk", q, k) / 8.0).max() >= 150
    (qj, qt), (kj, kt) = _pair(q, dtype), _pair(k, dtype)
    vj, vt = _pair(rng.standard_normal(shape), dtype)
    ref = jax_flash_attention(qj, kj, vj, block_q=128, block_k=128)
    out, lse = attention.flash_attention(qt, kt, vt)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    _close(out, ref, DTYPES[dtype][2])
    static, _ = attention.flash_attention(qt, kt, vt, static_max=24.0)
    assert not torch.isfinite(static.float()).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", [(128, 128), (200, 200), (300, 300), (77, 300), (300, 77)])
def test_flash_attention_online_plain_matches_pallas(sq, skv, dtype):
    """The online forward's plain version (the CPU path and the kernel's
    oracle) against `attention_with_lse(impl="flash")` with its online
    Pallas kernel: ragged S (200, 300 against 128-key blocks) and Sq != Skv,
    as the ring calls it. Logits reach ~40, past the static bound."""
    rng = np.random.default_rng(sq + 7 * skv)
    qj, qt = _pair(3.0 * rng.standard_normal((1, 2, sq, 64)), dtype)
    kj, kt = _pair(3.0 * rng.standard_normal((1, 2, skv, 64)), dtype)
    vj, vt = _pair(rng.standard_normal((1, 2, skv, 64)), dtype)
    ref_out, ref_lse = attention_with_lse(qj, kj, vj, impl="flash")
    before = (attention.flash_attention.launches,
              attention.flash_attention_online_kernel.launches)
    out, lse = attention.flash_attention(qt, kt, vt)
    assert before == (attention.flash_attention.launches,
                      attention.flash_attention_online_kernel.launches)
    assert out.shape == (1, 2, sq, 64) and out.dtype == qt.dtype and lse.shape == (1, 2, sq)
    _close(out, ref_out, DTYPES[dtype][2])
    _close(lse, ref_lse, 1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_dispatch_matches_jax(dtype):
    """`attention` and `attention_with_lse` with JAX's semantics: "auto" is
    the reference on the CPU; "flash" the online flash forward unless a
    static_max is given; "flash_q8" the int8 kernel with static_max 24 in
    `attention` and the bf16 flash forward in `attention_with_lse` (no int8
    lse exists); "xla" the reference with the exact lse."""
    rng = np.random.default_rng(4)
    shape = (1, 2, 200, 64)
    qj, qt = _pair(rng.standard_normal(shape), dtype)
    kj, kt = _pair(rng.standard_normal(shape), dtype)
    vj, vt = _pair(rng.standard_normal(shape), dtype)
    tol = DTYPES[dtype][2]
    ref = jax_mha_reference(qj, kj, vj)
    _close(attention.mha_reference(qt, kt, vt), ref, tol)
    torch.testing.assert_close(attention.attention(qt, kt, vt),
                               attention.mha_reference(qt, kt, vt), atol=0, rtol=0)
    for impl in ("xla", "flash"):
        _close(attention.attention(qt, kt, vt, impl=impl), jax_attention(qj, kj, vj, impl=impl),
               tol)
        out, lse = attention.attention_with_lse(qt, kt, vt, impl=impl)
        ref_out, ref_lse = attention_with_lse(qj, kj, vj, impl=impl)
        _close(out, ref_out, tol)
        _close(lse, ref_lse, 1e-4)
    flash = attention.flash_attention(qt, kt, vt, static_max=24.0)
    torch.testing.assert_close(attention.attention(qt, kt, vt, impl="flash", static_max=24.0),
                               flash[0], atol=0, rtol=0)
    for got, want in zip(attention.attention_with_lse(qt, kt, vt, impl="flash_q8",
                                                      static_max=24.0), flash):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(attention.attention(qt, kt, vt, impl="flash_q8"),
                               attention.flash_attention_q8(qt, kt, vt, static_max=24.0),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="impl"):
        attention.attention(qt, kt, vt, impl="pallas")


def test_flash_attention_plain_matches_softmax_in_f32():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 77, 64)).astype(np.float32))
               for _ in range(3))
    out, lse = attention.flash_attention_plain(q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=2e-5, rtol=0)


@pytest.mark.parametrize("norm_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_modulate_norm_plain_matches_pallas(dtype, norm_dtype):
    rng = np.random.default_rng(1)
    R, S, D = 3, 10, 32  # S=10 is ragged against the kernel's 8-row blocks
    xj, xt = _pair(rng.standard_normal((R, S, D)) * 2 + 0.5, dtype)
    scj, sct = _pair(rng.standard_normal((R, D)) * 0.3, dtype)
    shj, sht = _pair(rng.standard_normal((R, D)) * 0.3, dtype)
    nsj, nst = _pair(1 + 0.1 * rng.standard_normal(D), norm_dtype)
    nbj, nbt = _pair(0.1 * rng.standard_normal(D), norm_dtype)
    ref = jax_modulate_norm(xj, scj, shj, nsj, nbj, eps=1e-5)
    before = adaln.modulate_norm.launches
    out = adaln.modulate_norm(xt, sct, sht, nst, nbt, eps=1e-5)
    assert adaln.modulate_norm.launches == before
    assert out.dtype == xt.dtype
    # outputs reach ~8: bf16 also gets one ulp of relative slack (2^-7)
    _close(out, ref, DTYPES[dtype][2], rtol=2.0**-7 if dtype == "bf16" else 0.0)


@pytest.mark.parametrize("norm_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_modulate_norm_plain_matches_pallas_wide_rows(dtype, norm_dtype):
    """Rows 3072 wide (the CogVideoX1.5-5b family's 48 heads x 64), which the
    CUDA forwards take since they re-read rows from shared memory; S=13 is
    ragged against the Pallas kernel's 8-row blocks."""
    rng = np.random.default_rng(5)
    R, S, D = 2, 13, 3072
    xj, xt = _pair(rng.standard_normal((R, S, D)) * 2 + 0.5, dtype)
    scj, sct = _pair(rng.standard_normal((R, D)) * 0.3, dtype)
    shj, sht = _pair(rng.standard_normal((R, D)) * 0.3, dtype)
    nsj, nst = _pair(1 + 0.1 * rng.standard_normal(D), norm_dtype)
    nbj, nbt = _pair(0.1 * rng.standard_normal(D), norm_dtype)
    ref = jax_modulate_norm(xj, scj, shj, nsj, nbj, eps=1e-5)
    before = adaln.modulate_norm.launches
    out = adaln.modulate_norm(xt, sct, sht, nst, nbt, eps=1e-5)
    assert adaln.modulate_norm.launches == before
    assert out.dtype == xt.dtype and out.shape == (R, S, D)
    _close(out, ref, DTYPES[dtype][2], rtol=2.0**-7 if dtype == "bf16" else 0.0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gate_shape", ["per_frame", "global"])
def test_gated_residual_matches_pallas(gate_shape, dtype):
    """Both gate shapes the DiT uses: per-frame [B, F, 1, D] (video) and
    global [B, 1, D] (text), through the layer helper and the fused op."""
    rng = np.random.default_rng(2)
    B, F, P, D = 2, 3, 5, 16
    S = F * P if gate_shape == "per_frame" else 7
    gshape = (B, F, 1, D) if gate_shape == "per_frame" else (B, 1, D)
    xj, xt = _pair(rng.standard_normal((B, S, D)), dtype)
    yj, yt = _pair(rng.standard_normal((B, S, D)), dtype)
    gj, gt = _pair(rng.standard_normal(gshape), dtype)
    ref = jax_gate_residual_add(xj, yj, gj, fused=True)
    before = adaln.gated_residual.launches
    out = gate_residual_add(xt, yt, gt)
    assert adaln.gated_residual.launches == before
    assert out.dtype == xt.dtype
    _close(out, ref, DTYPES[dtype][2])
