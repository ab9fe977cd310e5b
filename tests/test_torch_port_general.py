"""The general route on the CPU: its dispatch, and the plain versions the general
kernels are held to, against orv_tpu.

The general CUDA kernels (orv_tpu_torch/ops/csrc/flash_attn_general*.cu,
adaln_general.cu and gated_residual.cu's f32 instance) take what the Hopper
kernels do not: f32, head dims other than 64 and adaLN widths that are not
multiples of 128, as the JAX Pallas kernels take any dtype and width. Here,
without a card:

* the dispatch functions (`attention.plan`, `adaln.plan_modulate_norm`,
  `adaln.plan_gated_residual`), pure functions of the operands' dtype and
  shape, on meta tensors: "hopper", "general", or a ValueError naming both
  limits;
* the general wrappers refuse CPU tensors (they launch CUDA kernels), while
  the public ops run their plain versions there and launch nothing;
* the plain attention forward (both modes) and backward (with an lse
  cotangent, Sq != Skv) in f32 at head dims 16 and 32, and `modulate_norm`
  and its backward at D = 40, against the JAX package's Pallas kernels in
  interpret mode and their custom VJPs. Tolerance: 1e-4 of the reference's
  RMS (f32; only the summation order differs).

The kernels themselves are held against these plain versions on the card by
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.ops import adaln as jax_adaln
from orv_tpu.ops.attention import attention_with_lse
from orv_tpu_torch.ops import adaln, attention
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

BF16, F32 = torch.bfloat16, torch.float32


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,dh,route", [
    (BF16, 64, "hopper"), (F32, 64, "general"), (BF16, 16, "general"), (BF16, 32, "general"),
    (BF16, 128, "general"), (F32, 8, "general"), (F32, 40, "general")])
def test_attention_plan(dtype, dh, route):
    q, k = _meta((1, 2, 5, dh), dtype), _meta((1, 2, 7, dh), dtype)
    assert attention.plan(q, k) == route


@pytest.mark.parametrize("dtype,dh", [(F32, 12), (BF16, 12), (F32, 136), (torch.float16, 64)])
def test_attention_plan_raises_naming_both_limits(dtype, dh):
    q = _meta((1, 2, 5, dh), dtype)
    with pytest.raises(ValueError, match=r"bf16 q and k at head dim 64 \(the Hopper kernels\) "
                                         r"or f32 or bf16 .* multiple of 8 up to 128"):
        attention.plan(q, q)


@pytest.mark.parametrize("dtype,D,route", [
    (BF16, 128, "hopper"), (BF16, 1920, "hopper"), (BF16, 4096, "hopper"),
    (BF16, 32, "general"), (BF16, 4224, "general"), (F32, 1920, "general"), (F32, 40, "general")])
def test_modulate_norm_plan(dtype, D, route):
    assert adaln.plan_modulate_norm(_meta((2, 9, D), dtype)) == route


@pytest.mark.parametrize("dtype,D", [(F32, 36), (BF16, 36), (torch.float16, 128)])
def test_modulate_norm_plan_raises_naming_both_limits(dtype, D):
    with pytest.raises(ValueError, match=r"D % 128 == 0 and D <= 4096 \(the Hopper kernels\) or "
                                         r"f32 or bf16 x with D % 8 == 0 \(the general"):
        adaln.plan_modulate_norm(_meta((2, 9, D), dtype))


@pytest.mark.parametrize("dtype,D,backward,route", [
    (BF16, 32, False, "hopper"), (F32, 32, False, "general"), (BF16, 16384, True, "hopper"),
    (BF16, 16392, True, "general"), (F32, 1920, True, "general")])
def test_gated_residual_plan(dtype, D, backward, route):
    assert adaln.plan_gated_residual(_meta((2, 9, D), dtype), backward=backward) == route


@pytest.mark.parametrize("dtype,D,backward", [(F32, 36, False), (BF16, 36, True),
                                              (BF16, 36, False)])
def test_gated_residual_plan_raises_naming_both_limits(dtype, D, backward):
    with pytest.raises(ValueError, match=r"\(the Hopper kernel\) or .*D % 8 == 0 \(the general "
                                         r"kernel\)"):
        adaln.plan_gated_residual(_meta((2, 9, D), dtype), backward=backward)


def test_general_wrappers_refuse_cpu_tensors():
    """The general entry points launch CUDA kernels: on CPU tensors each
    raises before any build, and the public ops run their plain versions
    without a launch."""
    q = torch.randn(1, 2, 9, 16)
    x = torch.randn(2, 9, 40)
    rows = torch.randn(2, 40)
    row = torch.zeros(1, 2, 9)  # an lse or a delta
    calls = [lambda: attention.flash_attention_general_kernel(q, q, q, 0.25, None),
             lambda: attention.flash_attention_general_bwd_dq(q, q, q, q, row, q, 0.25),
             lambda: attention.flash_attention_general_bwd_dkv(q, q, q, q, row, row, 0.25),
             lambda: adaln.modulate_norm_general(x, rows, rows, rows[0], rows[0], 1e-5),
             lambda: adaln.modulate_norm_bwd_general(x, x, rows, rows[0]),
             lambda: adaln.gated_residual_general(x, x, rows),
             lambda: adaln.gated_residual_bwd_general(x, x, rows)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    before = [k.launches for k in (attention.flash_attention_general_kernel,
                                   adaln.modulate_norm_general, adaln.gated_residual_general)]
    attention.flash_attention(q, q, q)
    adaln.modulate_norm(x, rows, rows, rows[0], rows[0])
    adaln.gated_residual(x, x, rows)
    assert before == [k.launches for k in (attention.flash_attention_general_kernel,
                                           adaln.modulate_norm_general,
                                           adaln.gated_residual_general)]


def _close(got, want, rel=1e-4):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rms = np.sqrt(np.mean(want ** 2))
    assert np.abs(got - want).max() <= rel * rms, (np.abs(got - want).max(), rms)


def _inputs(sq, skv, dh, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((1, 2, sq, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 2, skv, dh)).astype(np.float32) for _ in range(2))
    return q, k, v, do, rng.standard_normal((1, 2, sq)).astype(np.float32)


@pytest.mark.parametrize("static_max", [24.0, None])
@pytest.mark.parametrize("dh", [16, 32])
@pytest.mark.parametrize("sq,skv", [(77, 130), (130, 77)])
def test_plain_attention_at_narrow_heads_matches_pallas(sq, skv, dh, static_max):
    """The forward the general kernel computes, in f32 at head dims 16 and
    32, both modes, Sq != Skv: out and lse against `attention_with_lse`'s
    Pallas kernels."""
    q, k, v, _, _ = _inputs(sq, skv, dh, sq + skv + dh)
    ref_out, ref_lse = attention_with_lse(*(jnp.asarray(a) for a in (q, k, v)), impl="flash",
                                          static_max=static_max)
    out, lse = attention.flash_attention(*(torch.tensor(a) for a in (q, k, v)),
                                         static_max=static_max)
    assert out.dtype == F32 and out.shape == (1, 2, sq, dh) and lse.shape == (1, 2, sq)
    _close(out, ref_out)
    _close(lse, ref_lse)


@pytest.mark.parametrize("dh", [16, 32])
@pytest.mark.parametrize("sq,skv", [(77, 130), (130, 77)])
def test_plain_attention_backward_at_narrow_heads_matches_pallas(sq, skv, dh):
    """The backward the general dq and dk/dv kernels compute, in f32 at head
    dims 16 and 32 with an lse cotangent and Sq != Skv: the plain backward
    (autograd through `flash_attention` on the CPU) against `jax.grad`
    through the Pallas forward and backward kernels."""
    q, k, v, do, dl = _inputs(sq, skv, dh, 7 * sq + skv + dh)

    def jloss(q, k, v):
        out, lse = attention_with_lse(q, k, v, impl="flash")
        return jnp.sum(out * do) + jnp.sum(lse * dl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    out, lse = attention.flash_attention(*leaves)
    ((out * torch.tensor(do)).sum() + (lse * torch.tensor(dl)).sum()).backward()
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.dtype == F32 and leaf.grad.shape == leaf.shape
        _close(leaf.grad, ref)


def test_modulate_norm_at_d40_matches_jax():
    """`modulate_norm` and its backward at D = 40 (a multiple of 8, not of
    128: the general kernels' width) in f32, all five inputs' gradients,
    against JAX's custom VJP (its Pallas forward and backward)."""
    rng = np.random.default_rng(40)
    R, S, D = 2, 37, 40
    x = (1.5 * rng.standard_normal((R, S, D)) + 0.3).astype(np.float32)
    scale, shift = (0.3 * rng.standard_normal((R, D)).astype(np.float32) for _ in range(2))
    ns = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    nb = (0.2 * rng.standard_normal(D)).astype(np.float32)
    do = rng.standard_normal((R, S, D)).astype(np.float32)
    args = (x, scale, shift, ns, nb)
    ref = jax_adaln.modulate_norm(*(jnp.asarray(a) for a in args))
    want = jax.grad(lambda *a: jnp.sum(jax_adaln.modulate_norm(*a) * do),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args))
    leaves = [torch.tensor(a).requires_grad_() for a in args]
    out = adaln.modulate_norm(*leaves)
    _close(out, ref)
    (out * torch.tensor(do)).sum().backward()
    for leaf, g in zip(leaves, want):
        assert leaf.grad.dtype == F32 and leaf.grad.shape == leaf.shape
        _close(leaf.grad, g)
