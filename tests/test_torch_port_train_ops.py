"""The port's differentiable kernel wrappers against orv_tpu's custom VJPs.

Each of the three autograd Functions of `orv_tpu_torch.ops` runs, on the
CPU, its plain forward and its plain backward, the algorithm the CUDA
kernels implement. Its gradients are held against `jax.grad` through the
JAX op, whose Pallas kernels (forward and backward) run in interpret mode
on the CPU, as tests/test_attention.py runs them. Inputs are made from a
seed with numpy and handed to both.

Shapes: ragged S (200, 300: not a multiple of the 128-row Pallas blocks or
the 64-row CUDA tiles), H = 2, D = 64 for attention; adaLN x [2, S, 128].
Tolerances, each against the reference output's own RMS:
  f32: max error <= 1e-4 RMS (only the summation order differs; measured
  at most 1.2e-5);
  bf16: max error <= 4e-2 RMS and RMS error <= 2e-3 RMS. Both packages
  round at the same points (bf16 inputs, ds rounded to bf16, one rounding
  per output), so what is left is an ulp where a sum in another order lands
  on the other side of a bf16 midpoint; one ulp of an element four times
  the RMS is 1.6e-2 RMS (measured: at most 1.05e-2 and 1.3e-4). A wrong
  formula gives errors of order RMS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.ops import adaln as jax_adaln
from orv_tpu.ops.attention import attention_with_lse
from orv_tpu.ops.attention import flash_attention as jax_flash_attention
from orv_tpu_torch.ops import adaln, attention

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, prec):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    if prec == "f32":
        assert err.max() <= 1e-4 * rms, (err.max(), rms)
    else:
        assert err.max() <= 4e-2 * rms and np.sqrt(np.mean(err ** 2)) <= 2e-3 * rms, (
            err.max(), np.sqrt(np.mean(err ** 2)), rms)


def _pair(a, prec):
    """The same numpy values as a JAX array and a leaf torch tensor. The
    torch side copies: a tensor that shares the numpy buffer with a CPU JAX
    array read wrong values now and then while the JAX computation ran."""
    jdt, tdt = DTYPES[prec]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt).requires_grad_()


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("S", [200, 300])
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_attention_grads_match_jax(S, prec, with_lse):
    """Without lse: `flash_attention(static_max=24.0)`, loss on out. With it:
    `attention_with_lse(impl="flash", static_max=24.0)`, loss on both outputs,
    so the lse cotangent shifts the backward's delta."""
    rng = np.random.default_rng(S)
    q, k, v, do = (rng.standard_normal((1, 2, S, 64)).astype(np.float32) for _ in range(4))
    dl = rng.standard_normal((1, 2, S)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, prec) for a in (q, k, v))

    def jloss(q, k, v):
        if with_lse:
            out, lse = attention_with_lse(q, k, v, impl="flash", static_max=24.0)
            return jnp.sum(out.astype(jnp.float32) * do) + jnp.sum(lse * dl)
        out = jax_flash_attention(q, k, v, block_q=128, block_k=128, static_max=24.0)
        return jnp.sum(out.astype(jnp.float32) * do)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out, lse = attention.flash_attention(tq, tk, tv, static_max=24.0)
    loss = (out.float() * torch.tensor(do)).sum()
    if with_lse:
        loss = loss + (lse * torch.tensor(dl)).sum()
    loss.backward()
    for leaf, ref in zip((tq, tk, tv), want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, ref, prec)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("S", [200, 300])
def test_flash_attention_online_grads_match_jax(S, prec):
    """The online-softmax forward (`static_max=None`, the default) under the
    same backward: loss on out and lse against `attention_with_lse(impl=
    "flash")`, JAX's `_flash_lse` with its online Pallas kernel. In f32, q
    and k are scaled so that logits pass the static bound of 24. In bf16
    they stay at unit scale: sharper softmaxes give gradient elements many
    times the RMS, whose one-ulp flips exceed the bf16 bound."""
    rng = np.random.default_rng(S + 3)
    qk_scale = 3.0 if prec == "f32" else 1.0
    q, k = (qk_scale * rng.standard_normal((1, 2, S, 64)).astype(np.float32) for _ in range(2))
    v, do = (rng.standard_normal((1, 2, S, 64)).astype(np.float32) for _ in range(2))
    dl = rng.standard_normal((1, 2, S)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, prec) for a in (q, k, v))

    def jloss(q, k, v):
        out, lse = attention_with_lse(q, k, v, impl="flash")
        return jnp.sum(out.astype(jnp.float32) * do) + jnp.sum(lse * dl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out, lse = attention.flash_attention(tq, tk, tv)
    if prec == "f32":
        assert lse.max() > 24.0
    ((out.float() * torch.tensor(do)).sum() + (lse * torch.tensor(dl)).sum()).backward()
    for leaf, ref in zip((tq, tk, tv), want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, ref, prec)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("S", [200, 300])
def test_modulate_norm_grads_match_jax(S, prec):
    """All five inputs; x, scale and shift in the working dtype, the norm's
    scale and bias in f32 as the f32 parameters give them."""
    rng = np.random.default_rng(S + 1)
    R, D = 2, 128
    x = (1.5 * rng.standard_normal((R, S, D)) + 0.3).astype(np.float32)
    scale, shift = (0.3 * rng.standard_normal((R, D)).astype(np.float32) for _ in range(2))
    ns = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    nb = (0.2 * rng.standard_normal(D)).astype(np.float32)
    do = rng.standard_normal((R, S, D)).astype(np.float32)
    (jx, tx), (js, ts), (jh, th) = (_pair(a, prec) for a in (x, scale, shift))
    (jns, tns), (jnb, tnb) = (_pair(a, "f32") for a in (ns, nb))

    want = jax.grad(lambda *a: jnp.sum(jax_adaln.modulate_norm(*a).astype(jnp.float32) * do),
                    argnums=(0, 1, 2, 3, 4))(jx, js, jh, jns, jnb)
    out = adaln.modulate_norm(tx, ts, th, tns, tnb)
    (out.float() * torch.tensor(do)).sum().backward()
    for leaf, ref in zip((tx, ts, th, tns, tnb), want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, ref, prec)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("S", [200, 300])
def test_gated_residual_grads_match_jax(S, prec):
    rng = np.random.default_rng(S + 2)
    R, D = 3, 64
    x, y, do = (rng.standard_normal((R, S, D)).astype(np.float32) for _ in range(3))
    gate = rng.standard_normal((R, D)).astype(np.float32)
    (jx, tx), (jy, ty), (jg, tg) = (_pair(a, prec) for a in (x, y, gate))

    want = jax.grad(lambda *a: jnp.sum(jax_adaln.gated_residual(*a).astype(jnp.float32) * do),
                    argnums=(0, 1, 2))(jx, jy, jg)
    out = adaln.gated_residual(tx, ty, tg)
    (out.float() * torch.tensor(do)).sum().backward()
    for leaf, ref in zip((tx, ty, tg), want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, ref, prec)
