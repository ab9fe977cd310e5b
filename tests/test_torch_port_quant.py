"""The port's W8A8 serving path against orv_tpu's, on the CPU at tiny sizes.

Inputs come from a numpy seed; the JAX side runs its Pallas kernels in
interpret mode (as tests/test_quantize.py does), the port its plain
versions. Tolerances and why:
  * int8 outputs (`modulate_norm_q8`): both sides compute the same f32 value
    in another summation order, so a value at a rounding midpoint may round
    the other way: |xq - ref| <= 1 everywhere and != 0 in at most 1e-3 of
    the entries; xscale to rtol 1e-6 (a few f32 ulps).
  * `quantize_tokens`, `quantize_linear_params` (through the weight bridge)
    and the int32 product of `Int8Dense` on the same int8 inputs: bitwise.
  * attention out: f32 atol 2e-3 (one int8 flip of k, whose mean is summed in
    another order, moves a score by one quantum); bf16 atol 1e-2 (one bf16
    rounding of outputs below ~2).
  * `Int8Dense` out: f32 atol 1e-6; bf16 atol 1e-2 plus one bf16 ulp
    (2^-8) relative, for outputs above 2.
  * DiTBlock and ControlDiT against JAX's quant=True, attn_impl="flash_q8",
    compared against the output's range R = max|ref|. Every difference that
    lands on an int8 rounding midpoint of the next quantization moves a value
    by one quantum (amax/127), and the model carries it on.
      - f32: max error <= 1e-2·R, mean <= 3e-4·R. Measured: one block to
        3.1e-7·R (the same algorithm); the 6-chunk model to 1.2e-3·R and
        7.3e-5·R, where summation-order differences flip a few int8 values.
      - bf16: max error <= 4e-2·R, mean <= 3e-3·R. Measured at most
        2.6e-2·R and 1.9e-3·R. The max is twice that of
        tests/test_torch_port_dit.py's bf16 bound, because the frameworks
        round bf16 at other points (JAX evaluates the tanh-GELU op by op in
        bf16, torch in f32 with one rounding) and such differences flip
        int8 values far more often than f32 ones.
  * The port's quant ControlDiT against its own f32 model: the JAX package's
    2% relative bound (tests/test_quantize.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models.layers import DiTBlock as JaxDiTBlock
from orv_tpu.models.layers import Int8Dense as JaxInt8Dense
from orv_tpu.models.layers import quantize_tokens as jax_quantize_tokens
from orv_tpu.models.quantize import quantize_linear_params as jax_quantize_linear_params
from orv_tpu.ops.adaln import modulate_norm_q8 as jax_modulate_norm_q8
from orv_tpu.ops.attention import flash_attention_q8 as jax_flash_attention_q8
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.layers import DiTBlock, Int8Dense, int8_matmul, quantize_tokens
from orv_tpu_torch.models.quantize import (QUANT_LAYER_NAMES, quantize_linear_params,
                                           quantize_model_)
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.ops import adaln, attention

TINY = dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, in_channels=32,
            out_channels=16, text_embed_dim=32, time_embed_dim=64, max_text_seq_length=8,
            sample_width=16, sample_height=8, visual_guidance=True)
B, F, C, H, W = 1, 3, 16, 8, 16
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _int8_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (diff.max(), (diff != 0).mean())


def _range_close(port, ref, prec):
    got, want = port.float().numpy(), np.asarray(ref, np.float32)
    err, rng = np.abs(got - want), np.abs(want).max()
    if prec == "f32":
        assert err.max() <= 1e-2 * rng and err.mean() <= 3e-4 * rng, (err.max(), err.mean(), rng)
    else:
        assert err.max() <= 4e-2 * rng and err.mean() <= 3e-3 * rng, (err.max(), err.mean(), rng)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_modulate_norm_q8_plain_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    R, S, D = 3, 50, 256
    xj, xt = _pair(2.0 * rng.standard_normal((R, S, D)), dtype)
    sj, st = _pair(0.5 * rng.standard_normal((R, D)), dtype)
    hj, ht = _pair(0.5 * rng.standard_normal((R, D)), dtype)
    nsj, nst = _pair(1.0 + 0.1 * rng.standard_normal(D), "f32")
    nbj, nbt = _pair(0.1 * rng.standard_normal(D), "f32")
    ref_q, ref_s = jax_modulate_norm_q8(xj, sj, hj, nsj, nbj)
    before = adaln.modulate_norm_q8.launches
    xq, xscale = adaln.modulate_norm_q8(xt, st, ht, nst, nbt)
    assert adaln.modulate_norm_q8.launches == before  # CPU: plain version, no launch
    assert xq.dtype == torch.int8 and xq.shape == (R, S, D)
    assert xscale.dtype == torch.float32 and xscale.shape == (R, S)
    _int8_close(xq.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(xscale.numpy(), np.asarray(ref_s), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_modulate_norm_q8_plain_matches_pallas_wide_rows(dtype):
    """Rows 3072 wide, which the CUDA forward takes since it re-reads rows
    from shared memory; S=13 is ragged against the Pallas kernel's 8-row
    blocks."""
    rng = np.random.default_rng(6)
    R, S, D = 2, 13, 3072
    xj, xt = _pair(2.0 * rng.standard_normal((R, S, D)), dtype)
    sj, st = _pair(0.5 * rng.standard_normal((R, D)), dtype)
    hj, ht = _pair(0.5 * rng.standard_normal((R, D)), dtype)
    nsj, nst = _pair(1.0 + 0.1 * rng.standard_normal(D), dtype)
    nbj, nbt = _pair(0.1 * rng.standard_normal(D), dtype)
    ref_q, ref_s = jax_modulate_norm_q8(xj, sj, hj, nsj, nbj)
    before = adaln.modulate_norm_q8.launches
    xq, xscale = adaln.modulate_norm_q8(xt, st, ht, nst, nbt)
    assert adaln.modulate_norm_q8.launches == before  # CPU: plain version, no launch
    assert xq.shape == (R, S, D) and xscale.shape == (R, S)
    _int8_close(xq.numpy(), np.asarray(ref_q))
    np.testing.assert_allclose(xscale.numpy(), np.asarray(ref_s), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq", [128, 300, 1100])  # 1100: two 1024-key scale blocks
def test_flash_attention_q8_plain_matches_pallas(seq, dtype):
    rng = np.random.default_rng(seq)
    shape = (1, 2, seq, 64)
    qj, qt = _pair(rng.standard_normal(shape), dtype)
    kj, kt = _pair(rng.standard_normal(shape) + 0.5, dtype)  # a mean for the smoothing
    vj, vt = _pair(rng.standard_normal(shape), dtype)
    ref = jax_flash_attention_q8(qj, kj, vj)
    before = attention.flash_attention_q8.launches
    out = attention.flash_attention_q8(qt, kt, vt)
    assert attention.flash_attention_q8.launches == before
    assert out.dtype == qt.dtype and out.shape == shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-3 if dtype == "f32" else 1e-2, rtol=0)


def test_prepare_k_q8_blocks():
    """One scale per 1024 keys past S = 1024, one padded block below it."""
    for seq, block, nk in ((100, 128, 1), (300, 384, 1), (1100, 1024, 2)):
        k8, sk_r, block_k = attention.prepare_k_q8(torch.randn(1, 2, seq, 64))
        assert (block_k, tuple(k8.shape), tuple(sk_r.shape)) == (block, (1, 2, nk * block, 64),
                                                                 (2, nk))
        assert k8.dtype == torch.int8 and not k8[:, :, seq:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_tokens_and_int8_dense_match_jax(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 40, 96)), dtype)
    ref_q, ref_s = jax_quantize_tokens(xj)
    xq, xs = quantize_tokens(xt)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(ref_s))

    kernel = (0.05 * rng.standard_normal((96, 128))).astype(np.float32)
    scale = np.maximum(np.abs(kernel).max(0), 1e-8) / np.float32(127.0)
    kq = np.round(kernel / scale).astype(np.int8)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    jd, td = DTYPES[dtype]
    ref = JaxInt8Dense(128, dtype=jd).apply(
        {"params": {"kernel_q8": kq, "kernel_scale": scale, "bias": bias}}, xj)
    layer = Int8Dense(96, 128, dtype=td, device="cpu")
    layer.load_state_dict({"weight_q8": torch.from_numpy(kq.T.copy()),
                           "weight_scale": torch.from_numpy(scale),
                           "bias": torch.from_numpy(bias)})
    # the int32 product of the same int8 operands is exact on both sides
    y32 = int8_matmul(xq.reshape(-1, 96), layer.weight_q8)
    ref32 = jax.lax.dot_general(ref_q.reshape(-1, 96), jnp.asarray(kq), (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(y32.numpy(), np.asarray(ref32))
    with torch.no_grad():
        out, again = layer(xt), layer((xq, xs))  # again: the pre-quantized input
    assert out.dtype == td and out.shape == (2, 40, 128)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-6 if dtype == "f32" else 1e-2,
                               rtol=0 if dtype == "f32" else 2.0 ** -8)
    torch.testing.assert_close(again, out, atol=0, rtol=0)


def _config(regime):
    kw = dict(TINY, modulate_encoder_hidden_states=regime == "6chunk")
    return JaxDiTConfig(**kw), DiTConfig(**kw)


def _inputs():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(B, F, 2 * C, H, W), enc=f(B, 8, 32), t=np.array([500], np.int32),
                actions=0.5 * f(B, 8, 7), depths=f(B, F, 2 * C, H, W),
                labels=f(B, F, 2 * C, H, W))


def _randomize(params, seed):
    """Every leaf -> seeded random f32: norm scales ~1, kernels ~N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("scale", "norm_scale"):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name in ("kernel", "linear_kernel"):
            v = rng.standard_normal(shape) / np.sqrt(shape[-2])
        else:
            v = 0.2 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


_PARAMS = {}


def jax_params(regime):
    """(float tree, the tree quantized by orv_tpu), seeded random."""
    if regime not in _PARAMS:
        jcfg, _ = _config(regime)
        inp = _inputs()
        p = jax.eval_shape(lambda: JaxControlDiT(jcfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), inp["x"], inp["enc"], inp["t"], actions=inp["actions"],
            depths=inp["depths"], labels=inp["labels"]))
        p = _randomize(p, seed=10 + len(_PARAMS))
        _PARAMS[regime] = (p, jax.device_get(jax_quantize_linear_params(p)))
    return _PARAMS[regime]


@pytest.mark.parametrize("regime", ["3chunk", "6chunk"])
def test_quantize_linear_params_matches_bridge(regime):
    """Quantizing the bridged float weights in the port gives, bit for bit,
    the bridge of the tree orv_tpu quantized; it loads into the quant model."""
    _, tcfg = _config(regime)
    params, qparams = jax_params(regime)
    got = quantize_linear_params(dit_params_from_jax(params, tcfg))
    want = dit_params_from_jax(qparams, tcfg)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    n_q8 = [k for k in want if k.endswith(".weight_q8")]
    assert len(n_q8) == len(QUANT_LAYER_NAMES) * tcfg.num_layers
    assert all(want[k].dtype == torch.int8 for k in n_q8)
    ControlDiT(tcfg, device="cpu", quant=True, attn_impl="flash_q8").load_state_dict(
        want, strict=True)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("regime", ["3chunk", "6chunk"])
def test_quant_dit_block_matches_jax(regime, prec):
    jd, td = DTYPES[prec]
    _, tcfg = _config(regime)
    _, qparams = jax_params(regime)
    blk0 = jax.tree_util.tree_map(lambda a: a[0], qparams["params"]["blocks"]["block"])
    kw = dict(dim=64, heads=4, head_dim=16, time_embed_dim=64, modulate_enc=regime == "6chunk")
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, F * 32, 64)).astype(np.float32)
    enc = rng.standard_normal((B, 8, 64)).astype(np.float32)
    temb = rng.standard_normal((B, 64)).astype(np.float32)
    act = rng.standard_normal((B, F, 64)).astype(np.float32)

    jblock = JaxDiTBlock(**kw, attn_impl="flash_q8", quant=True, dtype=jd)
    cast = lambda a: jnp.asarray(a, jd)
    ref_h, ref_e = jax.jit(lambda p, h, e, t, a: jblock.apply({"params": p}, h, e, t,
                                                              action_emb=a))(
        blk0, cast(hidden), cast(enc), cast(temb), cast(act))

    block = DiTBlock(**kw, quant=True, dtype=td, device="cpu")
    prefix = "transformer_blocks.0."
    block.load_state_dict({k[len(prefix):]: v for k, v in dit_params_from_jax(qparams, tcfg).items()
                           if k.startswith(prefix)}, strict=True)
    tt = lambda a: torch.from_numpy(a).to(td)
    counts = (attention.flash_attention_q8.launches, adaln.modulate_norm_q8.launches)
    with torch.no_grad():
        out_h, out_e = block(tt(hidden), tt(enc), tt(temb), tt(act))
    assert counts == (attention.flash_attention_q8.launches, adaln.modulate_norm_q8.launches)
    _range_close(out_h, ref_h, prec)
    _range_close(out_e, ref_e, prec)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("regime", ["3chunk", "6chunk"])
def test_quant_control_dit_matches_jax(regime, prec):
    jd, td = DTYPES[prec]
    jcfg, tcfg = _config(regime)
    _, qparams = jax_params(regime)
    inp = _inputs()
    jmodel = JaxControlDiT(jcfg, dtype=jd, attn_impl="flash_q8", quant=True)
    ref, _, _ = jax.jit(lambda p, x, e, t, a, d, lab: jmodel.apply(
        p, x, e, t, actions=a, depths=d, labels=lab))(
        qparams, inp["x"], inp["enc"], inp["t"], inp["actions"], inp["depths"], inp["labels"])

    model = ControlDiT(tcfg, dtype=td, device="cpu", quant=True, attn_impl="flash_q8")
    model.load_state_dict(dit_params_from_jax(qparams, tcfg), strict=True)
    tt = {k: torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        out = model(tt["x"], tt["enc"], tt["t"], actions=tt["actions"], depths=tt["depths"],
                    labels=tt["labels"])
    assert out.shape == (B, F, C, H, W) and out.dtype == td
    assert torch.isfinite(out.float()).all()
    _range_close(out, ref, prec)


def test_quant_control_dit_close_to_its_bf16_model():
    """W8A8 against the port's own unquantized model (f32 activations): the
    2% relative bound of tests/test_quantize.py. Quantizing in place gives
    the model that loads the quantized state dict."""
    _, tcfg = _config("6chunk")
    params, _ = jax_params("6chunk")
    sd = dit_params_from_jax(params, tcfg)
    ref_model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    ref_model.load_state_dict(sd)
    qmodel = ControlDiT(tcfg, dtype=torch.float32, device="cpu", quant=True,
                        attn_impl="flash_q8")
    qmodel.load_state_dict(quantize_linear_params(sd), strict=True)
    tt = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    args = (tt["x"], tt["enc"], tt["t"])
    kw = dict(actions=tt["actions"], depths=tt["depths"], labels=tt["labels"])
    with torch.no_grad():
        ref, out = ref_model(*args, **kw), qmodel(*args, **kw)
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        assert rel < 0.02, rel
        quantize_model_(ref_model)
        assert ref_model.quant and ref_model.attn_impl == "flash_q8"
        torch.testing.assert_close(ref_model(*args, **kw), out, atol=0, rtol=0)


def test_quant_model_without_int8_weights_raises():
    _, tcfg = _config("6chunk")
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu", quant=True,
                       attn_impl="flash_q8")
    tt = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with pytest.raises(RuntimeError, match="int8 weights"), torch.no_grad():
        model(tt["x"], tt["enc"], tt["t"], actions=tt["actions"], depths=tt["depths"],
              labels=tt["labels"])
    # the port builds only the two pairings the JAX package serves with
    for quant, attn_impl in ((False, "flash_q8"), (True, "flash"), (False, "xla")):
        with pytest.raises(ValueError, match="attn_impl"):
            ControlDiT(tcfg, device="cpu", quant=quant, attn_impl=attn_impl)
