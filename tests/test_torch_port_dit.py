"""The port's DiT layers and ControlDiT against orv_tpu at a tiny config.

Every parameter of the JAX model is first filled with seeded random values
(the JAX init zeroes the combine linear and adaLN biases, which would hide
faults), then carried to the port by `dit_params_from_jax`. Two regimes:
  (a) f32, JAX with attn_impl="xla" and ORV_TPU_FUSED_ADALN=0: atol 1e-4;
  (b) bf16, JAX with attn_impl="flash" and ORV_TPU_FUSED_ADALN=force (the
      fused semantics the port implements): compared in f32 against the
      output's range R = max|ref|: max error <= 2e-2·R and mean error
      <= 3e-3·R. bf16 activations pass through two blocks, and the two
      frameworks round matmul outputs and elementwise chains at different
      points (measured: max 1.0e-2·R, mean 1.5e-3·R). A wrong formula
      gives errors of order R.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models.layers import DiTBlock as JaxDiTBlock
from orv_tpu.models.weights import export_dit_state_dict
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.layers import DiTBlock
from orv_tpu_torch.models.weights import dit_params_from_jax
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

TINY = dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, in_channels=32,
            out_channels=16, text_embed_dim=32, time_embed_dim=64, max_text_seq_length=8,
            sample_width=16, sample_height=8)
B, F, C, H, W = 1, 3, 16, 8, 16
PREC = {
    "f32": dict(jdt=jnp.float32, tdt=torch.float32, impl="xla", fused="0"),
    "bf16": dict(jdt=jnp.bfloat16, tdt=torch.bfloat16, impl="flash", fused="force"),
}
CASES = [(r, g) for r in ("3chunk", "6chunk") for g in (False, True)]


def randomize(params, seed):
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


def _config(regime, guidance):
    kw = dict(TINY, modulate_encoder_hidden_states=regime == "6chunk", visual_guidance=guidance)
    return JaxDiTConfig(**kw), DiTConfig(**kw)


def _inputs(guidance):
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = dict(x=f(B, F, 2 * C, H, W), enc=f(B, 8, 32), t=np.array([500], np.int32),
             actions=0.5 * f(B, 8, 7))
    if guidance:
        x.update(depths=f(B, F, 2 * C, H, W), labels=f(B, F, 2 * C, H, W))
    return x


_PARAMS = {}


def jax_params(regime, guidance):
    key = (regime, guidance)
    if key not in _PARAMS:
        jcfg, _ = _config(regime, guidance)
        inp = _inputs(guidance)
        extra = dict(depths=inp["depths"], labels=inp["labels"]) if guidance else {}
        # the param tree's structure from a traced init, its values seeded random
        p = jax.eval_shape(lambda: JaxControlDiT(jcfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), inp["x"], inp["enc"], inp["t"], actions=inp["actions"],
            **extra))
        _PARAMS[key] = randomize(p, seed=len(_PARAMS))
    return _PARAMS[key]


def _close(port, ref, prec):
    got, want = port.float().numpy(), np.asarray(ref, np.float32)
    if prec == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        return
    err, rng = np.abs(got - want), np.abs(want).max()
    assert err.max() <= 2e-2 * rng and err.mean() <= 3e-3 * rng, (err.max(), err.mean(), rng)


@pytest.mark.parametrize("regime,guidance", CASES)
def test_dit_params_from_jax_matches_export(regime, guidance):
    """The bridge emits the same keys and values as the JAX exporter, and
    they load into the port's ControlDiT with nothing missing or left over."""
    jcfg, tcfg = _config(regime, guidance)
    params = jax_params(regime, guidance)
    sd = dit_params_from_jax(params, tcfg)
    ref = export_dit_state_dict(params, jcfg)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    ControlDiT(tcfg, device="cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("actions", [True, False])
@pytest.mark.parametrize("regime", ["3chunk", "6chunk"])
def test_dit_block_matches_jax(regime, actions, prec, monkeypatch):
    """One DiTBlock (AdaLNZero with and without per-frame actions,
    JointAttention, FeedForward, the gated residuals) on random tokens."""
    pr = PREC[prec]
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", pr["fused"])
    _, tcfg = _config(regime, False)
    params = jax_params(regime, False)
    blk0 = jax.tree_util.tree_map(lambda a: a[0], params["params"]["blocks"]["block"])
    kw = dict(dim=64, heads=4, head_dim=16, time_embed_dim=64,
              modulate_enc=regime == "6chunk")
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, F * 32, 64)).astype(np.float32)
    enc = rng.standard_normal((B, 8, 64)).astype(np.float32)
    temb = rng.standard_normal((B, 64)).astype(np.float32)
    act = rng.standard_normal((B, F, 64)).astype(np.float32) if actions else None

    jblock = JaxDiTBlock(**kw, attn_impl=pr["impl"], dtype=pr["jdt"])
    cast = lambda a: None if a is None else jnp.asarray(a, pr["jdt"])
    ref_h, ref_e = jax.jit(lambda p, h, e, t, a: jblock.apply({"params": p}, h, e, t,
                                                              action_emb=a))(
        blk0, cast(hidden), cast(enc), cast(temb), cast(act))

    block = DiTBlock(**kw, dtype=pr["tdt"], device="cpu")
    prefix = "transformer_blocks.0."
    block.load_state_dict({k[len(prefix):]: v for k, v in dit_params_from_jax(params, tcfg).items()
                           if k.startswith(prefix)}, strict=True)
    tt = lambda a: None if a is None else torch.from_numpy(a).to(pr["tdt"])
    with torch.no_grad():
        out_h, out_e = block(tt(hidden), tt(enc), tt(temb), tt(act))
    _close(out_h, ref_h, prec)
    _close(out_e, ref_e, prec)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("regime,guidance,actions",
                         [c + (True,) for c in CASES] + [("3chunk", True, False),
                                                         ("6chunk", True, False)])
def test_control_dit_matches_jax(regime, guidance, actions, prec, monkeypatch):
    """Without actions the adaLN and the output norm modulate per sample
    instead of per frame."""
    pr = PREC[prec]
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", pr["fused"])
    jcfg, tcfg = _config(regime, guidance)
    params = jax_params(regime, guidance)
    inp = _inputs(guidance)
    if not actions:
        inp["actions"] = None
    ctrl = ("depths", "labels") if guidance else ()

    jmodel = JaxControlDiT(jcfg, dtype=pr["jdt"], attn_impl=pr["impl"])
    ref, _, _ = jax.jit(lambda p, x, e, t, a, c: jmodel.apply(
        p, x, e, t, actions=a, **dict(zip(ctrl, c))))(
        params, inp["x"], inp["enc"], inp["t"], inp["actions"], tuple(inp[k] for k in ctrl))

    model = ControlDiT(tcfg, dtype=pr["tdt"], device="cpu")
    model.load_state_dict(dit_params_from_jax(params, tcfg))
    tt = {k: None if v is None else torch.from_numpy(v) for k, v in inp.items()}
    with torch.no_grad():
        out = model(tt["x"], tt["enc"], tt["t"], actions=tt["actions"],
                    **{k: tt[k] for k in ctrl})
    assert out.shape == (B, F, C, H, W) and out.dtype == pr["tdt"]
    assert torch.isfinite(out.float()).all()
    _close(out, ref, prec)
    if guidance:  # the sampler's control cache gives the same prediction
        with torch.no_grad():
            cache = model(None, tt["enc"], None, depths=tt["depths"], labels=tt["labels"],
                          controls_only=True)
            again = model(tt["x"], tt["enc"], tt["t"], actions=tt["actions"],
                          control_cache=cache)
        torch.testing.assert_close(again, out, atol=0, rtol=0)


def test_control_dit_unported_options_raise():
    """The JAX config's use_learned_positional_embeddings is read by no JAX
    module: the port refuses it by name rather than ignore it. Multiview,
    RoPE, patch_size_t and the joint final norm are built
    (tests/test_torch_port_model_surface.py)."""
    with pytest.raises(NotImplementedError, match="use_learned_positional_embeddings"):
        ControlDiT(dataclasses.replace(DiTConfig(**TINY), use_learned_positional_embeddings=True),
                   device="cpu")
