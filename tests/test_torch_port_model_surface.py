"""The rest of the DiT's surface in the port against orv_tpu, on the CPU.

RoPE (the 1.0 crop-grid and 1.5 slice tables, `apply_rotary_emb`), the
CogVideoX 1.5 family (`patch_size_t` 2 with RoPE and the joint final norm),
multiview generation (`MVBlock`, V = 2, with and without `modulate_enc`,
bf16 and W8A8), PAB attention broadcast (`pab_full_flags`, the model's
attention cache, a PAB DDIM sample in bf16 and W8A8), `ensure_mv_blocks`
and the weight bridge in its three directions, at a tiny config (2 layers,
head dim 16). Every JAX parameter is filled with seeded random values
(JAX zero-inits the MVBlock's `proj_out`, which would hide its path) and
carried to the port by `dit_params_from_jax`.

Tolerances, as tests/test_torch_port_dit.py and test_torch_port_quant.py
hold the single-view model:
  * the rotary tables: 1e-6 (both float64 numpy, cast to f32);
    `apply_rotary_emb`: 1e-6 in f32, one bf16 rounding in bf16;
  * ControlDiT in f32 (JAX attn_impl="xla", ORV_TPU_FUSED_ADALN=0): 1e-4;
    in bf16 (JAX "flash", fused adaLN forced): max 2e-2 and mean 3e-3 of
    the output's range R;
  * one MVBlock in f32: 1e-5·R (measured 4e-7·R: the same algorithm); in
    W8A8 the single-view block's bound, max 1e-2·R and mean 3e-4·R (a
    summation order under jit flipped one int8 value: max 3.2e-3·R);
  * W8A8 multiview (JAX quant=True, "flash_q8"): f32 max 1e-2·R, mean
    1e-3·R; bf16 max 4e-2·R, mean 3e-3·R. Summation-order differences in
    f32 flip a few int8 values; in the cross-view attention a flipped k
    value moves the scores of every query of the frame, so the flips spread
    over more of the output than in the single-view model (measured f32:
    max 3.3e-3·R, mean 4.3e-4·R at 3 chunks, 1.3e-3·R and 1.1e-4·R at 6;
    with the MVBlocks' proj_out zeroed, 8.8e-4·R and 1.3e-6·R);
  * a PAB DDIM sample against JAX's PAB sampler with the same flags: the
    batch path's 2e-2·R max and 3e-3·R mean. 6 DDIM steps at a guidance of
    2 on the 6-chunk 5b model: measured 1.1e-2·R and 2.1e-3·R, as the same
    steps without PAB (1.1e-2·R, 2.0e-3·R); at a guidance of 3 the bf16
    drift alone, without PAB, reaches 1.8e-2·R. W8A8 on the RoPE model:
    6.6e-3·R and 1.3e-3·R;
  * flags, `ensure_mv_blocks` and the weight bridge: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models import weights as jweights
from orv_tpu.models.layers import MVBlock as JaxMVBlock
from orv_tpu.models.quantize import quantize_linear_params as jax_quantize_linear_params
from orv_tpu.pipelines import sample as jsample
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu.utils import embeddings as jemb
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.layers import MVBlock
from orv_tpu_torch.models.quantize import quantize_linear_params, quantize_model_
from orv_tpu_torch.models.weights import (dit_params_from_jax, dit_state_dict_from_diffusers,
                                          ensure_mv_blocks, read_safetensors)
from orv_tpu_torch.pipelines import sample as tsample
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils import embeddings as temb
from orv_tpu_torch.utils.checkpoint import export_pretrained
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

TINY = dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, in_channels=32,
            out_channels=16, text_embed_dim=32, time_embed_dim=64, max_text_seq_length=8,
            sample_width=16, sample_height=8)
C, H, W = 16, 8, 16
# each case: the config's extra fields, latent frames, views, actions' raw frames
CASES = {
    "rope": (dict(use_rotary_positional_embeddings=True), 3, 1, 8),
    "5b": (dict(patch_size_t=2, use_rotary_positional_embeddings=True, joint_final_norm=True,
                modulate_encoder_hidden_states=True), 4, 1, 15),
    "mv_3chunk": (dict(multiview=True, max_n_view=2), 3, 2, 8),
    "mv_6chunk": (dict(multiview=True, max_n_view=2, modulate_encoder_hidden_states=True,
                       visual_guidance=True), 3, 2, 8),
}
PREC = {
    "f32": dict(jdt=jnp.float32, tdt=torch.float32, impl="xla", fused="0"),
    "bf16": dict(jdt=jnp.bfloat16, tdt=torch.bfloat16, impl="flash", fused="force"),
}


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


def configs(case):
    kw = dict(TINY, **CASES[case][0])
    return JaxDiTConfig(**kw), DiTConfig(**kw)


def inputs(case, B=1):
    """Model inputs from a numpy seed, and the case's rotary tables (numpy)."""
    _, F, V, f_raw = CASES[case]
    jcfg, _ = configs(case)
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = dict(x=f(B, V * F, 2 * C, H, W), enc=f(B, 8, 32), t=np.array([500] * B, np.int32),
             actions=0.5 * f(B, f_raw, 7))
    if jcfg.visual_guidance:
        x.update(depths=f(B, V * F, 2 * C, H, W), labels=f(B, V * F, 2 * C, H, W))
    rope = None
    if jcfg.use_rotary_positional_embeddings:
        rope = tuple(np.asarray(a) for a in jemb.prepare_rotary_positional_embeddings(
            height=8 * H, width=8 * W, num_frames=F, patch_size_t=jcfg.patch_size_t,
            attention_head_dim=jcfg.attention_head_dim))
    return x, rope


_PARAMS = {}


def jax_params(case):
    """(float tree, the tree quantized by orv_tpu), seeded random."""
    if case not in _PARAMS:
        jcfg, _ = configs(case)
        inp, rope = inputs(case)
        ctrl = {k: inp[k] for k in ("depths", "labels") if k in inp}
        p = jax.eval_shape(lambda: JaxControlDiT(jcfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), inp["x"], inp["enc"], inp["t"], actions=inp["actions"],
            image_rotary_emb=rope, num_views=CASES[case][2], **ctrl))
        p = randomize(p, seed=20 + list(CASES).index(case))
        _PARAMS[case] = (p, jax.device_get(jax_quantize_linear_params(p)))
    return _PARAMS[case]


def range_close(port, ref, max_rel, mean_rel):
    got, want = port.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, rng = np.abs(got - want), np.abs(want).max()
    assert err.max() <= max_rel * rng and err.mean() <= mean_rel * rng, (
        err.max() / rng, err.mean() / rng)


# -- RoPE -------------------------------------------------------------------------

@pytest.mark.parametrize("hw,frames,pt", [((320, 480), 13, None), ((480, 720), 13, None),
                                          ((256, 384), 7, None), ((320, 480), 22, 2),
                                          ((320, 480), 21, 2), ((64, 128), 4, 2)])
def test_rotary_tables_match_jax(hw, frames, pt):
    """prepare_rotary_positional_embeddings: the 1.0 crop grid (inside the
    480x720 base grid and at it) and the 1.5 slice tables over
    ceil(F / pt) frames, head dims 64 and 16."""
    for head_dim in (64, 16):
        kw = dict(height=hw[0], width=hw[1], num_frames=frames, patch_size_t=pt,
                  attention_head_dim=head_dim)
        want = jemb.prepare_rotary_positional_embeddings(**kw)
        got = temb.prepare_rotary_positional_embeddings(**kw, device="cpu")
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    assert temb.get_resize_crop_region_for_grid((20, 30), 45, 30) == \
        jemb.get_resize_crop_region_for_grid((20, 30), 45, 30)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rotary_emb_matches_jax(dtype):
    """Interleaved pairs rotated in f32 and cast back: f32 to 1e-6, bf16 to
    one bf16 rounding of outputs below 4."""
    jd, td = PREC[dtype]["jdt"], PREC[dtype]["tdt"]
    cos, sin = jemb.get_3d_rotary_pos_embed(64, ((0, 0), (20, 30)), (4, 6), 3)
    x = np.random.default_rng(1).standard_normal((2, 3, 72, 64)).astype(np.float32)
    want = np.asarray(jemb.apply_rotary_emb(jnp.asarray(x, jd), cos, sin), np.float32)
    got = temb.apply_rotary_emb(torch.from_numpy(x).to(td), torch.tensor(np.asarray(cos)),
                                torch.tensor(np.asarray(sin)))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6 if dtype == "f32" else 2e-2,
                               rtol=0)


# -- ControlDiT -------------------------------------------------------------------

def run_both(case, prec, monkeypatch, quant=False, **jkw):
    """(port output, JAX output) of the case's model on its inputs."""
    pr = PREC[prec]
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", pr["fused"])
    jcfg, tcfg = configs(case)
    params = jax_params(case)[1 if quant else 0]
    inp, rope = inputs(case)
    ctrl = tuple(k for k in ("depths", "labels") if k in inp)
    V = CASES[case][2]
    jmodel = JaxControlDiT(jcfg, dtype=pr["jdt"], attn_impl="flash_q8" if quant else pr["impl"],
                           quant=quant)
    ref, _, _ = jax.jit(lambda p, x, e, t, a, c, r: jmodel.apply(
        p, x, e, t, actions=a, image_rotary_emb=r, num_views=V, **dict(zip(ctrl, c))))(
        params, inp["x"], inp["enc"], inp["t"], inp["actions"], tuple(inp[k] for k in ctrl),
        rope)
    model = ControlDiT(tcfg, dtype=pr["tdt"], device="cpu", quant=quant,
                       attn_impl="flash_q8" if quant else "flash")
    model.load_state_dict(dit_params_from_jax(params, tcfg), strict=True)
    tt = {k: torch.tensor(v) for k, v in inp.items()}
    trope = None if rope is None else tuple(torch.tensor(a) for a in rope)
    with torch.no_grad():
        out = model(tt["x"], tt["enc"], tt["t"], actions=tt["actions"], image_rotary_emb=trope,
                    num_views=V, **{k: tt[k] for k in ctrl})
    assert out.dtype == pr["tdt"]
    return model, out, ref, tt, trope


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_control_dit_surface_matches_jax(case, prec, monkeypatch):
    """RoPE (1.0 tables, 3-chunk), the 1.5 family (patch_size_t 2, 1.5
    tables, joint final norm, 6-chunk, actions grouped over pt), multiview
    (V = 2; per view temb, text and actions, the cross-view sin-cos table,
    MVBlocks; with modulate_enc and controls rearranged per view)."""
    model, out, ref, tt, trope = run_both(case, prec, monkeypatch)
    if prec == "f32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    else:
        range_close(out, ref, 2e-2, 3e-3)
    if "depths" in tt:  # the sampler's control cache gives the same prediction
        V = CASES[case][2]
        with torch.no_grad():
            cache = model(None, tt["enc"], None, depths=tt["depths"], labels=tt["labels"],
                          controls_only=True, num_views=V)
            again = model(tt["x"], tt["enc"], tt["t"], actions=tt["actions"],
                          control_cache=cache, num_views=V)
        torch.testing.assert_close(again, out, atol=0, rtol=0)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["mv_3chunk", "mv_6chunk"])
def test_w8a8_multiview_matches_jax(case, prec, monkeypatch):
    """The quantized multiview model: the MVBlocks' attention projections
    int8 (their adaLN emits bf16, so Int8Dense quantizes the tokens), their
    proj_out float, the cross-view attention on the int8 kernel."""
    _, out, ref, _, _ = run_both(case, prec, monkeypatch, quant=True)
    if prec == "f32":
        range_close(out, ref, 1e-2, 1e-3)
    else:
        range_close(out, ref, 4e-2, 3e-3)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "w8a8"])
@pytest.mark.parametrize("case", ["mv_3chunk", "mv_6chunk"])
def test_mv_block_matches_jax(case, quant, monkeypatch):
    """One MVBlock in f32 on random tokens of V = 2 views x 3 frames: the
    (b v)(f s) -> (b f)(v s) rearrange, the views' text joined and repeated
    per frame under modulate_enc, proj_out and the gated residual; W8A8 with
    the int8 attention."""
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", "0")
    _, tcfg = configs(case)
    params = jax_params(case)[1 if quant else 0]
    mv0 = jax.tree_util.tree_map(lambda a: a[0], params["params"]["blocks"]["mv_block"])
    kw = dict(dim=64, heads=4, head_dim=16, time_embed_dim=64,
              modulate_enc=tcfg.modulate_encoder_hidden_states, attention_bias=True)
    rng = np.random.default_rng(3)
    V, F = 2, 3
    hidden, enc, temb = (rng.standard_normal(s).astype(np.float32)
                         for s in ((V, F * 32, 64), (V, 8, 64), (V, 64)))
    jblock = JaxMVBlock(**kw, attn_impl="flash_q8" if quant else "xla", quant=quant,
                        dtype=jnp.float32)
    ref = jax.jit(lambda p, h, e, t: jblock.apply({"params": p}, h, e, t, None, V, F))(
        mv0, hidden, enc, temb)
    block = MVBlock(**kw, quant=quant, dtype=torch.float32, device="cpu")
    prefix = "mv_blocks.0."
    block.load_state_dict({k[len(prefix):]: v for k, v in dit_params_from_jax(params, tcfg).items()
                           if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        out = block(torch.tensor(hidden), torch.tensor(enc), torch.tensor(temb), None, V, F)
    if quant:  # an int8 value may flip (tests/test_torch_port_quant.py's block bound)
        range_close(out, ref, 1e-2, 3e-4)
    else:
        range_close(out, ref, 1e-5, 1e-5)


def test_quantize_covers_the_mv_blocks():
    """quantize_linear_params of the bridged float weights equals, bit for
    bit, the bridge of JAX's quantized tree: the MVBlocks' to_q, to_k, to_v
    and to_out become int8, their proj_out stays float; quantize_model_
    gives the model that loads it."""
    _, tcfg = configs("mv_6chunk")
    params, qparams = jax_params("mv_6chunk")
    got = quantize_linear_params(dit_params_from_jax(params, tcfg))
    want = dit_params_from_jax(qparams, tcfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    mv_q8 = sorted(k for k in want if k.startswith("mv_blocks.0.") and k.endswith("weight_q8"))
    assert mv_q8 == [f"mv_blocks.0.attn1.{n}.weight_q8" for n in
                     ("to_k", "to_out.0", "to_q", "to_v")]
    assert want["mv_blocks.0.proj_out.weight"].dtype == torch.float32
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(dit_params_from_jax(params, tcfg))
    quantize_model_(model)
    state = model.state_dict()
    assert sorted(state) == sorted(want)
    assert all(torch.equal(state[k], v) for k, v in want.items())


def test_pab_and_multiview_raise_as_jax_does():
    _, tcfg = configs("mv_3chunk")
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    inp, _ = inputs("mv_3chunk")
    tt = {k: torch.tensor(v) for k, v in inp.items()}
    with pytest.raises(NotImplementedError, match="PAB attention broadcast does not cover"):
        model(tt["x"], tt["enc"], tt["t"], num_views=2, collect_attn=True)
    sampler = tsample.make_sampler(model, make_schedule(), tsample.SamplerConfig(
        num_inference_steps=3, pab_skip=1), device="cpu")
    lat = torch.zeros(1, 6, C, H, W)
    with pytest.raises(NotImplementedError, match="PAB attention broadcast is single-view"):
        sampler(lat, lat, tt["enc"], num_views=2)


# -- PAB --------------------------------------------------------------------------

@pytest.mark.parametrize("n,skip,start,end", [(10, 2, 0.1, 0.85), (8, 2, 0.1, 0.85),
                                              (50, 2, 0.1, 0.85), (50, 3, 0.2, 0.9),
                                              (10, 2, 0.0, 1.0), (10, 3, 1.0, 1.0),
                                              (6, 2, 0.2, 0.9), (3, 2, 1 / 3, 1.0)])
def test_pab_full_flags_match_jax(n, skip, start, end):
    got = tsample.pab_full_flags(n, skip, start, end)
    want = jsample.pab_full_flags(n, skip, start, end)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if (n, skip) == (8, 2):
        assert got.tolist() == [True, True, False, False, True, False, False, True]


def test_pab_attention_cache_reproduces_the_full_forward():
    """The per-block cache collected on a step, fed back on the same inputs,
    gives the full forward's output (f32: the gate-only linear equals the
    gate columns of the full one to rounding)."""
    _, tcfg = configs("rope")
    params, _ = jax_params("rope")
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(dit_params_from_jax(params, tcfg))
    inp, rope = inputs("rope")
    tt = {k: torch.tensor(v) for k, v in inp.items()}
    kw = dict(actions=tt["actions"], image_rotary_emb=tuple(torch.tensor(a) for a in rope))
    with torch.no_grad():
        ref = model(tt["x"], tt["enc"], tt["t"], **kw)
        full, cache = model(tt["x"], tt["enc"], tt["t"], collect_attn=True, **kw)
        cached = model(tt["x"], tt["enc"], tt["t"], attn_cache=cache, **kw)
    assert len(cache) == tcfg.num_layers and cache[0][1] is None  # 3-chunk: no text output
    torch.testing.assert_close(full, ref, atol=0, rtol=0)
    torch.testing.assert_close(cached, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w8a8"])
def test_pab_ddim_sample_matches_jax(quant, monkeypatch):
    """6 DDIM steps with pab_skip=2 over [0.2, 0.9) (flags T T F F T T), CFG
    on (the cache holds the doubled batch), with actions and RoPE, from the
    same noise: the port's PAB sampler against JAX's, each with its own
    reuse steps; bf16 on the 5b family's model, W8A8 on the RoPE one."""
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", "force")
    case = "5b" if not quant else "rope"
    jcfg, tcfg = configs(case)
    params = jax_params(case)[1 if quant else 0]
    inp, rope = inputs(case)
    _, F, _, _ = CASES[case]
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, F, C, H, W)).astype(np.float32)
    img = (0.1 * rng.standard_normal((1, F, C, H, W))).astype(np.float32)
    neg = rng.standard_normal((1, 8, 32)).astype(np.float32)
    cfg = dict(num_inference_steps=6, scheduler="ddim", guidance_scale=2.0, pab_skip=2,
               pab_start=0.2, pab_end=0.9)
    assert tsample.pab_full_flags(6, 2, 0.2, 0.9).tolist() == [True, True, False, False,
                                                               True, True]
    attn = "flash_q8" if quant else "flash"
    jmodel = JaxControlDiT(jcfg, dtype=jnp.bfloat16, attn_impl=attn, quant=quant)
    jsampler = jsample.make_sampler(jmodel.apply, jax_make_schedule(),
                                    jsample.SamplerConfig(**cfg))
    want = jax.jit(jsampler)(params, lat, jnp.asarray(img, jnp.bfloat16),
                             jnp.asarray(inp["enc"], jnp.bfloat16), jax.random.PRNGKey(0),
                             negative_prompt_embeds=jnp.asarray(neg, jnp.bfloat16),
                             actions=jnp.asarray(inp["actions"], jnp.bfloat16),
                             image_rotary_emb=rope)
    model = ControlDiT(tcfg, dtype=torch.bfloat16, device="cpu", quant=quant, attn_impl=attn)
    model.load_state_dict(dit_params_from_jax(params, tcfg), strict=True)
    sampler = tsample.make_sampler(model, make_schedule(), tsample.SamplerConfig(**cfg),
                                   device="cpu")
    got = sampler(torch.tensor(lat), torch.tensor(img).bfloat16(),
                  torch.tensor(inp["enc"]).bfloat16(),
                  negative_prompt_embeds=torch.tensor(neg).bfloat16(),
                  actions=torch.tensor(inp["actions"]).bfloat16(),
                  image_rotary_emb=tuple(torch.tensor(a) for a in rope))
    range_close(got, want, 2e-2, 3e-3)
    # the reuse steps mattered: without PAB the port's sample is another one
    exact = tsample.make_sampler(model, make_schedule(), tsample.SamplerConfig(
        **dict(cfg, pab_skip=0)), device="cpu")(
        torch.tensor(lat), torch.tensor(img).bfloat16(), torch.tensor(inp["enc"]).bfloat16(),
        negative_prompt_embeds=torch.tensor(neg).bfloat16(),
        actions=torch.tensor(inp["actions"]).bfloat16(),
        image_rotary_emb=tuple(torch.tensor(a) for a in rope))
    assert (exact - got).abs().max() > 0


# -- weights ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["5b", "mv_6chunk"])
def test_weight_bridge_in_three_directions(case, tmp_path):
    """JAX tree -> port (`dit_params_from_jax`) equals JAX's diffusers export
    (`export_dit_state_dict`); that export through the port's diffusers load
    (`dit_state_dict_from_diffusers`) equals it through JAX's
    (`convert_dit_state_dict`, then the bridge); the port's own export read
    back equals JAX's export. Bitwise, the linear patch embed [D, C*pt*p*p]
    and the mv_blocks included."""
    jcfg, tcfg = configs(case)
    params, _ = jax_params(case)
    exported = jweights.export_dit_state_dict(params, jcfg)
    bridged = dit_params_from_jax(params, tcfg)
    assert sorted(bridged) == sorted(exported)
    for k, v in exported.items():
        assert np.array_equal(bridged[k].numpy(), v), k
    if case == "5b":
        assert bridged["patch_embed.proj.weight"].shape == (64, 32 * 2 * 2 * 2)
    else:
        assert "mv_blocks.1.cam_encoder.weight" in bridged
    loaded = dit_state_dict_from_diffusers({k: torch.tensor(v) for k, v in exported.items()},
                                           tcfg)
    want = dit_params_from_jax(jweights.convert_dit_state_dict(exported, jcfg), tcfg)
    assert sorted(loaded) == sorted(want)
    assert all(torch.equal(loaded[k], v) for k, v in want.items())
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(loaded, strict=True)
    export_pretrained(str(tmp_path / "out"), model.state_dict(), tcfg)
    back = read_safetensors(tmp_path / "out" / "diffusion_pytorch_model.safetensors")
    assert sorted(back) == sorted(exported)
    assert all(np.array_equal(back[k].numpy(), v) for k, v in exported.items())


def test_ensure_mv_blocks_matches_jax():
    """A single-view tree into a multiview config: JAX's surgery then its
    export equals the port's surgery on the bridged state dict, bitwise; so
    does the diffusers load of the single-view export, whose fresh
    cross-view path starts as an identity (proj_out zero)."""
    jcfg, tcfg = configs("mv_3chunk")
    single_j, single_t = (dataclasses.replace(c, multiview=False) for c in (jcfg, tcfg))
    params, _ = jax_params("rope")  # any single-view tree of the tiny widths
    params = {"params": {k: v for k, v in params["params"].items()}}
    blocks = dict(params["params"]["blocks"])
    params["params"]["blocks"] = blocks
    want = jweights.export_dit_state_dict(
        jweights.ensure_mv_blocks(jax.tree_util.tree_map(np.array, params), jcfg), jcfg)
    got = ensure_mv_blocks(dit_params_from_jax(params, single_t), tcfg)
    assert sorted(got) == sorted(want) and "mv_blocks.0.norm1.linear.weight" in got
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), v), k
    assert not got["mv_blocks.1.proj_out.weight"].any()
    single_sd = jweights.export_dit_state_dict(params, single_j)
    loaded = dit_state_dict_from_diffusers({k: torch.tensor(v) for k, v in single_sd.items()},
                                           tcfg)
    assert sorted(loaded) == sorted(want)
    assert all(np.array_equal(loaded[k].numpy(), v) for k, v in want.items())
    # mv_blocks in a single-view config's load are dropped, as JAX drops them
    assert not any(k.startswith("mv_blocks.") for k in dit_state_dict_from_diffusers(
        {k: torch.tensor(v) for k, v in want.items()}, single_t))
    assert ensure_mv_blocks(got, tcfg).keys() == got.keys()  # a no-op once they exist
