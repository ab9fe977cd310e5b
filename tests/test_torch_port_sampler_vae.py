"""The port's slice as a whole against orv_tpu, plus its import and device rules.

`make_sampler` (2 steps: DPM with stochastic_dpm=False, DDIM, and DDIM
with dynamic CFG) over a tiny ControlDiT, then `decode_chunked` over a tiny VAE, all in f32 on the
CPU, against the JAX sampler and decode. Weights are seeded random values
carried over by the port's bridges. Tolerances: latents atol 1e-4 (f32
through two DiT evaluations); frames atol 1e-4 (f32 convs accumulated in
another order).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models.vae import CausalVAE as JaxCausalVAE
from orv_tpu.models.vae import VAEConfig as JaxVAEConfig
from orv_tpu.models.vae import decode_chunked as jax_decode_chunked
from orv_tpu.pipelines import sample as jsample
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu_torch.models import CausalVAE, ControlDiT, DiTConfig, VAEConfig, decode_chunked
from orv_tpu_torch.models.weights import dit_params_from_jax, vae_params_from_jax
from orv_tpu_torch.pipelines import sample as tsample
from orv_tpu_torch.schedulers import make_schedule
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
DIT = dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, in_channels=32,
           out_channels=16, text_embed_dim=32, time_embed_dim=64, max_text_seq_length=8,
           sample_width=16, sample_height=8, modulate_encoder_hidden_states=True,
           visual_guidance=True)
VAE = dict(block_out_channels=(8, 16, 16, 32), layers_per_block=1, norm_num_groups=4,
           latent_channels=16)
B, F, C, H, W = 1, 3, 16, 8, 16


def randomize(params, seed):
    """Every leaf -> seeded random f32: norm scales ~1, kernels ~N(0, 1/fan_in)
    (a 5-D conv kernel [kt, kh, kw, I, O] fans in over all but its last axis)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("scale", "norm_scale"):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name in ("kernel", "linear_kernel"):
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 5 else shape[-2]
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            v = 0.2 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = dict(lat=f(B, F, C, H, W), img=0.5 * f(B, F, C, H, W), enc=f(B, 8, 32),
               actions=0.5 * f(B, 8, 7), depths=f(B, F, 2 * C, H, W),
               labels=f(B, F, 2 * C, H, W))
    jcfg, tcfg = JaxDiTConfig(**DIT), DiTConfig(**DIT)
    jdit = JaxControlDiT(jcfg, dtype=jnp.float32, attn_impl="xla")
    # the param tree's structure from a traced init, its values seeded random
    dparams = randomize(jax.eval_shape(lambda: jdit.init(
        jax.random.PRNGKey(0), np.concatenate([inp["lat"], inp["img"]], 2), inp["enc"],
        np.zeros((B,), np.int32), actions=inp["actions"], depths=inp["depths"],
        labels=inp["labels"])), seed=1)
    dit = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    dit.load_state_dict(dit_params_from_jax(dparams, tcfg))

    jvcfg, tvcfg = JaxVAEConfig(**VAE), VAEConfig(**VAE)
    jvae = JaxCausalVAE(jvcfg, dtype=jnp.float32)
    # encoder and decoder: the port's CausalVAE holds both
    vparams = randomize(jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 16, 16)))), seed=2)
    vae = CausalVAE(tvcfg, dtype=torch.float32, device="cpu")
    vae.load_state_dict(vae_params_from_jax(vparams, tvcfg))
    return dict(inp=inp, jdit=jdit, dparams=dparams, dit=dit, jvae=jvae, vparams=vparams,
                vae=vae)


def jax_decode(s, z):
    """The JAX chunked decode, as one jitted program (`fused=True`, which
    tests/test_vae.py holds equal to the chunk-at-a-time decode)."""
    return jax_decode_chunked(s["jvae"], s["vparams"], jnp.asarray(z), chunk_latent_frames=2,
                              fused=True)


def test_decode_chunked_matches_jax(slice_setup):
    """5 latent frames in chunks [1, 2, 2]: the conv caches carry across
    chunks and the first chunk's odd-frame splits apply."""
    s = slice_setup
    z = np.random.default_rng(3).standard_normal((1, 16, 5, 4, 6)).astype(np.float32)
    out = decode_chunked(s["vae"], torch.from_numpy(z), chunk_latent_frames=2, device="cpu")
    assert out.shape == (1, 3, 17, 32, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_decode(s, z)), atol=1e-4, rtol=0)
    assert all(m.conv_cache is None for m in s["vae"].modules() if hasattr(m, "conv_cache"))


@pytest.mark.parametrize("scheduler", ["dpm", "ddim"])
def test_sampler_then_decode_matches_jax(slice_setup, scheduler):
    """The slice end to end: denoise (control cache, per-frame actions,
    6-chunk adaLN) then unscale and chunked decode."""
    s = slice_setup
    inp = s["inp"]
    kw = dict(num_inference_steps=2, scheduler=scheduler, stochastic_dpm=False)
    jsampler = jsample.make_sampler(s["jdit"].apply, jax_make_schedule(),
                                    jsample.SamplerConfig(**kw))
    ref_lat = jax.jit(jsampler)(s["dparams"], inp["lat"], inp["img"], inp["enc"],
                                jax.random.PRNGKey(0), actions=inp["actions"],
                                depths=inp["depths"], labels=inp["labels"])
    ref_video = jsample.decode_latents(lambda p, z: jax_decode(s, z), None, ref_lat)

    sampler = tsample.make_sampler(s["dit"], make_schedule(), tsample.SamplerConfig(**kw),
                                   device="cpu")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    lat = sampler(t["lat"], t["img"], t["enc"], actions=t["actions"], depths=t["depths"],
                  labels=t["labels"])
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref_lat), atol=1e-4, rtol=0)
    video = tsample.decode_latents(
        lambda z: decode_chunked(s["vae"], z, chunk_latent_frames=2, device="cpu"), lat)
    assert video.shape == (1, 3, 9, 64, 128) and torch.isfinite(video).all()
    np.testing.assert_allclose(video.numpy(), np.asarray(ref_video), atol=1e-4, rtol=0)


def test_sampler_cfg_matches_jax(slice_setup):
    """Classifier-free guidance: the uncond/cond batch of 2 (zero negative
    prompt), the dynamic-CFG schedule, DDIM."""
    s = slice_setup
    inp = s["inp"]
    kw = dict(num_inference_steps=2, scheduler="ddim", guidance_scale=6.0, use_dynamic_cfg=True)
    jsampler = jsample.make_sampler(s["jdit"].apply, jax_make_schedule(),
                                    jsample.SamplerConfig(**kw))
    ref = jax.jit(jsampler)(s["dparams"], inp["lat"], inp["img"], inp["enc"],
                            jax.random.PRNGKey(0), actions=inp["actions"],
                            depths=inp["depths"], labels=inp["labels"])
    sampler = tsample.make_sampler(s["dit"], make_schedule(), tsample.SamplerConfig(**kw),
                                   device="cpu")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    lat = sampler(t["lat"], t["img"], t["enc"], actions=t["actions"], depths=t["depths"],
                  labels=t["labels"])
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_stochastic_dpm_noise_follows_the_generator(slice_setup):
    s = slice_setup
    sampler = tsample.make_sampler(s["dit"], make_schedule(),
                                   tsample.SamplerConfig(num_inference_steps=2), device="cpu")
    t = {k: torch.from_numpy(v) for k, v in s["inp"].items()}
    run = lambda seed: sampler(t["lat"], t["img"], t["enc"],
                               generator=torch.Generator().manual_seed(seed),
                               actions=t["actions"], depths=t["depths"], labels=t["labels"])
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_prepare_latents_match_jax():
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 1, 8, 16)).astype(np.float32)
    ref = jsample.prepare_image_latents(jnp.asarray(lat), 3, jax.random.PRNGKey(0))
    out = tsample.prepare_image_latents(torch.from_numpy(lat), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    ctrl = rng.standard_normal((2, 16, 3, 8, 16)).astype(np.float32)
    ref = jsample.prepare_control_latents(jnp.asarray(ctrl), jax.random.PRNGKey(0))
    out = tsample.prepare_control_latents(torch.from_numpy(ctrl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    # moments with a tiny variance sample to (almost exactly) their mean
    moments = np.concatenate([lat, np.full_like(lat, -30.0)], axis=1)
    out = tsample.sample_from_moments(torch.from_numpy(moments), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out.numpy(), lat, atol=1e-5, rtol=0)


def test_port_imports_no_jax_and_no_orv_tpu():
    """Every orv_tpu_torch module (the serving subpackages data/ and the
    entry points in pipelines/ and utils/ among them, and the offline path's
    text encoder, feature extractors, data_process and encode_dataset),
    chip_smoke and scripts/hf_model_torch.py import in a fresh process
    without pulling in jax, flax, transformers, grain, huggingface_hub or
    any module of the JAX package; the mesh, its fsdp shards and the
    pipeline (parallel/mesh.py, fsdp.py, pp.py), the grain-free loader
    (data/grain_loader.py) and the Hub helper (utils/hub.py) among them."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import orv_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(orv_tpu_torch.__path__, 'orv_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('hf_model_torch',\n"
        "                                              'scripts/hf_model_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k.split('.')[0] in ('flax', 'transformers', 'grain', 'huggingface_hub')\n"
        "       or k == 'orv_tpu' or k.startswith('orv_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('models.text_encoder', 'models.feature_extractors',\n"
        "          'pipelines.data_process', 'pipelines.encode_dataset',\n"
        "          'parallel.mesh', 'parallel.pp', 'parallel.fsdp',\n"
        "          'data.grain_loader', 'utils.hub'):\n"
        "    assert 'orv_tpu_torch.' + m in sys.modules, m\n"
        "print(len([k for k in sys.modules if k.startswith('orv_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 41


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ControlDiT(DiTConfig(**DIT))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CausalVAE(VAEConfig(**VAE))
    dit = ControlDiT(DiTConfig(**DIT), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsample.make_sampler(dit, make_schedule())
    vae = CausalVAE(VAEConfig(**VAE), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_chunked(vae, torch.zeros(1, 16, 1, 4, 4))
    with pytest.raises(ValueError):  # a model on the CPU cannot serve a CUDA call
        tsample.make_sampler(dit, make_schedule(), device="cuda")

