"""The port's synthetic PAB quality harness (scripts/pab_quality_synthetic_torch.py)
against the JAX one (scripts/pab_quality_synthetic.py), on the CPU at the JAX
script's config in f32.

One module-scoped fixture runs the JAX side once: its initial parameters
(`build_overfit_model(0)`), its 8-step overfit, and its deterministic exact and
PAB samplers from those trained parameters. The port replays JAX's initial
weights (through `models/weights.py`), text embeds and per-step loss draws
(`fold_in(PRNGKey(seed + 1), step)` split seven ways, as orv_tpu's
train step draws them). Tolerances: the overfit's loss at each of the 8 steps
rtol 1e-5 (measured at most 3.0e-6); the sampled latents 1e-4 of their range
(measured 1.5e-7; f32, the same formulas, sums in other orders), where PAB
moves them 1.0e-3 of it from the exact sampler's.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.pipelines.sample import SamplerConfig as JaxSamplerConfig
from orv_tpu.pipelines.sample import make_sampler as jax_make_sampler
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu_torch.models import ControlDiT
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.parallel import LossDraws
from orv_tpu_torch.pipelines.sample import SamplerConfig
from orv_tpu_torch.schedulers import make_schedule
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import pab_quality_synthetic as jax_harness  # noqa: E402
import pab_quality_synthetic_torch as harness  # noqa: E402

STEPS, SAMPLE_STEPS, CLIPS = 8, 4, 2
CPU = torch.device("cpu")
CONFIGS = {"exact": dict(), "pab": dict(pab_skip=2, pab_start=0.1, pab_end=0.85)}


def t(a):
    """A torch copy of a numpy or JAX array (never a view of its buffer)."""
    return torch.tensor(np.array(a))


def _jax_draws(step: int, shape) -> LossDraws:
    """What orv_tpu's train step draws at `step` (fold_in of the harness's
    PRNGKey(seed + 1), train_step.py:366-367) and its loss from that key
    (train_step.py:259-290)."""
    B, F, C, H, W = shape
    r_lat, r_img, r_noise, r_t, r_drop, r_mask, _ = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(1), step), 7)
    return LossDraws(lat_noise=t(jax.random.normal(r_lat, (B, C, F, H, W))),
                     img_noise=t(jax.random.normal(r_img, (B, C, 1, H, W))),
                     noise=t(jax.random.normal(r_noise, (B, F, C, H, W))),
                     t=t(jax.random.randint(r_t, (B,), 0, 1000)).long(),
                     drop_u=t(jax.random.uniform(r_drop, ())),
                     mask_u=t(jax.random.uniform(r_mask, (B,))))


def _with_action_embed(model, params, clip, enc):
    """JAX's tree plus the `action_embed` parameters (zeros) that its init
    without actions never creates and the port's model always holds; a model
    called without actions reads none of them."""
    full = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.concatenate([clip, clip], axis=2), enc,
        jnp.zeros((1,), jnp.int32), actions=jnp.zeros((1, 4 * clip.shape[1] - 4, 7))))
    inner = dict(params["params"])
    for k, v in full["params"].items():
        if k not in inner:
            inner[k] = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), v)
    return {"params": inner}


@pytest.fixture(scope="module")
def jax_run():
    _, params0, clip, img_lat, enc, _ = jax_harness.build_overfit_model(train_steps=0)
    model, params, _, _, _, losses = jax_harness.build_overfit_model(train_steps=STEPS)
    params0, params = (_with_action_embed(model, p, clip, enc) for p in (params0, params))
    lat0 = [np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(100 + i), 0),
                                         clip.shape, jnp.float32)) for i in range(CLIPS)]
    latents = {}
    for name, kw in CONFIGS.items():
        fn = jax.jit(jax_make_sampler(model.apply, jax_make_schedule(), JaxSamplerConfig(
            num_inference_steps=SAMPLE_STEPS, stochastic_dpm=False, **kw)))
        latents[name] = [np.asarray(fn(params, jnp.asarray(x), jnp.asarray(img_lat),
                                       jnp.asarray(enc), jax.random.PRNGKey(0)))
                         for x in lat0]
    return dict(params0=params0, params=params, clip=clip, img_lat=img_lat, enc=enc,
                losses=losses, lat0=lat0, latents=latents)


def _port_model(params):
    cfg, dtype = harness.model_setup(CPU)
    model = ControlDiT(cfg, dtype=dtype, device="cpu")
    model.load_state_dict(dit_params_from_jax(params, cfg), strict=True)
    return model


def test_clip_is_the_jax_clip():
    np.testing.assert_array_equal(harness._make_clip(), jax_harness._make_clip())
    assert harness._make_clip().dtype == np.float32


def test_overfit_loss_matches_jax_at_every_step(jax_run):
    cfg, _ = harness.model_setup(CPU)
    clip = jax_run["clip"]
    draws = [_jax_draws(i, clip.shape) for i in range(STEPS)]
    _, got_clip, img_lat, _, losses = harness.build_overfit_model(
        STEPS, device="cpu", state_dict=dit_params_from_jax(jax_run["params0"], cfg),
        prompt_embeds=t(jax_run["enc"]), draws=draws)
    np.testing.assert_array_equal(got_clip, clip)
    np.testing.assert_array_equal(img_lat.numpy(), jax_run["img_lat"])
    assert len(losses) == len(jax_run["losses"]) == STEPS
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_deterministic_latents_match_jax(jax_run, name):
    """From JAX's trained parameters and starting latents, the harness's
    `render` of the deterministic group's exact and PAB (skip 2, 0.1-0.85)
    samplers at 4 steps."""
    got = harness.render(_port_model(jax_run["params"]), make_schedule(),
                         SamplerConfig(num_inference_steps=SAMPLE_STEPS, stochastic_dpm=False,
                                       **CONFIGS[name]),
                         t(jax_run["img_lat"]), t(jax_run["enc"]), CLIPS,
                         latents=[t(x) for x in jax_run["lat0"]])
    for g, want in zip(got, jax_run["latents"][name]):
        rng = float(want.max() - want.min())
        assert np.abs(g - want).max() <= 1e-4 * rng, (np.abs(g - want).max(), rng)
    if name == "pab":  # the broadcast moves the latents 5x past the tolerance (1.0e-3)
        for g, e in zip(got, jax_run["latents"]["exact"]):
            assert np.abs(g - e).max() > 5e-4 * float(e.max() - e.min())


def test_report_keys_and_safe_rule(tmp_path):
    """A short CPU run's report has the JAX report's keys, top level and per
    cell, plus the four naming the device; `safe` is the +6 dB rule."""
    out = tmp_path / "report.json"
    report = harness.run(train_steps=4, sample_steps=SAMPLE_STEPS, n_clips=CLIPS, out=str(out),
                         skips=(2,), windows=((0.1, 0.85),), device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    ref = json.loads((REPO / "reports" / "pab_quality_synthetic.json").read_text())
    added = {"device", "compute_dtype", "attention_head_dim", "card"}
    assert set(report) == set(ref) | added
    assert (report["device"], report["compute_dtype"], report["attention_head_dim"],
            report["card"]) == ("cpu", "float32", 16, None)
    for group in ("stochastic_dpm", "deterministic"):
        assert set(report[group]) == set(ref[group])
        for cell in report[group]["cells"]:
            assert set(cell) == set(ref[group]["cells"][0])
            assert all(np.isfinite(cell[k]) for k in
                       ("recon_psnr_pab", "pab_vs_exact_psnr", "frechet_rp"))
            assert cell["safe"] == (cell["pab_vs_exact_psnr"]
                                    >= report[group]["recon_psnr_exact"] + 6.0)
    assert report["cells"] == report["stochastic_dpm"]["cells"]
    assert report["recon_psnr_exact"] == report["stochastic_dpm"]["recon_psnr_exact"]


def test_empty_window_is_the_exact_sampler():
    """pab_start == pab_end: no broadcast step, so the PAB sampler (the
    cache collected on every step) gives the exact sampler's bits, the
    stochastic DPM noise included."""
    model, _, img_lat, enc, _ = harness.build_overfit_model(train_steps=2, device="cpu")
    exact, empty = (harness.render(model, make_schedule(),
                                   SamplerConfig(num_inference_steps=SAMPLE_STEPS, **kw),
                                   img_lat, enc, 1)[0]
                    for kw in ({}, dict(pab_skip=2, pab_start=0.5, pab_end=0.5)))
    np.testing.assert_array_equal(exact, empty)
