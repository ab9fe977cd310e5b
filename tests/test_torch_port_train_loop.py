"""The port's training loop against orv_tpu's, on the CPU.

`pipelines/train.py:train` and `main` against JAX `train` on the same files,
starting folder and draws (the helpers and tolerances of
tests/test_torch_port_train_entry.py): the loss per micro-step, the
parameters and EMA after 2 applied updates, the exports read back by both
packages, resume against an unbroken run (at an update boundary and
mid-accumulation, bitwise), and `ONLY_INIT_VAL`'s validation files.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu import configs as jconfigs
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models import weights as jweights
from orv_tpu.parallel import train_step as jax_train_step
from orv_tpu.pipelines import train as jtrain
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.models import DiTConfig
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.parallel import TrainState, make_lr_schedule, make_optimizer, make_train_step
from orv_tpu_torch.pipelines import train as ttrain
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils.checkpoint import TrainCheckpointer, load_pretrained

from test_torch_port_serving_data import C_LAT, LAT_HW, SEQ, randomize
from test_torch_port_train_entry import (DIT, F_LAT, JAX_CFG, PORT_CFG, _control_batch,
                                         fix_uniforms, load, make_setup, overrides,
                                         replayed_draws)
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("train_loop"))


# -- train against JAX train ------------------------------------------------------

@pytest.fixture(scope="module")
def trained(setup, tmp_path_factory):
    """JAX `train` and the port's on the one-slice dataset from one folder,
    2 applied updates of 2 micro-steps with an EMA."""
    out = tmp_path_factory.mktemp("trained")
    extra = [f"transformer.pretrained_name_or_path={setup['folder']}", "dataset.num_samples=1",
             "train.max_train_steps=4", "train.ema_decay=0.9", "train.checkpointing_steps=3",
             # the AdamW test's clip (tests/test_torch_port_train_step.py):
             # grad norms of 267-649 (the loss weight at small t) scale down
             # 5e3-1.3e4 fold, so gradients at f32 rounding level fall far
             # below Adam's eps 1e-8. At a clip of 0.5 the recon head's 1e-5 gradients
             # land near eps, where each package's f32 run stood 9.2e-4 and
             # 1.07e-3 RMS of the change from an f64 run of the port; at
             # 0.05, 9.8e-5 and 1.2e-4 (max 1.8e-2 both).
             "train.optimizer.max_grad_norm=0.05"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("NO_INIT_VAL", "1")
        mp.setenv("ORV_TPU_FUSED_ADALN", "0")
        fix_uniforms(mp, 1)
        jcfg = load(jconfigs, JAX_CFG, setup["one"], out / "jax",
                    extra + ["train.mesh.dp=1", "train.mesh.tp=8"])
        jstate = jtrain.train(jcfg)
        tcfg = load(tconfigs, PORT_CFG, setup["one"], out / "port", extra)
        state = ttrain.train(tcfg, device="cpu", draws=replayed_draws(42))
    finally:
        mp.undo()
    return dict(out=out, jstate=jstate, state=state, cfg=DiTConfig(**DIT))


def _metrics(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_train_loss_per_micro_step_matches_jax(trained):
    want = _metrics(trained["out"] / "jax" / "run" / "logs" / "metrics.jsonl")
    got = _metrics(trained["out"] / "port" / "run" / "logs" / "metrics.jsonl")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("loss", "diffusion_loss", "rot_loss", "pos_loss", "grip_loss", "grad_norm",
                  "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=(k, w["step"]))
    assert min(m["grad_norm"] for m in want) > 100  # the clip acts on every update


def test_train_parameters_and_ema_match_jax(trained, setup):
    s = trained
    state, cfg = s["state"], s["cfg"]
    assert state.step == 4 and state.opt_state.count == 2 and state.opt_state.mini_step == 0
    start = dit_params_from_jax(setup["params"], cfg)
    want = dit_params_from_jax(jax.device_get(s["jstate"].params), cfg)
    want_ema = dit_params_from_jax(jax.device_get(jax_train_step.ema_params(
        s["jstate"].opt_state)), cfg)
    names = [n for n, _ in state.model.named_parameters()]
    scale = max((want[k] - start[k]).abs().max().item() for k in want)
    assert scale > 1e-4
    pairs = [(p.detach(), want[n]) for n, p in state.model.named_parameters()]
    pairs += [(e, want_ema[n]) for n, e in zip(names, state.opt_state.ema)]
    err = torch.cat([(a - b).flatten() for a, b in pairs])
    assert err.abs().max() <= 5e-2 * scale, (err.abs().max().item(), scale)
    assert err.pow(2).mean().sqrt() <= 1e-4 * scale, (err.pow(2).mean().sqrt().item(), scale)


def test_train_export_reads_back_in_both_packages(trained):
    """`checkpoint/` and `checkpoint_ema/`: the port's load_pretrained gives
    the trained state dict and the EMA bitwise, and so do JAX's
    load_torch_state_dict + convert_dit_state_dict; the rotated
    checkpoints hold steps 3 (mid-accumulation) and 4."""
    s = trained
    run = s["out"] / "port" / "run"
    model, cfg = s["state"].model, s["cfg"]
    names = [n for n, _ in model.named_parameters()]
    ema = {**model.state_dict(), **dict(zip(names, s["state"].opt_state.ema))}
    for folder, want in (("checkpoint", model.state_dict()), ("checkpoint_ema", ema)):
        got_cfg, sd = load_pretrained(run / folder, DiTConfig)
        assert got_cfg == cfg and sorted(sd) == sorted(want)
        assert all(torch.equal(sd[k], v) for k, v in want.items()), folder
        jparams = jweights.convert_dit_state_dict(
            jweights.load_torch_state_dict(str(run / folder)), JaxDiTConfig(**DIT))
        back = dit_params_from_jax(jparams, cfg)
        assert all(torch.equal(back[k], v) for k, v in want.items()), folder
    assert TrainCheckpointer(str(run / "checkpoints")).all_steps() == [3, 4]


# -- resume, rotation ---------------------------------------------------------------

class _Stop(Exception):
    pass


def _port_cfg(setup, out, extra=()):
    return load(tconfigs, PORT_CFG, setup["one"], out,
                ["dataset.num_samples=1", "train.max_train_steps=4", "train.ema_decay=0.9",
                 "train.checkpointing_steps=1", "train.checkpoints_total_limit=2",
                 "transformer.pretrained_name_or_path=null", *extra])


@pytest.mark.parametrize("stop", [2, 3])  # at an update boundary, mid-accumulation
def test_resume_equals_an_unbroken_run(setup, tmp_path, monkeypatch, stop):
    """A run cut before micro-step `stop` and resumed from its latest
    checkpoint ends bitwise where an unbroken run ends (the default seeded
    draws: each micro-step's come from (seed, step) alone). The unbroken
    run also validates inline (init and every 2 micro-steps, with the EMA),
    which must leave its training untouched."""
    monkeypatch.setenv("NO_INIT_VAL", "")
    whole = ttrain.train(_port_cfg(setup, tmp_path / "whole", ["train.validation_steps=2"]),
                         device="cpu")
    assert sorted(p.name for p in (tmp_path / "whole" / "run" / "validation").iterdir()) == [
        "step_000000_latents.npz", "step_000002_latents.npz", "step_000004_latents.npz"]
    monkeypatch.setenv("NO_INIT_VAL", "1")
    cut_cfg = _port_cfg(setup, tmp_path / "cut")
    default = ttrain.seeded_draws(42, "cpu")

    def draws(step, batch):
        if step == stop:
            raise _Stop
        return default(step, batch)

    with pytest.raises(_Stop):
        ttrain.train(cut_cfg, device="cpu", draws=draws)
    ckpts = TrainCheckpointer(str(tmp_path / "cut" / "run" / "checkpoints"))
    assert ckpts.all_steps() == [stop - 1, stop]
    resumed = ttrain.train(cut_cfg, device="cpu")
    assert resumed.step == whole.step == 4
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for group in ("mu", "nu", "ema"):
        assert all(torch.equal(x, y) for x, y in zip(getattr(whole.opt_state, group),
                                                     getattr(resumed.opt_state, group))), group
    assert whole.opt_state.count == resumed.opt_state.count == 2


# -- validation ------------------------------------------------------------------

def test_only_init_val_writes_num_validation_videos(setup, tmp_path, monkeypatch):
    """ONLY_INIT_VAL: one validation of the first batch, then return; 2
    clips asked of a batch of 2. Without a VAE one .npz of both clips'
    latents, with one an mp4 per clip; JAX's run_validation names and shapes
    the same files. A training step on the model after its validation
    runs (the sampler's inference mode leaves no inference tensor cached)."""
    from test_torch_port_serving_data import VAE
    from orv_tpu.models.vae import CausalVAE as JaxCausalVAE
    from orv_tpu.models.vae import VAEConfig as JaxVAEConfig
    from orv_tpu_torch.models import CausalVAE, VAEConfig
    from orv_tpu_torch.models.weights import vae_params_from_jax
    from orv_tpu_torch.utils.video import read_video

    monkeypatch.setenv("ONLY_INIT_VAL", "1")
    extra = ["train.num_validation_videos=2", "train.train_batch_size=2",
             "transformer.pretrained_name_or_path=null"]
    jvae = JaxCausalVAE(JaxVAEConfig(**VAE), dtype=jnp.float32)
    vparams = randomize(jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 16, 16)))), seed=2)
    vae = CausalVAE(VAEConfig(**VAE), dtype=torch.float32, device="cpu")
    vae.load_state_dict(vae_params_from_jax(vparams, VAEConfig(**VAE)))
    for tag, kw, jkw in (("npz", {}, {}), ("mp4", dict(vae=vae),
                                          dict(vae=jvae, vae_params=vparams))):
        jcfg = load(jconfigs, JAX_CFG, setup["many"], tmp_path / f"jax_{tag}",
                    extra + ["train.mesh.dp=2", "train.mesh.tp=4"])
        jtrain.train(jcfg, **jkw)
        tcfg = load(tconfigs, PORT_CFG, setup["many"], tmp_path / f"port_{tag}", extra)
        state = ttrain.train(tcfg, device="cpu", **kw)
        assert state.step == 0
        jdir, tdir = (tmp_path / f"{side}_{tag}" / "run" / "validation" for side in ("jax", "port"))
        names = sorted(p.name for p in tdir.iterdir())
        assert names == sorted(p.name for p in jdir.iterdir())
        if tag == "npz":
            assert names == ["step_000000_latents.npz"]
            got, want = np.load(tdir / names[0]), np.load(jdir / names[0])
            assert sorted(got.files) == sorted(want.files) == ["arr_0", "arr_1"]
            for k in got.files:
                assert got[k].shape == want[k].shape == (F_LAT, C_LAT, *LAT_HW)
                assert np.isfinite(got[k]).all()
        else:
            assert names == ["step_000000_0.mp4", "step_000000_1.mp4"]
            for n in names:
                assert read_video(str(tdir / n)).shape == read_video(str(jdir / n)).shape == (
                    SEQ + 1, 32, 48, 3)
    assert not any(t_.is_inference() for t_ in state.model.patch_embed._pos_tables.values())
    tx = make_optimizer(make_lr_schedule("constant", 1e-3, warmup_steps=0))
    batch = {k: torch.tensor(v[:1]) for k, v in _control_batch().items()}
    _, m = make_train_step(tx, make_schedule(), recon_action=True)(
        TrainState(step=0, model=state.model, opt_state=tx.init(list(state.model.parameters()))),
        batch, torch.Generator().manual_seed(0))
    assert np.isfinite(m["loss"].item())


# -- device ------------------------------------------------------------------------

def test_main_runs_on_cuda_unless_cpu_is_asked(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ONLY_INIT_VAL", "1")
    argv = ["--experiment", "traj_image_2b_finetune", "--dataset_type", "bridgev2",
            *overrides(setup["one"], tmp_path, ["transformer.pretrained_name_or_path=null"])]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(argv)
    state = ttrain.main(argv + ["--device", "cpu"])
    assert state.step == 0 and next(state.model.parameters()).device.type == "cpu"
    assert (tmp_path / "run" / "validation" / "step_000000_latents.npz").exists()


def test_overfit_trains_on_the_val_split_in_bf16(setup, tmp_path, monkeypatch):
    """train.overfit reads the 'val' split (here the only one written); the
    recipe's mixed_precision bf16 builds a bf16-compute model over f32
    parameters; init validation only."""
    from test_torch_port_serving_data import write_dataset

    data = write_dataset(tmp_path / "val_only", n_episodes=1, split="val")
    monkeypatch.setenv("ONLY_INIT_VAL", "1")
    cfg = load(tconfigs, PORT_CFG, data, tmp_path, [
        "train.overfit=true", "train.mixed_precision=bf16",
        "transformer.pretrained_name_or_path=null"])
    state = ttrain.train(cfg, device="cpu")
    assert state.model.dtype == torch.bfloat16
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert (tmp_path / "run" / "validation" / "step_000000_latents.npz").exists()


def test_validation_takes_its_draws_from_the_hook(setup, tmp_path):
    """run_validation's `draws(step, noise_shape, image_shape)`: called with
    the clip's shapes, and the same draws give the same latents."""
    from orv_tpu_torch.models import ControlDiT
    from orv_tpu_torch.parallel import EvalDraws

    cfg = load(tconfigs, PORT_CFG, setup["one"], tmp_path, ["train.num_validation_videos=2"])
    torch.manual_seed(0)
    model = ControlDiT(DiTConfig(**DIT), dtype=torch.float32, device="cpu")
    batch = {k: v for k, v in _control_batch().items()}
    calls = []

    def draws(step, noise_shape, image_shape):
        calls.append((step, noise_shape, image_shape))
        return EvalDraws.draw(torch.Generator().manual_seed(5), noise_shape, image_shape)

    outs = []
    for i in range(2):
        path = ttrain.run_validation(cfg, model, batch, tmp_path / f"v{i}", 7, device="cpu",
                                     draws=draws)
        outs.append(np.load(path))
    assert calls == [(7, (2, F_LAT, C_LAT, *LAT_HW), (2, C_LAT, 1, *LAT_HW))] * 2
    assert all(np.array_equal(outs[0][k], outs[1][k]) for k in ("arr_0", "arr_1"))
    default = np.load(ttrain.run_validation(cfg, model, batch, tmp_path / "v2", 7, device="cpu"))
    assert not np.array_equal(default["arr_0"], outs[0]["arr_0"])
