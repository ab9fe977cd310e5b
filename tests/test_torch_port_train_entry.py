"""The port's training entry point against orv_tpu's, on the CPU.

`pipelines/train.py` (`train`, `main`, `prefetch_batches`, `init_params`,
`run_validation`, `total_train_steps`, `scaled_lr`), the loss with
visual-control latents, `BucketSampler`, `Tracker`, the safetensors
writer, the init surgery on a diffusers state dict and the checkpoints
(`TrainCheckpointer`, `export_pretrained`), against the JAX functions on
the same files (written from a numpy seed), the same starting folder (one
`export_torch_pretrained` folder of a seeded random DiT) and the same draws
(`LossDraws` replayed from JAX's keys; the image-dropout and action-mask
uniforms fixed in both, as tests/test_torch_port_train_step.py does).

The whole-loop comparison trains on a one-slice dataset: JAX's loader runs
two threads, so with more batches than one which comes next is a race in
both packages; the sampler's index lists and the collated batches are held
apart, in order. JAX shards the batch over dp x fsdp of its 8 host
devices, so its mesh is tp=8 at B=1; the port runs the batch on the CPU.

Tolerances:
  * the loss and every gradient with depth and label latents: 1e-5, as
    tests/test_torch_port_train_step.py holds them;
  * `train`'s loss and grad norm per micro-step: 1e-5 relative; its
    parameters and EMA after 2 applied updates: RMS error <= 1e-4 of the
    largest change of any parameter, as the AdamW test holds them, and max
    error <= 5e-2 of it (Adam divides by the gradient's own size, so where
    it is near rounding level both packages move by their rounding: each
    package's f32 run stands up to 1.8e-2 from an f64 run of the port, the
    two 1.8e-2 from each other, in the recon head's first weight);
  * index lists, collated batches, step counts, learning rates, the
    safetensors round trip, the surgery, the exports read back, resume
    against an unbroken run: equal (bitwise).
  * validation: its DPM steps draw noise inside each sampler, which the
    port cannot replay from JAX's keys, so the files are held by name,
    shape and finiteness.
"""

import itertools
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch

from orv_tpu import configs as jconfigs
from orv_tpu.data import BucketSampler as JaxBucketSampler
from orv_tpu.data import collate_control as jax_collate
from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models import weights as jweights
from orv_tpu.parallel import train_step as jax_train_step
from orv_tpu.pipelines import train as jtrain
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.data import BucketSampler, collate_control
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.weights import (dit_params_from_jax, dit_state_dict_from_diffusers,
                                          read_safetensors, write_safetensors)
from orv_tpu_torch.parallel import (LossDraws, TrainState, diffusion_loss, make_lr_schedule,
                                    make_optimizer, make_train_step)
from orv_tpu_torch.pipelines import train as ttrain
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils.checkpoint import TrainCheckpointer
from orv_tpu_torch.utils.tracker import Tracker

from test_torch_port_serving_data import C_LAT, LAT_HW, SEQ, randomize, write_dataset
from test_torch_port_train_step import _seeded, t
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX_CFG, PORT_CFG = REPO / "orv_tpu" / "config", REPO / "orv_tpu_torch" / "config"
RECIPE = "experiments/traj_image_2b_finetune.yaml"
DIT = dict(num_attention_heads=2, attention_head_dim=64, num_layers=1, text_embed_dim=32,
           time_embed_dim=32, max_text_seq_length=8, in_channels=32, out_channels=16,
           modulate_encoder_hidden_states=True, visual_guidance=True, recon_action=True)
F_LAT = SEQ // 4 + 1
MASK_U = 0.6  # the one row's action-CFG uniform: not masked
DROP_U = 0.5  # the image-dropout uniform: image latents kept


def fix_uniforms(monkeypatch, batch: int):
    """orv_tpu's image-dropout draw (shape ()) and action-mask draw (shape
    (batch,)) return DROP_U and MASK_U."""
    table = {(): np.float32(DROP_U), (batch,): np.full((batch,), MASK_U, np.float32)}

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(table[tuple(shape)], dtype)

    monkeypatch.setattr(jax.random, "uniform", uniform)


def jax_loss_draws(rng, B, F=F_LAT, controls=True):
    """What orv_tpu's diffusion_loss draws from `rng`
    (orv_tpu/parallel/train_step.py:259-312), as the port's LossDraws."""
    r_lat, r_img, r_noise, r_t, _, _, r_cond = jax.random.split(rng, 7)
    shape = (B, C_LAT, F, *LAT_HW)
    normal = lambda k, s: t(jax.random.normal(k, s))
    return LossDraws(
        lat_noise=normal(r_lat, shape), img_noise=normal(r_img, (B, C_LAT, 1, *LAT_HW)),
        noise=normal(r_noise, (B, F, C_LAT, *LAT_HW)),
        t=t(jax.random.randint(r_t, (B,), 0, 1000)).long(),
        drop_u=torch.tensor(DROP_U), mask_u=torch.full((B,), MASK_U),
        depth_noise=normal(r_cond, shape) if controls else None,
        label_noise=normal(jax.random.fold_in(r_cond, 1), shape) if controls else None)


def replayed_draws(seed):
    """The port's `draws(step, batch)` giving what JAX `train` draws at
    micro-step `step`: its key folds the step into PRNGKey(seed)."""
    def draws(step, batch):
        rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        return jax_loss_draws(rng, batch["latents"].shape[0])
    return draws


def overrides(data, out, extra=()):
    keys = ("num_attention_heads", "attention_head_dim", "num_layers", "text_embed_dim",
            "time_embed_dim", "max_text_seq_length")
    return [f"dataset.data_root={data}", "dataset.sequence_length=8",
            "dataset.start_frame_interval=8", "dataset.video_size=[32, 48]",
            "dataset.sample_size=[4, 6]",
            *(f"transformer.{k}={DIT[k]}" for k in keys),
            # the recipe's runtime block does not reach the transformer section
            # (ROADMAP.md C, "config resolution"): name the model's flags there
            "transformer.visual_guidance=true", "transformer.recon_action=true",
            "runtime.use_cond=true", "train.mixed_precision=no", "train.train_batch_size=1",
            "train.gradient_accumulation_steps=2", "train.lr_warmup_steps=0",
            "train.learning_rate=1e-3", "train.log_every=1", "train.validation_steps=1000",
            "inference.num_inference_steps=2", f"train.output_path={out}",
            "train.output_dir=run", *extra]


def load(mod, cfg_dir, data, out, extra=()):
    return mod.load_config(str(cfg_dir / "base_train.yaml"), str(cfg_dir / RECIPE), "bridgev2",
                           overrides=overrides(data, out, extra))


def jax_dit_params(seed=1):
    jdit = JaxControlDiT(JaxDiTConfig(**DIT), dtype=jnp.float32)
    x = np.zeros((1, F_LAT, 32, *LAT_HW), np.float32)
    return randomize(jax.eval_shape(lambda: jdit.init(
        {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
        np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
        actions=np.zeros((1, SEQ, 7), np.float32), depths=x, labels=x, deterministic=False)),
        seed=seed)


def make_setup(root: Path):
    """Two training datasets from a numpy seed (`one`: one episode, of which
    `dataset.num_samples=1` keeps one slice; `many`: three episodes), a
    seeded random DiT's JAX params and their `export_torch_pretrained`
    folder."""
    one = write_dataset(root / "one", n_episodes=1, split="train")
    many = write_dataset(root / "many", seed=3, n_episodes=3, split="train")
    params = jax_dit_params()
    folder = root / "dit"
    jweights.export_torch_pretrained(str(folder), params, JaxDiTConfig(**DIT))
    return dict(root=root, one=one, many=many, params=params, folder=folder)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("train_entry"))


# -- the loss with visual-control latents (A2) ---------------------------------

def _control_batch(B=2):
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(latents=f(B, 2 * C_LAT, F_LAT, *LAT_HW),
                image_latents=f(B, 2 * C_LAT, 1, *LAT_HW), prompt_embeds=f(B, 8, 32),
                actions=0.1 * f(B, SEQ, 7), latents_depth=f(B, 2 * C_LAT, F_LAT, *LAT_HW),
                latents_label=f(B, 2 * C_LAT, F_LAT, *LAT_HW))


@pytest.mark.parametrize("controls", ["depth_label", "depth"])
def test_diffusion_loss_with_control_latents_matches_jax(controls, monkeypatch):
    """The loss and every gradient of a visual-guidance model whose batch
    carries depth (and label) moments, against jax.grad (XLA lowering)."""
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", "0")
    cfg = dict(DIT, num_layers=2, num_control_keys=2 if controls == "depth_label" else 1)
    jmodel = JaxControlDiT(JaxDiTConfig(**cfg), dtype=jnp.float32, attn_impl="xla")
    batch = _control_batch()
    if controls == "depth":
        del batch["latents_label"]
    fix_uniforms(monkeypatch, 2)
    x = batch["latents"][:, :32].transpose(0, 2, 1, 3, 4)
    params = _seeded(jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
        batch["prompt_embeds"], jnp.zeros((2,), jnp.int32), actions=batch["actions"],
        depths=x, labels=x if controls == "depth_label" else None, deterministic=False)), 6)
    rng = jax.random.PRNGKey(11)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jax_train_step.diffusion_loss(jmodel.apply, p, batch, jax_make_schedule(), rng,
                                                recon_action=True), has_aux=True)(params)

    tcfg = DiTConfig(**cfg)
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(dit_params_from_jax(params, tcfg), strict=True)
    draws = jax_loss_draws(rng, 2)
    if controls == "depth":
        draws.label_noise = None
    loss, metrics = diffusion_loss(model, {k: t(v) for k, v in batch.items()}, make_schedule(),
                                   draws, recon_action=True)
    loss.backward()
    for k in ("loss", "diffusion_loss", "rot_loss", "pos_loss", "grip_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]), rtol=1e-5, err_msg=k)
    want = dit_params_from_jax(want_g, tcfg)
    scale = max(v.abs().max().item() for v in want.values())
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - want[name]).abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)
    assert model.initial_combine_linear.weight.grad.abs().max() > 0  # the controls train it


def test_loss_draws_cover_the_batch_controls_and_refusals():
    batch = {k: torch.tensor(v) for k, v in _control_batch().items()}
    d = LossDraws.draw(torch.Generator().manual_seed(0), batch)
    assert d.depth_noise.shape == d.label_noise.shape == (2, C_LAT, F_LAT, *LAT_HW)
    del batch["latents_label"]
    d2 = LossDraws.draw(torch.Generator().manual_seed(0), batch)
    assert d2.label_noise is None and torch.equal(d2.depth_noise, d.depth_noise)
    model = ControlDiT(DiTConfig(**DIT), dtype=torch.float32, device="cpu")
    d2.depth_noise = None
    with pytest.raises(ValueError, match="latents_depth"):
        diffusion_loss(model, batch, make_schedule(), d2)


# -- loader ---------------------------------------------------------------------

def _datasets(data, ref):
    extra = ["dataset.start_frame_interval=2", f"runtime.num_observation={ref}"]
    jcfg = jconfigs.load_config(str(JAX_CFG / "base_train.yaml"), None, "bridgev2",
                                overrides=overrides(data, "/unused", extra))
    tcfg = tconfigs.load_config(str(PORT_CFG / "base_train.yaml"), None, "bridgev2",
                                overrides=overrides(data, "/unused", extra))
    return jtrain.build_dataset(jcfg), ttrain.build_dataset(tcfg)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_bucket_sampler_matches_jax(setup, seed):
    """Index lists equal, infinite and finite, shuffled and not, with
    multi-ref buckets; the first collated batches equal, in order."""
    jds, tds = _datasets(setup["many"], "[1, 2, 3]")
    assert len(tds) == len(jds) > 20
    for kw in (dict(shuffle=True, infinite=True), dict(shuffle=False, infinite=False),
               dict(shuffle=True, infinite=False)):
        want = list(itertools.islice(JaxBucketSampler(jds, 3, seed=seed, **kw), 40))
        got = list(itertools.islice(BucketSampler(tds, 3, seed=seed, **kw), 40))
        assert got == want
    assert {r for b in got for _, r, _ in b} == {1, 2, 3}
    for idxs in want[:4]:
        jb, tb = jax_collate([jds[i] for i in idxs]), collate_control([tds[i] for i in idxs])
        assert sorted(jb) == sorted(tb)
        for k, v in jb.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(tb[k], v, err_msg=k)
            else:
                assert tb[k] == v, k


class _Flaky:
    """Items are their index; index 3 raises."""

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("bad sample")
        return {"x": np.full((2,), i)}


def test_prefetch_batches_skips_bad_batches_and_stops():
    before = threading.active_count()
    sampler = [[i] for i in range(8)]
    got = sorted(int(b["x"][0, 0]) for b in ttrain.prefetch_batches(_Flaky(), sampler, 3, 2))
    assert got == [0, 1, 2, 4, 5, 6, 7]  # every batch once, the bad one dropped
    it = ttrain.prefetch_batches(_Flaky(), itertools.cycle(sampler), 2, 1)
    next(it)
    it.close()  # the workers of an endless loader stop
    assert threading.active_count() == before


# -- schedules, tracker, safetensors --------------------------------------------

def test_total_train_steps_and_scaled_lr_match_jax():
    for explicit, epochs, accum, bs, n, scale in itertools.product(
            (None, 7), (None, 1, 3), (1, 4), (1, 4), (1, 9, 100), (False, True)):
        tc = {"max_train_steps": explicit, "num_train_epochs": epochs,
              "gradient_accumulation_steps": accum, "learning_rate": 3e-4, "scale_lr": scale}
        assert ttrain.total_train_steps(tc, n, bs) == jtrain.total_train_steps(tc, n, bs)
        assert ttrain.scaled_lr(tc, bs) == jtrain.scaled_lr(tc, bs)
    assert ttrain.total_train_steps({}, 5, 1) == 20000


def test_tracker_writes_jsonl_and_config(tmp_path):
    tr = Tracker(str(tmp_path / "logs"), None, config={"a": {"b": 1}, "p": Path("x")})
    tr.log({"loss": torch.tensor(0.5), "n": 3}, 1)
    tr.log_video("validation", "v.mp4", 2)
    tr.close()
    recs = [json.loads(x) for x in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["loss"] == 0.5 and recs[0]["step"] == 1 and recs[1]["video/validation"] == "v.mp4"
    assert json.loads((tmp_path / "logs" / "config.json").read_text()) == {"a": {"b": 1}, "p": "x"}


def test_write_safetensors_round_trips(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(4, generator=g).bfloat16(),
               "f16": torch.randn(2, 2, generator=g).half(), "i64": torch.arange(6).reshape(2, 3),
               "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
               "u8": torch.tensor([0, 255], dtype=torch.uint8), "b": torch.tensor([True, False]),
               "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
               "strided": torch.randn(4, 6, generator=g)[:, ::2]}
    path = tmp_path / "x.safetensors"
    n = write_safetensors(path, tensors)
    assert n == path.stat().st_size
    with safetensors.safe_open(str(path), framework="numpy") as f:
        assert f.metadata() == {"format": "pt"}
    back = read_safetensors(path)
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    ref = safetensors.numpy.load_file(str(path))
    for k, v in tensors.items():
        if v.dtype == torch.bfloat16:
            np.testing.assert_array_equal(ref[k].view(np.uint16), v.view(torch.int16).numpy()
                                          .view(np.uint16))
        else:
            np.testing.assert_array_equal(ref[k], v.numpy(), err_msg=k)


# -- init surgery ------------------------------------------------------------------

def _t2v_state_dict(setup, cfg):
    """A T2V-shaped diffusers state dict: the JAX export of a seeded DiT,
    its patch embed cut to 16 input channels."""
    sd = dict(jweights.export_dit_state_dict(setup["params"], cfg))
    sd["patch_embed.proj.weight"] = np.ascontiguousarray(sd["patch_embed.proj.weight"][:, :16])
    return sd


def test_t2v_surgery_matches_convert_dit_state_dict(setup):
    jcfg, tcfg = JaxDiTConfig(**DIT), DiTConfig(**DIT)
    sd = _t2v_state_dict(setup, jcfg)
    want = dit_params_from_jax(jweights.convert_dit_state_dict(sd, jcfg, from_t2v=True), tcfg)
    got = dit_state_dict_from_diffusers({k: t(v) for k, v in sd.items()}, tcfg, from_t2v=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert got["patch_embed.proj.weight"].shape[1] == 32
    assert not got["patch_embed.proj.weight"][:, 16:].any()
    ControlDiT(tcfg, device="cpu").load_state_dict(got, strict=True)
    # without from_t2v the 16-channel weight stays, and the strict load names it
    kept = dit_state_dict_from_diffusers({k: t(v) for k, v in sd.items()}, tcfg)
    with pytest.raises(RuntimeError, match="patch_embed.proj.weight"):
        ControlDiT(tcfg, device="cpu").load_state_dict(kept, strict=True)


def test_optional_keys_are_accepted_where_the_model_has_them_and_refused_by_name(setup):
    jcfg = JaxDiTConfig(**DIT, patch_bias=False)
    tcfg = DiTConfig(**DIT, patch_bias=False)
    sd = {k: v for k, v in _t2v_state_dict(setup, JaxDiTConfig(**DIT)).items()
          if k != "patch_embed.proj.bias"}
    want = dit_params_from_jax(jweights.convert_dit_state_dict(sd, jcfg, from_t2v=True), tcfg)
    got = dit_state_dict_from_diffusers({k: t(v) for k, v in sd.items()}, tcfg, from_t2v=True)
    assert sorted(got) == sorted(want) and "patch_embed.proj.bias" not in got
    ControlDiT(tcfg, device="cpu").load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="patch_embed.proj.bias"):  # the model has one
        dit_state_dict_from_diffusers({k: t(v) for k, v in sd.items()}, DiTConfig(**DIT))
    with_bias = dict(sd, **{"patch_embed.proj.bias": np.zeros(128, np.float32)})
    with pytest.raises(ValueError, match="patch_embed.proj.bias"):  # the model has none
        dit_state_dict_from_diffusers({k: t(v) for k, v in with_bias.items()}, tcfg)
    no_norm = {k: t(v) for k, v in sd.items() if not k.startswith("norm_out.norm.")}
    with pytest.raises(ValueError, match="norm_out.norm.weight"):
        dit_state_dict_from_diffusers(no_norm, tcfg)
    # mv_blocks in a single-view config's load are dropped, as JAX's
    # convert_dit_state_dict drops them; a multiview model takes them
    # (tests/test_torch_port_model_surface.py)
    assert dit_state_dict_from_diffusers(
        dict(got, **{"mv_blocks.0.norm1.linear.weight": torch.zeros(1)}), tcfg).keys() == got.keys()
    # a T2V checkpoint proper has no action or control heads: the strict load
    # names them (JAX's apply fails on them too, ROADMAP.md C)
    bare = {k: v for k, v in got.items() if not k.startswith(("action_", "initial_combine"))}
    with pytest.raises(RuntimeError, match="action_embed.mlp.0.weight"):
        ControlDiT(tcfg, device="cpu").load_state_dict(
            dit_state_dict_from_diffusers(bare, tcfg), strict=True)
    # a linear patch embed (CogVideoX 1.5) passes as it is; the strict load
    # of a conv model names it, a patch_size_t model takes it
    linear = dict(got, **{"patch_embed.proj.weight": torch.zeros(128, 64)})
    loaded = dit_state_dict_from_diffusers(linear, tcfg, from_t2v=True)
    assert loaded["patch_embed.proj.weight"].shape == (128, 64)
    with pytest.raises(RuntimeError, match="patch_embed.proj.weight"):
        ControlDiT(tcfg, device="cpu").load_state_dict(loaded, strict=True)


# -- checkpoints ------------------------------------------------------------------

def _tiny_state(seed, ema=None):
    torch.manual_seed(seed)
    model = ControlDiT(DiTConfig(**DIT), dtype=torch.float32, device="cpu")
    tx = make_optimizer(make_lr_schedule("constant", 1e-3, warmup_steps=0), grad_accum_steps=2,
                        ema_decay=ema)
    return TrainState.create(model, tx), tx


def test_checkpointer_rotates_skips_and_restores(tmp_path):
    state, tx = _tiny_state(0, ema=0.9)
    step = make_train_step(tx, make_schedule(), recon_action=True)
    batch = {k: torch.tensor(v[:1]) for k, v in _control_batch().items()}
    ck = TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    (tmp_path / "ck" / "9.tmp").mkdir()  # a write cut short is no checkpoint
    saved = {}
    for i in range(5):
        state, _ = step(state, batch, torch.Generator().manual_seed(i))
        assert ck.save(state.step, state)
        saved[state.step] = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert ck.all_steps() == [4, 5] and ck.latest_step() == 5
    assert not ck.save(5, state) and not ck.save(3, state)  # at or below the latest
    other, _ = _tiny_state(1, ema=0.9)
    ck.restore(other, step=4)
    assert other.step == 4 and other.opt_state.mini_step == 0 and other.opt_state.acc is None
    assert all(torch.equal(other.model.state_dict()[k], v) for k, v in saved[4].items())
    ck.restore(other)  # the latest, mid-accumulation
    assert other.step == 5 and other.opt_state.mini_step == 1
    assert all(torch.equal(a, b) for a, b in zip(other.opt_state.acc, state.opt_state.acc))
    no_ema, _ = _tiny_state(1)
    with pytest.raises(KeyError, match="ema/"):
        ck.restore(no_ema)
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(str(tmp_path / "empty")).restore(other)


# -- refusals, device, CLI --------------------------------------------------------

@pytest.mark.parametrize("extra,item", [
    (["train.mesh.dp=2"], "train.mesh.dp=2 needs 2 ranks, and this process has 1"),
    (["train.mesh.fsdp=2"], "train.mesh.fsdp=2 needs 2 ranks, and this process has 1"),
    (["train.mesh.tp=2"], "train.mesh.tp=2 needs 2 ranks, and this process has 1"),
    (["train.mesh.pp=2"], "train.mesh.pp=2 needs 2 ranks, and this process has 1"),
    (["train.loader=grain", "runtime.num_observation=[1, 5, 9]"],
     r"train.loader=grain supports fixed \(ref_num, n_view\) configs; bucketed runs use"),
    (["train.loader=grain", "runtime.multiview=true"],
     r"train.loader=grain supports fixed \(ref_num, n_view\) configs; bucketed runs use"),
])
def test_unported_options_are_refused_by_name(setup, tmp_path, extra, item):
    """grain with several ref_num choices or a multiview config raises JAX's
    ValueError (tests/test_torch_port_grain_loader.py runs grain itself); a
    dp, fsdp, tp or pp mesh (data and model parallelism run since they were
    ported: tests/test_torch_port_mesh_entry.py) without a communicator or a
    torch.distributed group of its size names the ranks it needs."""
    cfg = load(tconfigs, PORT_CFG, setup["one"], tmp_path, extra)
    with pytest.raises(ValueError, match=item):
        ttrain.train(cfg, device="cpu")
    assert not (tmp_path / "run").exists()  # refused before anything is written


@pytest.mark.parametrize("option", ["prodigy_decouple", "prodigy_use_bias_correction"])
def test_prodigy_variants_are_refused_as_jax_refuses_them(setup, tmp_path, option):
    """The prodigy variants optax lacks raise the JAX package's ValueError
    in both packages' `train`, before a step runs."""
    extra = ["train.optimizer.type=prodigy", f"train.optimizer.{option}=true",
             "transformer.pretrained_name_or_path=null"]
    with pytest.raises(ValueError, match="prodigy_decouple / prodigy_use_bias_correction") as want:
        jtrain.train(load(jconfigs, JAX_CFG, setup["one"], tmp_path / "jax",
                          extra + ["train.mesh.dp=1", "train.mesh.tp=8"]))
    with pytest.raises(ValueError, match="prodigy_decouple / prodigy_use_bias_correction") as got:
        ttrain.train(load(tconfigs, PORT_CFG, setup["one"], tmp_path / "port", extra),
                     device="cpu")
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "port" / "run" / "checkpoints").exists()


def test_multiview_frame_padding_is_refused_as_jax_refuses_it():
    """The 1.5 family's frame padding is single-view: a multiview batch of
    odd frames under patch_size_t raises JAX's ValueError."""
    batch = {k: torch.tensor(v) for k, v in _control_batch().items()}
    model = ControlDiT(DiTConfig(**dict(DIT, multiview=True, max_n_view=2)),
                       dtype=torch.float32, device="cpu")
    draws = LossDraws.draw(torch.Generator().manual_seed(0), batch, patch_size_t=2)
    with pytest.raises(ValueError, match="single-view only"):
        diffusion_loss(model, batch, make_schedule(), draws, num_views=2, patch_size_t=2)
    with pytest.raises(ValueError, match="single-view only"):
        jax_train_step.diffusion_loss(None, None, _control_batch(), jax_make_schedule(),
                                      jax.random.PRNGKey(0), num_views=2, patch_size_t=2)


def test_a_jax_flax_folder_is_refused_naming_its_conversion(setup, tmp_path):
    from orv_tpu.utils.checkpoint import export_pretrained as jax_export

    jax_export(str(tmp_path / "flax"), setup["params"], JaxDiTConfig(**DIT))
    cfg = load(tconfigs, PORT_CFG, setup["one"], tmp_path,
               [f"transformer.pretrained_name_or_path={tmp_path / 'flax'}"])
    with pytest.raises(ValueError, match="export_torch_pretrained"):
        ttrain.init_params(cfg, ttrain.build_dit_config(cfg), device="cpu")


def test_train_cli_runs_without_jax():
    """`python -m orv_tpu_torch.pipelines.train --help` in a fresh process,
    which must not import jax or orv_tpu."""
    code = ("import runpy, sys\n"
            "sys.argv = ['x', '--help']\n"
            "try:\n"
            "    runpy.run_module('orv_tpu_torch.pipelines.train', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'orv_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "usage:" in res.stdout and "--experiment" in res.stdout
