"""The training side of the DiT's surface in the port against orv_tpu's, on
the CPU.

`diffusion_loss` with RoPE tables, with `patch_size_t` 2 at an odd frame
count (actions, depth and label controls and a given frame mask padded
with it), and with 2 and 3 views, against `jax.value_and_grad` of JAX's
loss (XLA lowering, f32); per-block remat (`ControlDiT(remat=True)`, and the
"dots" policy) against no remat; `train` against JAX `train` on a tiny
stage-3 multiview recipe (remat, the `mv_blocks` predicate, init from a
stage-2 export whose MVBlocks are seeded) and on a tiny 1.5-family recipe
(RoPE, `patch_size_t` 2 over odd latent frames); resume under the
predicate; validation of the two models as JAX runs it. The helpers, data
and draws of tests/test_torch_port_train_entry.py and
tests/test_torch_port_model_surface_serving.py.

Tolerances, as tests/test_torch_port_train_step.py holds the loss:
  * the loss to 1e-5 relative, every gradient to 1e-5 of the largest;
  * remat against no remat: bitwise;
  * `train`: the loss and grad norm per micro-step 1e-5 relative, the
    parameters after 2 updates RMS <= 1e-4 of the largest change (max
    5e-2 of it), the frozen parameters bitwise unchanged; resume bitwise.
    The clip is 5e-4 (tests/test_torch_port_train_loop.py's reasoning): in
    the 1.5-family model one hidden unit of the action MLP is nearly dead,
    and its row of `action_embed.mlp.0.weight` takes gradients at rounding
    level, 1e-8 of the largest, which the packages compute 25% apart; at a
    clip of 0.05 Adam's eps put that row's update in reach of the change
    (7.3e-4 RMS), at 5e-4 it falls far below it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu import configs as jconfigs
from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models import weights as jweights
from orv_tpu.parallel import train_step as jax_train_step
from orv_tpu.pipelines import train as jtrain
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu.utils import embeddings as jemb
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.parallel import LossDraws, diffusion_loss
from orv_tpu_torch.parallel.train_step import state_tensors
from orv_tpu_torch.pipelines import train as ttrain
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils import embeddings as temb

from test_torch_port_model_surface_serving import add_views
from test_torch_port_serving_data import C_LAT, LAT_HW, SEQ, randomize, write_dataset
from test_torch_port_train_entry import DROP_U, JAX_CFG, MASK_U, PORT_CFG, fix_uniforms
from test_torch_port_train_step import t
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

H, W = LAT_HW
F = SEQ // 4 + 1  # 3 latent frames of a 9-frame slice
TINY = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, in_channels=32,
            out_channels=16, text_embed_dim=32, time_embed_dim=32, max_text_seq_length=8)
# each case: the config's extra fields, views, whether the batch carries controls
LOSS_CASES = {
    "rope": (dict(use_rotary_positional_embeddings=True, recon_action=True), 1, False),
    # no action-recon head: with patch_size_t it returns 4 raw frames a pt
    # group, which neither package's loss can hold against the actions
    "patch_size_t": (dict(patch_size_t=2, use_rotary_positional_embeddings=True,
                          joint_final_norm=True, modulate_encoder_hidden_states=True,
                          visual_guidance=True), 1, True),
    "views2": (dict(multiview=True, max_n_view=2, modulate_encoder_hidden_states=True), 2,
               False),
    "views3": (dict(multiview=True, max_n_view=3), 3, False),
}


def jax_rope(cfg, frames):
    """The RoPE tables JAX `train` builds for a batch of `frames` latent
    frames (numpy), or None."""
    if not cfg.use_rotary_positional_embeddings:
        return None
    return tuple(np.asarray(a) for a in jemb.prepare_rotary_positional_embeddings(
        height=8 * H, width=8 * W, num_frames=frames, patch_size=cfg.patch_size,
        patch_size_t=cfg.patch_size_t, attention_head_dim=cfg.attention_head_dim))


def replayed_loss_draws(rng, batch, patch_size_t=None):
    """What orv_tpu's diffusion_loss draws from `rng` for `batch`
    (orv_tpu/parallel/train_step.py:259-312), the diffusion noise over the
    padded frames, as the port's LossDraws."""
    r_lat, r_img, r_noise, r_t, _, _, r_cond = jax.random.split(rng, 7)
    B, C2, Fb = batch["latents"].shape[:3]
    F_pad = Fb + (-Fb % patch_size_t if patch_size_t else 0)
    normal = lambda k, s: t(jax.random.normal(k, s))
    moments = (B, C2 // 2, Fb, H, W)
    ctrl = "latents_depth" in batch
    return LossDraws(
        lat_noise=normal(r_lat, moments),
        img_noise=normal(r_img, (B, C2 // 2, batch["image_latents"].shape[2], H, W)),
        noise=normal(r_noise, (B, F_pad, C2 // 2, H, W)),
        t=t(jax.random.randint(r_t, (B,), 0, 1000)).long(),
        drop_u=torch.tensor(DROP_U), mask_u=torch.full((B,), MASK_U),
        depth_noise=normal(r_cond, moments) if ctrl else None,
        label_noise=normal(jax.random.fold_in(r_cond, 1), moments) if ctrl else None)


def loss_batch(V, controls, B=2):
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    batch = dict(latents=f(B, 2 * C_LAT, V * F, H, W), image_latents=f(B, 2 * C_LAT, V, H, W),
                 prompt_embeds=f(B, 8, 32), actions=0.1 * f(B, SEQ, 7))
    if controls:
        batch.update(latents_depth=f(B, 2 * C_LAT, F, H, W),
                     latents_label=f(B, 2 * C_LAT, F, H, W),
                     frame_mask=np.array([True, True, False]))
    return batch


def loss_params(cfg_kw, V, seed=31):
    cfg = JaxDiTConfig(**cfg_kw)
    Fm = F + (F % 2 if cfg.patch_size_t else 0)  # the padded frames the loss runs
    x = np.zeros((1, V * Fm, 32, H, W), np.float32)
    kw = dict(depths=x, labels=x) if cfg.visual_guidance else {}
    acts = np.zeros((1, SEQ + (4 if cfg.patch_size_t else 0), 7), np.float32)
    rope = jax_rope(cfg, F)
    return randomize(jax.eval_shape(lambda: JaxControlDiT(cfg, dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
        np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32), actions=acts,
        image_rotary_emb=rope, num_views=V, deterministic=False, **kw)), seed=seed)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_diffusion_loss_on_the_surface_matches_jax(case, monkeypatch):
    """The loss terms and every gradient: RoPE (1.0 tables), the 1.5 family
    at 3 latent frames (padded to 4: the latents, the 8 raw actions by 4,
    the depth and label latents, and the frame mask [T, T, F] merged with
    the padded tail), and 2 and 3 views stacked on the frame axis."""
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", "0")
    extra, V, controls = LOSS_CASES[case]
    cfg_kw = dict(TINY, **extra)
    jcfg, tcfg = JaxDiTConfig(**cfg_kw), DiTConfig(**cfg_kw)
    batch = loss_batch(V, controls)
    params = loss_params(cfg_kw, V)
    fix_uniforms(monkeypatch, 2)
    rope = jax_rope(jcfg, F)
    kw = dict(recon_action=jcfg.recon_action, num_views=V, patch_size_t=jcfg.patch_size_t)
    jmodel = JaxControlDiT(jcfg, dtype=jnp.float32, attn_impl="xla")
    rng = jax.random.PRNGKey(13)
    (_, want_m), want_g = jax.value_and_grad(
        lambda p: jax_train_step.diffusion_loss(jmodel.apply, p, batch, jax_make_schedule(), rng,
                                                image_rotary_emb=rope, **kw), has_aux=True)(params)

    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(dit_params_from_jax(params, tcfg), strict=True)
    tbatch = {k: t(v) for k, v in batch.items()}
    trope = None if rope is None else tuple(t(a) for a in rope)
    loss, metrics = diffusion_loss(model, tbatch, make_schedule(),
                                   replayed_loss_draws(rng, batch, jcfg.patch_size_t),
                                   image_rotary_emb=trope, **kw)
    loss.backward()
    for k in want_m:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]), rtol=1e-5, err_msg=k)
    want = dit_params_from_jax(want_g, tcfg)
    scale = max(v.abs().max().item() for v in want.values())
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - want[name]).abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)
    if V > 1:  # the cross-view blocks train
        assert model.mv_blocks[0].attn1.to_q.weight.grad.abs().max() > 0


def test_patch_size_t_padding_with_views_is_refused_as_jax_refuses_it():
    cfg_kw = dict(TINY, multiview=True, max_n_view=2)
    batch = loss_batch(2, False)
    with pytest.raises(ValueError, match="single-view only") as want:
        jax_train_step.diffusion_loss(None, None, batch, jax_make_schedule(),
                                      jax.random.PRNGKey(0), num_views=2, patch_size_t=4)
    model = ControlDiT(DiTConfig(**cfg_kw), dtype=torch.float32, device="cpu")
    tbatch = {k: t(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="single-view only") as got:
        diffusion_loss(model, tbatch, make_schedule(),
                       LossDraws.draw(torch.Generator().manual_seed(0), tbatch, 1000, 4),
                       num_views=2, patch_size_t=4)
    assert str(got.value) == str(want.value)


def test_loss_draws_cover_the_padded_frames():
    tbatch = {k: t(v) for k, v in loss_batch(1, True).items()}
    d = LossDraws.draw(torch.Generator().manual_seed(0), tbatch, 1000, patch_size_t=2)
    assert d.noise.shape[1] == 4 and d.lat_noise.shape[2] == d.depth_noise.shape[2] == 3
    assert LossDraws.draw(None, tbatch, 1000, patch_size_t=3).noise.shape[1] == 3


# -- remat -----------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_gives_the_same_loss_and_gradients(policy):
    """A multiview RoPE model's loss and every gradient with per-block remat
    (all recomputed, or the linears' outputs kept) equal those without,
    bitwise; under remat each cell's forward starts again in the backward
    (the recompute stops once the last tensor the backward saves is back,
    so a forward hook would miss the last block's end)."""
    cfg = DiTConfig(**dict(TINY, multiview=True, max_n_view=2,
                           use_rotary_positional_embeddings=True,
                           modulate_encoder_hidden_states=True))
    torch.manual_seed(0)
    sd = ControlDiT(cfg, dtype=torch.float32, device="cpu").state_dict()
    tbatch = {k: t(v) for k, v in loss_batch(2, False).items()}
    draws = LossDraws.draw(torch.Generator().manual_seed(1), tbatch)
    draws.mask_u = torch.tensor([0.05, 0.6])
    rope = temb.prepare_rotary_positional_embeddings(8 * H, 8 * W, F, attention_head_dim=16,
                                                     device="cpu")
    got = {}
    for remat in (False, True):
        model = ControlDiT(cfg, dtype=torch.float32, device="cpu", remat=remat,
                           remat_policy=policy if remat else None)
        model.load_state_dict(sd)
        calls = []
        for blk in (model.mv_blocks[0], model.transformer_blocks[1]):
            blk.register_forward_pre_hook(lambda *a: calls.append(1))
        loss, _ = diffusion_loss(model, tbatch, make_schedule(), draws, num_views=2,
                                 image_rotary_emb=rope)
        forward_calls = len(calls)
        loss.backward()
        got[remat] = (loss, {n: p.grad for n, p in model.named_parameters()},
                      forward_calls, len(calls))
    (l0, g0, f0, c0), (l1, g1, f1, c1) = got[False], got[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0 if g0[n] is not None)
    assert [n for n in g0 if g0[n] is None] == [n for n in g1 if g1[n] is None]
    assert (f0, c0, f1, c1) == (2, 2, 2, 4)  # the recompute runs each cell once more
    with torch.no_grad():  # no grad, no remat
        model(torch.zeros(1, 2 * F, 32, H, W), tbatch["prompt_embeds"][:1], torch.tensor([3]),
              num_views=2, image_rotary_emb=rope)
    assert len(calls) == 6


def test_rotary_tables_are_never_inference_tensors():
    """Tables a validation builds under the sampler's inference mode can
    feed a training step."""
    with torch.inference_mode():
        cos, sin = temb.prepare_rotary_positional_embeddings(64, 96, 3, attention_head_dim=16,
                                                             device="cpu")
    assert not cos.is_inference() and not sin.is_inference()


# -- train against JAX train -------------------------------------------------------------

MV_RECIPE = "experiments/traj_image_2b_multiview.yaml"
PT_RECIPE = "experiments/traj_image_5b_finetune.yaml"
MV_DIT = dict(TINY, modulate_encoder_hidden_states=True)  # the stage-2 model
PT_DIT = dict(TINY, patch_size_t=2, use_rotary_positional_embeddings=True,
              modulate_encoder_hidden_states=True, joint_final_norm=True)


def surface_overrides(data, out, dit, extra=()):
    keys = ("num_attention_heads", "attention_head_dim", "num_layers", "text_embed_dim",
            "time_embed_dim", "max_text_seq_length")
    return [f"dataset.data_root={data}", "dataset.sequence_length=8",
            "dataset.start_frame_interval=8", "dataset.video_size=[32, 48]",
            "dataset.sample_size=[4, 6]", *(f"transformer.{k}={dit[k]}" for k in keys),
            "train.mixed_precision=no", "train.train_batch_size=1",
            "train.gradient_accumulation_steps=2", "train.lr_warmup_steps=0",
            "train.learning_rate=1e-3", "train.log_every=1", "train.validation_steps=1000",
            "train.max_train_steps=4", "train.checkpointing_steps=100",
            "train.optimizer.max_grad_norm=5e-4", "inference.num_inference_steps=2",
            f"train.output_path={out}", "train.output_dir=run", *extra]


def surface_load(mod, cfg_dir, recipe, data, out, dit, extra=()):
    return mod.load_config(str(cfg_dir / "base_train.yaml"), str(cfg_dir / recipe), "bridgev2",
                           overrides=surface_overrides(data, out, dit, extra))


def mv_extra(s):
    """The stage-3 recipe on the 2-view 'val' split (`train.overfit`: no view
    sampling, so the one slice keeps both views) from the stage-2 folder."""
    return ["train.overfit=true", "dataset.num_samples=1", "dataset.max_n_view=2",
            "transformer.max_n_view=2", f"transformer.pretrained_name_or_path={s['stage2']}"]


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    """Data (a 2-view 'val' split; a single-view 'train' split), the
    stage-2 folder (a seeded non-multiview DiT, exported as diffusers) and
    a 1.5-family folder, written from numpy seeds."""
    root = tmp_path_factory.mktemp("train_surface")
    mv = add_views(write_dataset(root / "mv", n_episodes=1, split="val"), split="val")
    one = write_dataset(root / "one", n_episodes=1, split="train")
    folders = {}
    for tag, dit, V, frames in (("stage2", MV_DIT, 1, F), ("pt", PT_DIT, 1, F + 1)):
        cfg = JaxDiTConfig(**dit)
        x = np.zeros((1, frames, 32, H, W), np.float32)
        rope = jax_rope(cfg, frames)
        params = randomize(jax.eval_shape(lambda: JaxControlDiT(cfg, dtype=jnp.float32).init(
            {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
            np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
            actions=np.zeros((1, 4 * frames - 4, 7), np.float32),
            image_rotary_emb=rope, deterministic=False)), seed=41)
        folders[tag] = root / tag
        jweights.export_torch_pretrained(str(folders[tag]), params, cfg)
    return dict(root=root, mv=mv, one=one, **folders)


def jax_loss_draws_for(patch_size_t=None):
    """The port's `draws(step, batch)` replaying JAX `train`'s keys."""
    def draws(step, batch):
        rng = jax.random.fold_in(jax.random.PRNGKey(42), step)
        return replayed_loss_draws(rng, {k: v.numpy() for k, v in batch.items()}, patch_size_t)
    return draws


def _train_both(s, out, recipe, data, dit, extra, patch_size_t=None):
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("NO_INIT_VAL", "1")
        mp.setenv("ORV_TPU_FUSED_ADALN", "0")
        fix_uniforms(mp, 1)
        jstate = jtrain.train(surface_load(jconfigs, JAX_CFG, recipe, data, out / "jax", dit,
                                           extra + ["train.mesh.dp=1", "train.mesh.tp=8"]))
        state = ttrain.train(surface_load(tconfigs, PORT_CFG, recipe, data, out / "port", dit,
                                          extra), device="cpu",
                             draws=jax_loss_draws_for(patch_size_t))
    finally:
        mp.undo()
    read = lambda side: [json.loads(x) for x in (out / side / "run" / "logs" /
                                                 "metrics.jsonl").read_text().splitlines()]
    return dict(jstate=jstate, state=state, want=read("jax"), got=read("port"))


@pytest.fixture(scope="module", params=["stage3", "patch_size_t"])
def trained(request, surface, tmp_path_factory):
    out = tmp_path_factory.mktemp(request.param)
    if request.param == "stage3":
        r = _train_both(surface, out, MV_RECIPE, surface["mv"], MV_DIT, mv_extra(surface))
        r["start"] = jweights.convert_dit_state_dict(
            jweights.load_torch_state_dict(str(surface["stage2"])),
            JaxDiTConfig(**dict(MV_DIT, multiview=True, max_n_view=2)))
    else:
        extra = ["dataset.num_samples=1", f"transformer.pretrained_name_or_path={surface['pt']}"]
        r = _train_both(surface, out, PT_RECIPE, surface["one"], PT_DIT, extra, patch_size_t=2)
        r["start"] = jweights.convert_dit_state_dict(
            jweights.load_torch_state_dict(str(surface["pt"])), JaxDiTConfig(**PT_DIT))
    r["case"] = request.param
    return r


def test_train_on_the_surface_matches_jax(trained):
    """Loss terms and grad norm (over every parameter, frozen ones too) per
    micro-step; the parameters after 2 updates. Stage 3: the model is
    multiview with remat, its MVBlocks seeded from the stage-2 folder (their
    proj_out zero), only they move, and every one of them moves but the
    cam_encoder, which nothing calls (zero, no gradient, so decay keeps it
    zero)."""
    want, got = trained["want"], trained["got"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("loss", "diffusion_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=(k, w["step"]))
    state = trained["state"]
    model = state.model
    cfg = model.config
    assert state.step == 4 and state.opt_state.count == 2
    start = dit_params_from_jax(trained["start"], cfg)
    want = dit_params_from_jax(jax.device_get(trained["jstate"].params), cfg)
    got = {n: p.detach() for n, p in model.named_parameters()}
    if trained["case"] == "stage3":
        assert cfg.multiview and model.remat and not start["mv_blocks.0.proj_out.weight"].any()
        frozen = [n for n in got if not n.startswith("mv_blocks.")]
        assert all(torch.equal(got[n], start[n]) and torch.equal(want[n], start[n])
                   for n in frozen)
        assert sum(state.opt_state.mask) == len(got) - len(frozen)
        still = [n for n in got if n.startswith("mv_blocks.") and torch.equal(got[n], start[n])]
        assert sorted(still) == sorted(n for n in got if ".cam_encoder." in n)
    else:
        assert cfg.patch_size_t == 2 and cfg.use_rotary_positional_embeddings
    scale = max((want[k] - start[k]).abs().max().item() for k in want)
    assert scale > 1e-4
    err = torch.cat([(got[k] - want[k]).flatten() for k in want])
    worst = sorted(((got[k] - want[k]).abs().max().item() / scale, k) for k in want)[-3:]
    assert err.abs().max() <= 5e-2 * scale, (err.abs().max().item(), scale, worst)
    assert err.pow(2).mean().sqrt() <= 1e-4 * scale, (err.pow(2).mean().sqrt().item(), scale,
                                                      worst)


def test_stage3_resume_equals_an_unbroken_run(surface, tmp_path, monkeypatch):
    """Stage 3 (remat, the predicate) cut before micro-step 3 and resumed:
    the model and every optimizer tensor bitwise as an unbroken run's; the
    checkpoint holds moments for the MVBlocks only."""
    monkeypatch.setenv("NO_INIT_VAL", "1")
    extra = mv_extra(surface) + ["train.checkpointing_steps=1"]
    load = lambda out: surface_load(tconfigs, PORT_CFG, MV_RECIPE, surface["mv"], out, MV_DIT,
                                    extra)
    whole = ttrain.train(load(tmp_path / "whole"), device="cpu")
    default = ttrain.seeded_draws(42, "cpu")

    class Stop(Exception):
        pass

    def draws(step, batch):
        if step == 3:
            raise Stop
        return default(step, batch)

    with pytest.raises(Stop):
        ttrain.train(load(tmp_path / "cut"), device="cpu", draws=draws)
    resumed = ttrain.train(load(tmp_path / "cut"), device="cpu")
    a, b = state_tensors(whole), state_tensors(resumed)
    assert a[1] == b[1] == dict(step=4, count=2, mini_step=0)
    assert sorted(a[0]) == sorted(b[0]) and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    moments = [k for k in a[0] if k.startswith(("mu/", "nu/"))]
    assert moments and all(k.split("/", 1)[1].startswith("mv_blocks.") for k in moments)


@pytest.mark.parametrize("case", ["stage3", "patch_size_t"])
def test_validation_runs_as_jax_runs_it(surface, tmp_path, monkeypatch, case):
    """ONLY_INIT_VAL. A multiview model validates its batch's V x F latent
    frames as one view in both packages (their samplers take no num_views);
    a patch_size_t model's validation of 3 latent frames fails in both."""
    monkeypatch.setenv("ONLY_INIT_VAL", "1")
    if case == "stage3":
        args = (MV_RECIPE, surface["mv"], MV_DIT, mv_extra(surface))
    else:
        args = (PT_RECIPE, surface["one"], PT_DIT,
                ["dataset.num_samples=1", f"transformer.pretrained_name_or_path={surface['pt']}"])
    recipe, data, dit, extra = args
    jcfg = surface_load(jconfigs, JAX_CFG, recipe, data, tmp_path / "jax", dit,
                        extra + ["train.mesh.dp=1", "train.mesh.tp=8"])
    tcfg = surface_load(tconfigs, PORT_CFG, recipe, data, tmp_path / "port", dit, extra)
    if case == "patch_size_t":
        with pytest.raises(Exception, match="divide"):
            jtrain.train(jcfg)
        with pytest.raises(ValueError, match="patch_size_t=2 does not divide"):
            ttrain.train(tcfg, device="cpu")
        return
    jtrain.train(jcfg)
    ttrain.train(tcfg, device="cpu")
    name = "step_000000_latents.npz"
    got = np.load(tmp_path / "port" / "run" / "validation" / name)
    want = np.load(tmp_path / "jax" / "run" / "validation" / name)
    assert got["arr_0"].shape == want["arr_0"].shape == (2 * F, C_LAT, H, W)
    assert np.isfinite(got["arr_0"]).all()
