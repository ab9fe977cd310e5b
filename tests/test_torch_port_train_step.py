"""The port's training step against orv_tpu's, on the CPU at a tiny size.

Inputs, weights and random draws are made with numpy or `jax.random` and
handed to both packages. orv_tpu draws the image-dropout and action-mask
uniforms inside its loss and its ActionEmbed; the tests fix those two
draws in both packages by standing in for `jax.random.uniform` (the JAX
package's normal and randint draws do not go through it).

The model is a 2-layer, 4x16-head ControlDiT with 6-chunk adaLN and
`recon_action`, f32 throughout, every parameter filled with seeded random
values and carried to the port by `dit_params_from_jax`. It runs under the
XLA lowering (ORV_TPU_FUSED_ADALN=0, attn_impl="xla") and under the Pallas
kernels (=force, attn_impl="flash"), which must give the same loss and
gradients in f32. Tolerances:
  * scheduler pieces and action loss: f32 rounding (rtol 1e-6); lr
    schedules: rtol 1e-5 plus 1e-6 of the peak lr (JAX computes them in f32);
  * the loss: rtol 1e-5; each gradient leaf: max error <= 1e-5 of the
    largest gradient of the model (the port's attention uses a static max
    where orv_tpu's XLA path takes a softmax, and sums run in other orders;
    measured at most 3.9e-7);
  * the parameters after 3 AdamW steps (2 micro-steps each, clipped),
    against the largest change of any parameter: RMS error over all
    parameters <= 1e-4 (measured 1.4e-5) and max error <= 1e-2 (measured
    3.1e-3). The max is loose because Adam divides a gradient by its own
    size: where the exact gradient is zero (attn1.norm_k.bias: shifting
    every key shifts each query's logits uniformly) both packages update by
    their rounding noise over eps. A wrong lr, clip, decay or accumulation
    moves the RMS error to the order of the change itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models.layers import ActionEmbed as JaxActionEmbed
from orv_tpu.models.layers import ActionRecon as JaxActionRecon
from orv_tpu.parallel import TrainState as JaxTrainState
from orv_tpu.parallel import make_lr_schedule as jax_make_lr_schedule
from orv_tpu.parallel import make_optimizer as jax_make_optimizer
from orv_tpu.parallel import make_train_step as jax_make_train_step
from orv_tpu.parallel import train_step as jax_train_step
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu.schedulers import scheduling as jax_sched
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.layers import ActionEmbed, ActionRecon, Int8Dense
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.ops import adaln, attention
from orv_tpu_torch.parallel import (
    LossDraws,
    TrainState,
    diffusion_loss,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from orv_tpu_torch.parallel.train_step import compute_action_loss
from orv_tpu_torch.schedulers import (
    add_noise,
    get_velocity,
    loss_weights,
    make_schedule,
    pred_x0_from_v,
)
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

TINY = dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, in_channels=32,
            out_channels=16, text_embed_dim=32, time_embed_dim=64, max_text_seq_length=8,
            sample_width=16, sample_height=8, modulate_encoder_hidden_states=True,
            recon_action=True)
B, F, C, H, W = 2, 3, 16, 8, 16
MASK_U = np.array([0.05, 0.6], np.float32)  # row 0 action-CFG masked, row 1 not
LOWERINGS = {"xla": dict(fused="0", impl="xla"), "pallas": dict(fused="force", impl="flash")}


def t(a):
    """A torch copy of a numpy or JAX array (never a view of its buffer)."""
    return torch.tensor(np.asarray(a))


def fix_uniforms(monkeypatch, drop_u: float):
    """orv_tpu's image-dropout draw (shape ()) and action-mask draw (shape
    (B,)) return these values."""
    table = {(): np.float32(drop_u), (B,): MASK_U}

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(table[tuple(shape)], dtype)

    monkeypatch.setattr(jax.random, "uniform", uniform)


def test_scheduler_pieces_match_jax():
    js, ts = jax_make_schedule(), make_schedule()
    rng = np.random.default_rng(0)
    x, n = (rng.standard_normal((4, 3, 2, 5)).astype(np.float32) for _ in range(2))
    steps = np.array([0, 17, 500, 999])
    for jf, tf in ((jax_sched.add_noise, add_noise), (jax_sched.get_velocity, get_velocity),
                   (jax_sched.pred_x0_from_v, pred_x0_from_v)):
        np.testing.assert_allclose(tf(ts, t(x), t(n), t(steps)).numpy(),
                                   np.asarray(jf(js, x, n, steps)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loss_weights(ts, t(steps)).numpy(),
                               np.asarray(jax_sched.loss_weights(js, steps)), rtol=1e-6)


@pytest.mark.parametrize("mask", [[True, True, False], [False, False, False]])
def test_compute_action_loss_matches_jax(mask):
    rng = np.random.default_rng(1)
    actions, recon = (rng.standard_normal((3, 16, 7)).astype(np.float32) for _ in range(2))
    recon[0, 0, :3] += 3.0  # one position error past the smooth-L1 knee
    want = jax_train_step.compute_action_loss(actions, recon, np.array(mask))
    got = compute_action_loss(t(actions), t(recon), torch.tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["constant", "linear", "cosine", "cosine_with_restarts",
                                  "polynomial"])
def test_lr_schedules_match_jax(name):
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=110, num_cycles=2, power=2.0)
    want, got = jax_make_lr_schedule(name, **kw), make_lr_schedule(name, **kw)
    for step in (0, 5, 10, 35, 60, 109, 110, 150):  # start, warmup, its end, mid, end, past
        # JAX evaluates in f32: near a cosine's end the value keeps fewer digits
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-6 * kw["learning_rate"],
                                   err_msg=f"{name} at step {step}")
    no_warmup = dict(kw, warmup_steps=0)
    np.testing.assert_allclose(make_lr_schedule(name, **no_warmup)(0),
                               float(jax_make_lr_schedule(name, **no_warmup)(0)), rtol=1e-6)


def _seeded(params, seed):
    """Every leaf of a JAX param tree -> seeded random f32 values."""
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


def test_action_embed_with_given_mask_and_action_recon_match_jax(monkeypatch):
    fix_uniforms(monkeypatch, 0.5)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 11, 7)).astype(np.float32)  # 4n-1 frames, as ControlDiT pads
    jembed = JaxActionEmbed(state_dim=7, hidden_size=64, dtype=jnp.float32)
    p = _seeded(jax.eval_shape(lambda: jembed.init(jax.random.PRNGKey(0), x)), 3)
    (want_h, want_mask) = jembed.apply(p, x, deterministic=False,
                                       rngs={"action_mask": jax.random.PRNGKey(1)})
    embed = ActionEmbed(7, 64, dtype=torch.float32, device="cpu")
    pp = p["params"]
    embed.load_state_dict({
        "mlp.0.weight": t(pp["fc1"]["kernel"].T), "mlp.0.bias": t(pp["fc1"]["bias"]),
        "mlp.3.weight": t(pp["fc2"]["kernel"].T), "mlp.3.bias": t(pp["fc2"]["bias"]),
        "mask_embed.weight": t(pp["mask_embed"][None])})
    h, is_mask = embed(t(x), torch.tensor(MASK_U))
    assert is_mask.tolist() == np.asarray(want_mask).tolist() == [True, False]
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    h0, mask0 = embed(t(x))  # deterministic: nothing masked
    assert not mask0.any() and torch.equal(h0[1], h[1]) and not torch.equal(h0[0], h[0])

    jrecon = JaxActionRecon(state_dim=7, hidden_size=64, dtype=jnp.float32)
    e = rng.standard_normal((B, 3, 64)).astype(np.float32)
    pr = _seeded(jax.eval_shape(lambda: jrecon.init(jax.random.PRNGKey(0), e)), 4)["params"]
    recon = ActionRecon(7, 64, dtype=torch.float32, device="cpu")
    recon.load_state_dict({
        "mlp.0.weight": t(pr["fc1"]["kernel"].T), "mlp.0.bias": t(pr["fc1"]["bias"]),
        "mlp.2.weight": t(pr["fc2"]["kernel"].T), "mlp.2.bias": t(pr["fc2"]["bias"])})
    got = recon(t(e))
    assert got.shape == (B, 11, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jrecon.apply({"params": pr}, e)),
                               rtol=1e-5, atol=1e-5)


def _batch():
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(latents=f(B, 2 * C, F, H, W), image_latents=f(B, 2 * C, 1, H, W),
                prompt_embeds=f(B, 8, 32), actions=0.1 * f(B, 4 * F - 4, 7))


_PARAMS = {}


def _jax_model(impl):
    jcfg = JaxDiTConfig(**TINY)
    model = JaxControlDiT(jcfg, dtype=jnp.float32, attn_impl=impl)
    if "p" not in _PARAMS:
        b = _batch()
        _PARAMS["p"] = _seeded(jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)},
            b["latents"].transpose(0, 2, 1, 3, 4), b["prompt_embeds"],
            jnp.zeros((B,), jnp.int32), actions=b["actions"], deterministic=False)), 6)
    return model, _PARAMS["p"]


def _port_model(params):
    tcfg = DiTConfig(**TINY)
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(dit_params_from_jax(params, tcfg), strict=True)
    return model, tcfg


def _jax_draws(rng, drop_u):
    """What orv_tpu's diffusion_loss draws from `rng` (train_step.py:259-290)."""
    r_lat, r_img, r_noise, r_t, _, _, _ = jax.random.split(rng, 7)
    return LossDraws(lat_noise=t(jax.random.normal(r_lat, (B, C, F, H, W))),
                     img_noise=t(jax.random.normal(r_img, (B, C, 1, H, W))),
                     noise=t(jax.random.normal(r_noise, (B, F, C, H, W))),
                     t=t(jax.random.randint(r_t, (B,), 0, 1000)).long(),
                     drop_u=torch.tensor(drop_u), mask_u=torch.tensor(MASK_U))


@pytest.mark.parametrize("drop_u", [0.5, 0.01])  # image latents kept, dropped
@pytest.mark.parametrize("lowering", ["xla", "pallas"])
def test_diffusion_loss_and_grads_match_jax(lowering, drop_u, monkeypatch):
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", LOWERINGS[lowering]["fused"])
    fix_uniforms(monkeypatch, drop_u)
    jmodel, params = _jax_model(LOWERINGS[lowering]["impl"])
    batch, rng = _batch(), jax.random.PRNGKey(11)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jax_train_step.diffusion_loss(jmodel.apply, p, batch, jax_make_schedule(), rng,
                                                recon_action=True), has_aux=True)(params)

    model, tcfg = _port_model(params)
    loss, metrics = diffusion_loss(model, {k: t(v) for k, v in batch.items()}, make_schedule(),
                                   _jax_draws(rng, drop_u), recon_action=True)
    loss.backward()
    for k in ("loss", "diffusion_loss", "rot_loss", "pos_loss", "grip_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]), rtol=1e-5, err_msg=k)
    want = dit_params_from_jax(want_g, tcfg)
    scale = max(v.abs().max().item() for v in want.values())
    for name, p in model.named_parameters():
        ref = want[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)
    # the masked row trains mask_embed, the other row the action MLP
    assert model.action_embed.mask_embed.weight.grad.abs().max() > 0


@pytest.mark.parametrize("ema_decay", [None, 0.9])
def test_three_accumulated_clipped_adamw_steps_match_jax(ema_decay, monkeypatch):
    """3 optimizer steps of 2 micro-steps each, the clip active, warmup 1
    (so the first applied update has lr 0), against make_train_step with
    fold_rng=False: every micro-step sees the same batch and draws. With
    ema_decay, the EMA of the parameters matches `ema_params` too."""
    monkeypatch.setenv("ORV_TPU_FUSED_ADALN", "0")
    fix_uniforms(monkeypatch, 0.5)
    jmodel, params = _jax_model("xla")
    batch, rng = _batch(), jax.random.PRNGKey(12)
    sched_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    opt_kw = dict(max_grad_norm=0.05, grad_accum_steps=2, weight_decay=1e-2, ema_decay=ema_decay)

    jtx = jax_make_optimizer(jax_make_lr_schedule(**sched_kw), **opt_kw)
    jp = jax.tree_util.tree_map(jnp.array, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jtx.init(jp))
    jstep = jax_make_train_step(jmodel.apply, jtx, jax_make_schedule(), recon_action=True,
                                fold_rng=False)
    model, tcfg = _port_model(params)
    tx = make_optimizer(make_lr_schedule(**sched_kw), **opt_kw)
    state = TrainState.create(model, tx)
    step = make_train_step(tx, make_schedule(), recon_action=True)
    tbatch, draws = {k: t(v) for k, v in batch.items()}, _jax_draws(rng, 0.5)

    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i in range(6):
        jstate, jm = jstep(jstate, batch, rng)
        state, m = step(state, tbatch, draws)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert float(jm["grad_norm"]) > 2 * opt_kw["max_grad_norm"]  # the clip acts
        if i == 0:  # accumulating: nothing applied yet
            assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert state.step == 6 and state.opt_state.count == 3

    want = dit_params_from_jax(jax.device_get(jstate.params), tcfg)
    moved = {k: want[k] - before[k] for k in want}
    scale = max(v.abs().max().item() for v in moved.values())
    assert scale > 1e-4
    names = [n for n, _ in model.named_parameters()]
    pairs = [(p.detach(), want[n]) for n, p in model.named_parameters()]
    if ema_decay is not None:  # the EMA moves (1 - decay) of the way each step
        want_ema = dit_params_from_jax(jax.device_get(jax_train_step.ema_params(
            jstate.opt_state)), tcfg)
        pairs += [(e, want_ema[n]) for n, e in zip(names, state.opt_state.ema)]
    err = torch.cat([(a - b).flatten() for a, b in pairs])
    assert err.abs().max() <= 1e-2 * scale, (err.abs().max().item(), scale)
    assert err.pow(2).mean().sqrt() <= 1e-4 * scale, (err.pow(2).mean().sqrt().item(), scale)


def test_inference_only_wrappers_raise_under_grad():
    """The W8A8 ops have no backward (nor have they in orv_tpu): under grad
    mode with an input that requires grad they raise, and they run under
    no_grad."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 40, 64, generator=g) for _ in range(3))
    x = torch.randn(2, 5, 128, generator=g)
    scale, shift = torch.randn(2, 128, generator=g), torch.randn(2, 128, generator=g)
    ns, nb = torch.ones(128), torch.zeros(128)
    dense = Int8Dense(128, 32, dtype=torch.float32, device="cpu")
    dense.has_int8_weights = True
    calls = [lambda q: attention.flash_attention_q8(q, k, v),
             lambda x: adaln.modulate_norm_q8(x, scale, shift, ns, nb),
             lambda x: dense(x)]
    for call, arg in zip(calls, (q, x, x)):
        leaf = arg.clone().requires_grad_()
        with pytest.raises(RuntimeError, match="inference-only"):
            call(leaf)
        with torch.no_grad():
            call(leaf)
        call(arg)  # nothing requires grad: runs
