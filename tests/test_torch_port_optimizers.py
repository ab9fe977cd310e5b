"""The port's optimizers against orv_tpu's, on the CPU.

CAME (`parallel/came.py` against `orv_tpu.parallel.came`), prodigy
(`parallel/prodigy.py` against `optax.contrib.prodigy`, optax 0.2.6) and
AdamW, each inside the port's `Optimizer` against JAX's `make_optimizer`
chain (clip, MultiSteps accumulation, multi_transform with a
`trainable_predicate`, params EMA), over the tree of a tiny multiview DiT
(its stacked block leaves, 1-D ones too, and the 1.0 family's conv patch
embed), fed the same seeded gradients. Then `train` against JAX `train`
with each new optimizer on a tiny recipe, and resume against an unbroken
run (the helpers of tests/test_torch_port_train_entry.py).

Tolerances:
  * the parameters (and the EMA) after 3 clipped updates of 2 accumulated
    micro-steps, beyond one f32 ulp of each value: each error <= 1e-2 of
    the largest change of any parameter and their RMS <= 1e-4 of it (the
    AdamW test's bounds, tests/test_torch_port_train_step.py). XLA rounds
    p + u and the EMA's multiply-add as its fusions fall, leaf by leaf, so
    the packages' f32 results part by an ulp here and there; prodigy's first
    updates move parameters near 1 by 1e-6, a tenth of an ulp there;
  * prodigy's d-estimate over 10 updates, and the parameters then: 1e-3
    relative and 1e-3 RMS of the change (JAX's own f32 numerator stands 9e-5
    from the exact sum under jit); the frozen parameters bitwise
    unchanged; CAME's leaf plan equal to the JAX tree leaf by leaf;
  * `train`: the loss and grad norm per micro-step 1e-5 relative, the
    parameters after 2 updates as above; resume against an unbroken run:
    bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orv_tpu import configs as jconfigs
from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.parallel import make_lr_schedule as jax_make_lr_schedule
from orv_tpu.parallel import make_optimizer as jax_make_optimizer
from orv_tpu.parallel import train_step as jax_train_step
from orv_tpu.pipelines import train as jtrain
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.parallel import TrainState, make_lr_schedule, make_optimizer
from orv_tpu_torch.parallel.came import leaf_plan
from orv_tpu_torch.parallel.train_step import state_tensors
from orv_tpu_torch.pipelines import train as ttrain

from test_torch_port_serving_data import randomize
from test_torch_port_train_entry import (DIT, JAX_CFG, PORT_CFG, fix_uniforms, load, make_setup,
                                         replayed_draws)
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

TREE = dict(num_attention_heads=2, attention_head_dim=16, num_layers=3, in_channels=32,
            out_channels=16, text_embed_dim=32, time_embed_dim=32, max_text_seq_length=8,
            modulate_encoder_hidden_states=True, visual_guidance=True, recon_action=True,
            multiview=True, max_n_view=2)
SCHED = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
OPTIMIZERS = ("adamw", "came", "prodigy")


def _tree(cfg_kw, seed=3):
    """A seeded random JAX param tree of ControlDiT(cfg_kw) (2 views, or 4
    latent frames for patch_size_t, of 4 x 6)."""
    cfg = JaxDiTConfig(**cfg_kw)
    V = 2 if cfg.multiview else 1
    x = np.zeros((1, V * (4 if cfg.patch_size_t else 3), 32, 4, 6), np.float32)
    kw = dict(depths=x, labels=x) if cfg.visual_guidance else {}
    return randomize(jax.eval_shape(lambda: JaxControlDiT(cfg, dtype=jnp.float32).init(
        {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
        np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
        actions=np.zeros((1, 15 if cfg.patch_size_t else 8, 7), np.float32), num_views=V,
        deterministic=False, **kw)),
        seed=seed)


def _port_tree(params, cfg_kw):
    cfg = DiTConfig(**cfg_kw)
    return dit_params_from_jax(params, cfg), cfg


# -- CAME's leaf plan --------------------------------------------------------------

@pytest.mark.parametrize("case", ["multiview", "patch_size_t"])
def test_came_leaf_plan_matches_the_jax_tree(case):
    """Every JAX leaf is one entry of the plan, of the leaf's shape, whose
    members are the port tensors the weight bridge fills from it, in layer
    order: each leaf filled with its own index (and each layer of a stacked
    leaf with the layer) and carried over by `dit_params_from_jax` tells
    which port tensor came from which leaf and layer."""
    cfg_kw = TREE if case == "multiview" else dict(
        TREE, multiview=False, patch_size_t=2, use_rotary_positional_embeddings=True)
    params = _tree(cfg_kw)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    ids = {}
    for n, (path, leaf) in enumerate(leaves):
        keys = tuple(p.key for p in path)
        stacked = "blocks" in keys
        v = np.full(leaf.shape, 1000.0 * n, np.float32)
        if stacked:
            v = v + np.arange(leaf.shape[0], dtype=np.float32).reshape(-1, *[1] * (leaf.ndim - 1))
        ids[n] = (keys, leaf.shape, stacked)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x, v=v, keys=keys: v if tuple(q.key for q in p) == keys else x, params)
    sd, _ = _port_tree(params, cfg_kw)
    model = ControlDiT(DiTConfig(**cfg_kw), device="meta")
    names = [n for n, _ in model.named_parameters()]
    plan = leaf_plan(names, [p.shape for _, p in model.named_parameters()])
    assert len(plan) == len(leaves)
    seen = set()
    for leaf in plan:
        first = sd[names[leaf.members[0]]]
        n = int(first.flatten()[0].item() // 1000)
        keys, shape, stacked = ids[n]
        assert leaf.shape == tuple(shape) and leaf.stacked == stacked, (leaf.key, keys)
        for layer, i in enumerate(leaf.members):
            assert torch.all(sd[names[i]] == 1000.0 * n + (layer if stacked else 0)), names[i]
        seen.add(n)
    assert seen == set(ids)
    # the traps: a stacked 1-D block leaf is 2-D, the conv patch embed a [(c p p), D] kernel
    by_key = {leaf.key: leaf for leaf in plan}
    assert by_key["transformer_blocks.*.norm1.norm.bias"].shape == (3, 32)
    if case == "multiview":
        assert by_key["mv_blocks.*.attn1.norm_q.weight"].shape == (3, 16)
        assert by_key["patch_embed.proj.weight"].shape == (32 * 2 * 2, 32)


# -- the optimizer chain ----------------------------------------------------------

def _grads(params, n, seed=9):
    """`n` micro-steps' seeded gradient trees: per leaf one direction, of a
    scale of 0.01, 1 or 10 (so the leaves' norms differ), plus 30% noise a
    micro-step (a gradient that keeps its sign, as prodigy's d-estimate
    needs to grow)."""
    rng = np.random.default_rng(seed)
    base = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape) * rng.choice([0.01, 1.0, 10.0]), params)
    return [jax.tree_util.tree_map(
        lambda b: (b * (1 + 0.3 * rng.standard_normal(b.shape))).astype(np.float32), base)
        for _ in range(n)]


def _run_both(optimizer, params, grads, cfg_kw, predicate=False, ema=None, max_norm=0.05,
              weight_decay=1e-2, epsilon=1e-8):
    """The JAX chain and the port's Optimizer over the same gradients from
    the same parameters; returns the port's state and parameters by name
    and JAX's parameters and EMA as port state dicts."""
    kw = dict(max_grad_norm=max_norm, grad_accum_steps=2, weight_decay=weight_decay,
              ema_decay=ema, epsilon=epsilon)
    jtx = jax_make_optimizer(jax_make_lr_schedule(**SCHED), optimizer,
                             trainable_predicate=(lambda path: "mv_block" in path)
                             if predicate else None, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jtx.init(jp)
    update = jax.jit(jtx.update)
    for g in grads:
        u, jstate = update(g, jstate, jp)
        jp = optax.apply_updates(jp, u)

    sd, cfg = _port_tree(params, cfg_kw)
    model = ControlDiT(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd, strict=True)
    named = list(model.named_parameters())
    tx = make_optimizer(make_lr_schedule(**SCHED), optimizer,
                        trainable_predicate=(lambda n: n.startswith("mv_blocks."))
                        if predicate else None, **kw)
    state = tx.init([p for _, p in named], [n for n, _ in named])
    for g in grads:
        gsd, _ = _port_tree(g, cfg_kw)
        tx.update([gsd[n].clone() for n, _ in named], state, [p for _, p in named])
    want = dit_params_from_jax(jax.device_get(jp), cfg)
    want_ema = (dit_params_from_jax(jax.device_get(jax_train_step.ema_params(jstate)), cfg)
                if ema else None)
    return state, {n: p.detach() for n, p in named}, sd, want, want_ema


def _assert_close(got, want, start, rms: float = 1e-4, ulps: int = 1):
    """Beyond `ulps` f32 ulps of the value, each error <= 1e-2 of the
    largest change and their RMS <= `rms` of it. XLA fuses, and so rounds,
    p + u and the EMA's multiply-add differently from leaf to leaf, so the
    packages' results part by an ulp here and there (an EMA by one an
    update): prodigy's first updates move parameters near 1 by 1e-6, where
    an ulp (1.2e-7) is a tenth of it."""
    scale = max((want[k] - start[k]).abs().max().item() for k in want)
    assert scale > 0
    err = torch.cat([(got[k] - want[k]).flatten() for k in want]).abs()
    w = torch.cat([want[k].flatten() for k in want]).abs()
    ulp = torch.nextafter(w, torch.full_like(w, float("inf"))) - w
    excess = (err - ulps * ulp).clamp_min(0)
    assert (excess <= 1e-2 * scale).all(), (excess.max().item(), scale)
    assert excess.pow(2).mean().sqrt() <= rms * scale, (excess.pow(2).mean().sqrt().item(), scale)
    return scale


@pytest.mark.parametrize("optimizer", ["came", "prodigy"])
def test_three_clipped_accumulated_updates_match_jax(optimizer):
    """3 updates of 2 accumulated micro-steps each, the clip active, over
    every leaf of the tiny multiview DiT (stacked 1-D block leaves and the
    conv patch embed among them)."""
    params = _tree(TREE)
    state, got, start, want, _ = _run_both(optimizer, params, _grads(params, 6), TREE)
    assert state.count == 3 and state.mini_step == 0
    _assert_close(got, want, start)
    assert all(not torch.equal(got[n], start[n]) for n in got)  # every leaf took its update


def test_prodigy_d_estimate_follows_jax():
    """10 updates, through the d-estimate's growth (it first moves at the
    4th): `estim_lr` and `numerator_weighted` after each update against
    optax's, to 1e-3 relative, and the parameters after the 10th to 1e-3
    RMS of the largest change. The bound is JAX's: under jit, XLA's f32
    vdot of the numerator stands 9e-5 from the exact sum (torch.dot's, the
    port's: 5e-8), so the two d-estimates part by 1e-4 relative, and so do
    the updates."""
    params = _tree(TREE)
    grads = _grads(params, 20)
    kw = dict(max_grad_norm=0.05, grad_accum_steps=2, weight_decay=1e-2)
    jtx = jax_make_optimizer(jax_make_lr_schedule(**SCHED), "prodigy", **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate, update = jtx.init(jp), jax.jit(jtx.update)
    sd, cfg = _port_tree(params, TREE)
    model = ControlDiT(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd, strict=True)
    named = list(model.named_parameters())
    tx = make_optimizer(make_lr_schedule(**SCHED), "prodigy", **kw)
    state = tx.init([p for _, p in named], [n for n, _ in named])
    for i, g in enumerate(grads):
        u, jstate = update(g, jstate, jp)
        jp = optax.apply_updates(jp, u)
        gsd, _ = _port_tree(g, TREE)
        tx.update([gsd[n].clone() for n, _ in named], state, [p for _, p in named])
        if i % 2:
            want = jstate.inner_opt_state[1]  # chain(clip, prodigy)'s ProdigyState
            for k in ("estim_lr", "numerator_weighted"):
                np.testing.assert_allclose(state.scalars[k].item(), float(getattr(want, k)),
                                           rtol=1e-3, err_msg=(k, i))
    assert state.scalars["estim_lr"].item() > 10 * 1e-6  # the d-estimate grew
    want = dit_params_from_jax(jax.device_get(jp), cfg)
    got = {n: p.detach() for n, p in named}
    scale = max((want[k] - sd[k]).abs().max().item() for k in want)
    err = torch.cat([(got[k] - want[k]).flatten() for k in want])
    assert err.pow(2).mean().sqrt() <= 1e-3 * scale, (err.pow(2).mean().sqrt().item(), scale)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_trainable_predicate_matches_multi_transform(optimizer):
    """The multiview stage's predicate (`mv_blocks` only) against JAX's
    multi_transform: the frozen parameters bitwise unchanged, the trained
    ones and the EMA of every parameter as JAX's. The clip's norm covers the
    trainable leaves only: the frozen leaves' gradients are scaled 1000x,
    which moves the all-leaves norm but must not move the update (AdamW
    runs with an eps of 0.1, which makes its update depend on the clipped
    gradients' scale; CAME's and prodigy's hardly depend on it)."""
    params = _tree(TREE)
    grads = _grads(params, 6)
    for g in grads:
        g["params"] = {k: (v if k == "blocks" else jax.tree_util.tree_map(lambda x: 1e3 * x, v))
                       for k, v in g["params"].items()}
        g["params"]["blocks"]["block"] = jax.tree_util.tree_map(
            lambda x: 1e3 * x, g["params"]["blocks"]["block"])
    state, got, start, want, want_ema = _run_both(optimizer, params, grads, TREE,
                                                  predicate=True, ema=0.9, max_norm=5.0,
                                                  epsilon=0.1 if optimizer == "adamw" else 1e-8)
    frozen = [n for n in got if not n.startswith("mv_blocks.")]
    assert frozen and all(torch.equal(got[n], start[n]) for n in frozen)
    moved = [not torch.equal(got[n], start[n]) for n in got if n.startswith("mv_blocks.")]
    # prodigy's first updates move by about d = 1e-6: a parameter near 1 may round back
    assert all(moved) if optimizer != "prodigy" else sum(moved) > len(moved) // 2
    assert sum(state.mask) == len(got) - len(frozen)
    for group in state.tensors.values():  # the rule's state: trainable leaves only
        assert all(k.startswith("mv_blocks.") for k in group)
    _assert_close(got, want, start)
    _assert_close(dict(zip(got, state.ema)), want_ema, start, ulps=3)  # 3 EMA updates


def test_prodigy_and_unknown_optimizers_are_refused_as_jax_refuses_them():
    lr = make_lr_schedule("constant", 1e-3, warmup_steps=0)
    jlr = jax_make_lr_schedule("constant", 1e-3, warmup_steps=0)
    for kw in (dict(prodigy_decouple=True), dict(prodigy_use_bias_correction=True)):
        with pytest.raises(ValueError, match="prodigy_decouple") as want:
            jax_make_optimizer(jlr, "prodigy", **kw)
        with pytest.raises(ValueError, match="prodigy_decouple") as got:
            make_optimizer(lr, "prodigy", **kw)
        assert str(got.value) == str(want.value)
    for make, sched in ((jax_make_optimizer, jlr), (make_optimizer, lr)):
        with pytest.raises(ValueError, match="unsupported optimizer lion"):
            make(sched, "lion")


def test_came_state_names_its_leaves_and_skips_unused_fields():
    """A CAME train state's checkpoint names: one m per leaf, row/col and
    res_row/res_col for the factored leaves (stacked 1-D block leaves
    among them), sq for the 1-D top-level ones, nothing else."""
    torch.manual_seed(0)
    model = ControlDiT(DiTConfig(**DIT), dtype=torch.float32, device="cpu")
    tx = make_optimizer(make_lr_schedule("constant", 1e-3, warmup_steps=0), "came")
    tensors, _ = state_tensors(TrainState.create(model, tx))
    groups = {}
    for name in tensors:
        group, _, leaf = name.partition("/")
        groups.setdefault(group, set()).add(leaf)
    assert groups["row"] == groups["col"] == groups["res_row"] == groups["res_col"]
    assert groups["m"] == groups["row"] | groups["sq"] and not groups["row"] & groups["sq"]
    assert "transformer_blocks.*.norm1.norm.bias" in groups["row"]
    assert "norm_final.bias" in groups["sq"] and "proj_out.weight" in groups["row"]
    assert tensors["row/transformer_blocks.*.attn1.to_q.weight"].shape == (1, 128)


# -- train with CAME and prodigy ------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("optimizers"))


def _jax_train_by_hand(cfg, params, steps):
    """JAX `train`'s loop for the one-slice dataset, driven by hand with an
    undonated step: its own donated step cannot run prodigy, whose state's
    params0 is the parameters' buffer (ROADMAP.md C, "noted in the
    reference"). The same optimizer, lr schedule, loss arguments, batch and
    keys (PRNGKey(seed) folded with the step) as `train`'s."""
    from orv_tpu.data import collate_control as jax_collate
    from orv_tpu.parallel import TrainState as JaxTrainState
    from orv_tpu.parallel import make_train_step as jax_make_train_step
    from orv_tpu.schedulers import make_schedule as jax_make_schedule

    tc, opt = cfg.train, cfg.train.optimizer
    dataset = jtrain.build_dataset(cfg)
    batch = {k: v for k, v in jax_collate([dataset[0]]).items() if isinstance(v, np.ndarray)}
    tx = jax_make_optimizer(
        jax_make_lr_schedule(tc.lr_scheduler, float(tc.learning_rate), int(tc.lr_warmup_steps),
                             steps), opt.type, opt.beta1, opt.beta2, opt.epsilon,
        opt.weight_decay, opt.max_grad_norm, int(tc.gradient_accumulation_steps))
    model = JaxControlDiT(JaxDiTConfig(**DIT), dtype=jnp.float32)
    step = jax_make_train_step(model.apply, tx, jax_make_schedule(), donate=False,
                               recon_action=True)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch, jax.random.PRNGKey(42))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module", params=["came", "prodigy"])
def trained(request, setup, tmp_path_factory):
    """The port's `train` on the one-slice dataset from the setup's folder,
    2 applied updates of 2 micro-steps with the optimizer, against JAX
    `train` (CAME) or its loop by hand (prodigy, `_jax_train_by_hand`)."""
    out = tmp_path_factory.mktemp(f"trained_{request.param}")
    extra = [f"transformer.pretrained_name_or_path={setup['folder']}", "dataset.num_samples=1",
             "train.max_train_steps=4", "train.checkpointing_steps=100",
             f"train.optimizer.type={request.param}", "train.optimizer.max_grad_norm=0.05"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("NO_INIT_VAL", "1")
        mp.setenv("ORV_TPU_FUSED_ADALN", "0")
        fix_uniforms(mp, 1)
        jcfg = load(jconfigs, JAX_CFG, setup["one"], out / "jax",
                    extra + ["train.mesh.dp=1", "train.mesh.tp=8"])
        if request.param == "prodigy":
            jstate, want = _jax_train_by_hand(jcfg, setup["params"], 4)
        else:
            jstate = jtrain.train(jcfg)
            want = _metrics(out / "jax")
        state = ttrain.train(load(tconfigs, PORT_CFG, setup["one"], out / "port", extra),
                             device="cpu", draws=replayed_draws(42))
    finally:
        mp.undo()
    return dict(jstate=jstate, want=want, got=_metrics(out / "port"), state=state,
                optimizer=request.param)


def _metrics(out):
    import json

    path = out / "run" / "logs" / "metrics.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_train_with_the_optimizer_matches_jax(trained, setup):
    """The loss terms and grad norm of each micro-step, and the parameters
    after 2 updates. CAME normalizes each gradient by its own running
    square, so a parameter whose exact gradient is zero moves by the sign
    of its rounding noise, a full step in each package: such is
    `attn1.norm_k.bias` (every key shifted alike moves all of a query's
    logits alike), which stands apart (11.7% of the largest change in
    either direction); it is held to the size of the others' steps."""
    want, got = trained["want"], trained["got"]
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "diffusion_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=(k, i))
    cfg = DiTConfig(**DIT)
    state = trained["state"]
    assert state.step == 4 and state.opt_state.count == 2
    start = dit_params_from_jax(setup["params"], cfg)
    want = dit_params_from_jax(jax.device_get(trained["jstate"].params), cfg)
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    noise = [k for k in want if k.endswith("attn1.norm_k.bias")]
    assert noise
    if trained["optimizer"] == "came":
        scale = max((want[k] - start[k]).abs().max().item() for k in want)
        for k in noise:
            for side in (got, want):
                assert (side[k] - start[k]).abs().max() <= scale
            want.pop(k), got.pop(k), start.pop(k)
    _assert_close(got, want, start)


@pytest.mark.parametrize("optimizer", ["came", "prodigy"])
def test_resume_equals_an_unbroken_run(setup, tmp_path, monkeypatch, optimizer):
    """Cut before micro-step 3 (mid-accumulation) and resumed: the
    parameters and every tensor and scalar of the optimizer's state equal
    an unbroken run's, bitwise."""
    monkeypatch.setenv("NO_INIT_VAL", "1")
    extra = ["dataset.num_samples=1", "train.max_train_steps=4", "train.checkpointing_steps=1",
             "transformer.pretrained_name_or_path=null", f"train.optimizer.type={optimizer}"]
    whole = ttrain.train(load(tconfigs, PORT_CFG, setup["one"], tmp_path / "whole", extra),
                         device="cpu")
    cut_cfg = load(tconfigs, PORT_CFG, setup["one"], tmp_path / "cut", extra)
    default = ttrain.seeded_draws(42, "cpu")

    class Stop(Exception):
        pass

    def draws(step, batch):
        if step == 3:
            raise Stop
        return default(step, batch)

    with pytest.raises(Stop):
        ttrain.train(cut_cfg, device="cpu", draws=draws)
    resumed = ttrain.train(cut_cfg, device="cpu")
    a, b = state_tensors(whole), state_tensors(resumed)
    assert a[1] == b[1] == dict(step=4, count=2, mini_step=0)
    assert sorted(a[0]) == sorted(b[0])
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    if optimizer == "prodigy":
        assert "scalar/estim_lr" in a[0]
