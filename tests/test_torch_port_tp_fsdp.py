"""The port's resident mesh step (dp, fsdp, tp and their compositions) and the
optimizers under sharding, against orv_tpu's, on the CPU at a tiny size.

The port's ranks are `LocalRing` threads, each with its part of the model
(`parallel/fsdp.py:build_rank_model`); the JAX reference is one
`make_train_step(mesh=...)` on a dp2 x fsdp2 x tp2 mesh of the 8 forced host
devices (tests/conftest.py), jitted once, whose optimizer is a stand-in that
returns the gradients as its state. The JAX step is GSPMD over one global
batch and one rng, the single-device step's function; so is the port's:
every rank draws the global batch's draws and takes its rows. Inputs come
from numpy seeds, the draws from JAX's keys (the image-dropout and
action-mask uniforms fixed, as tests/test_torch_port_train_step.py fixes
them; two of the four rows action-masked, so the masked action-loss means
cross the data shards).

Tolerances, f32 throughout: the loss and the logged grad norm to 1e-5
relative, every gradient (gathered whole) to 1e-5 of the largest, as the
resident step is held; W8A8 under tp bitwise (the int32 accumulators are
summed exactly, each token quantized by its whole row); the optimizers
after 2 updates at fsdp2 against resident: the parameters to 1e-4 RMS and
5e-2 at most of the largest change (the keys' LayerNorm bias apart: its
exact gradient is zero, ROADMAP.md C), each optimizer state to 1e-4 RMS of
its own RMS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.parallel import TrainState as JaxTrainState
from orv_tpu.parallel import make_train_step as jax_make_train_step
from orv_tpu.parallel import mesh as jmesh
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.quantize import quantize_linear_params
from orv_tpu_torch.models.weights import dit_params_from_jax, gather_state_dict
from orv_tpu_torch.parallel import LossDraws, TrainState, make_lr_schedule, make_optimizer
from orv_tpu_torch.parallel import make_train_step
from orv_tpu_torch.parallel.fsdp import build_rank_model
from orv_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from orv_tpu_torch.parallel.sp import LocalRing
from orv_tpu_torch.parallel.train_step import state_tensors
from orv_tpu_torch.schedulers import make_schedule

from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)
from test_torch_port_train_step import _seeded, t

TIMEOUT = 60.0
CFG = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, in_channels=32,
           out_channels=16, text_embed_dim=32, time_embed_dim=32, max_text_seq_length=8,
           modulate_encoder_hidden_states=True, recon_action=True)
B, F, C, H, W = 4, 3, 16, 8, 8
DROP_U = 0.5
MASK_U = np.array([0.05, 0.6, 0.7, 0.03], np.float32)  # rows 0 and 3 action-CFG masked


def _batch():
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(latents=f(B, 2 * C, F, H, W), image_latents=f(B, 2 * C, 1, H, W),
                prompt_embeds=f(B, 8, 32), actions=0.1 * f(B, 4 * F - 1, 7))


def _draws(rng):
    """What orv_tpu's diffusion_loss draws from `rng`, as LossDraws."""
    r_lat, r_img, r_noise, r_t, _, _, _ = jax.random.split(rng, 7)
    normal = lambda k, s: t(jax.random.normal(k, s))
    return LossDraws(lat_noise=normal(r_lat, (B, C, F, H, W)),
                     img_noise=normal(r_img, (B, C, 1, H, W)),
                     noise=normal(r_noise, (B, F, C, H, W)),
                     t=t(jax.random.randint(r_t, (B,), 0, 1000)).long(),
                     drop_u=torch.tensor(DROP_U), mask_u=torch.tensor(MASK_U))


@pytest.fixture(scope="module")
def reference():
    """JAX's step on a dp2 x fsdp2 x tp2 mesh: loss, grad norm, gradients
    (port names), the parameters (port state dict) and the batch."""
    mp = pytest.MonkeyPatch()
    table = {(): np.float32(DROP_U), (B,): MASK_U}
    mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, minval=0.0,
               maxval=1.0: jnp.asarray(table[tuple(shape)], dtype))
    try:
        jcfg = JaxDiTConfig(**CFG)
        jmodel = JaxControlDiT(jcfg, dtype=jnp.float32, attn_impl="xla")
        batch = _batch()
        x = batch["latents"][:, :32].transpose(0, 2, 1, 3, 4)
        params = _seeded(jax.eval_shape(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
            batch["prompt_embeds"], jnp.zeros((B,), jnp.int32), actions=batch["actions"],
            deterministic=False)), 3)
        capture = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
        mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=2, fsdp=2, tp=2), devices=jax.devices()[:8])
        step = jax_make_train_step(jmodel.apply, capture, jax_make_schedule(), mesh=mesh,
                                   recon_action=True)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=capture.init(params))
        rng = jax.random.PRNGKey(11)
        state, metrics = step(state, batch, rng)
        cfg = DiTConfig(**CFG)
        return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                    grads=dit_params_from_jax(jax.device_get(state.opt_state), cfg),
                    params=dit_params_from_jax(params, cfg), batch=batch,
                    draws=_draws(jax.random.fold_in(rng, 0)))
    finally:
        mp.undo()


class _Capture:
    """An optimizer that keeps the step's gradients and changes nothing."""

    def init(self, params, names, mesh=None):
        return None

    def update(self, grads, state, params):
        self.grads = [g.clone() for g in grads]


def _rank_model(whole, mesh, **kw):
    make = lambda tp, layers: ControlDiT(DiTConfig(**CFG), dtype=torch.float32, device="cpu",
                                         tp=tp, layers=layers, **kw)
    return build_rank_model(make, whole, mesh, CFG["num_layers"])


def _step(whole, batch, draws, mesh_cfg, comm):
    """One port step at `mesh_cfg` on this rank: (metrics, whole grads);
    `remat` in `mesh_cfg` builds the model with per-block remat."""
    mesh_cfg = dict(mesh_cfg)
    remat = mesh_cfg.pop("remat", False)
    mesh = make_mesh(MeshConfig(**mesh_cfg), comm)
    model, layout = _rank_model(whole, mesh, remat=remat)
    tx = _Capture()
    state = TrainState.create(model, tx, layout)
    state, metrics = make_train_step(tx, make_schedule(), recon_action=True)(
        state, {k: t(v) for k, v in batch.items()}, draws)
    names = [n for n, _ in state.named_params()]
    grads = gather_state_dict(dict(zip(names, tx.grads)), layout.placements, mesh,
                              CFG["num_layers"])
    return metrics, grads


def _resident(whole, batch, draws):
    model = ControlDiT(DiTConfig(**CFG), dtype=torch.float32, device="cpu")
    model.load_state_dict(whole, strict=True)
    tx = _Capture()
    state = TrainState.create(model, tx)
    state, metrics = make_train_step(tx, make_schedule(), recon_action=True)(
        state, {k: t(v) for k, v in batch.items()}, draws)
    return metrics, dict(zip([n for n, _ in state.named_params()], tx.grads))


def _close_grads(got, want):
    scale = max(v.abs().max().item() for v in want.values())
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("mesh_cfg", [
    dict(dp=2), dict(dp=1, fsdp=2), dict(dp=1, tp=2), dict(dp=2, tp=2), dict(dp=1, fsdp=2, tp=2),
    dict(dp=1, tp=4), dict(dp=1, fsdp=2, remat=True)],
    ids=["dp2", "fsdp2", "tp2", "dp2xtp2", "fsdp2xtp2", "tp4", "fsdp2_remat"])
def test_mesh_step_matches_jax_and_resident(reference, mesh_cfg):
    """The loss, the logged grad norm and every gradient of the port's step at
    `mesh_cfg` against JAX's mesh step and the port's resident step; every
    rank's gathered gradients the same bits. At tp=4 the two heads do not
    divide: the attention stays whole on every rank, the feed-forward
    splits, as JAX shards the columns. Under remat each block's fsdp gather
    runs again in the backward."""
    ref = reference
    n = int(np.prod([v for k, v in mesh_cfg.items() if k != "remat"]))
    comm = LocalRing(n, timeout=TIMEOUT)
    res = comm.run(lambda: _step(ref["params"], ref["batch"], ref["draws"], mesh_cfg, comm))
    metrics, grads = res[0]
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-5)
    _close_grads(grads, ref["grads"])
    res_metrics, res_grads = _resident(ref["params"], ref["batch"], ref["draws"])
    np.testing.assert_allclose(metrics["loss"].item(), res_metrics["loss"].item(), rtol=1e-5)
    _close_grads(grads, res_grads)
    for _, g in res[1:]:
        assert all(torch.equal(g[k], grads[k]) for k in grads)


def test_resident_step_matches_jax_mesh_step(reference):
    """The port's resident step, which the mesh steps are held to, against
    JAX's mesh step: the same function."""
    metrics, grads = _resident(reference["params"], reference["batch"], reference["draws"])
    np.testing.assert_allclose(metrics["loss"].item(), reference["loss"], rtol=1e-5)
    _close_grads(grads, reference["grads"])


@pytest.mark.parametrize("rule", ["adamw", "came", "prodigy"])
def test_optimizers_under_fsdp2_match_resident(reference, rule):
    """Two updates (clip, the rule, the EMA) at fsdp2, the rule's state held
    as shards (CAME's factored means and rms and prodigy's d-estimate sums
    reduced over the ranks), against the resident optimizer: the whole
    parameters and every state tensor."""
    ref = reference
    mk = lambda: make_optimizer(make_lr_schedule("constant", 1e-3, 0, 10), rule,
                                max_grad_norm=0.05, ema_decay=0.9)
    batch = {k: t(v) for k, v in ref["batch"].items()}

    def run(mesh_cfg, comm):
        mesh = make_mesh(MeshConfig(**mesh_cfg), comm)
        if mesh.size > 1:
            model, layout = _rank_model(ref["params"], mesh)
        else:
            model, layout = ControlDiT(DiTConfig(**CFG), dtype=torch.float32, device="cpu"), None
            model.load_state_dict(ref["params"], strict=True)
        tx = mk()
        state = TrainState.create(model, tx, layout)
        step = make_train_step(tx, make_schedule(), recon_action=True)
        for i in range(2):
            state, _ = step(state, batch, LossDraws.draw(torch.Generator().manual_seed(i), batch))
        return state_tensors(state)

    want, want_scalars = run(dict(dp=1), None)
    comm = LocalRing(2, timeout=TIMEOUT)
    got = comm.run(lambda: run(dict(dp=1, fsdp=2), comm))
    assert all(torch.equal(got[0][0][k], got[1][0][k]) for k in got[0][0])
    got, scalars = got[0]
    assert scalars == want_scalars and got.keys() == want.keys()
    start = ref["params"]
    moved = max((want[f"params/{k}"] - v).abs().max().item() for k, v in start.items())
    diff = torch.cat([(got[f"params/{k}"] - want[f"params/{k}"]).flatten() for k in start
                      if not k.endswith("norm_k.bias")])
    assert diff.pow(2).mean().sqrt() <= 1e-4 * moved and diff.abs().max() <= 5e-2 * moved
    for k, w in want.items():
        if k.startswith("params/") or "norm_k.bias" in k:
            continue
        rms = w.float().pow(2).mean().sqrt().clamp_min(1e-30)
        err = (got[k].float() - w.float()).pow(2).mean().sqrt()
        assert err <= 1e-4 * rms, (k, err.item(), rms.item())


def test_w8a8_under_tp_is_the_resident_model_bit_for_bit():
    """A W8A8 ControlDiT at tp=2 (its row-parallel Int8Dense layers quantize
    each token by the absmax of its whole row and sum their exact int32
    products) gives the resident W8A8 model's output bit for bit, and the
    bf16 model at tp=2 its output to the bf16 DiT's bound."""
    rng = np.random.default_rng(3)
    cfg = DiTConfig(**CFG)
    torch.manual_seed(0)
    full = ControlDiT(cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for p in full.parameters():
            p.add_(0.1 * torch.randn_like(p))
    whole = {k: v.clone() for k, v in full.state_dict().items()}
    x = torch.tensor(rng.standard_normal((2, F, 32, H, W)).astype(np.float32))
    enc = torch.tensor(rng.standard_normal((2, 8, 32)).astype(np.float32))
    ts = torch.tensor([10, 700])

    def forward(model):
        with torch.inference_mode():
            return model(x, enc, ts)

    for quant in (False, True):
        dtype = torch.bfloat16
        sd = quantize_linear_params(whole) if quant else whole
        ref = ControlDiT(cfg, dtype=dtype, device="cpu", quant=quant,
                         attn_impl="flash_q8" if quant else "flash")
        ref.load_state_dict(sd, strict=True)
        want = forward(ref)
        comm = LocalRing(2, timeout=TIMEOUT)

        def rank():
            mesh = make_mesh(MeshConfig(dp=1, tp=2), comm)
            model, _ = build_rank_model(lambda tp, layers: ControlDiT(
                cfg, dtype=dtype, device="cpu", quant=quant,
                attn_impl="flash_q8" if quant else "flash", tp=tp, layers=layers),
                sd, mesh, cfg.num_layers)
            return forward(model)

        outs = comm.run(rank)
        assert torch.equal(outs[0], outs[1])
        if quant:
            assert torch.equal(outs[0], want)
        else:
            span = (want.max() - want.min()).float()
            assert (outs[0].float() - want.float()).abs().max() <= 2e-2 * span
