"""The port's pipeline-parallel step (`orv_tpu_torch/parallel/pp.py`) against
orv_tpu's, on the CPU at a tiny size.

The JAX reference is one `make_pp_train_step` on a dp2 x pp2 mesh of 4 of
the 8 forced host devices (tests/conftest.py), jitted once, its optimizer a
stand-in that returns the gradients as its state: each dp shard draws from
the step's key folded with its index, and the loss is the mean of the
shards' losses. The port's ranks are `LocalRing` threads, each holding its
stage's blocks (`parallel/fsdp.py:build_rank_model`); the port's draws for
a shard are JAX's for that shard. fsdp2 x pp2 takes the same draws and must
give the same step (fsdp acts as data parallelism: JAX's dp4 and
dp2 x fsdp2 pipelines compute bit-identical steps). At dp = fsdp = 1 the
pipeline computes the resident step, which is held to JAX
(tests/test_torch_port_train_step.py): pp2, pp2 x tp2, remat,
joint_final_norm and multiview are held to the port's resident step on the
same draws. JAX's refusals raise JAX's messages.

Tolerances, f32 throughout: the loss and the grad norm to 1e-5 relative,
every gradient (gathered whole) to 1e-5 of the largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.parallel import TrainState as JaxTrainState
from orv_tpu.parallel import mesh as jmesh
from orv_tpu.parallel import pp as jpp
from orv_tpu.schedulers import make_schedule as jax_make_schedule
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.weights import dit_params_from_jax, gather_state_dict
from orv_tpu_torch.parallel import LossDraws, TrainState, make_train_step
from orv_tpu_torch.parallel import pp
from orv_tpu_torch.parallel.fsdp import build_rank_model
from orv_tpu_torch.parallel.mesh import AXES, MeshConfig, make_mesh
from orv_tpu_torch.parallel.sp import LocalRing
from orv_tpu_torch.parallel.train_step import batch_rows
from orv_tpu_torch.schedulers import make_schedule

from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)
from test_torch_port_tp_fsdp import _Capture, _close_grads
from test_torch_port_train_step import _seeded, t

TIMEOUT = 60.0
CFG = dict(num_attention_heads=2, attention_head_dim=16, num_layers=4, in_channels=32,
           out_channels=16, text_embed_dim=32, time_embed_dim=32, max_text_seq_length=8,
           modulate_encoder_hidden_states=True, recon_action=True)
B, F, C, H, W = 4, 3, 16, 8, 8
DROP_U = 0.5
MASK_U = np.array([0.05, 0.6], np.float32)  # a shard's two rows: the first action-CFG masked


def _batch(views=1):
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(latents=f(B, 2 * C, views * F, H, W),
                image_latents=f(B, 2 * C, views, H, W), prompt_embeds=f(B, 8, 32),
                actions=0.1 * f(B, 4 * F - 1, 7))


def _draws(rng, n, views=1):
    """What orv_tpu's diffusion_loss draws from `rng` for n rows."""
    r_lat, r_img, r_noise, r_t, _, _, _ = jax.random.split(rng, 7)
    normal = lambda k, s: t(jax.random.normal(k, s))
    return LossDraws(lat_noise=normal(r_lat, (n, C, views * F, H, W)),
                     img_noise=normal(r_img, (n, C, views, H, W)),
                     noise=normal(r_noise, (n, views * F, C, H, W)),
                     t=t(jax.random.randint(r_t, (n,), 0, 1000)).long(),
                     drop_u=torch.tensor(DROP_U),
                     mask_u=torch.tensor(np.resize(MASK_U, n)))


def _jax_model(cfg):
    return JaxControlDiT(JaxDiTConfig(**cfg), dtype=jnp.float32, attn_impl="xla")


def _jax_params(cfg, seed=5):
    batch = _batch()
    x = batch["latents"][:, :32].transpose(0, 2, 1, 3, 4)
    return _seeded(jax.eval_shape(lambda: _jax_model(cfg).init(
        {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
        batch["prompt_embeds"], jnp.zeros((B,), jnp.int32), actions=batch["actions"],
        deterministic=False)), seed)


def _capture():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_pp_reference(cfg, mesh_cfg, n_dev, views=1, **loss_kw):
    """JAX's pipeline step at `mesh_cfg` over the first `n_dev` host devices
    (n_micro 1 a data shard), jitted once: the loss, grad norm, gradients
    and parameters under the port's names, the batch, and the draws (with
    data shards, each shard's: JAX folds the key with the shard's index;
    without, the global batch's from the step's key)."""
    params = _jax_params(cfg)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, minval=0.0,
               maxval=1.0: jnp.asarray(np.resize(MASK_U, shape) if shape else DROP_U, dtype))
    try:
        mesh = jmesh.make_mesh(jmesh.MeshConfig(**mesh_cfg), devices=jax.devices()[:n_dev])
        step = jpp.make_pp_train_step(_jax_model(cfg), _capture(), jax_make_schedule(), mesh,
                                      n_micro=1, num_views=views, **loss_kw)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=_capture().init(params))
        rng = jax.random.PRNGKey(13)
        state, metrics = step(state, _batch(views), rng)
        tcfg = DiTConfig(**cfg)
        key = jax.random.fold_in(rng, 0)
        shards = mesh.shape["dp"] * mesh.shape["fsdp"]
        draws = (_draws(key, B, views) if shards == 1 else
                 [_draws(jax.random.fold_in(key, i), B // shards, views) for i in range(shards)])
        return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                    grads=dit_params_from_jax(jax.device_get(state.opt_state), tcfg),
                    params=dit_params_from_jax(params, tcfg), batch=_batch(views), draws=draws)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def reference():
    """JAX's pipeline step at dp2 x pp2."""
    return _jax_pp_reference(CFG, dict(dp=2, pp=2), 4, recon_action=True)


# a multiview model trains without the action-recon head (its per-view
# reconstruction does not meet the per-sample actions, in either package)
MV_CFG = dict(CFG, multiview=True, recon_action=False, joint_final_norm=True)


@pytest.fixture(scope="module")
def references(reference):
    """JAX's pipeline steps with no data shards, by name: "pp2xtp2" at
    dp1 x pp2 x tp2 (GSPMD's tp inside the stages), "multiview" at
    dp1 x pp2 on a multiview batch of two views with the [text|video]
    final norm (the stages collect the enc tokens)."""
    return dict(dp2xpp2=reference,
                pp2xtp2=_jax_pp_reference(CFG, dict(dp=1, pp=2, tp=2), 4, recon_action=True),
                multiview=_jax_pp_reference(MV_CFG, dict(dp=1, pp=2), 2, views=2))


def _pp_step(whole, cfg, batch, draws, mesh_cfg, comm, n_micro=None, num_views=1, **kw):
    """One pipeline step on this rank: (metrics, whole grads). `draws`: a
    list of each data shard's draws, or the global batch's."""
    mesh = make_mesh(MeshConfig(**mesh_cfg), comm)
    make = lambda tp, layers: ControlDiT(DiTConfig(**cfg), dtype=torch.float32, device="cpu",
                                         tp=tp, layers=layers, **kw)
    model, layout = build_rank_model(make, whole, mesh, cfg["num_layers"])
    tx = _Capture()
    state = TrainState.create(model, tx, layout)
    batch = {k: t(v) for k, v in batch.items()}
    n = mesh.data_size
    sl = slice(mesh.data_index * (B // n), (mesh.data_index + 1) * (B // n))
    mine = draws[mesh.data_index] if isinstance(draws, list) else draws.rows(sl)
    step = pp.make_pp_train_step(tx, make_schedule(), mesh, cfg["num_layers"], n_micro,
                                 recon_action=True, num_views=num_views)
    state, metrics = step(state, batch_rows(batch, sl), mine)
    names = [n for n, _ in state.named_params()]
    return metrics, gather_state_dict(dict(zip(names, tx.grads)), layout.placements, mesh,
                                      cfg["num_layers"])


def _resident(whole, cfg, batch, draws, num_views=1, **kw):
    model = ControlDiT(DiTConfig(**cfg), dtype=torch.float32, device="cpu", **kw)
    model.load_state_dict(whole, strict=True)
    tx = _Capture()
    state = TrainState.create(model, tx)
    state, metrics = make_train_step(tx, make_schedule(), recon_action=True,
                                     num_views=num_views)(
        state, {k: t(v) for k, v in batch.items()}, draws)
    return metrics, dict(zip([n for n, _ in state.named_params()], tx.grads))


@pytest.mark.parametrize("mesh_cfg", [dict(dp=2, pp=2), dict(dp=1, fsdp=2, pp=2)],
                         ids=["dp2xpp2", "fsdp2xpp2"])
def test_pipeline_with_data_shards_matches_jax(reference, mesh_cfg):
    """The pipeline step with two data shards (each its own rows and JAX's
    draws for its index, the loss the mean of the shards') against JAX's
    dp2 x pp2 step: the loss, the grad norm and every gradient; fsdp2 x pp2
    gathers each stage's blocks from their shards and gives the same."""
    ref = reference
    comm = LocalRing(4, timeout=TIMEOUT)
    res = comm.run(lambda: _pp_step(ref["params"], CFG, ref["batch"], ref["draws"],
                                    mesh_cfg, comm, n_micro=1))
    metrics, grads = res[0]
    np.testing.assert_allclose(metrics["loss"].item(), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["grad_norm"], rtol=1e-5)
    _close_grads(grads, ref["grads"])
    for _, g in res[1:]:
        assert all(torch.equal(g[k], grads[k]) for k in grads)


_VARIANTS = {  # name: mesh, step options, model options, the JAX reference
    "pp2": (dict(dp=1, pp=2), {}, {}, "pp2xtp2"),
    "pp4_nmicro4": (dict(dp=1, pp=4), dict(n_micro=4), {}, "pp2xtp2"),
    "pp2xtp2": (dict(dp=1, pp=2, tp=2), {}, {}, "pp2xtp2"),
    "pp2_remat": (dict(dp=1, pp=2), {}, dict(remat=True), "pp2xtp2"),
    "pp2_joint_final_norm": (dict(dp=1, pp=2), {}, dict(joint_final_norm=True), None),
    "pp2_multiview": (dict(dp=1, pp=2), dict(num_views=2), MV_CFG, "multiview"),
}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_pipeline_matches_the_resident_step(references, name):
    """At dp = fsdp = 1 the pipeline (n_micro microbatches, every stage
    running every tick, one rotation a tick, the last stage's masked sum)
    computes the resident step: the loss, the grad norm and every
    gradient, against JAX's pipeline step at dp1 x pp2 x tp2 (pp2, pp4 with
    4 microbatches, tp inside the stages, remat: the same function), JAX's
    multiview step with the enc tokens collected (joint_final_norm), and
    the port's resident step on the same draws (each variant; the
    single-view joint_final_norm only against it)."""
    mesh_cfg, step_kw, model_kw, jax_ref = _VARIANTS[name]
    cfg = dict(CFG, **{k: v for k, v in model_kw.items() if k != "remat"})
    remat = dict(remat=True) if model_kw.get("remat") else {}
    views = step_kw.get("num_views", 1)
    ref = references[jax_ref] if jax_ref else None
    if ref is not None:
        whole, batch, draws = ref["params"], ref["batch"], ref["draws"]
    else:
        whole = dit_params_from_jax(_jax_params(cfg), DiTConfig(**cfg))
        batch = _batch(views)
        draws = LossDraws.draw(torch.Generator().manual_seed(4),
                               {k: t(v) for k, v in batch.items()})
    n = int(np.prod(list(mesh_cfg.values())))
    comm = LocalRing(n, timeout=TIMEOUT)
    res = comm.run(lambda: _pp_step(whole, cfg, batch, draws, mesh_cfg, comm,
                                    n_micro=step_kw.get("n_micro"), num_views=views, **remat))
    metrics, grads = res[0]
    want_m, want = _resident(whole, cfg, batch, draws, num_views=views, **remat)
    for loss, norm, g in ([want_m["loss"].item(), want_m["grad_norm"].item(), want],
                          *([[ref["loss"], ref["grad_norm"], ref["grads"]]] if ref else [])):
        np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_allclose(metrics["grad_norm"].item(), norm, rtol=1e-5)
        _close_grads(grads, g)


# -- refusals ---------------------------------------------------------------------

def _both_raise(jax_fn, port_fn):
    with pytest.raises(ValueError) as want:
        jax_fn()
    with pytest.raises(ValueError) as got:
        port_fn()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("mesh_cfg,n,match", [
    (dict(dp=1, pp=2, sp=2), 4, "pp composes with dp, fsdp and tp"),
    (dict(dp=1, fsdp=2, pp=2, tp=2), 8, "pp x tp requires fsdp=1"),
    (dict(dp=1, pp=4), 4, "num_layers=2 not divisible by pp=4")])
def test_pp_mesh_refusals_are_jax_messages(mesh_cfg, n, match):
    cfg = dict(CFG, num_layers=2)
    jm = jmesh.make_mesh(jmesh.MeshConfig(**mesh_cfg), devices=jax.devices()[:n])
    msg = _both_raise(
        lambda: jpp.make_pp_train_step(_jax_model(cfg), _capture(), jax_make_schedule(), jm),
        lambda: pp.check_pp_mesh({a: getattr(MeshConfig(**mesh_cfg).resolve(n), a)
                                  for a in AXES}, 2))
    assert match in msg


def test_pp_batch_and_multiview_refusals_are_jax_messages(reference):
    """A batch n_micro does not divide, and a multiview batch whose samples
    n_micro does not divide, raise JAX's messages (at the first step)."""
    ref = reference
    params = _jax_params(CFG)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, minval=0.0,
                   maxval=1.0: jnp.full(shape, 0.5, dtype))
        jm = jmesh.make_mesh(jmesh.MeshConfig(dp=1, pp=2), devices=jax.devices()[:2])
        jstep = jpp.make_pp_train_step(_jax_model(CFG), _capture(), jax_make_schedule(), jm,
                                       n_micro=3)
        jstate = lambda: JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                       opt_state=_capture().init(params))
        comm = LocalRing(2, timeout=TIMEOUT)
        draws = LossDraws.draw(torch.Generator().manual_seed(0),
                               {k: t(v) for k, v in ref["batch"].items()})
        msg = _both_raise(
            lambda: jstep(jstate(), ref["batch"], jax.random.PRNGKey(0)),
            lambda: comm.run(lambda: _pp_step(ref["params"], CFG, ref["batch"], draws,
                                              dict(dp=1, pp=2), comm, n_micro=3)))
        assert msg == "pipeline batch 4 not divisible by n_micro=3"
        mv = dict(CFG, multiview=True)
        japply = jpp.make_pp_apply(_jax_model(mv), 2, 2)
        x = jnp.zeros((1, 2 * F, 32, H, W))
        port = pp.make_pp_apply(ControlDiT(DiTConfig(**mv), dtype=torch.float32, device="cpu"),
                                dataclasses.make_dataclass("Solo", ["size", "rank"])(2, 0), 2)
        msg = _both_raise(lambda: japply(None, x, jnp.zeros((1, 8, 32)), jnp.zeros((1,)),
                                         num_views=2),
                          lambda: port(torch.zeros(1, 2 * F, 32, H, W), torch.zeros(1, 8, 32),
                                       torch.zeros(1), num_views=2))
        assert msg.startswith("multiview pp needs n_micro to divide the sample batch")
    finally:
        mp.undo()
