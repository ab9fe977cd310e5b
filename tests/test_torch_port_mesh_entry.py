"""The entry points under a mesh, against orv_tpu's: `train` at a pp mesh and
at dp2 x sp2, a checkpoint saved at fsdp2 resumed resident, and `evaluate`
at dp2 x tp2 in bf16 and W8A8, on the CPU at tiny sizes.

The port's ranks are threads of this process (`LocalRing`); the JAX package
runs on a mesh over the first n of the 8 forced host devices
(tests/conftest.py): its `train` builds its mesh over every device, so the
test hands it the first n (`make_mesh(..., devices=...)`), as its
`evaluate` does itself for a mesh smaller than the host. Both loaders run
one thread here, so both packages take the same batches in the same order
(with two, which collated batch comes next is a race in both). The draws
are JAX's keys replayed into the port (tests/test_torch_port_train_entry.py).

Tolerances: `train` as tests/test_torch_port_train_loop.py holds it against
JAX `train` (the loss and grad norm per micro-step to 1e-5 relative; the
parameters and EMA after 2 updates to 1e-4 RMS and 5e-2 at most of the
largest change); a checkpoint's round trip bitwise; `evaluate`'s latents
to the serving tolerances of tests/test_torch_port_serving.py (2e-2 of the
range at most and 3e-3 on average, W8A8 4e-2 and 3e-3).
"""

import functools
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from orv_tpu import configs as jconfigs
from orv_tpu.parallel import mesh as jmesh
from orv_tpu.parallel import train_step as jax_train_step
from orv_tpu.pipelines import evaluate as jevaluate
from orv_tpu.pipelines import train as jtrain
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.models import DiTConfig
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.parallel import TrainState
from orv_tpu_torch.parallel.sp import LocalRing
from orv_tpu_torch.parallel.train_step import state_tensors
from orv_tpu_torch.pipelines import evaluate as tevaluate
from orv_tpu_torch.pipelines import train as ttrain
from orv_tpu_torch.utils.checkpoint import TrainCheckpointer

from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)
from test_torch_port_serving import COND, compare_outputs, configs, jax_draws
from test_torch_port_serving import setup as serving_setup  # noqa: F401 (fixture)
from test_torch_port_serving_data import randomize
from test_torch_port_train_entry import (DIT, JAX_CFG, PORT_CFG, fix_uniforms, load,
                                         replayed_draws)
from test_torch_port_train_entry import setup as train_setup  # noqa: F401 (fixture)

TIMEOUT = 120.0  # seconds any rank may wait at a collective


def _one_thread_loaders(mp):
    for mod in (jtrain, ttrain):
        mp.setattr(mod, "prefetch_batches", functools.partial(mod.prefetch_batches,
                                                              num_threads=1))


def _jax_devices(mp, n):
    """JAX `train`'s mesh over the first n host devices."""
    make = jtrain.make_mesh
    mp.setattr(jtrain, "make_mesh", lambda cfg: make(cfg, devices=jax.devices()[:n]))


@pytest.fixture(scope="module")
def two_layers(tmp_path_factory):
    """The seeded random DiT of tests/test_torch_port_train_entry.py with two
    layers (a pipeline of two stages needs them), as its JAX params and its
    `export_torch_pretrained` folder."""
    from orv_tpu.models import ControlDiT as JaxControlDiT
    from orv_tpu.models import DiTConfig as JaxDiTConfig
    from orv_tpu.models import weights as jweights

    cfg = dict(DIT, num_layers=2)
    x = np.zeros((1, 3, 32, 4, 6), np.float32)
    params = randomize(jax.eval_shape(lambda: JaxControlDiT(JaxDiTConfig(**cfg)).init(
        {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
        np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
        actions=np.zeros((1, 8, 7), np.float32), depths=x, labels=x, deterministic=False)),
        seed=1)
    folder = tmp_path_factory.mktemp("two_layers") / "dit"
    jweights.export_torch_pretrained(str(folder), params, JaxDiTConfig(**cfg))
    return dict(params=params, folder=folder, cfg=DiTConfig(**cfg))


def _train_extra(s):
    return [f"transformer.pretrained_name_or_path={s['folder']}", "dataset.num_samples=2",
            "train.train_batch_size=2", "train.max_train_steps=4", "train.ema_decay=0.9",
            "train.checkpointing_steps=1000",
            # the clip of tests/test_torch_port_train_loop.py: rounding-level
            # gradients fall far below Adam's eps
            "train.optimizer.max_grad_norm=0.05"]


def _metrics(path):
    return [m for m in map(json.loads, path.read_text().splitlines()) if "loss" in m]


@pytest.mark.parametrize("axes", [("pp=2",), ("dp=2", "sp=2")])
def test_train_at_a_mesh_matches_jax(train_setup, two_layers, tmp_path, axes):
    """JAX `train` and the port's at the same mesh (the pipeline with its
    default n_micro = pp over a batch of 2; dp x sp with the ring inside each
    dp group), 2 updates of 2 micro-steps with an EMA, on the same batches
    and draws: the loss and grad norm per micro-step, and the whole
    parameters and EMA after."""
    s = train_setup
    mesh = [f"train.mesh.{a}" for a in axes] + (["train.mesh.dp=1"] if "dp=2" not in axes
                                                 else [])
    n = int(np.prod([int(a.split("=")[1]) for a in axes]))
    extra = _train_extra(two_layers) + mesh + ["transformer.num_layers=2"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("NO_INIT_VAL", "1")
        mp.setenv("ORV_TPU_FUSED_ADALN", "0")
        fix_uniforms(mp, 2)
        _one_thread_loaders(mp)
        _jax_devices(mp, n)
        jstate = jtrain.train(load(jconfigs, JAX_CFG, s["one"], tmp_path / "jax", extra))
        tcfg = load(tconfigs, PORT_CFG, s["one"], tmp_path / "port", extra)
        comm = LocalRing(n, timeout=TIMEOUT)

        def rank():
            state = ttrain.train(tcfg, device="cpu", draws=replayed_draws(42), comm=comm)
            return state.step, ttrain.whole_params(state), ttrain.whole_params(state, ema=True)

        ranks = comm.run(rank)
    finally:
        mp.undo()
    want = _metrics(tmp_path / "jax" / "run" / "logs" / "metrics.jsonl")
    got = _metrics(tmp_path / "port" / "run" / "logs" / "metrics.jsonl")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("loss", "diffusion_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=(k, w["step"]))
    cfg = two_layers["cfg"]
    start = dit_params_from_jax(two_layers["params"], cfg)
    want_p = dit_params_from_jax(jax.device_get(jstate.params), cfg)
    want_e = dit_params_from_jax(jax.device_get(jax_train_step.ema_params(jstate.opt_state)),
                                 cfg)
    scale = max((want_p[k] - start[k]).abs().max().item() for k in want_p)
    for step, params, ema in ranks:
        assert step == 4 and sorted(params) == sorted(want_p)
        err = torch.cat([(params[k] - want_p[k]).flatten() for k in want_p]
                        + [(ema[k] - want_e[k]).flatten() for k in want_p])
        assert err.abs().max() <= 5e-2 * scale, (err.abs().max().item(), scale)
        assert err.pow(2).mean().sqrt() <= 1e-4 * scale, (err.pow(2).mean().sqrt().item(), scale)
    assert all(torch.equal(ranks[0][1][k], r[1][k]) for r in ranks[1:] for k in want_p)


def test_checkpoint_saved_at_fsdp2_resumes_resident(train_setup, tmp_path, monkeypatch):
    """`train` at fsdp2 (ZeRO-3 shards of the parameters, moments and EMA)
    saves whole tensors under the resident names: a resident train state
    restores them bitwise, and resident `train` resumes from them; a
    resident checkpoint restores into fsdp2 shards bitwise, back again."""
    s = train_setup
    monkeypatch.setenv("NO_INIT_VAL", "1")
    base = [f"transformer.pretrained_name_or_path={s['folder']}", "dataset.num_samples=2",
            "train.train_batch_size=2", "train.ema_decay=0.9", "train.checkpointing_steps=1000"]
    cfg = lambda *extra: load(tconfigs, PORT_CFG, s["one"], tmp_path, base + list(extra))
    comm = LocalRing(2, timeout=TIMEOUT)
    sharded = cfg("train.max_train_steps=3", "train.mesh.fsdp=2")

    def rank():
        state = ttrain.train(sharded, device="cpu", comm=comm)
        assert state.model.zero is not None and state.opt_state.mini_step == 1
        return state_tensors(state)[0]

    whole = comm.run(rank)
    assert all(torch.equal(whole[0][k], whole[1][k]) for k in whole[0])
    ck = TrainCheckpointer(str(tmp_path / "run" / "checkpoints"))
    assert ck.all_steps() == [3]
    resident = cfg("train.max_train_steps=3")
    model = ttrain.init_params(resident, ttrain.build_dit_config(resident), torch.float32, "cpu")
    state = TrainState.create(model, ttrain.build_optimizer(resident.train, 3, 2))
    ck.restore(state)
    back, scalars = state_tensors(state)
    assert scalars == dict(step=3, count=1, mini_step=1) and sorted(back) == sorted(whole[0])
    assert all(torch.equal(back[k], v) for k, v in whole[0].items())
    resumed = ttrain.train(cfg("train.max_train_steps=4", "train.resume_from_checkpoint=true"),
                           device="cpu")
    assert resumed.step == 4 and resumed.opt_state.count == 2
    # and back: the resident checkpoint of step 4 into fsdp2 shards
    want, _ = state_tensors(resumed)

    def restore():
        st = ttrain.train(cfg("train.max_train_steps=4", "train.resume_from_checkpoint=true",
                              "train.mesh.fsdp=2"), device="cpu", comm=comm)
        return state_tensors(st)[0]

    for got in comm.run(restore):
        assert all(torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("quant", [False, True])
def test_evaluate_dp2_tp2_matches_jax(serving_setup, quant):
    """`evaluate` at evaluation.mesh dp=2, tp=2 on 4 ranks, and on 5 (the
    mesh over the first 4, the fifth returning nothing), against JAX's
    serving mesh over the first 4 of its 8 devices: the batch of 2 split over dp (each rank
    denoising its row), the heads and feed-forward columns over tp (W8A8:
    the row-parallel layers quantize by their whole rows' absmax); rank 0
    writes what JAX writes, every rank returns the clip names."""
    s = serving_setup
    extra = ["evaluation.mode=traj-image-depth-label", "evaluation.mesh.dp=2",
             "evaluation.mesh.tp=2"] + (["evaluation.quant=true"] if quant else [])
    jcfg, tcfg = configs(s, COND, f"mesh_{quant}", extra)
    jres = jevaluate.evaluate(jcfg, max_batches=1)
    for ranks in (4, 5):  # on 5 the mesh takes the first 4 ranks, as JAX's its first devices
        shutil.rmtree(tcfg.evaluation.output_dir, ignore_errors=True)
        comm = LocalRing(ranks, timeout=TIMEOUT)
        tres = comm.run(lambda: tevaluate.evaluate(tcfg, max_batches=1, device="cpu",
                                                   draws=jax_draws(), comm=comm))
        assert all(r == jres for r in tres[:4]) and tres[4:] in ([], [[]])
        names = compare_outputs(s, Path(jcfg.evaluation.output_dir),
                                Path(tcfg.evaluation.output_dir),
                                *((4e-2, 3e-3) if quant else ()))
        assert sum(n.endswith("_latents.npz") for n in names) == 2


def test_evaluate_dp2_dpm_rows_match_the_whole_batch(serving_setup):
    """With the stochastic DPM sampler the dp ranks each draw the whole
    batch's noise and keep their rows: evaluation.mesh.dp=2 (and fsdp=2,
    whose ranks gather each block) writes the resident run's latents, to
    the bf16 serving tolerance."""
    s = serving_setup
    dpm = ["evaluation.mode=traj-image-depth-label", "evaluation.scheduler=dpm"]
    _, ref = configs(s, COND, "dpm_res", dpm)
    tevaluate.evaluate(ref, max_batches=1, device="cpu")
    for mesh, n in ((["evaluation.mesh.dp=2"], 2), (["evaluation.mesh.dp=2",
                                                      "evaluation.mesh.fsdp=2"], 4)):
        _, tcfg = configs(s, COND, f"dpm_{n}", dpm + mesh)
        comm = LocalRing(n, timeout=TIMEOUT)
        comm.run(lambda: tevaluate.evaluate(tcfg, max_batches=1, device="cpu", comm=comm))
        names = sorted(p.name for p in Path(ref.evaluation.output_dir).glob("*.npz"))
        assert len(names) == 2
        for name in names:
            got = np.load(Path(tcfg.evaluation.output_dir) / name)["arr_0"]
            want = np.load(Path(ref.evaluation.output_dir) / name)["arr_0"]
            span = want.max() - want.min()
            assert np.abs(got - want).max() <= 2e-2 * span, (mesh, name)


def test_evaluate_mesh_smaller_than_the_ranks_takes_the_first(serving_setup):
    """evaluation.mesh.tp=2 on 3 ranks: ranks 0 and 1 serve, rank 2 returns
    at once with nothing; a mesh larger than the ranks names the cause."""
    s = serving_setup
    _, tcfg = configs(s, COND, "first", ["evaluation.mode=traj-image-depth-label",
                                         "evaluation.mesh.dp=1", "evaluation.mesh.tp=2"])
    comm = LocalRing(3, timeout=TIMEOUT)
    res = comm.run(lambda: tevaluate.evaluate(tcfg, max_batches=1, device="cpu", comm=comm))
    assert res[0] == res[1] and len(res[0]) == 2 and res[2] == []
    _, big = configs(s, COND, "big", ["evaluation.mesh.tp=4"])
    with pytest.raises(ValueError, match="evaluation.mesh.tp=4 needs 4 ranks but the "
                                         "communicator passed has 2"):
        tevaluate.evaluate(big, device="cpu", comm=_Sized(2))


class _Sized:
    """A communicator of `size` ranks, seen from rank 0, for refusals that
    come before any collective."""

    def __init__(self, size):
        self.size, self.rank = size, 0


def test_jax_serving_mesh_is_the_first_devices():
    """JAX's `evaluate` builds an explicit mesh smaller than the host over
    its first devices (orv_tpu/pipelines/evaluate.py:221-226), the layout
    the port's `serving_mesh` takes over its ranks."""
    m = jmesh.make_mesh(jmesh.MeshConfig(dp=2, tp=2), devices=jax.devices()[:4])
    assert [d.id for d in m.devices.reshape(-1)] == [0, 1, 2, 3]
