"""Context parallelism in the port: the ring under autograd, the sp ControlDiT's
gradients, and `train` / `evaluate` at `mesh.sp = 2`, on the CPU at tiny sizes.

The JAX side runs its ring on a CPU mesh of n of the 8 forced host devices
(tests/conftest.py), as tests/test_ring_attention.py does; the port runs its
ranks as threads of this process (`LocalRing(n)`), and once as two
processes over gloo (`ProcessGroupRing`). Inputs come from numpy seeds and
are copied into torch (`torch.tensor`). Tolerances, f32 throughout:
  * the ring's q, k, v gradients against JAX's ring gradients (its XLA
    path, which takes the exact lse whatever the static max; twice through
    its Pallas flash kernels in interpret mode) and against the port's resident flash gradients: 1e-5 of the
    largest gradient (the same partials, merged and summed in another
    order); every rank's gradients bitwise equal, and gloo's bitwise equal
    to `LocalRing`'s (every sum in rank order);
  * the sp ControlDiT against JAX's sp model (tests/test_train_step.py:391):
    the loss to 1e-6 relative, every parameter's gradient to 1e-5 of the
    largest gradient;
  * `train` at train.mesh.sp=2 against the port's resident `train` on the
    same batches and draws: each micro-step's loss and grad norm to 1e-5
    relative; the parameters after one AdamW update, against the largest
    change of any parameter, to 1e-4 RMS and 5e-2 at most, as
    tests/test_torch_port_train_entry.py holds them, over every parameter
    but the keys' LayerNorm bias: its exact gradient is zero (shifting
    every key shifts a query's logits uniformly), so Adam's first step,
    g / (|g| + eps), moves it by rounding noise, anywhere within the lr, in
    either run (bound: twice the largest change); every rank's parameters,
    moments and batches bitwise equal;
  * `evaluate` at evaluation.mesh.sp=2 against JAX's `evaluate` at the same
    overrides (tests/test_e2e_pipeline.py:279): the serving tolerances of
    tests/test_torch_port_serving.py (2e-2 of the latents' range at most,
    3e-3 on average: both DiTs compute in bf16).
Every collective waits at most TIMEOUT seconds and the gloo processes are
killed at their deadline, so no test can hang.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orv_tpu import configs as jconfigs
from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.ops.ring_attention import joint_ring_attention as jax_joint_ring_attention
from orv_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from orv_tpu.pipelines import evaluate as jevaluate
from orv_tpu.pipelines import train as jtrain
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.ops import attention
from orv_tpu_torch.ops.ring_attention import joint_ring_attention, ring_attention
from orv_tpu_torch.parallel.sp import LocalRing
from orv_tpu_torch.pipelines import evaluate as tevaluate
from orv_tpu_torch.pipelines import train as ttrain

from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)
from test_torch_port_ring import _free_port, _randomize
from test_torch_port_serving import COND, compare_outputs, configs, jax_draws
from test_torch_port_serving import setup as serving_setup  # noqa: F401 (fixture)
from test_torch_port_train_entry import JAX_CFG, PORT_CFG, load
from test_torch_port_train_entry import setup as train_setup  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 60.0  # seconds any rank may wait at a collective
T_TEXT = 12  # text tokens, not divisible by 4 (tests/test_ring_attention.py:59)


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(n), ("sp",))


def _inputs(seed, shape):
    """numpy q, k (N(0, 0.5^2)), v and the output cotangent (N(0, 1))."""
    rng = np.random.default_rng(seed)
    q, k = (0.5 * rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _ring_grads(comm, fn, arrays, **kw):
    """(out, dq, dk, dv) of sum(fn(q, k, v) * do) on every rank of `comm`."""
    q, k, v, do = (torch.tensor(a) for a in arrays)

    def body():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, comm, **kw)
        (out * do).sum().backward()
        return (out.detach(), *(x.grad for x in leaves))

    return comm.run(body)


def _same_on_all_ranks(results):
    for r in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, results[0]))
    return results[0]


def _close(got, want, tol=1e-5):
    """Each error within `tol` of the largest magnitude of `want`."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("joint,n,static_max,jax_impl", [
    *((joint, n, sm, "xla") for joint in (True, False) for n in (2, 4) for sm in (None, 24.0)),
    (True, 2, None, "flash"), (False, 2, 24.0, "flash")])
def test_ring_grads_match_jax_and_resident(joint, n, static_max, jax_impl):
    """`joint_ring_attention` / `ring_attention` under autograd (the flash
    path: per-chunk (out, lse) merged by their logsumexp, the text merge's
    max carrying no gradient) against `jax.grad` through JAX's ring on an
    n-device mesh and against the port's resident flash gradients."""
    S = T_TEXT + 128 if joint else 128
    q, k, v, do = _inputs(40 + n + (2 if joint else 0), (1, 2, S, 16))
    comm = LocalRing(n, timeout=TIMEOUT)
    if joint:
        fn = lambda q, k, v, comm, **kw: joint_ring_attention(q, k, v, T_TEXT, comm, **kw)
        jfn = lambda q, k, v: jax_joint_ring_attention(q, k, v, T_TEXT, _mesh(n), impl=jax_impl,
                                                       static_max=static_max)
    else:
        fn = ring_attention
        jfn = lambda q, k, v: jax_ring_attention(q, k, v, _mesh(n), impl=jax_impl,
                                                 static_max=static_max)
    got = _same_on_all_ranks(_ring_grads(comm, fn, (q, k, v, do), impl="flash",
                                         static_max=static_max))
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v) * do), argnums=(0, 1, 2)))(
        q, k, v)
    for a, b in zip(got[1:], want):
        _close(a.numpy(), np.asarray(b))
    leaves = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    out, _ = attention.flash_attention(*leaves, static_max=static_max)
    (out * torch.tensor(do)).sum().backward()
    _close(got[0].numpy(), out.detach().numpy())
    for a, b in zip(got[1:], leaves):
        _close(a.numpy(), b.grad.numpy())


_GLOO_WORKER = """
import sys
import torch
from orv_tpu_torch.ops.ring_attention import joint_ring_attention
from orv_tpu_torch.parallel.sp import ProcessGroupRing

rank, world, port, folder = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
comm = ProcessGroupRing.init_process_group("gloo", f"tcp://localhost:{port}", world, rank,
                                           timeout=60.0)
q, k, v, do = torch.load(f"{folder}/inputs.pt")
leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
out = joint_ring_attention(*leaves, 12, comm, impl="flash", static_max=24.0)
(out * do).sum().backward()
torch.save([out.detach()] + [x.grad for x in leaves], f"{folder}/rank{rank}.pt")
torch.distributed.destroy_process_group()
"""


def test_ring_grads_over_gloo_match_local_ring(tmp_path):
    """Two processes over gloo (`ProcessGroupRing`): the joint ring's output
    and q, k, v gradients are, bit for bit, those of the two threads of
    `LocalRing(2)`. The processes are killed at a 120 s deadline."""
    arrays = _inputs(7, (1, 2, T_TEXT + 64, 16))
    torch.save([torch.tensor(a) for a in arrays], tmp_path / "inputs.pt")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r), "2", str(port),
                               str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.monotonic() + 120.0
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    comm = LocalRing(2, timeout=TIMEOUT)
    want = _ring_grads(comm, lambda q, k, v, comm, **kw: joint_ring_attention(
        q, k, v, T_TEXT, comm, **kw), arrays, impl="flash", static_max=24.0)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert all(torch.equal(a, b) for a, b in zip(got, want[r]))


# the DiT of tests/test_train_step.py:391-395: 2 layers of 4 x 16 heads, 6-chunk
SP_DIT = dict(num_attention_heads=4, attention_head_dim=16, num_layers=2, in_channels=32,
              out_channels=16, text_embed_dim=32, time_embed_dim=64, max_text_seq_length=8,
              sample_width=16, sample_height=8, modulate_encoder_hidden_states=True)


@pytest.mark.parametrize("remat", [False, True])
def test_sp_control_dit_loss_and_grads_match_jax(remat):
    """mean(out^2) of `ControlDiT(sp=LocalRing(2))` (one model a rank, the
    same weights) and every parameter's gradient, against JAX's sp model on
    a 2-device mesh (the joint-text regime, tests/test_train_step.py:384);
    under remat the backward recomputes the ring, collectives included.
    Every rank's loss and gradients are the same bits."""
    B, F, C, H, W = 2, 3, 16, 8, 16
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, F, 2 * C, H, W)).astype(np.float32)
    enc = rng.standard_normal((B, 8, 32)).astype(np.float32)
    t = np.zeros((B,), np.int32)
    jcfg = JaxDiTConfig(**SP_DIT)
    params = _randomize(jax.eval_shape(lambda: JaxControlDiT(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(2), x, enc, t, actions=np.zeros((B, 4 * F - 1, 7), np.float32))),
        seed=31)  # with the action embed the port's state dict holds (unused here)
    jmodel = JaxControlDiT(jcfg, dtype=jnp.float32, sp_mesh=_mesh(2))

    def jax_loss(p):
        out, _, _ = jmodel.apply(p, x, enc, t)
        return (out.astype(jnp.float32) ** 2).mean()

    want_loss, want_g = jax.jit(jax.value_and_grad(jax_loss))(params)
    tcfg = DiTConfig(**SP_DIT)
    want = dit_params_from_jax(jax.device_get(want_g), tcfg)
    state = dit_params_from_jax(params, tcfg)
    comm = LocalRing(2, timeout=TIMEOUT)
    models = [ControlDiT(tcfg, dtype=torch.float32, device="cpu", sp=comm, remat=remat)
              for _ in range(2)]
    for m in models:
        m.load_state_dict(state, strict=True)
    tx, te, tt = torch.tensor(x), torch.tensor(enc), torch.tensor(t)

    def body():
        model = models[comm.rank]
        out = model(tx, te, tt)
        loss = (out.float() ** 2).mean()
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None}

    results = comm.run(body)
    (loss, grads), (loss1, grads1) = results
    assert torch.equal(loss, loss1) and grads.keys() == grads1.keys()
    assert all(torch.equal(grads[n], grads1[n]) for n in grads)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    scale = max(np.abs(np.asarray(g)).max() for g in want.values())
    for name, w in want.items():
        got = grads.get(name, torch.zeros_like(w))
        err = (got - w).abs().max().item()
        assert err <= 1e-5 * scale, (name, err, scale)


# -- the entry points ---------------------------------------------------------------

class _Batches:
    """Stands in for pipelines/train.py's `to_device`: records the bits of
    each micro-step's batch by rank (`LocalRing` threads tell theirs by the
    ring's rank) and, with `replay`, feeds a run those batches instead."""

    def __init__(self, monkeypatch, comm=None, replay=None):
        self.seen, self.replay, self.comm = {}, replay, comm
        self.orig = ttrain.to_device
        monkeypatch.setattr(ttrain, "to_device", self)

    def __call__(self, batch, device):
        rank = 0 if self.comm is None else self.comm.rank
        seen = self.seen.setdefault(rank, [])
        if self.replay is not None:
            batch = self.replay[len(seen)]
        seen.append({k: np.array(v) for k, v in batch.items() if isinstance(v, np.ndarray)})
        return self.orig(batch, device)


def _train_cfg(setup, out: Path, extra=()):
    return load(tconfigs, PORT_CFG, setup["many"], out, [
        f"transformer.pretrained_name_or_path={setup['folder']}", "train.max_train_steps=2",
        "train.checkpointing_steps=1000", *extra])


def test_train_sp_matches_resident_and_ranks_agree(train_setup, tmp_path, monkeypatch):
    """`train` with train.mesh.sp=2 on `LocalRing(2)`'s ranks (each calls
    `train`) over a three-episode dataset (the two-thread loader's order is
    not fixed): every rank takes rank 0's batches and ends with the same
    parameters and moments, bit for bit; only rank 0 writes the inline
    validation, the tracker's lines, the checkpoint and the export. The
    port's resident `train` on the same batches and draws gives the same
    losses, grad norms and parameters."""
    comm = LocalRing(2, timeout=TIMEOUT)
    # the clip of tests/test_torch_port_train_loop.py: without it, on one of
    # the orders the loader can give ([episode 0, episode 2]) a few to_q
    # gradients lie near Adam's eps and its first step turns the ring's other
    # summation order into a fifth of an lr step (RMS 3.3e-7 over 1e-3 moved)
    clip = ["train.optimizer.max_grad_norm=0.05"]
    cfg = _train_cfg(train_setup, tmp_path / "sp", ["train.mesh.sp=2"] + clip)
    batches = _Batches(monkeypatch, comm)
    states = comm.run(lambda: ttrain.train(cfg, device="cpu", comm=comm))
    assert batches.seen[0] and len(batches.seen[0]) == 2
    for a, b in zip(batches.seen[0], batches.seen[1]):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    params = [[p.detach() for p in s.model.parameters()] for s in states]
    assert all(torch.equal(a, b) for a, b in zip(*params))
    moments = [s.opt_state.mu + s.opt_state.nu for s in states]
    assert all(torch.equal(a, b) for a, b in zip(*moments))
    assert all(s.model.sp is comm and s.step == 2 for s in states)
    run = tmp_path / "sp" / "run"
    assert sorted(p.name for p in (run / "validation").iterdir()) == [
        "step_000000_latents.npz"]
    assert (run / "checkpoint" / "config.json").exists()
    assert [p.name for p in (run / "checkpoints").iterdir()] == ["2"]
    sp_metrics = [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text()
                  .splitlines()]
    sp_metrics = [m for m in sp_metrics if "loss" in m]

    monkeypatch.setattr(ttrain, "to_device", batches.orig)
    resident = _Batches(monkeypatch, replay=batches.seen[0])
    ref_cfg = _train_cfg(train_setup, tmp_path / "res", clip)
    ref = ttrain.train(ref_cfg, device="cpu")
    assert len(resident.seen[0]) == 2
    ref_metrics = [json.loads(line) for line in
                   (tmp_path / "res" / "run" / "logs" / "metrics.jsonl").read_text().splitlines()]
    ref_metrics = [m for m in ref_metrics if "loss" in m]
    assert len(sp_metrics) == len(ref_metrics) == 2
    for a, b in zip(sp_metrics, ref_metrics):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    init = ttrain.init_params(ref_cfg, ref.model.config, torch.float32, "cpu")
    start = dict(init.named_parameters())
    moved = max((p.detach() - start[n]).abs().max().item()
                for n, p in ref.model.named_parameters())
    assert moved > 0
    diffs = {n: (a - b.detach()).flatten()
             for a, (n, b) in zip(params[0], ref.model.named_parameters())}
    d = torch.cat([e for n, e in diffs.items() if not n.endswith("norm_k.bias")])
    # measured over the three orders: 8.7e-6 to 5.1e-5, and 2.1e-3 to 2.3e-2
    assert d.pow(2).mean().sqrt().item() <= 1e-4 * moved
    assert d.abs().max().item() <= 5e-2 * moved
    assert all(e.abs().max().item() <= 2 * moved for n, e in diffs.items()
               if n.endswith("norm_k.bias"))


def test_train_sp_resumes_every_rank_from_one_checkpoint(train_setup, tmp_path, monkeypatch):
    """A run at sp=2 on one slice, cut after micro-step 2 and resumed to 3:
    every rank restores rank 0's checkpoint and ends with the same
    parameters as the other ranks and as an unbroken run of 3, bit for
    bit."""
    monkeypatch.setenv("NO_INIT_VAL", "1")
    comm = LocalRing(2, timeout=TIMEOUT)
    cfg = lambda out, *extra: load(tconfigs, PORT_CFG, train_setup["one"], tmp_path / out, [
        f"transformer.pretrained_name_or_path={train_setup['folder']}", "dataset.num_samples=1",
        "train.mesh.sp=2", "train.checkpointing_steps=1000", *extra])
    cut = cfg("cut", "train.max_train_steps=2")
    comm.run(lambda: ttrain.train(cut, device="cpu", comm=comm))
    resumed = cfg("cut", "train.max_train_steps=3", "train.resume_from_checkpoint=true")
    states = comm.run(lambda: ttrain.train(resumed, device="cpu", comm=comm))
    whole = cfg("whole", "train.max_train_steps=3")
    ref = comm.run(lambda: ttrain.train(whole, device="cpu", comm=comm))
    assert all(s.step == 3 for s in states + ref)
    for s in states[1:] + ref:
        assert all(torch.equal(a, b) for a, b in zip(s.model.parameters(),
                                                     states[0].model.parameters()))


@pytest.mark.parametrize("quant", [False, True])
def test_evaluate_sp_matches_jax(serving_setup, quant):
    """`evaluate` with evaluation.mesh.sp=2 on `LocalRing(2)`'s ranks (each
    with its own replay of JAX's draws) against JAX's `evaluate` at the same
    overrides on a 2-device sp mesh: rank 0 writes what JAX writes (the
    latents, the decoded clips and the manifests), to the serving
    tolerances (W8A8: the int8 model's ring runs the bf16 attention on both
    sides, held to the W8A8 serving tolerance); every rank returns the clip
    names."""
    s = serving_setup
    extra = ["evaluation.mode=traj-image-depth-label", "evaluation.mesh.sp=2"] + (
        ["evaluation.quant=true"] if quant else [])
    jcfg, tcfg = configs(s, COND, f"sp_{quant}", extra)
    jres = jevaluate.evaluate(jcfg, max_batches=1)
    comm = LocalRing(2, timeout=TIMEOUT)
    tres = comm.run(lambda: tevaluate.evaluate(tcfg, max_batches=1, device="cpu",
                                               draws=jax_draws(), comm=comm))
    assert tres[0] == tres[1] == jres
    names = compare_outputs(s, Path(jcfg.evaluation.output_dir),
                            Path(tcfg.evaluation.output_dir), *((4e-2, 3e-3) if quant else ()))
    assert sum(n.endswith("_latents.npz") for n in names) == 2


# -- refusals -----------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["tp", "pp"])
def test_train_sp_with_tp_or_pp_raises_jax_error(train_setup, tmp_path, axis):
    extra = ["train.mesh.sp=2", f"train.mesh.{axis}=2"]
    with pytest.raises(ValueError) as want:
        jtrain.train(load(jconfigs, JAX_CFG, train_setup["one"], tmp_path / "jax", extra))
    with pytest.raises(ValueError) as got:
        ttrain.train(_train_cfg(train_setup, tmp_path / "port", extra), device="cpu")
    assert str(got.value) == str(want.value) == "train.mesh.sp composes with dp/fsdp only (tp=pp=1)"
    assert not (tmp_path / "port" / "run").exists()


@pytest.mark.parametrize("axis", ["dp", "fsdp"])
def test_train_sp_with_dp_or_fsdp_names_a8(train_setup, tmp_path, monkeypatch, axis):
    """dp x sp and fsdp x sp (2 x 2 ranks, the ring inside each data group;
    fsdp's shards gathered outside the ring) on `LocalRing(4)`, against the
    port's resident `train` on the same batches and draws: each micro-step's
    loss and grad norm to 1e-5 relative, the whole parameters after the
    update as the sp run is held above; every rank's whole parameters the
    same bits. (These meshes were refused naming ROADMAP.md A8 until data
    and model parallelism were ported.)"""
    monkeypatch.setenv("NO_INIT_VAL", "1")
    comm = LocalRing(4, timeout=TIMEOUT)
    # the clip of tests/test_torch_port_train_loop.py: gradients at f32
    # rounding level fall far below Adam's eps, so its first step does not
    # turn the two runs' different summation orders into whole lr steps
    extra = ["train.train_batch_size=2", "train.max_train_steps=2",
             "train.optimizer.max_grad_norm=0.05"]
    cfg = _train_cfg(train_setup, tmp_path / "mesh", extra + [
        "train.mesh.sp=2", f"train.mesh.{axis}=2", "train.mesh.dp=" + ("2" if axis == "dp"
                                                                      else "1")])
    batches = _Batches(monkeypatch, comm)
    ranks = comm.run(lambda: ttrain.whole_params(ttrain.train(cfg, device="cpu", comm=comm)))
    assert all(torch.equal(ranks[0][k], r[k]) for r in ranks[1:] for k in ranks[0])
    assert len(batches.seen[0]) == 2 and all(len(batches.seen[r]) == 2 for r in range(4))
    got = [m for m in map(json.loads, (tmp_path / "mesh" / "run" / "logs" / "metrics.jsonl")
                          .read_text().splitlines()) if "loss" in m]
    monkeypatch.setattr(ttrain, "to_device", batches.orig)
    _Batches(monkeypatch, replay=batches.seen[0])
    ref_cfg = _train_cfg(train_setup, tmp_path / "res", extra)
    ref = ttrain.train(ref_cfg, device="cpu")
    want = [m for m in map(json.loads, (tmp_path / "res" / "run" / "logs" / "metrics.jsonl")
                           .read_text().splitlines()) if "loss" in m]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    start = dict(ttrain.init_params(ref_cfg, ref.model.config, torch.float32,
                                    "cpu").named_parameters())
    moved = max((p.detach() - start[n]).abs().max().item() for n, p in ref.model.named_parameters())
    diffs = {n: (ranks[0][n] - p.detach()).flatten() for n, p in ref.model.named_parameters()}
    d = torch.cat([e for n, e in diffs.items() if not n.endswith("norm_k.bias")])
    assert d.pow(2).mean().sqrt().item() <= 1e-4 * moved
    assert d.abs().max().item() <= 5e-2 * moved


def test_sp_without_enough_ranks_names_the_cause(train_setup, serving_setup, tmp_path):
    """No communicator and no torch.distributed group of that size, or a
    communicator of another size: both entry points raise, naming the
    ranks they need."""
    cfg = _train_cfg(train_setup, tmp_path, ["train.mesh.sp=2"])
    with pytest.raises(ValueError, match="train.mesh.sp=2 needs 2 ranks, and this process has 1"):
        ttrain.train(cfg, device="cpu")
    # a communicator of another size than the mesh names (dp: -1 would take
    # any multiple of the other axes)
    with pytest.raises(ValueError, match="communicator passed has 4 ranks"):
        ttrain.train(_train_cfg(train_setup, tmp_path, ["train.mesh.sp=2", "train.mesh.dp=1"]),
                     device="cpu", comm=LocalRing(4))
    with pytest.raises(ValueError, match="train.mesh.dp=1 needs 1 ranks but the communicator "
                                         "passed has 2"):
        ttrain.train(_train_cfg(train_setup, tmp_path, ["train.mesh.dp=1"]), device="cpu",
                     comm=LocalRing(2))
    _, tcfg = configs(serving_setup, COND, "few", ["evaluation.mesh.sp=2"])
    with pytest.raises(ValueError, match="evaluation.mesh.sp=2 needs 2 ranks"):
        tevaluate.evaluate(tcfg, device="cpu")


def test_evaluate_sp_with_tp_raises_jax_error(serving_setup):
    jcfg, tcfg = configs(serving_setup, COND, "sptp", ["evaluation.mesh.sp=2",
                                                       "evaluation.mesh.tp=2"])
    with pytest.raises(ValueError) as want:
        jevaluate.evaluate(jcfg, max_batches=1)
    with pytest.raises(ValueError) as got:
        tevaluate.evaluate(tcfg, device="cpu", comm=LocalRing(2))
    assert str(got.value) == str(want.value)
