"""The port's mesh (`orv_tpu_torch/parallel/mesh.py`) and the communicators it
splits (`parallel/sp.py`), against orv_tpu's, on the CPU.

* `MeshConfig.resolve` and its error text, and the rank layout of
  `make_mesh` (row-major over (dp, fsdp, pp, tp, sp), as
  `np.asarray(devices).reshape(...)` lays JAX's devices), each axis's group
  and the (dp, fsdp) data group;
* the shard plan: the port's `param_shardings` on every parameter of the
  port's DiT against JAX's `param_shardings` on `jax.eval_shape` of the JAX
  DiT (no compile), leaf by leaf, at meshes that exercise each rule (tp
  column and row parallel, fsdp's largest free axis, the head's in-dim,
  the stacked kernels' out-dim and ('tp', 'fsdp') stacking, sp's in-dim
  rule, pp on the layer axis), single-view and multiview;
* the sub-group collectives on `LocalRing` threads and their backwards,
  every sum in rank order (bitwise against a sum written out in that
  order), and the same from 4 processes over gloo (`ProcessGroupRing.split`
  over `torch.distributed.new_group`), bitwise equal to the threads';
* `train` at pp2 x tp2 from 4 processes over gloo (`torchrun`'s
  environment, given by hand): the same whole parameters, bit for bit, as
  the same run on `LocalRing(4)`;
* `initialize_distributed` with an explicit address that fails raises,
  naming it.
Every collective waits at most TIMEOUT seconds and the gloo processes are
killed at their deadline, so no test can hang.
"""

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.parallel import mesh as jmesh
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.parallel import mesh
from orv_tpu_torch.parallel import sp as spmod
from orv_tpu_torch.parallel.sp import LocalRing

from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)
from test_torch_port_ring import _free_port

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 60.0


# -- layout ---------------------------------------------------------------------

@pytest.mark.parametrize("cfg,n", [
    (dict(dp=-1), 8), (dict(dp=-1, tp=2), 8), (dict(dp=2, fsdp=2, tp=2), 8),
    (dict(dp=-1, fsdp=2, pp=2), 8), (dict(dp=1, pp=2, tp=2, sp=1), 4), (dict(dp=-1, sp=2), 4)])
def test_resolve_matches_jax(cfg, n):
    want = jmesh.MeshConfig(**cfg).resolve(n)
    assert mesh.MeshConfig(**cfg).resolve(n) == mesh.MeshConfig(
        want.dp, want.fsdp, want.tp, want.pp, want.sp)


@pytest.mark.parametrize("cfg,n", [(dict(dp=2, tp=2), 8), (dict(dp=-1, tp=3), 8),
                                   (dict(dp=1, pp=2, sp=2), 2)])
def test_resolve_refuses_as_jax_does(cfg, n):
    with pytest.raises(ValueError) as want:
        jmesh.MeshConfig(**cfg).resolve(n)
    with pytest.raises(ValueError) as got:
        mesh.MeshConfig(**cfg).resolve(n)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg", [dict(dp=2, fsdp=2, tp=2), dict(dp=1, fsdp=2, pp=2, tp=2),
                                 dict(dp=2, pp=2, sp=2)])
def test_rank_layout_and_groups_match_jax_make_mesh(cfg):
    """Each rank's coordinates are its device's place in JAX's mesh array,
    and each axis's group (and the data group) are the devices that differ
    from it only on those axes, in the array's order."""
    jm = jmesh.make_mesh(jmesh.MeshConfig(**cfg), devices=jax.devices()[:8])
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    comm = LocalRing(8, timeout=TIMEOUT)

    def body():
        m = mesh.make_mesh(mesh.MeshConfig(**cfg), comm)
        groups = {}
        for axes in (("dp",), ("fsdp",), ("pp",), ("tp",), ("sp",), ("dp", "fsdp")):
            c = m.comm_of(axes)
            groups[axes] = (c.rank, c.all_gather_seq(torch.tensor([m.rank]), 0).tolist())
        return m.coords, groups

    for rank, (coords, groups) in enumerate(comm.run(body)):
        assert tuple(coords[a] for a in mesh.AXES) == where[rank]
        for axes, (sub_rank, members) in groups.items():
            idx = where[rank]
            keep = [a not in axes for a in mesh.AXES]
            want = [d.id for i, d in np.ndenumerate(jm.devices)
                    if all(i[k] == idx[k] for k in range(5) if keep[k])]
            assert members == want and members[sub_rank] == rank, (axes, rank)


def test_batch_sharding_gives_each_data_shard_its_rows():
    comm = LocalRing(8, timeout=TIMEOUT)
    rows = comm.run(lambda: mesh.batch_sharding(
        mesh.make_mesh(mesh.MeshConfig(dp=2, fsdp=2, tp=2), comm), 8))
    assert [(r.start, r.stop) for r in rows] == [(0, 2), (0, 2), (2, 4), (2, 4), (4, 6), (4, 6),
                                                  (6, 8), (6, 8)]
    with pytest.raises(ValueError, match="not divisible by dp x fsdp = 4"):
        comm.run(lambda: mesh.batch_sharding(
            mesh.make_mesh(mesh.MeshConfig(dp=2, fsdp=2, tp=2), comm), 6))


# -- the shard plan ---------------------------------------------------------------

PLAN_DIT = dict(num_attention_heads=2, attention_head_dim=16, num_layers=4, in_channels=32,
                out_channels=16, text_embed_dim=32, time_embed_dim=32, max_text_seq_length=8,
                modulate_encoder_hidden_states=True, recon_action=True, visual_guidance=True)


@functools.lru_cache(maxsize=None)
def _jax_shapes(multiview: bool):
    """`jax.eval_shape` of the JAX DiT's init: its parameter tree's shapes."""
    jdit = JaxControlDiT(JaxDiTConfig(**dict(PLAN_DIT, multiview=multiview)), dtype=jnp.float32)
    x = np.zeros((1, 3, 32, 8, 8), np.float32)
    return jax.eval_shape(lambda: jdit.init(
        {"params": jax.random.PRNGKey(0), "action_mask": jax.random.PRNGKey(1)}, x,
        np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
        actions=np.zeros((1, 11, 7), np.float32), depths=x, labels=x, deterministic=False))


def _jax_specs(cfg, mesh_cfg, n):
    params = _jax_shapes(cfg["multiview"])
    jm = jmesh.make_mesh(jmesh.MeshConfig(**mesh_cfg), devices=jax.devices()[:n])
    specs = jmesh.param_shardings(params, jm)
    return {tuple(getattr(p, "key", str(p)) for p in path): tuple(s.spec) + (None,) * (
        len(leaf.shape) - len(s.spec)) for (path, s), leaf in zip(
            jax.tree_util.tree_leaves_with_path(specs), jax.tree_util.tree_leaves(params))}


@pytest.mark.parametrize("multiview", [False, True])
@pytest.mark.parametrize("mesh_cfg,n", [
    (dict(dp=1, fsdp=2, tp=2), 4), (dict(dp=1, tp=4), 4), (dict(dp=1, fsdp=4), 4),
    (dict(dp=1, fsdp=2, sp=2), 4), (dict(dp=1, fsdp=2, pp=2), 4), (dict(dp=1, pp=2, tp=2), 4),
    (dict(dp=1, fsdp=8), 8)])
def test_param_shardings_match_jax_leaf_by_leaf(mesh_cfg, n, multiview):
    """The port's plan of every parameter (at its JAX leaf's name and shape)
    is the JAX package's spec of that leaf, and every JAX leaf has a port
    parameter."""
    cfg = dict(PLAN_DIT, multiview=multiview)
    want = _jax_specs(cfg, mesh_cfg, n)
    model = ControlDiT(DiTConfig(**cfg), dtype=torch.float32, device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    got = mesh.param_shardings(shapes, mesh.MeshConfig(**mesh_cfg).resolve(n).__dict__,
                               cfg["num_layers"])
    seen = set()
    for name, spec in got.items():
        names, _ = mesh.jax_leaf(name, shapes[name], cfg["num_layers"])
        assert names in want, name
        assert spec == want[names], (name, spec, want[names])
        seen.add(names)
    assert seen == set(want)
    assert any("tp" in str(s) for s in got.values()) == (mesh_cfg.get("tp", 1) > 1)


def test_placement_maps_the_plan_onto_torch_dims():
    """A Dense kernel [in, out] is the torch weight [out, in]: JAX's out-dim
    spec splits torch dim 0; the conv patch embed [(c p p), D] is [D, C, p,
    p]; a stacked leaf's layer axis is the block index."""
    shapes = {"transformer_blocks.1.attn1.to_q.weight": (32, 32),
              "transformer_blocks.1.attn1.to_out.0.weight": (32, 32),
              "patch_embed.proj.weight": (32, 32, 2, 2), "proj_out.weight": (64, 32)}
    plan = mesh.param_shardings(shapes, dict(dp=1, fsdp=2, pp=2, tp=2, sp=1), 4)
    assert plan["transformer_blocks.1.attn1.to_q.weight"] == ("pp", None, ("tp", "fsdp"))
    q = mesh.placement("transformer_blocks.1.attn1.to_q.weight", (32, 32),
                       plan["transformer_blocks.1.attn1.to_q.weight"], True)
    assert (q.tp_dim, q.fsdp_dim, q.layer) == (0, 0, 1)
    o = mesh.placement("transformer_blocks.1.attn1.to_out.0.weight", (32, 32),
                       plan["transformer_blocks.1.attn1.to_out.0.weight"], True)
    assert (o.tp_dim, o.fsdp_dim) == (1, 0)
    pe = mesh.placement("patch_embed.proj.weight", (32, 32, 2, 2),
                        plan["patch_embed.proj.weight"], False)
    assert plan["patch_embed.proj.weight"] == ("fsdp", None) and pe.fsdp_dim == 1
    assert plan["proj_out.weight"] == ("fsdp", None)  # the head's in-dim


# -- the collectives ------------------------------------------------------------------

def _collectives(comm, x):
    """Each axis's collectives and backwards on a 2x2 mesh (dp x tp) over
    the first 4 ranks of `comm`; nothing on a rank after them, which builds
    the mesh's groups all the same."""
    m = mesh.make_mesh(mesh.MeshConfig(dp=2, tp=2), comm, members=range(4))
    out = {}
    if not m.inside:
        return out
    r = m.rank
    for axes in (("dp",), ("tp",), ("dp", "tp")):
        c = m.comm_of(axes)
        t = (x[r] * (1 + r)).clone().requires_grad_(True)
        g = spmod.all_gather(c, t, 0)
        (g * torch.arange(g.numel()).reshape(g.shape)).sum().backward()
        out[axes, "gather"] = g.detach()
        out[axes, "gather_grad"] = t.grad.clone()
        t.grad = None
        rs = spmod.reduce_scatter_sum(c, t, 0)
        (rs * 3).sum().backward()
        out[axes, "reduce_scatter"] = rs.detach()
        out[axes, "reduce_scatter_grad"] = t.grad.clone()
        t.grad = None
        ps = spmod.sum_partials(c, t)
        ps.sum().backward()
        out[axes, "sum_partials"] = ps.detach()
        out[axes, "sum_partials_grad"] = t.grad.clone()
        out[axes, "max"] = c.all_reduce_max(t.detach())
    return out


def _members(axes, rank):
    dp, tp = divmod(rank, 2)
    if axes == ("dp",):
        return [tp, 2 + tp]
    if axes == ("tp",):
        return [2 * dp, 2 * dp + 1]
    return [0, 1, 2, 3]


@pytest.mark.parametrize("ranks", [4, 5])
def test_sub_group_collectives_and_backwards_in_rank_order(ranks):
    """On LocalRing(4) split 2 x 2 (and on the first 4 ranks of
    LocalRing(5), the fifth left out): all_gather concatenates in rank
    order and its backward reduce-scatters the cotangent;
    reduce_scatter_sum adds each slice in rank order (bitwise against the
    sum written out) and its backward all-gathers; sum_partials adds in
    rank order and passes the cotangent through; every group's members get
    the same bits."""
    x = torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
    comm = LocalRing(ranks, timeout=TIMEOUT)
    res = comm.run(lambda: _collectives(comm, x))
    assert all(out == {} for out in res[4:])
    for rank, out in enumerate(res[:4]):
        for axes in (("dp",), ("tp",), ("dp", "tp")):
            mem = _members(axes, rank)
            parts = [x[m] * (1 + m) for m in mem]
            me = mem.index(rank)
            k = 4 // len(mem)
            assert torch.equal(out[axes, "gather"], torch.cat(parts))
            ramp = torch.arange(4 * len(mem)).float()
            want = ramp[me * 4:(me + 1) * 4] * len(mem)
            assert torch.equal(out[axes, "gather_grad"], want)
            total = parts[0][me * k:(me + 1) * k]
            for p in parts[1:]:
                total = total + p[me * k:(me + 1) * k]
            assert torch.equal(out[axes, "reduce_scatter"], total)
            assert torch.equal(out[axes, "reduce_scatter_grad"], torch.full((4,), 3.0))
            s = parts[0]
            for p in parts[1:]:
                s = s + p
            assert torch.equal(out[axes, "sum_partials"], s)
            assert torch.equal(out[axes, "sum_partials_grad"], torch.ones(4))
            assert torch.equal(out[axes, "max"], torch.stack(parts).amax(0))


_GLOO_COLLECTIVES = """
import sys, torch
sys.path.insert(0, {tests!r})
from test_torch_port_mesh import _collectives
from orv_tpu_torch.parallel.sp import ProcessGroupRing
rank, port, folder, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
comm = ProcessGroupRing.init_process_group("gloo", f"tcp://localhost:{{port}}", n, rank, timeout=60.0)
x = torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
torch.save(_collectives(comm, x), f"{{folder}}/rank{{rank}}.pt")
torch.distributed.destroy_process_group()
"""


def _run_ranks(code, n, tmp_path, deadline_s=240.0, env=None):
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(tmp_path),
                               str(n)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(n)]
    deadline = time.monotonic() + deadline_s
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
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]


@pytest.mark.parametrize("ranks", [4, 5])
def test_gloo_sub_groups_match_local_ring(tmp_path, ranks):
    """The same collectives from 4 processes over gloo, each axis a
    `torch.distributed.new_group`, and from 5 with the mesh over the first
    4 (the fifth creates every group and leaves): bitwise the threads'
    results."""
    _run_ranks(_GLOO_COLLECTIVES.format(tests=str(REPO / "tests")), ranks, tmp_path)
    x = torch.randn(4, 4, generator=torch.Generator().manual_seed(0))
    comm = LocalRing(4, timeout=TIMEOUT)
    want = comm.run(lambda: _collectives(comm, x))
    assert all(torch.load(tmp_path / f"rank{r}.pt") == {} for r in range(4, ranks))
    for r in range(4):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got.keys() == want[r].keys()
        assert all(torch.equal(got[k], want[r][k]) for k in got), r


_GLOO_TRAIN = """
import os, sys
sys.path.insert(0, {tests!r})
rank, port, folder = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ.update(WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                  MASTER_PORT=port, NO_INIT_VAL="1")
import torch
from test_torch_port_mesh import _pp_tp_train
from orv_tpu_torch.parallel.mesh import initialize_distributed
comm = initialize_distributed()
torch.save(_pp_tp_train(folder, comm, "gloo"), f"{{folder}}/rank{{rank}}.pt")
torch.distributed.destroy_process_group()
"""


def _pp_tp_train(folder, comm, tag):
    """A tiny training run at pp2 x tp2 (two updates of `train` with an
    EMA, random init) over `comm`: the whole parameters and EMA."""
    from orv_tpu_torch import configs as tconfigs
    from orv_tpu_torch.pipelines import train as ttrain

    from test_torch_port_train_entry import PORT_CFG, load

    cfg = load(tconfigs, PORT_CFG, Path(folder) / "data", Path(folder) / tag, [
        "transformer.num_layers=2", "transformer.pretrained_name_or_path=null",
        "dataset.num_samples=1", "train.max_train_steps=2", "train.ema_decay=0.9",
        "train.gradient_accumulation_steps=1", "train.mesh.dp=1", "train.mesh.pp=2",
        "train.mesh.tp=2", "train.mesh.n_micro=1", "train.checkpointing_steps=1000"])
    state = ttrain.train(cfg, device="cpu", comm=comm)
    return ttrain.whole_params(state), ttrain.whole_params(state, ema=True)


def test_train_from_gloo_processes_matches_local_ring(tmp_path, monkeypatch):
    """`train` at pp2 x tp2 from 4 processes that start their group from
    torchrun's environment (`initialize_distributed`): every process ends
    with the whole parameters and EMA of the same run on LocalRing(4), bit
    for bit."""
    from test_torch_port_serving_data import write_dataset

    monkeypatch.setenv("NO_INIT_VAL", "1")
    write_dataset(tmp_path / "data", n_episodes=1, split="train")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    _run_ranks(_GLOO_TRAIN.format(tests=str(REPO / "tests")), 4, tmp_path, env=env)
    comm = LocalRing(4, timeout=TIMEOUT)
    want = comm.run(lambda: _pp_tp_train(tmp_path, comm, "threads"))
    for r in range(4):
        params, ema = torch.load(tmp_path / f"rank{r}.pt")
        assert params.keys() == want[r][0].keys()
        assert all(torch.equal(params[k], want[r][0][k]) and torch.equal(ema[k], want[r][1][k])
                   for k in params), r


def test_initialize_distributed_names_a_failed_address():
    """An explicit address that cannot form the group raises, naming it:
    every process going on alone would repeat the work."""
    with pytest.raises(RuntimeError, match="distributed bring-up failed .*tcp://localhost:1"):
        mesh.initialize_distributed("tcp://localhost:1", 2, 1, timeout=2.0)
    assert mesh.initialize_distributed() is None  # no torchrun environment: one process
