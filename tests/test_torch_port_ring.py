"""The port's communicators, ring attention and sequence-parallel ControlDiT
against orv_tpu's, on the CPU at tiny sizes.

The JAX side runs on a CPU mesh of n of the 8 forced host devices
(tests/conftest.py), as tests/test_ring_attention.py does; the port runs
its ranks as threads of this process (`LocalRing(n)`) or, once, as four
processes over gloo (`ProcessGroupRing`). Inputs come from numpy seeds and
are copied into torch (`torch.tensor`). Tolerances:
  * ring attention against JAX's ring and against full attention: f32 atol
    2e-5 (the same merges, summed in another order);
  * the ranks' results against each other, and gloo's against `LocalRing`'s:
    bitwise (every rank merges the same partials in rank order);
  * `JointAttention(qk_norm=False)`: f32 atol 2e-5; bf16 compared in f32 at
    atol 1e-2 (one bf16 rounding of outputs below ~2);
  * the sequence-parallel ControlDiT: f32 atol 1e-4, as
    tests/test_torch_port_dit.py; W8A8 as tests/test_torch_port_quant.py
    (max 1e-2 and mean 3e-4 of the output's range: int8 rounding flips
    carry through the blocks);
  * 2 sampler steps at sp=4 against the resident sampler: atol 1e-4, as
    tests/test_torch_port_sampler_vae.py.
Every collective waits at most a few tens of seconds, and the gloo
processes are killed at their deadline, so no test can hang.
"""

import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models.layers import JointAttention as JaxJointAttention
from orv_tpu.models.quantize import quantize_linear_params as jax_quantize_linear_params
from orv_tpu.ops.attention import mha_reference as jax_mha_reference
from orv_tpu.ops.ring_attention import joint_ring_attention as jax_joint_ring_attention
from orv_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.models.layers import JointAttention
from orv_tpu_torch.models.weights import dit_params_from_jax
from orv_tpu_torch.ops import attention
from orv_tpu_torch.ops.ring_attention import joint_ring_attention, ring_attention
from orv_tpu_torch.parallel.sp import LocalRing
from orv_tpu_torch.pipelines import sample as tsample
from orv_tpu_torch.schedulers import make_schedule

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 60.0  # seconds any rank may wait at a collective
T_TEXT = 12  # text tokens, not divisible by 4 (tests/test_ring_attention.py:59)


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]).reshape(n), ("sp",))


def _qkv(seed, shape, logit_scale=1.0):
    """(numpy, torch) q, k, v: N(0, 0.5^2) q and k (times `logit_scale`),
    N(0, 1) v."""
    rng = np.random.default_rng(seed)
    q, k = (0.5 * logit_scale * rng.standard_normal(shape).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal(shape).astype(np.float32)
    return (q, k, v), tuple(torch.tensor(a) for a in (q, k, v))


def _same_on_all_ranks(outs):
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_ring_collectives(n):
    comm = LocalRing(n, timeout=TIMEOUT)
    rng = np.random.default_rng(n)
    parts = [torch.tensor(rng.standard_normal((3, 5)).astype(np.float32)) for _ in range(n)]

    def body():
        r = comm.rank
        (got,) = comm.rotate([parts[r]])
        return (r, got, comm.all_reduce_sum(parts[r]), comm.all_reduce_max(parts[r]),
                comm.all_gather_seq(parts[r], dim=0))

    outs = comm.run(body)
    assert [o[0] for o in outs] == list(range(n))
    for r, got, total, top, gathered in outs:
        assert torch.equal(got, parts[(r - 1) % n])  # a ppermute to rank + 1
        want = parts[0]
        for p in parts[1:]:
            want = want + p  # rank order: the same bits on every rank
        assert torch.equal(total, want)
        assert torch.equal(top, torch.stack(parts).amax(0))
        assert torch.equal(gathered, torch.cat(parts, dim=0))


def test_local_ring_failing_rank_stops_every_rank():
    """A rank that raises breaks the barrier: the other ranks leave their
    collective at once and `run` raises the failing rank's error. A rank
    that never reaches a collective makes the others time out. Either way
    the ring runs again afterwards."""
    comm = LocalRing(4, timeout=TIMEOUT)

    def body():
        if comm.rank == 2:
            raise ValueError("rank 2 failed")
        return comm.all_reduce_sum(torch.ones(2))

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 2 failed"):
        comm.run(body)
    assert time.monotonic() - t0 < TIMEOUT / 2

    short = LocalRing(2, timeout=0.5)
    with pytest.raises(threading.BrokenBarrierError):
        short.run(lambda: None if short.rank else short.all_reduce_sum(torch.ones(1)))
    assert [t.item() for t in comm.run(lambda: comm.all_reduce_sum(torch.ones(1)))] == [4.0] * 4
    with pytest.raises(RuntimeError, match="only inside"):
        comm.rank


def test_local_ring_and_launch_counts_under_thread_stress():
    """More threads than cores with a shortened switch interval: 16 ranks
    sum in rank order with nothing lost, and the launch counter that every
    kernel wrapper bumps (`ops._build.count`, shared by the ranks' threads)
    loses no update."""
    from orv_tpu_torch.ops import _build

    def counter():
        pass

    counter.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        comm = LocalRing(16, timeout=TIMEOUT)
        outs = comm.run(lambda: [comm.all_reduce_sum(torch.full((4,), float(comm.rank)))
                                 for _ in range(20)])
        threads = [threading.Thread(target=lambda: [_build.count(counter) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter.launches == 16 * 2000
    assert all(torch.equal(x, torch.full((4,), 120.0)) for rank in outs for x in rank)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_attention_matches_jax(n, impl):
    """"flash": the port's online plain version against JAX's online Pallas
    kernel in interpret mode (static_max=None on both sides)."""
    (q, k, v), (tq, tk, tv) = _qkv(n, (2, 2, 128, 16))
    ref = jax_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _mesh(n),
                             impl=impl)
    comm = LocalRing(n, timeout=TIMEOUT)
    out = _same_on_all_ranks(comm.run(lambda: ring_attention(tq, tk, tv, comm, impl=impl)))
    assert out.shape == tq.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_mha_reference(q, k, v)), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_joint_ring_attention_matches_jax(n, impl):
    (q, k, v), (tq, tk, tv) = _qkv(10 + n, (2, 2, T_TEXT + 128, 16))
    ref = jax_joint_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T_TEXT,
                                   _mesh(n), impl=impl)
    comm = LocalRing(n, timeout=TIMEOUT)
    out = _same_on_all_ranks(comm.run(
        lambda: joint_ring_attention(tq, tk, tv, T_TEXT, comm, impl=impl)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_mha_reference(q, k, v)), atol=2e-5,
                               rtol=0)


def test_joint_ring_attention_unbounded_logits():
    """Logits past 150: the ring's default (the online softmax) stays exact;
    the static-max forward at the DiT's bound of 24 overflows."""
    (q, k, v), (tq, tk, tv) = _qkv(3, (1, 2, T_TEXT + 64, 64), logit_scale=14.0)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    assert logits.max() >= 150
    comm = LocalRing(4, timeout=TIMEOUT)
    out = _same_on_all_ranks(comm.run(
        lambda: joint_ring_attention(tq, tk, tv, T_TEXT, comm, impl="flash")))
    # logits near 150 carry an f32 rounding of ~1e-5 each, which moves the
    # softmax weights by that much relative to each other on both sides
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_mha_reference(q, k, v)), atol=1e-4,
                               rtol=0)
    bad = comm.run(lambda: joint_ring_attention(tq, tk, tv, T_TEXT, comm, impl="flash",
                                                static_max=24.0))[0]
    assert not torch.isfinite(bad).all()


def test_ring_attention_raises_on_indivisible_tokens():
    (_, (tq, tk, tv)) = _qkv(4, (1, 1, T_TEXT + 30, 16))
    comm = LocalRing(4, timeout=TIMEOUT)
    with pytest.raises(ValueError, match="do not split"):
        comm.run(lambda: joint_ring_attention(tq, tk, tv, T_TEXT, comm))
    with pytest.raises(ValueError, match="do not split"):
        comm.run(lambda: ring_attention(tq, tk, tv, comm))


def test_ring_attention_refuses_grad():
    """The collectives carry no gradient yet: under grad mode with an input
    that requires grad the ring raises instead of cutting gradients."""
    (_, (tq, tk, tv)) = _qkv(6, (1, 1, T_TEXT + 32, 16))
    comm = LocalRing(2, timeout=TIMEOUT)
    tq.requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        comm.run(lambda: joint_ring_attention(tq, tk, tv, T_TEXT, comm))
    with pytest.raises(RuntimeError, match="inference-only"):
        comm.run(lambda: ring_attention(tq, tk, tv, comm))
    with torch.no_grad():
        assert comm.run(lambda: ring_attention(tq, tk, tv, comm))[0].shape == tq.shape


_GLOO_WORKER = """
import sys
import torch
from orv_tpu_torch.ops.ring_attention import joint_ring_attention, ring_attention
from orv_tpu_torch.parallel.sp import ProcessGroupRing

rank, world, port, folder = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
comm = ProcessGroupRing.init_process_group("gloo", f"tcp://localhost:{port}", world, rank,
                                           timeout=60.0)
q, k, v = torch.load(f"{folder}/inputs.pt")
res = dict(rotated=comm.rotate([q[:, :, rank:rank + 1]])[0],
           total=comm.all_reduce_sum(q[..., 0]), top=comm.all_reduce_max(q[..., 0]),
           joint=joint_ring_attention(q, k, v, 12, comm, impl="flash"),
           ring=ring_attention(q[:, :, 12:], k[:, :, 12:], v[:, :, 12:], comm, impl="xla"))
torch.save(res, f"{folder}/rank{rank}.pt")
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _local_ring_results(q, k, v, n):
    comm = LocalRing(n, timeout=TIMEOUT)

    def body():
        r = comm.rank
        return dict(rotated=comm.rotate([q[:, :, r:r + 1].contiguous()])[0],
                    total=comm.all_reduce_sum(q[..., 0]), top=comm.all_reduce_max(q[..., 0]),
                    joint=joint_ring_attention(q, k, v, T_TEXT, comm, impl="flash"),
                    ring=ring_attention(q[:, :, T_TEXT:], k[:, :, T_TEXT:], v[:, :, T_TEXT:],
                                        comm, impl="xla"))

    return comm.run(body)


def test_process_group_ring_over_gloo_matches_local_ring(tmp_path):
    """Four processes over gloo (`ProcessGroupRing`): every collective and
    both ring attentions give, bit for bit, what the four threads of
    `LocalRing(4)` give. The processes are killed at a 120 s deadline."""
    n = 4
    _, (q, k, v) = _qkv(5, (1, 2, T_TEXT + 64, 16))
    torch.save((q, k, v), tmp_path / "inputs.pt")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r), str(n), str(port),
                               str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
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
    want = _local_ring_results(q, k, v, n)
    for r in range(n):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert set(got) == set(want[r])
        for key, value in want[r].items():
            assert torch.equal(got[key], value), (r, key)


def _dense_state(params, name):
    """A flax Dense {kernel [in, out], bias} as an nn.Linear state dict."""
    p = params[name]
    return {"weight": torch.tensor(np.asarray(p["kernel"]).T.copy()),
            "bias": torch.tensor(np.asarray(p["bias"]))}


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_joint_attention_without_qk_norm_matches_jax(prec):
    """No norm_q/norm_k and the online softmax (JAX: attention(static_max=
    None), layers.py:485-488, through its Pallas kernel). In f32 the inputs
    drive the logits past the static bound of 24, so only a running max is
    right. In bf16 they stay near unit scale: at logits of tens, one bf16
    rounding of q or k, which the two frameworks place differently, moves a
    logit by a few tenths and the output with it."""
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[prec]
    rng = np.random.default_rng(8)
    heads, head_dim, D = 2, 64, 128
    x_scale = 3.0 if prec == "f32" else 1.0
    hidden = (x_scale * rng.standard_normal((1, 40, D))).astype(np.float32)
    enc = (x_scale * rng.standard_normal((1, 8, D))).astype(np.float32)
    params = {name: {"kernel": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
                     "bias": (0.2 * rng.standard_normal(D)).astype(np.float32)}
              for name in ("to_q", "to_k", "to_v", "to_out")}
    jmod = JaxJointAttention(heads, head_dim, qk_norm=False, attn_impl="flash", dtype=jd)
    ref_h, ref_e = jax.jit(lambda p, h, e: jmod.apply({"params": p}, h, e))(
        params, jnp.asarray(hidden, jd), jnp.asarray(enc, jd))

    mod = JointAttention(heads, head_dim, qk_norm=False, dtype=td, device="cpu")
    state = {}
    for name in ("to_q", "to_k", "to_v"):
        state.update({f"{name}.{k}": v for k, v in _dense_state(params, name).items()})
    state.update({f"to_out.0.{k}": v for k, v in _dense_state(params, "to_out").items()})
    mod.load_state_dict(state, strict=True)
    with torch.no_grad():
        x = torch.cat([torch.tensor(enc), torch.tensor(hidden)], dim=1).to(td)
        q = mod.to_q(x.float()).reshape(1, 48, heads, head_dim).transpose(1, 2)
        k = mod.to_k(x.float()).reshape(1, 48, heads, head_dim).transpose(1, 2)
        if prec == "f32":
            assert (q @ k.transpose(-1, -2)).max() / 8.0 > 24.0
        out_h, out_e = mod(torch.tensor(hidden).to(td), torch.tensor(enc).to(td))
    atol = 2e-5 if prec == "f32" else 1e-2
    np.testing.assert_allclose(out_h.float().numpy(), np.asarray(ref_h, np.float32), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(out_e.float().numpy(), np.asarray(ref_e, np.float32), atol=atol,
                               rtol=0)


# the sequence-parallel DiT of tests/test_ring_attention.py:73-92, with actions
SP_DIT = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, in_channels=16,
              out_channels=16, text_embed_dim=32, time_embed_dim=64, max_text_seq_length=8,
              sample_width=16, sample_height=8, modulate_encoder_hidden_states=True)
SP_B, SP_F, SP_H, SP_W = 1, 2, 8, 16  # video tokens 2*4*8 = 64, divisible by 4


def _randomize(params, seed):
    """Every leaf -> seeded random f32: norm scales ~1, kernels ~N(0, 1/fan_in)."""
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


def _sp_inputs():
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(SP_B, SP_F, 16, SP_H, SP_W), enc=f(SP_B, 8, 32),
                t=np.array([500], np.int32), actions=0.5 * f(SP_B, 7, 7))


@pytest.fixture(scope="module")
def sp_params():
    """(config, float tree, the tree quantized by orv_tpu), seeded random."""
    inp = _sp_inputs()
    cfg = JaxDiTConfig(**SP_DIT)
    p = jax.eval_shape(lambda: JaxControlDiT(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), inp["x"], inp["enc"], inp["t"], actions=inp["actions"]))
    p = _randomize(p, seed=21)
    return cfg, p, jax.device_get(jax_quantize_linear_params(p))


@pytest.mark.parametrize("quant", [False, True])
def test_sp_control_dit_matches_jax(sp_params, quant):
    """`ControlDiT(sp=LocalRing(4))` against JAX `ControlDiT(sp_mesh=...)`
    on a 4-device mesh: f32 with attn_impl "xla" on the JAX side, and the
    W8A8 model (attn_impl "flash_q8": both rings run the bf16 flash path).
    All four ranks return the same bits, and nothing launches on the CPU."""
    jcfg, params, qparams = sp_params
    tree = qparams if quant else params
    impl = "flash_q8" if quant else "xla"
    inp = _sp_inputs()
    jmodel = JaxControlDiT(jcfg, dtype=jnp.float32, attn_impl=impl, quant=quant,
                           sp_mesh=_mesh(4))
    ref, _, _ = jax.jit(lambda p, x, e, t, a: jmodel.apply(p, x, e, t, actions=a))(
        tree, inp["x"], inp["enc"], inp["t"], inp["actions"])

    tcfg = DiTConfig(**SP_DIT)
    comm = LocalRing(4, timeout=TIMEOUT)
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu", quant=quant,
                       attn_impl="flash_q8" if quant else "flash", sp=comm)
    model.load_state_dict(dit_params_from_jax(tree, tcfg), strict=True)
    assert all(b.attn1.sp is comm for b in model.transformer_blocks)
    tt = {k: torch.tensor(v) for k, v in inp.items()}
    before = (attention.flash_attention.launches,
              attention.flash_attention_online_kernel.launches)
    with torch.no_grad():
        outs = comm.run(lambda: model(tt["x"], tt["enc"], tt["t"], actions=tt["actions"]))
    assert before == (attention.flash_attention.launches,
                      attention.flash_attention_online_kernel.launches)
    out = _same_on_all_ranks(outs)
    assert out.shape == (SP_B, SP_F, 16, SP_H, SP_W) and torch.isfinite(out).all()
    got, want = out.numpy(), np.asarray(ref, np.float32)
    if quant:
        err, rng = np.abs(got - want), np.abs(want).max()
        assert err.max() <= 1e-2 * rng and err.mean() <= 3e-4 * rng, (err.max(), err.mean(), rng)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_sp_control_dit_raises_on_indivisible_video_tokens(sp_params):
    """64 video tokens do not split over 3 ranks: every rank raises the JAX
    package's ValueError (layers.py:465-469) and `run` re-raises it."""
    tcfg = DiTConfig(**SP_DIT)
    comm = LocalRing(3, timeout=TIMEOUT)
    model = ControlDiT(tcfg, dtype=torch.float32, device="cpu", sp=comm)
    tt = {k: torch.tensor(v) for k, v in _sp_inputs().items()}
    with pytest.raises(ValueError, match="divisible by sp"), torch.no_grad():
        comm.run(lambda: model(tt["x"], tt["enc"], tt["t"]))


def test_sp_sampler_matches_resident():
    """2 stochastic DPM steps through `make_sampler` on every rank of
    `LocalRing(4)`, each with a generator of the same seed, against the same
    model resident: every rank holds the same latents."""
    cfg = DiTConfig(num_attention_heads=4, attention_head_dim=16, num_layers=2, in_channels=32,
                    out_channels=16, text_embed_dim=32, time_embed_dim=64,
                    max_text_seq_length=8, sample_width=16, sample_height=8,
                    modulate_encoder_hidden_states=True)
    torch.manual_seed(0)
    model = ControlDiT(cfg, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(12)
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    lat, img, enc, acts = f(1, 3, 16, 8, 16), f(1, 3, 16, 8, 16), f(1, 8, 32), f(1, 11, 7)
    sampler = tsample.make_sampler(model, make_schedule(),
                                   tsample.SamplerConfig(num_inference_steps=2), device="cpu")
    run = lambda: sampler(lat, img, enc, generator=torch.Generator().manual_seed(3),
                          actions=acts)
    ref = run()
    comm = LocalRing(4, timeout=TIMEOUT)
    model.set_sp(comm)
    try:
        out = _same_on_all_ranks(comm.run(run))
    finally:
        model.set_sp(None)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=0)


def test_ring_modules_import_no_jax():
    """The communicators and the ring import in a fresh process without
    jax or any module of the JAX package."""
    code = ("import sys\n"
            "import orv_tpu_torch.parallel.sp, orv_tpu_torch.ops.ring_attention\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'orv_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
