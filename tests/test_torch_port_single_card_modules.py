"""The port's last single-card modules against orv_tpu's, on the CPU.

`FloatGroupNorm` (both statistics paths), `Fuser` and
`ConditioningEmbedding` (orv_tpu/models/layers.py:799-876) with seeded
random parameters carried by `models/weights.py:aux_params_from_jax`;
`tiled_decode` (orv_tpu/models/vae.py:493) around a tiny VAE's decode, with
tile seams and zero padding; `utils/profiling.py` (`flatten_dict`,
`global_grad_norm`, the memory stats on the CPU, a profiler trace).
Inputs come from numpy seeds and are copied into torch. Tolerances: f32
1e-5 of the output's largest magnitude for the norm and the FiLM (the same
f32 operations, summed in another order); 1e-4 for the conv stack and the
VAE (convolutions summed in another order over 27 to 3x3x3x32 terms, as
tests/test_torch_port_sampler_vae.py holds the decode); bf16 runs one
rounding of bf16 outputs (2^-8 of the largest magnitude, plus the same for
each bf16 input it went through: 2e-2); the gradient norm to 1e-6
relative.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models.layers import ConditioningEmbedding as JaxConditioningEmbedding
from orv_tpu.models.layers import FloatGroupNorm as JaxFloatGroupNorm
from orv_tpu.models.layers import Fuser as JaxFuser
from orv_tpu.models.vae import CausalVAE as JaxCausalVAE
from orv_tpu.models.vae import VAEConfig as JaxVAEConfig
from orv_tpu.models.vae import decode_chunked as jax_decode_chunked
from orv_tpu.models.vae import tiled_decode as jax_tiled_decode
from orv_tpu.utils import profiling as jprofiling
from orv_tpu_torch.models import CausalVAE, VAEConfig, decode_chunked, tiled_decode
from orv_tpu_torch.models.layers import ConditioningEmbedding, FloatGroupNorm, Fuser
from orv_tpu_torch.models.weights import aux_params_from_jax, vae_params_from_jax
from orv_tpu_torch.utils import profiling

from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)
from test_torch_port_sampler_vae import VAE, randomize

REPO = Path(__file__).resolve().parents[1]


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _init(module, *args):
    """A flax module's param tree, its values seeded random."""
    return randomize(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)), seed=3)


@pytest.mark.parametrize("shape", [(2, 5, 64), (2, 3, 7, 64), (4, 64)])
def test_float_group_norm_matches_jax(shape):
    """ndim >= 3: statistics over the group's channels and the third axis
    from the end (frames of [B, F, D], tokens of [B, F, P, D]); 2-dim: the
    group alone. f32 in and bf16 in (the result back in bf16)."""
    x = (3.0 + 2.0 * np.random.default_rng(len(shape)).standard_normal(shape)).astype(np.float32)
    jmod = JaxFloatGroupNorm(32, 64)
    params = _init(jmod, x)
    mod = FloatGroupNorm(32, 64, device="cpu")
    mod.load_state_dict(aux_params_from_jax(params), strict=True)
    for jd, td, tol in ((jnp.float32, torch.float32, 1e-5), (jnp.bfloat16, torch.bfloat16, 2e-2)):
        want = jmod.apply(params, jnp.asarray(x, jd))
        got = mod(torch.tensor(x).to(td))
        assert got.dtype == td
        _close(got, want, tol)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_fuser_matches_jax(prec):
    """The FiLM with every parameter random (the temporal projections too,
    which start at zero): h [B, F, P, D] and action states [B, F, P, 128]."""
    jd, td, tol = {"f32": (jnp.float32, torch.float32, 1e-5),
                   "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[prec]
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 3, 5, 64)).astype(np.float32)
    a = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    jmod = JaxFuser(action_in_channel=16, out_channels=64, dtype=jd)
    params = _init(jmod, h, a)
    mod = Fuser(16, 64, dtype=td, device="cpu")
    mod.load_state_dict(aux_params_from_jax(params), strict=True)
    want = jmod.apply(params, jnp.asarray(h, jd), jnp.asarray(a, jd))
    got = mod(torch.tensor(h).to(td), torch.tensor(a).to(td))
    assert got.dtype == td
    _close(got, want, tol)


def test_fuser_starts_as_the_identity():
    """Zero-initialised temporal projections: gamma = beta = 0 at init."""
    rng = np.random.default_rng(8)
    h = torch.tensor(rng.standard_normal((1, 2, 3, 64)).astype(np.float32))
    a = torch.tensor(rng.standard_normal((1, 2, 3, 16)).astype(np.float32))
    mod = Fuser(16, 64, dtype=torch.float32, device="cpu")
    assert torch.equal(mod(h, a), h)
    jparams = jax.device_get(JaxFuser(16, 64, dtype=jnp.float32).init(jax.random.PRNGKey(0),
                                                                      h.numpy(), a.numpy()))
    assert aux_params_from_jax(jparams).keys() == mod.state_dict().keys()


@pytest.mark.parametrize("prec,hw", [("f32", (32, 48)), ("f32", (30, 37)), ("bf16", (32, 48))])
def test_conditioning_embedding_matches_jax(prec, hw):
    """NHWC in and out; 3x3 convs with padding 1, three of them of stride 2
    (an odd size rounds as both frameworks' padding-1 stride-2 conv does)."""
    jd, td, tol = {"f32": (jnp.float32, torch.float32, 1e-4),
                   "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[prec]
    x = np.random.default_rng(hw[1]).standard_normal((2, *hw, 3)).astype(np.float32)
    jmod = JaxConditioningEmbedding(embedding_channels=24, block_out_channels=(8, 16, 16, 32),
                                    dtype=jd)
    params = _init(jmod, x)
    mod = ConditioningEmbedding(24, (8, 16, 16, 32), dtype=td, device="cpu")
    mod.load_state_dict(aux_params_from_jax(params), strict=True)
    want = jmod.apply(params, jnp.asarray(x, jd))
    got = mod(torch.tensor(x).to(td))
    assert tuple(got.shape) == tuple(want.shape) == (2, -(-hw[0] // 8), -(-hw[1] // 8), 24)
    _close(got, want, tol)


@pytest.fixture(scope="module")
def tiny_vae():
    jcfg, tcfg = JaxVAEConfig(**VAE), VAEConfig(**VAE)
    jvae = JaxCausalVAE(jcfg, dtype=jnp.float32)
    params = randomize(jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 16, 16)))), seed=5)
    vae = CausalVAE(tcfg, dtype=torch.float32, device="cpu")
    vae.load_state_dict(vae_params_from_jax(params, tcfg))
    return jvae, params, vae


@pytest.mark.parametrize("hw,tile,overlap,frames", [
    ((4, 6), (24, 32), 8, 2),   # one tile: no seams, no padding
    ((7, 9), (4, 4), 2, 2),     # 3 x 4 tiles, seams both ways, zero padding
    ((5, 5), (3, 4), 1, 1),     # one frame, ragged in both directions
])
def test_tiled_decode_matches_jax(tiny_vae, hw, tile, overlap, frames):
    """The tile plan (uniform zero-padded tiles), the ramps and the
    normalised overlap-add, around each package's chunked decode of the
    same tiny VAE (2 latent frames a chunk)."""
    jvae, params, vae = tiny_vae
    z = np.random.default_rng(sum(hw)).standard_normal((1, 16, frames, *hw)).astype(np.float32)
    want = jax_tiled_decode(
        lambda t: jax_decode_chunked(jvae, params, t, chunk_latent_frames=2, fused=True),
        jnp.asarray(z), tile_latent_h=tile[0], tile_latent_w=tile[1], overlap=overlap)
    got = tiled_decode(lambda t: decode_chunked(vae, t, chunk_latent_frames=2, device="cpu"),
                       torch.tensor(z), tile_latent_h=tile[0], tile_latent_w=tile[1],
                       overlap=overlap)
    assert tuple(got.shape) == (1, 3, (frames - 1) * 4 + 1, 8 * hw[0], 8 * hw[1])
    _close(got, want, 1e-4)


def test_tiled_decode_blends_only_at_seams():
    """With an identity-like decode (each latent pixel an 8x8 block of its
    value), the overlap-add of tiles that agree reproduces the untiled
    decode exactly, padding and seams included."""
    decode = lambda t: t[:, :3].repeat_interleave(8, -1).repeat_interleave(8, -2)
    z = torch.tensor(np.random.default_rng(2).standard_normal((1, 4, 1, 11, 13))
                     .astype(np.float32))
    got = tiled_decode(decode, z, tile_latent_h=4, tile_latent_w=5, overlap=2)
    torch.testing.assert_close(got, decode(z), atol=1e-6, rtol=1e-6)


def test_flatten_dict_and_global_grad_norm_match_jax():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3, 4: {"f": 5}}
    assert profiling.flatten_dict(tree) == jprofiling.flatten_dict(tree)
    assert profiling.flatten_dict(tree, sep=".") == jprofiling.flatten_dict(tree, sep=".")
    rng = np.random.default_rng(4)
    grads = {"w": rng.standard_normal((7, 5)).astype(np.float32),
             "blk": {"b": (1e3 * rng.standard_normal(9)).astype(np.float32),
                     "c": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    want = jprofiling.global_grad_norm(jax.tree_util.tree_map(jnp.asarray, grads))
    got = profiling.global_grad_norm({"w": torch.tensor(grads["w"]),
                                      "blk": [torch.tensor(grads["blk"]["b"]).bfloat16(),
                                              torch.tensor(grads["blk"]["c"])]})
    bf = {**grads, "blk": {**grads["blk"], "b": jnp.asarray(grads["blk"]["b"], jnp.bfloat16)}}
    np.testing.assert_allclose(got, jprofiling.global_grad_norm(bf), rtol=1e-6)
    np.testing.assert_allclose(profiling.global_grad_norm(torch.tensor(grads["w"])),
                               jprofiling.global_grad_norm(jnp.asarray(grads["w"])), rtol=1e-6)
    assert abs(want - got) / want < 1e-2  # a bf16 leaf squares its rounding in f32


def test_memory_stats_on_the_cpu_and_profile_trace(tmp_path):
    """The CPU keeps no device memory counters: zeros, with JAX's keys, as
    JAX's CPU device gives; the default device is the card (absent here).
    `profile_trace` writes a Chrome trace of the block."""
    got = profiling.device_memory_stats("cpu")
    want = jprofiling.device_memory_stats(jax.devices("cpu")[0])
    assert got == want == {"bytes_in_use_gb": 0.0, "peak_bytes_in_use_gb": 0.0,
                           "bytes_limit_gb": 0.0}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.device_memory_stats()
    profiling.print_memory("cpu", tag="test")
    with profiling.profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])


def test_profiling_imports_without_jax():
    code = ("import sys; import orv_tpu_torch.utils.profiling, orv_tpu_torch.models.layers\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'orv_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
