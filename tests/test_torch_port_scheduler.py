"""The port's embeddings and schedulers against orv_tpu, elementwise.

Same f32 formulas on both sides: tolerance atol 1e-5 on O(1) values (the
frameworks' transcendental functions differ in the last bits); the timestep
embedding takes sin/cos of arguments up to 999, so 1.5e-4 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.schedulers import scheduling as jsched
from orv_tpu.utils import embeddings as jemb
from orv_tpu_torch.schedulers import scheduling as tsched
from orv_tpu_torch.utils import embeddings as temb
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)


@pytest.mark.parametrize("flip,shift", [(True, 0.0), (False, 1.0)])
def test_timestep_embedding_matches_jax(flip, shift):
    t = np.array([0, 1, 500, 999], np.int32)
    ref = jemb.get_timestep_embedding(jnp.asarray(t), 66, flip_sin_to_cos=flip,
                                      downscale_freq_shift=shift)
    out = temb.get_timestep_embedding(torch.from_numpy(t), 66, flip_sin_to_cos=flip,
                                      downscale_freq_shift=shift)
    # sin/cos of f32 arguments up to 999, whose last bit is 6.1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1.5e-4, rtol=0)


def test_sincos_pos_embed_is_the_reference_table():
    ref = jemb.get_3d_sincos_pos_embed(64, (8, 4), 3, 1.875, 1.0)
    np.testing.assert_array_equal(temb.get_3d_sincos_pos_embed(64, (8, 4), 3, 1.875, 1.0), ref)


def test_schedule_tables_match_jax():
    js, ts = jsched.make_schedule(), tsched.make_schedule()
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    assert float(ts.final_alpha_cumprod) == float(js.final_alpha_cumprod)
    for n in (2, 4, 50):
        np.testing.assert_array_equal(tsched.get_inference_timesteps(ts, n),
                                      jsched.get_inference_timesteps(js, n))


def _step_tables(n):
    ts = jsched.get_inference_timesteps(jsched.make_schedule(), n)
    return ts, np.append(ts[1:], -1), np.concatenate([[ts[0]], ts[:-1]])


@pytest.mark.parametrize("with_noise", [False, True])
def test_dpm_step_scan_matches_jax(with_noise):
    """Every step of a 4-step table: step 0 first order (have_old False),
    the 2M middle steps, and the terminal step (prev -1) falling back to
    first order; the same numpy noise goes to both."""
    js, tsc = jsched.make_schedule(), tsched.make_schedule()
    ts, prev, back = _step_tables(4)
    rng = np.random.default_rng(0)
    shape = (2, 3, 4, 5)
    x = rng.standard_normal(shape).astype(np.float32)
    old = np.zeros(shape, np.float32)
    xj, oldj = jnp.asarray(x), jnp.asarray(old)
    xt, oldt = torch.from_numpy(x), torch.from_numpy(old)
    for i in range(len(ts)):
        v = rng.standard_normal(shape).astype(np.float32)
        noise = rng.standard_normal(shape).astype(np.float32) if with_noise else None
        xj, oldj = jsched.dpm_step_scan(js, jnp.asarray(v), oldj, jnp.asarray(i > 0),
                                        jnp.asarray(ts[i]), jnp.asarray(back[i]),
                                        jnp.asarray(prev[i]), xj,
                                        noise=None if noise is None else jnp.asarray(noise))
        xt, oldt = tsched.dpm_step_scan(tsc, torch.from_numpy(v), oldt, i > 0, int(ts[i]),
                                        int(back[i]), int(prev[i]), xt,
                                        noise=None if noise is None else torch.from_numpy(noise))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-5, rtol=0,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(oldt.numpy(), np.asarray(oldj), atol=1e-5, rtol=0)


def test_ddim_step_matches_jax():
    js, tsc = jsched.make_schedule(), tsched.make_schedule()
    ts, prev, _ = _step_tables(4)
    rng = np.random.default_rng(1)
    for i in range(len(ts)):
        x, v = (rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2))
        ref = jsched.ddim_step(js, jnp.asarray(v), jnp.asarray(ts[i]), jnp.asarray(prev[i]),
                               jnp.asarray(x))
        out = tsched.ddim_step(tsc, torch.from_numpy(v), int(ts[i]), int(prev[i]),
                               torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
