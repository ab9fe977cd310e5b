"""The port's tests run their JAX references without JAX's persistent
compilation cache.

Collecting the whole of tests/ imports `__graft_entry__`
(tests/test_dryrun_gate.py) and `bench` (tests/test_bench_*.py), and each
sets `jax_compilation_cache_dir` to the repository's `.jax_cache` at import,
with a 2 s minimum compile time. So in a full run every xdist worker reads
and writes one on-disk cache that outlives the run: it holds executables
that earlier runs compiled, on whatever host ran them. Its key for the CPU
backend names the platform "cpu" and no CPU features, and an XLA:CPU
executable is compiled for its host's instruction set (AVX-512, AMX where
the host has them): `__graft_entry__` itself notes the risk of SIGILL from
such foreign blobs. A worker that dies in its first test has that test
reported failed and the rest of the file rerun on a fresh worker, where it
passes. Run alone, or with only the port's files, nothing imports those
modules and no cache is used.

`no_persistent_jax_cache` turns the cache off for a module and restores it
after; every port test file that runs JAX imports it (autouse).

The file also holds the port's scripts under scripts/ apart from the JAX
package: they import neither jax nor orv_tpu.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import compilation_cache

TESTS = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def no_persistent_jax_cache():
    """JAX's persistent compilation cache off for the module's tests (the
    cache's memo of its own state reset, so the change takes), restored
    after."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)
        compilation_cache.reset_cache()


def test_port_tests_compile_without_the_persistent_cache(tmp_path):
    """Under the fixture a compile neither reads nor writes a cache: with
    the directory pointed at an empty folder, no minimum compile time and
    the cache's memo reset, a new jitted function leaves the folder empty
    (without the fixture it writes its executable there)."""
    prev = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    compilation_cache.reset_cache()
    try:
        assert not compilation_cache.is_persistent_cache_enabled()
        out = jax.jit(lambda x: jnp.sin(x) * 3.0 + 0.125)(np.arange(7, dtype=np.float32))
        np.testing.assert_allclose(np.asarray(out), np.sin(np.arange(7)) * 3 + 0.125, rtol=1e-6)
        assert not list(tmp_path.iterdir())
    finally:
        jax.config.update("jax_compilation_cache_dir", prev[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", prev[1])
        compilation_cache.reset_cache()


def test_every_port_test_file_that_runs_jax_takes_the_fixture():
    for path in sorted(TESTS.glob("test_torch_port_*.py")):
        text = path.read_text()
        if path != Path(__file__).resolve() and ("\nimport jax" in text
                                                 or "\nfrom orv_tpu." in text):
            assert "import no_persistent_jax_cache" in text, path.name


def test_port_scripts_import_no_jax_and_no_orv_tpu():
    """The port's scripts stand apart from the JAX package:
    scripts/pab_quality_synthetic_torch.py runs a short harness in a fresh
    process without pulling in jax or any module of orv_tpu (the `_torch`
    launchers are read in test_torch_port_launchers.py)."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'scripts')\n"
        "import pab_quality_synthetic_torch as h\n"
        "r = h.run(train_steps=2, sample_steps=2, n_clips=2, skips=(2,),\n"
        "          windows=((0.1, 0.85),), device='cpu')\n"
        "assert r['device'] == 'cpu' and 'orv_tpu_torch.pipelines.sample' in sys.modules\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orv_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=TESTS.parent, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
