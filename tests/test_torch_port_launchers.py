"""The port's launchers, scripts/*_torch.sh, against the JAX package's, on the CPU.

Each JAX launcher under scripts/ (the TPU tooling `onchip_*.sh` and
`tpu_watch.sh` aside) has one `_torch` twin. Both run under bash with `python`
and `torchrun` standing in as stubs that record their arguments, so the test
reads the exact command each script builds from its presets (`DEBUG=1`, the
environment's defaults, the arguments passed through): the twin names the
same entry point in `orv_tpu_torch.pipelines` with the same arguments, and
that module's own argument parser (called through its `main`, stopped right
after parsing) accepts them, and the twin names neither jax nor orv_tpu. The
two `_dist` twins start `torchrun --nproc_per_node N -m`, N from
NPROC_PER_NODE (default 1).
"""

import argparse
import importlib
import os
import re
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
JAX_LAUNCHERS = sorted(p.name for p in SCRIPTS.glob("*.sh")
                       if not p.name.startswith("onchip_") and p.name != "tpu_watch.sh"
                       and not p.name.endswith("_torch.sh"))
# what a user passes through each entry point's launcher: its required arguments,
# or an override or option of its own
USER_ARGS = {"train": ["train.seed=3"], "evaluate": ["evaluation.batch_size=2"],
             "encode_dataset": ["--ref_nums", "1,5", "--encode_conds"],
             "metrics": ["--gt_dir", "gt", "--pred_dir", "pred"],
             "data_process": ["--dataset", "bridgev2", "--tfds_dir", "tfds", "--output_dir", "o"],
             "inference": ["--demo_root", "demo"], "prepare_dataset": ["--dense"]}
STUB = '#!/usr/bin/env bash\nprintf "%s\\0" "$(basename "$0")" "$@" > "$LAUNCH_LOG"\n'


def twin(name: str) -> str:
    return name[:-len(".sh")] + "_torch.sh"


def launch(script: str, tmp_path: Path, *args, **env) -> list:
    """The command `script` runs (program name first), with `python` and
    `torchrun` stubbed."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name in ("python", "torchrun"):
        (bin_dir / name).write_text(STUB)
        (bin_dir / name).chmod(0o755)
    log = tmp_path / "launch.log"
    log.unlink(missing_ok=True)
    run_env = {k: v for k, v in os.environ.items()
               if k not in ("DEBUG", "DATASET_TYPE", "DATA_ROOT", "NPROC_PER_NODE")}
    run_env.update(env, PATH=f"{bin_dir}:{os.environ['PATH']}", LAUNCH_LOG=str(log))
    res = subprocess.run(["bash", str(SCRIPTS / script), *args], env=run_env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return log.read_text().split("\0")[:-1]


class _Parsed(Exception):
    pass


def parse_with_main(module, argv, monkeypatch) -> argparse.Namespace:
    """What `module.main(argv)` parses from `argv` (strictly: an unknown or
    malformed argument fails), stopping it there."""
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed) as got:
        module.main(argv)
    return got.value.args[0]


def test_every_jax_launcher_has_one_torch_twin():
    assert len(JAX_LAUNCHERS) == 18
    twins = sorted(p.name for p in SCRIPTS.glob("*_torch.sh"))
    assert twins == sorted(twin(n) for n in JAX_LAUNCHERS)


@pytest.mark.parametrize("name", JAX_LAUNCHERS)
def test_twin_launches_the_port_entry_with_the_same_presets(name, tmp_path, monkeypatch):
    script = twin(name)
    syntax = subprocess.run(["bash", "-n", str(SCRIPTS / script)], capture_output=True,
                            text=True, timeout=60)
    assert syntax.returncode == 0, syntax.stderr
    assert not re.search(r"\bjax\b|orv_tpu\.", (SCRIPTS / script).read_text())
    for env in ({"DEBUG": "1"}, {"DEBUG": "0", "DATASET_TYPE": "droid", "NPROC_PER_NODE": "3"}):
        want = launch(name, tmp_path, **env)
        assert want[:2] == ["python", "-m"] and want[2].startswith("orv_tpu.pipelines.")
        entry = want[2][len("orv_tpu.pipelines."):]
        want = launch(name, tmp_path, *USER_ARGS[entry], **env)
        got = launch(script, tmp_path, *USER_ARGS[entry], **env)
        if name.endswith("_dist.sh"):
            assert got[:3] == ["torchrun", "--nproc_per_node", env.get("NPROC_PER_NODE", "1")]
            got = ["python"] + got[3:]
        assert got[:3] == ["python", "-m", f"orv_tpu_torch.pipelines.{entry}"]
        assert got[3:] == want[3:]
        module = importlib.import_module(f"orv_tpu_torch.pipelines.{entry}")
        args = parse_with_main(module, got[3:], monkeypatch)
        experiment = getattr(args, "experiment", None)
        if "--experiment" in got:
            assert experiment == got[got.index("--experiment") + 1]
            assert (REPO / "orv_tpu_torch" / "config" / "experiments"
                    / f"{experiment}.yaml").is_file()
        if "--debug" in got:
            assert args.debug and env["DEBUG"] == "1"
