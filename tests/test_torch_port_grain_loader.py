"""The port's grain loader and Hub helper against grain and the JAX package.

`orv_tpu_torch/data/grain_loader.py` computes grain's batch order without
grain; these tests hold it against grain itself on the CPU:

  * `index_shuffle` against grain's compiled `index_shuffle`, bitwise, at
    block sizes from 16 to 32 bits and at max_index = 2^16 and 2^20, where
    grain's block is one bit short (the map is then no permutation);
  * the record order against `grain.IndexSampler` for 1 to 3 shards (a
    shard's order is the one-shard order over its records), with and
    without shuffling, over 3 epochs;
  * `make_grain_loader` against `orv_tpu.data.grain_loader.make_grain_loader`
    on tests/test_grain_loader.py's layout (5 records, batch 2, so a batch
    straddles two epochs): arrays bitwise, dtypes, keys and Python types
    equal; 2 spawned workers give the same batches as none; a dead worker
    raises the pool's BrokenProcessPool naming a record, a failing record raises its own error, and
    closing the loader stops its workers;
  * the port's `train` with `train.loader=grain` against JAX `train` with
    it over a dataset of 9 slices (the helpers and tolerances of
    tests/test_torch_port_train_loop.py): the loss per micro-step to 1e-5
    relative, the parameters and EMA after 2 applied updates to 1e-4 RMS and
    5e-2 max of the largest change;
  * `orv_tpu_torch/utils/hub.py` and `scripts/hf_model_torch.py` against
    `orv_tpu/utils/hub.py` and `scripts/hf_model.py` over one fake
    `huggingface_hub` module (no network): the same calls, the same copies,
    the same errors.
"""

import importlib.util
import json
import multiprocessing as mp
import os
import re
import signal
import sys
import time
import types
from concurrent.futures.process import BrokenProcessPool
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

grain = pytest.importorskip("grain.python")

from orv_tpu import configs as jconfigs  # noqa: E402
from orv_tpu.data.dataset import DatasetConfig as JaxDatasetConfig  # noqa: E402
from orv_tpu.data.dataset import RobotDataset as JaxRobotDataset  # noqa: E402
from orv_tpu.data.grain_loader import make_grain_loader as jax_make_grain_loader  # noqa: E402
from orv_tpu.parallel import train_step as jax_train_step  # noqa: E402
from orv_tpu.pipelines import train as jtrain  # noqa: E402
from orv_tpu.utils import hub as jhub  # noqa: E402
from orv_tpu_torch import configs as tconfigs  # noqa: E402
from orv_tpu_torch.data.dataset import DatasetConfig, RobotDataset  # noqa: E402
from orv_tpu_torch.data.grain_loader import (index_shuffle, make_grain_loader,  # noqa: E402
                                             record_order, shuffled_epoch)
from orv_tpu_torch.models import DiTConfig  # noqa: E402
from orv_tpu_torch.models.weights import dit_params_from_jax  # noqa: E402
from orv_tpu_torch.pipelines import train as ttrain  # noqa: E402
from orv_tpu_torch.utils import hub as thub  # noqa: E402

from test_torch_port_isolation import no_persistent_jax_cache  # noqa: E402,F401 (autouse)
from test_torch_port_train_entry import (DIT, JAX_CFG, PORT_CFG, fix_uniforms,  # noqa: E402
                                         load, make_setup, replayed_draws)

REPO = Path(__file__).resolve().parents[1]
MAX_INDICES = [0, 1, 9, 999, 65535, 65536, 65537, 2**17, 2**20 + 3, 2**31 + 7]
SEEDS = [0, 42, 2**32 - 1]


# -- index_shuffle and the record order ----------------------------------------------

def _grain_index_shuffle():
    from grain._src.python.experimental.index_shuffle.python import index_shuffle_module

    return index_shuffle_module.index_shuffle


@pytest.mark.parametrize("max_index", MAX_INDICES)
def test_index_shuffle_equals_grains_compiled_one(max_index):
    """Every seed of SEEDS at the first 64 indices, the last two, the middle
    and 32 drawn from a numpy seed: the port's value is grain's."""
    want_fn = _grain_index_shuffle()
    rng = np.random.default_rng(max_index)
    indices = sorted({*range(min(max_index + 1, 64)), max_index, max(max_index - 1, 0),
                      max_index // 2, *rng.integers(0, max_index + 1, 32).tolist()})
    for seed in SEEDS:
        got = [index_shuffle(i, max_index, seed) for i in indices]
        want = [want_fn(i, max_index=max_index, seed=seed, rounds=4) for i in indices]
        assert got == want, (max_index, seed)
        assert all(0 <= v <= max_index for v in got)


@pytest.mark.parametrize("k", [16, 20])
def test_grains_block_is_one_bit_short_at_a_power_of_two(k):
    """At max_index = 2^k grain's block has k bits: index 2^k wraps to 0's
    place, so the map over [0, 2^k] is no permutation. The port repeats it:
    the whole epoch of 2^k + 1 records equals grain's value by value."""
    want_fn = _grain_index_shuffle()
    n = 2**k + 1
    got = shuffled_epoch(n, 7)
    assert got[-1] == got[0] == index_shuffle(0, n - 1, 7)
    assert len(set(got.tolist())) == n - 1
    check = range(n) if k == 16 else [*range(512), *range(n - 512, n)]
    assert [int(got[i]) for i in check] == [want_fn(i, max_index=n - 1, seed=7, rounds=4)
                                            for i in check]


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("shard_count", [1, 2, 3])
def test_record_order_equals_grains_index_sampler(shard_count, shuffle):
    """Each shard of 10 records (3 shards drop one) over 3 epochs: the
    records grain's DataLoader reads from `IndexSampler` (global index
    j * shard_count + shard), in order, are the port's order over
    per = 10 // shard_count records, offset by per * shard (the loader
    reads shard 0 of 1; other shards hold the order at 5 and 3 records)."""
    n = 10
    per = n // shard_count
    for shard in range(shard_count):
        sampler = grain.IndexSampler(
            num_records=n, shuffle=shuffle, num_epochs=3, seed=1234,
            shard_options=grain.ShardOptions(shard, shard_count, drop_remainder=True))
        want = [sampler[j * shard_count + shard].record_key
                for j in range(len(sampler) // shard_count)]
        got = [per * shard + k for k in record_order(per, 1234, 3, shuffle)]
        assert got == want, (shard, shard_count, shuffle)
        assert len(got) == 3 * per


@pytest.mark.parametrize("kwargs,match", [
    (dict(seed=None), "Shuffling requires specifying a seed"),
    (dict(seed=2**32), "Seed should be positive 32-bit integer"),
    (dict(seed=-1), "Seed should be positive 32-bit integer"),
    (dict(num_epochs=0), "num_epochs must be positive"),
    (dict(num_records=0), "needs at least one record"),
])
def test_record_order_refuses_what_index_sampler_refuses(kwargs, match):
    kwargs = {"num_records": 10, "seed": 0, **kwargs}
    with pytest.raises(ValueError, match=match):
        record_order(**kwargs)
    with pytest.raises(ValueError):  # grain's own sampler refuses the same
        grain.IndexSampler(shuffle=True, **kwargs)


# -- the loader against the JAX package's -----------------------------------------------

def write_layout(root: Path, frames=(40, 40, 20)):
    """tests/test_grain_loader.py's layout, one episode a length of
    `frames`: 16-frame slices every 16 frames (two of 40 frames, one of 20),
    so 5 records."""
    ann_dir = root / "annotations" / "train"
    ann_dir.mkdir(parents=True)
    emb = root / "embeddings_full" / "train"
    for sub in ("latents", "image_latents", "prompt_embeds"):
        (emb / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for ep, T in enumerate(frames):
        ann = {"episode_id": f"{ep:05d}", "texts": [f"task {ep}"],
               "state": rng.normal(size=(T, 6)).tolist(),
               "continuous_gripper_state": rng.uniform(0, 1, T).tolist(),
               "videos": [f"videos/{ep:05d}.mp4"]}
        (ann_dir / f"{ep:05d}.json").write_text(json.dumps(ann))
        for start in range(0, T - 16, 16):
            name = f"{ep:05d}_{start:02d}_17_0"
            np.savez(emb / "latents" / f"{name}.npz",
                     rng.normal(size=(32, 5, 4, 6)).astype(np.float32))
            np.savez(emb / "image_latents" / f"{name}.npz",
                     rng.normal(size=(32, 1, 4, 6)).astype(np.float32))
    np.savez(emb / "prompt_embeds" / "empty.npz", np.zeros((8, 16), np.float32))
    return root


def _config(cls, root):
    return cls(data_root=str(root), sequence_length=16, start_frame_interval=16,
               sample_frames=17, video_size=(32, 48), empty_prompt=False)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return write_layout(tmp_path_factory.mktemp("grain_layout"))


@pytest.fixture
def dataset(layout):
    ds = RobotDataset(_config(DatasetConfig, layout))
    assert len(ds) == 5
    return ds


def assert_same_batches(got, want):
    """Keys in order, arrays bitwise with their dtypes, every other value
    equal and of the same Python type (the metainfo dicts' too)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, wv in w.items():
            gv = g[k]
            assert type(gv) is type(wv), (k, type(gv), type(wv))
            if isinstance(wv, np.ndarray):
                assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
                assert gv.tobytes() == wv.tobytes(), k
            elif k == "metainfos":
                assert [list(m.items()) for m in gv] == [list(m.items()) for m in wv]
                assert [[type(v) for v in m.values()] for m in gv] == \
                       [[type(v) for v in m.values()] for m in wv]
            else:
                assert gv == wv, k
                if isinstance(wv, list):
                    assert [type(v) for v in gv] == [type(v) for v in wv], k


@pytest.mark.parametrize("kwargs", [
    dict(seed=0, num_epochs=2),
    dict(seed=42, num_epochs=2),
    dict(shuffle=False, num_epochs=2),
    dict(seed=3, num_epochs=1, drop_remainder=False),
])
def test_loader_yields_what_the_jax_grain_loader_yields(layout, dataset, kwargs):
    """Batch 2 over 5 records: with 2 epochs 5 batches, the third holding
    the first epoch's last record and the second's first; with one epoch
    and drop_remainder off, a last batch of 1."""
    jds = JaxRobotDataset(_config(JaxDatasetConfig, layout))
    want = list(jax_make_grain_loader(jds, 2, **kwargs))
    got = list(make_grain_loader(dataset, 2, **kwargs))
    assert len(want) == (5 if kwargs["num_epochs"] == 2 else 3)
    assert_same_batches(got, want)
    order = list(record_order(5, kwargs.get("seed", 0), kwargs["num_epochs"],
                              kwargs.get("shuffle", True)))
    names = [(m["episode_id"], m["start_frame_idx"]) for b in got for m in b["metainfos"]]
    samples = [(s["episode_id"], s["start_frame_idx"]) for s in dataset.samples]
    assert names == [samples[i] for i in order]


def test_loader_endless_by_default_and_refuses_as_jax(dataset):
    it = make_grain_loader(dataset, 2, seed=1)
    batches = [next(it) for _ in range(12)]  # 24 records: about 5 epochs
    it.close()
    order = record_order(5, 1)
    assert [m["start_frame_idx"] for b in batches for m in b["metainfos"]] == \
           [dataset.samples[next(order)]["start_frame_idx"] for _ in range(24)]
    with pytest.raises(ValueError, match="batch_size must be a positive integer"):
        make_grain_loader(dataset, 0)
    with pytest.raises(ValueError, match="Shuffling requires specifying a seed"):
        make_grain_loader(dataset, 2, seed=None)


def _loader_children():
    return [p for p in mp.active_children() if type(p).__name__ == "SpawnProcess"]


def test_workers_give_the_same_batches_and_stop_on_close(dataset):
    """worker_count=2 (spawned processes) against 0, over 3 epochs, and
    the workers gone once the loader is closed."""
    want = list(make_grain_loader(dataset, 2, seed=5, num_epochs=3))
    loader = make_grain_loader(dataset, 2, seed=5, num_epochs=3, worker_count=2)
    got = [next(loader)]
    assert len(_loader_children()) == 2 and loader.worker_start_s > 0
    got += list(loader)
    assert_same_batches(got, want)
    assert not _loader_children()
    loader = make_grain_loader(dataset, 2, seed=5, worker_count=2)  # endless, closed early
    next(loader)
    loader.close()
    assert not _loader_children()


def test_a_worker_imports_no_torch(dataset, tmp_path):
    """What a spawned worker imports (the loader's module, then the
    dataset it unpickles) pulls in no torch: a fresh process doing the same."""
    import pickle
    import subprocess

    (tmp_path / "ds.pkl").write_bytes(pickle.dumps(dataset))
    code = ("import pickle, sys\n"
            "import orv_tpu_torch.data.grain_loader\n"
            f"ds = pickle.loads(open({str(tmp_path / 'ds.pkl')!r}, 'rb').read())\n"
            "ds[0]\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('torch', 'jax', 'grain')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_a_dead_worker_raises_naming_its_record(dataset):
    loader = make_grain_loader(dataset, 2, seed=5, worker_count=2)
    next(loader)
    victim = _loader_children()[0]
    os.kill(victim.pid, signal.SIGKILL)
    t0 = time.time()
    with pytest.raises(BrokenProcessPool) as e:
        for _ in range(20):
            next(loader)
    assert time.time() - t0 < 30
    assert re.fullmatch(r"raised by a grain loader worker reading record \d \(position \d+\)",
                        "".join(e.value.__notes__))
    loader.close()
    assert not _loader_children()


def test_a_failing_record_raises_its_error_from_a_worker(layout, tmp_path, monkeypatch):
    """With DEBUG set the dataset raises instead of resampling: the error a
    worker meets is the one the in-process loader raises, noting the record."""
    root = write_layout(tmp_path / "broken")
    (root / "embeddings_full" / "train" / "latents" / "00001_16_17_0.npz").unlink()
    monkeypatch.setenv("DEBUG", "1")
    ds = RobotDataset(_config(DatasetConfig, root))
    bad = [s["start_frame_idx"] for s in ds.samples].index(16, 2)  # episode 1, start 16
    with pytest.raises(FileNotFoundError, match="missing latents") as inproc:
        list(make_grain_loader(ds, 1, shuffle=False, num_epochs=1))
    with pytest.raises(FileNotFoundError, match="missing latents") as worker:
        list(make_grain_loader(ds, 1, shuffle=False, num_epochs=1, worker_count=2))
    assert str(worker.value) == str(inproc.value)
    assert f"reading record {bad} (position {bad})" in "".join(worker.value.__notes__)
    assert not _loader_children()


# -- train with train.loader=grain against JAX train ------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return make_setup(tmp_path_factory.mktemp("grain_train"))


def test_train_with_grain_matches_jax_train_with_grain(setup, tmp_path):
    """Both packages' `train` with train.loader=grain over the 9 slices of
    three episodes (B=1 x accumulation 2, 4 micro-steps, an EMA): the
    batches follow the grain order from seed 42, so each micro-step trains
    on another slice, the same in both."""
    extra = ["train.loader=grain", f"transformer.pretrained_name_or_path={setup['folder']}",
             "train.max_train_steps=4", "train.ema_decay=0.9", "train.checkpointing_steps=1000",
             "train.optimizer.max_grad_norm=0.05"]  # tests/test_torch_port_train_loop.py's clip
    mp_ = pytest.MonkeyPatch()
    seen = []
    to_device = ttrain.to_device
    mp_.setattr(ttrain, "to_device", lambda b, d: seen.append(b["metainfos"]) or to_device(b, d))
    try:
        mp_.setenv("NO_INIT_VAL", "1")
        mp_.setenv("ORV_TPU_FUSED_ADALN", "0")
        fix_uniforms(mp_, 1)
        jcfg = load(jconfigs, JAX_CFG, setup["many"], tmp_path / "jax",
                    extra + ["train.mesh.dp=1", "train.mesh.tp=8"])
        jstate = jtrain.train(jcfg)
        tcfg = load(tconfigs, PORT_CFG, setup["many"], tmp_path / "port", extra)
        state = ttrain.train(tcfg, device="cpu", draws=replayed_draws(42))
    finally:
        mp_.undo()
    ds = ttrain.build_dataset(tcfg)
    assert len(ds) == 9
    order = record_order(9, 42)
    assert [(m["episode_id"], m["start_frame_idx"]) for ms in seen for m in ms] == \
           [(ds.samples[i]["episode_id"], ds.samples[i]["start_frame_idx"])
            for i in (next(order) for _ in range(4))]
    assert len(set(str(ms) for ms in seen)) == 4

    read = lambda p: [json.loads(x) for x in p.read_text().splitlines()]
    want = read(tmp_path / "jax" / "run" / "logs" / "metrics.jsonl")
    got = read(tmp_path / "port" / "run" / "logs" / "metrics.jsonl")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("loss", "diffusion_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=(k, w["step"]))
    assert len({round(m["loss"], 6) for m in want}) == 4

    cfg = DiTConfig(**DIT)
    assert state.step == 4 and state.opt_state.count == 2
    start = dit_params_from_jax(setup["params"], cfg)
    want_p = dit_params_from_jax(jax.device_get(jstate.params), cfg)
    want_ema = dit_params_from_jax(jax.device_get(jax_train_step.ema_params(jstate.opt_state)),
                                   cfg)
    names = [n for n, _ in state.model.named_parameters()]
    scale = max((want_p[k] - start[k]).abs().max().item() for k in want_p)
    assert scale > 1e-4
    pairs = [(p.detach(), want_p[n]) for n, p in state.model.named_parameters()]
    pairs += [(e, want_ema[n]) for n, e in zip(names, state.opt_state.ema)]
    err = torch.cat([(a - b).flatten() for a, b in pairs])
    assert err.abs().max() <= 5e-2 * scale, (err.abs().max().item(), scale)
    assert err.pow(2).mean().sqrt() <= 1e-4 * scale, (err.pow(2).mean().sqrt().item(), scale)


# -- the Hub helper and its CLI ----------------------------------------------------------

class FakeHub:
    """A `huggingface_hub` module that records every call and downloads
    files it writes under `root`."""

    def __init__(self, root: Path):
        self.root, self.calls = root, []
        mod = types.ModuleType("huggingface_hub")
        hub = self

        class HfApi:
            def __getattr__(self, name):
                return lambda *a, **kw: hub.calls.append((name, a, kw))

        def hf_hub_download(**kw):
            hub.calls.append(("hf_hub_download", (), kw))
            path = root / "cache" / kw["repo_id"] / kw["filename"]
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(f"{kw['repo_id']}:{kw['filename']}")
            return str(path)

        def snapshot_download(*a, **kw):
            hub.calls.append(("snapshot_download", a, kw))
            return kw["local_dir"]

        mod.HfApi, mod.hf_hub_download, mod.snapshot_download = \
            HfApi, hf_hub_download, snapshot_download
        self.module = mod


def _relative(calls, root: Path):
    """`calls` with every string argument under `root` made relative to it."""
    rel = lambda v: os.path.relpath(v, root) if isinstance(v, str) and v.startswith(
        str(root)) else v
    return [(n, tuple(map(rel, a)), {k: rel(v) for k, v in kw.items()}) for n, a, kw in calls]


def _hub_session(hub, root: Path):
    """Each function of `hub` once, with downloads copied under `root`."""
    hub.upload_folder("outputs/run/checkpoint", "user/repo", path_in_repo="ckpt", token="t")
    hub.upload_folder("outputs/run/checkpoint", "user/repo")
    hub.upload_file("outputs/run/checkpoint/config.json", "user/repo", token="t", private=False)
    paths = [hub.download_file("user/repo", "checkpoint/config.json",
                               save_path=str(root / "saved"), token="t"),
             hub.download_file("user/repo", "model.safetensors")]
    paths.append(hub.download_folder("user/repo", str(root / "folder"),
                                     allow_patterns=["*.json"], token="t"))
    return paths


def test_hub_makes_the_jax_helpers_calls(tmp_path, monkeypatch):
    results = {}
    for name, hub in (("jax", jhub), ("port", thub)):
        fake = FakeHub(tmp_path / name)
        monkeypatch.setitem(sys.modules, "huggingface_hub", fake.module)
        paths = _hub_session(hub, tmp_path / name)
        results[name] = (_relative(fake.calls, tmp_path / name),
                         [os.path.relpath(p, tmp_path / name) for p in paths])
        saved = tmp_path / name / "saved" / "checkpoint" / "config.json"
        assert saved.read_text() == "user/repo:checkpoint/config.json"
    assert results["port"] == results["jax"]
    assert [c[0] for c in results["port"][0]] == [
        "create_repo", "upload_folder", "create_repo", "upload_folder", "create_repo",
        "upload_file", "hf_hub_download", "hf_hub_download", "snapshot_download"]


def test_hub_without_huggingface_hub_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for call in (lambda h: h.upload_folder("d", "u/r"), lambda h: h.upload_file("f", "u/r"),
                 lambda h: h.download_file("u/r", "f"), lambda h: h.download_folder("u/r", "d")):
        messages = []
        for hub in (jhub, thub):
            with pytest.raises(RuntimeError) as e:
                call(hub)
            assert isinstance(e.value.__cause__, ImportError)
            messages.append(str(e.value))
        assert messages == ["huggingface_hub not installed"] * 2


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_cli(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    try:
        mod.main()
    except SystemExit as e:
        return str(e.code)
    return None


@pytest.mark.parametrize("argv", [
    ["--repo_id", "user/repo", "--upload"],
    ["--repo_id", "repo", "--upload", "--folder_path", "ckpt"],
    ["--repo_id", "a/b/c", "--download", "--file_path", "x"],
    ["--repo_id", "user/repo", "--upload", "--download", "--folder_path", "ckpt",
     "--file_path", "config.json", "--path_in_repo", "sub", "--token", "t"],
    ["--repo_id", "user/repo", "--download", "--folder_path", "ckpt"],
])
def test_cli_matches_hf_model(argv, tmp_path, monkeypatch):
    """The same SystemExit message, or the same Hub calls, from both CLIs."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.delenv("hf_token", raising=False)
    outcomes = []
    for name in ("hf_model", "hf_model_torch"):
        fake = FakeHub(tmp_path / name)
        monkeypatch.setitem(sys.modules, "huggingface_hub", fake.module)
        exit_msg = _run_cli(_script(name), argv, monkeypatch)
        outcomes.append((exit_msg, _relative(fake.calls, tmp_path / name)))
    assert outcomes[1] == outcomes[0]
    if "--folder_path" not in argv and "--file_path" not in argv:
        assert outcomes[0][0] == "choose either --folder_path or --file_path"
    elif argv[1] != "user/repo":
        assert outcomes[0][0] == f"invalid repo_id {argv[1]!r}: use user/repo"
    else:
        assert outcomes[0][0] is None and outcomes[0][1]
