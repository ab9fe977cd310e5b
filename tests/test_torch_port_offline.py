"""The port's offline path against orv_tpu's, on the CPU: raw episodes
through `pipelines/data_process.py:extract`, then
`pipelines/encode_dataset.py:encode_split` and the empty prompt, then the
port's `train` on what the port encoded.

The same seeded episodes go through both packages' `extract`; one tiny f32
VAE's seeded random JAX params go to the port through
`vae_params_from_jax`. The file lists, annotation JSON and mp4 frames are
held bitwise; every latent within 1e-4 of its RMS (only the order of sums
differs).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.pipelines import encode_dataset as jenc
from orv_tpu_torch.pipelines import encode_dataset as tenc
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)


def _rel(got, want):
    """(max error, RMS error) over the reference's RMS."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    return err.max() / rms, np.sqrt(np.mean(err ** 2)) / rms


# -- raw episodes -> latents -> train ----------------------------------------------

N_RAW = 33  # frames an episode: 4 slices of 9 frames, one every 8


def _episodes(seed=0):
    """Two single-view episodes and one with two cameras, from a numpy seed:
    smooth frames (codec-friendly), states, gripper and actions."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(32), np.arange(48), indexing="ij")
    for i, cams in enumerate((1, 1, 2)):
        t = np.arange(N_RAW)[:, None, None, None]
        frames = {c: np.clip(128 + 60 * np.sin(0.2 * xx[None, :, :, None] + 0.15 * t + i + c
                                               + np.arange(3))
                             + 40 * np.cos(0.25 * yy)[None, :, :, None]
                             + rng.normal(0, 4, (N_RAW, 32, 48, 3)), 0, 255).astype(np.uint8)
                  for c in range(cams)}
        ep = dict(episode_id=f"{i:05d}", texts=[f"pick object {i}"], frames=frames,
                  state=rng.uniform(-1, 1, (N_RAW, 7)).tolist(),
                  continuous_gripper_state=rng.uniform(0, 1, N_RAW).tolist(),
                  action=rng.uniform(-1, 1, (N_RAW, 7)).tolist())
        if cams > 1:
            ep["has_image"] = {c: True for c in range(cams)}
        yield ep


def _renders(root: Path, seed=1):
    """A render.npz of depths and semantic labels for every episode (its
    views side by side), as the factory leaves them."""
    rng = np.random.default_rng(seed)
    for i, cams in enumerate((1, 1, 2)):
        (root / f"{i:05d}").mkdir(exist_ok=True)
        np.savez(root / f"{i:05d}" / "render.npz",
                 depths=rng.uniform(0.0, 0.5, (N_RAW, cams, 32, 48)).astype(np.float32),
                 semantics=rng.integers(0, 60, (N_RAW, cams, 32, 48)).astype(np.int32),
                 is_labeled=np.ones(1, bool))


def _files(root: Path, sub=""):
    return sorted(str(p.relative_to(root)) for p in (root / sub).rglob("*") if p.is_file())


def _encode_cfgs(root_j, root_t, tmp, extra=()):
    from orv_tpu import configs as jconfigs
    from orv_tpu_torch import configs as tconfigs

    from test_torch_port_train_entry import JAX_CFG, PORT_CFG, load

    return (load(jconfigs, JAX_CFG, root_j, tmp / "jax_run", extra),
            load(tconfigs, PORT_CFG, root_t, tmp / "port_run", extra))


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """Both packages' `extract` over the same episodes, then each one's
    `encode_split` (ref_nums 1 and 5, condition latents) and empty prompt
    with one tiny f32 VAE (seeded random weights through the bridge)."""
    from orv_tpu.models.vae import CausalVAE as JaxCausalVAE
    from orv_tpu.models.vae import VAEConfig as JaxVAEConfig
    from orv_tpu.pipelines import data_process as jdp
    from orv_tpu_torch.models import CausalVAE, VAEConfig
    from orv_tpu_torch.models.weights import vae_params_from_jax
    from orv_tpu_torch.pipelines import data_process as tdp

    from test_torch_port_serving_data import VAE, randomize

    tmp = tmp_path_factory.mktemp("offline")
    root_j, root_t = tmp / "jax", tmp / "port"
    jdp.extract(_episodes(), str(root_j), split="train", num_workers=2)
    tdp.extract(_episodes(), str(root_t), split="train", num_workers=2)
    for root in (root_j, root_t):
        _renders(root)
    jcfg, tcfg = _encode_cfgs(root_j, root_t, tmp)
    jvae = JaxCausalVAE(JaxVAEConfig(**VAE), dtype=jnp.float32)
    params = randomize(jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 32, 48)))), seed=2)
    tvae = CausalVAE(VAEConfig(**VAE), dtype=torch.float32, device="cpu")
    tvae.load_state_dict(vae_params_from_jax(params, VAEConfig(**VAE)), strict=True)
    kw = dict(ref_nums=[1, 5], encode_conds=True)
    jenc.encode_split(jcfg, jvae, params, "train", **kw)
    written = tenc.encode_split(tcfg, tvae, "train", device="cpu", **kw)
    for root, mod, cfg, dev in ((root_j, jenc, jcfg, {}), (root_t, tenc, tcfg, {"device": "cpu"})):
        mod.encode_empty_prompt(cfg, root / "embeddings_full" / "train", **dev)
    return dict(tmp=tmp, root_j=root_j, root_t=root_t, tcfg=tcfg, vae=tvae, kw=kw,
                written=written)


def test_extract_writes_what_jax_writes(encoded):
    root_j, root_t = encoded["root_j"], encoded["root_t"]
    assert _files(root_j, "annotations") == _files(root_t, "annotations")
    assert _files(root_j, "videos") == _files(root_t, "videos") == [
        "videos/00000.mp4", "videos/00001.mp4", "videos/00002_0.mp4", "videos/00002_1.mp4"]
    for name in _files(root_j, "annotations"):
        assert (root_t / name).read_text() == (root_j / name).read_text()
    from orv_tpu_torch.utils.video import read_video

    for name in _files(root_j, "videos"):
        np.testing.assert_array_equal(read_video(str(root_t / name)),
                                      read_video(str(root_j / name)))


def test_encode_split_writes_what_jax_writes(encoded):
    """The same files (view v's latents as `_{v}`, the observations of view
    0 unsuffixed past r = 1 (`_ref5`), depth and label latents, the zero
    empty prompt), and every latent within 1e-4 of its RMS."""
    ej = encoded["root_j"] / "embeddings_full" / "train"
    et = encoded["root_t"] / "embeddings_full" / "train"
    names = _files(ej)
    assert names == _files(et)
    assert {"latents/00002_08_09_1.npz", "image_latents/00002_08_09_1_ref5.npz",
            "latents/00000_00_09_0.npz", "image_latents/00000_00_09_ref5.npz"} <= set(names)
    kinds = {n.split("/")[0] for n in names}
    assert kinds == {"latents", "image_latents", "depth_latents", "label_latents", "prompt_embeds"}
    # 3 episodes x 4 slices; 4 streams a slice start (the last episode's two views)
    assert len([n for n in names if n.startswith("latents/")]) == 16
    assert sorted(encoded["written"]) == sorted(str(et / n) for n in names
                                                if not n.startswith("prompt_embeds"))
    for n in names:
        j, t = np.load(ej / n)["arr_0"], np.load(et / n)["arr_0"]
        assert t.shape == j.shape and t.dtype == np.float32, n
        if n.startswith("prompt_embeds"):
            np.testing.assert_array_equal(t, j)
        else:
            assert _rel(t, j)[0] <= 1e-4, n
    lat = np.load(et / "latents/00000_00_09_0.npz")["arr_0"]
    assert lat.shape == (32, 3, 4, 6)  # moments: 2 x 16 channels, 9 frames -> 3


def test_encode_split_skips_and_backfills(encoded):
    """A second call writes nothing; after one file is deleted, a third
    rewrites that file only and leaves every other file's mtime alone."""
    tcfg, vae, kw = encoded["tcfg"], encoded["vae"], encoded["kw"]
    et = encoded["root_t"] / "embeddings_full" / "train"
    assert tenc.encode_split(tcfg, vae, "train", device="cpu", **kw) == []
    gone = et / "depth_latents" / "00001_16_09_0.npz"
    before = np.load(gone)["arr_0"]
    gone.unlink()
    mtimes = {p: p.stat().st_mtime_ns for p in et.rglob("*.npz")}
    assert tenc.encode_split(tcfg, vae, "train", device="cpu", **kw) == [str(gone)]
    assert {p: p.stat().st_mtime_ns for p in mtimes} == mtimes
    np.testing.assert_array_equal(np.load(gone)["arr_0"], before)


def test_encode_split_max_samples_and_ranks(encoded, tmp_path, monkeypatch):
    """`max_samples` cuts the work list; two ranks (torch.distributed's rank
    and world size, as `_rank` reads them) take disjoint halves whose union
    is the whole."""
    from orv_tpu_torch import configs as tconfigs

    from test_torch_port_train_entry import PORT_CFG, load

    vae, root = encoded["vae"], encoded["root_t"]
    full = {Path(p).relative_to(root / "embeddings_full" / "train").as_posix()
            for p in encoded["written"]}
    runs = {}
    for name, kw, rank in (("max", dict(max_samples=2), (0, 1)), ("r0", {}, (0, 2)),
                           ("r1", {}, (1, 2))):
        monkeypatch.setattr(tenc, "_rank", lambda: rank)
        cfg = load(tconfigs, PORT_CFG, root, tmp_path, [f"dataset.embeddings_folder=emb_{name}"])
        runs[name] = {Path(p).relative_to(root / f"emb_{name}" / "train").as_posix()
                      for p in tenc.encode_split(cfg, vae, "train", device="cpu",
                                                 ref_nums=[1], encode_conds=False, **kw)}
    lat = lambda s: {p for p in s if p.startswith("latents/")}
    assert len(lat(runs["max"])) == 2 and lat(runs["max"]) < lat(full)
    assert not runs["r0"] & runs["r1"]
    assert lat(runs["r0"] | runs["r1"]) == lat(full)


def test_encode_main_runs_on_the_cpu(encoded, monkeypatch):
    """The CLI: the recipe's config with overrides, a random full-size bf16
    VAE, one sample (`--max_samples 1`) on the CPU, and the zero empty
    prompt; without --device it needs the card."""
    from test_torch_port_train_entry import overrides

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--dataset_type", "bridgev2", "--max_samples", "1",
            *overrides(encoded["root_t"], encoded["tmp"] / "unused",
                       ["dataset.embeddings_folder=emb_main"])]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenc.main(argv)
    tenc.main(argv + ["--device", "cpu"])
    out = encoded["root_t"] / "emb_main" / "train"
    assert _files(out) == ["image_latents/00000_00_09_0.npz", "latents/00000_00_09_0.npz",
                           "prompt_embeds/empty.npz"]
    assert np.load(out / "latents" / "00000_00_09_0.npz")["arr_0"].shape == (32, 3, 4, 6)
    assert np.load(out / "prompt_embeds" / "empty.npz")["arr_0"].shape == (8, 32)


def test_port_trains_on_what_it_encoded(encoded, monkeypatch):
    """One step of the port's `train` at a tiny config on the port's own
    encode output (latents, image, depth and label latents, the empty
    prompt), as tests/test_e2e_pipeline.py trains JAX on JAX's."""
    from orv_tpu_torch import configs as tconfigs
    from orv_tpu_torch.pipelines import train as ttrain

    from test_torch_port_train_entry import PORT_CFG, load

    monkeypatch.setenv("NO_INIT_VAL", "1")
    out = encoded["tmp"] / "train_out"
    cfg = load(tconfigs, PORT_CFG, encoded["root_t"], out,
               ["train.max_train_steps=1", "train.gradient_accumulation_steps=1",
                "transformer.pretrained_name_or_path=null"])
    state = ttrain.train(cfg, device="cpu")
    assert state.step == 1
    log = [json.loads(l) for l in (out / "run" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert log and all(np.isfinite(r["loss"]) for r in log if "loss" in r)
