"""The port's serving entry points against orv_tpu's, on the CPU.

`pipelines/evaluate.py:evaluate` (the batch path in traj-image-depth-label
mode, W8A8 `quant=true`, raw pixels under `load_tensors=false`, and the
cascaded rollout with and without a VAE) and
`pipelines/inference.py:generate_video`, against the JAX functions on the
same files (written from a numpy seed), the same weights (a seeded random
DiT exported by the JAX package both as its flax folder and as a diffusers
folder, and a tiny VAE through the weight bridge) and the same draws (the
port's `EvalDraws` replayed from JAX's keys, DDIM steps so that no sampler
noise is drawn). Both sides compute the DiT in bf16 with f32 parameters.

Tolerances:
  * latents: 2e-2 of their range at most and 3e-3 of it on average, the
    bf16 DiT's bound (tests/test_torch_port_dit.py); W8A8 4e-2 and 3e-3,
    the bound of tests/test_torch_port_quant.py;
  * frames: the port's mp4 as long as the JAX package's, and equal, to 1
    uint8 level but for at most 1% of the values and 0.05 levels on
    average, to the mp4 the JAX package makes of the port's own latents
    (the random tiny VAE magnifies the latents' bf16 differences to 7
    levels on average between the two packages' frames, so those are
    held through the latents);
  * file names, manifests and `chunk_starts`: equal.
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

from orv_tpu import configs as jconfigs
from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models.vae import CausalVAE as JaxCausalVAE
from orv_tpu.models.vae import VAEConfig as JaxVAEConfig
from orv_tpu.models.vae import decode_chunked as jax_decode_chunked
from orv_tpu.models.weights import export_torch_pretrained
from orv_tpu.pipelines import evaluate as jevaluate
from orv_tpu.pipelines import inference as jinference
from orv_tpu.utils.checkpoint import export_pretrained
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.models import CausalVAE, ControlDiT, DiTConfig, VAEConfig
from orv_tpu_torch.models.weights import dit_params_from_jax, vae_params_from_jax
from orv_tpu_torch.parallel import EvalDraws
from orv_tpu_torch.pipelines import evaluate as tevaluate
from orv_tpu_torch.pipelines import inference as tinference
from orv_tpu_torch.utils import video as tvideo
from orv_tpu_torch.utils.checkpoint import load_pretrained

from test_torch_port_serving_data import VAE, randomize, write_dataset
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX_CFG, PORT_CFG = REPO / "orv_tpu" / "config", REPO / "orv_tpu_torch" / "config"
COND = "eval/eval_traj_image_cond_2b_finetune.yaml"
CASCADED = "eval/eval_traj_image_2b_finetune_cascaded.yaml"
DIT = dict(num_attention_heads=2, attention_head_dim=8, num_layers=1, text_embed_dim=32,
           time_embed_dim=32, max_text_seq_length=8, in_channels=32, out_channels=16,
           modulate_encoder_hidden_states=True, visual_guidance=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    data = write_dataset(root / "data")
    jdit = JaxControlDiT(JaxDiTConfig(**DIT), dtype=jnp.bfloat16)
    x = np.zeros((1, 3, 32, 4, 6), np.float32)
    params = randomize(jax.eval_shape(lambda: jdit.init(
        jax.random.PRNGKey(0), x, np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
        actions=np.zeros((1, 8, 7), np.float32), depths=x, labels=x)), seed=1)
    folder = root / "dit"
    export_pretrained(str(folder), params, JaxDiTConfig(**DIT))  # the JAX package reads this
    export_torch_pretrained(str(folder), params, JaxDiTConfig(**DIT))  # the port this
    jvae = JaxCausalVAE(JaxVAEConfig(**VAE), dtype=jnp.float32)
    vparams = randomize(jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 16, 16)))), seed=2)
    return dict(root=root, data=data, folder=folder, params=params, jvae=jvae,
                vparams=vparams)


def port_vae(s):
    vae = CausalVAE(VAEConfig(**VAE), dtype=torch.float32, device="cpu")
    vae.load_state_dict(vae_params_from_jax(s["vparams"], VAEConfig(**VAE)))
    return vae


def overrides(s, out, extra=()):
    keys = ("num_attention_heads", "attention_head_dim", "num_layers", "text_embed_dim",
            "time_embed_dim", "max_text_seq_length")
    return [f"dataset.data_root={s['data']}", "dataset.sequence_length=8",
            "dataset.start_frame_interval=8", "dataset.video_size=[32, 48]",
            "dataset.ori_size=[32, 48]", *(f"transformer.{k}={DIT[k]}" for k in keys),
            f"transformer.pretrained_name_or_path={s['folder']}",
            # the eval yamls' `transformer: <<: *runtime` keeps the base's
            # visual_guidance: false, which the transformer section's value wins
            "transformer.visual_guidance=true",
            "evaluation.num_inference_steps=2", "evaluation.scheduler=ddim",
            "evaluation.batch_size=2", f"evaluation.output_dir={out}", *extra]


def configs(s, name, tag, extra=()):
    args = lambda mod, d, side: mod.load_config(
        str(d / "base_eval.yaml"), str(d / name), "bridgev2",
        overrides=overrides(s, s["root"] / f"{tag}_{side}", extra))
    return args(jconfigs, JAX_CFG, "jax"), args(tconfigs, PORT_CFG, "port")


def jax_draws(seed=42, chunks=None):
    """The port's EvalDraws from JAX's keys, split as JAX `evaluate` splits
    them: per batch (rng, r_img, r_ctrl, r_noise, r_samp); in the cascaded
    rollout per episode (rng, r_ep), then per chunk (r_ep, r_img, r_noise,
    r_samp) and (r_ep, r_ctrl). `chunks`: the chunk count of each episode,
    in the rollout's order."""
    state = dict(rng=jax.random.PRNGKey(seed), left=0, ep=None, chunks=list(chunks or []))
    normal = lambda k, shape: None if shape is None else torch.tensor(
        np.asarray(jax.random.normal(k, tuple(shape), jnp.float32)))

    def draws(noise_shape, image_shape=None, depth_shape=None, label_shape=None):
        if chunks is None:
            state["rng"], r_img, r_ctrl, r_noise, _ = jax.random.split(state["rng"], 5)
        else:
            if state["left"] == 0:
                state["rng"], state["ep"] = jax.random.split(state["rng"])
                state["left"] = state["chunks"].pop(0)
            state["left"] -= 1
            state["ep"], r_img, r_noise, _ = jax.random.split(state["ep"], 4)
            state["ep"], r_ctrl = jax.random.split(state["ep"])
        return EvalDraws(noise=normal(r_noise, noise_shape), image_noise=normal(r_img, image_shape),
                         depth_noise=normal(r_ctrl, depth_shape),
                         label_noise=normal(jax.random.fold_in(r_ctrl, 1), label_shape))

    return draws


def assert_latents_close(got, want, max_rel=2e-2, mean_rel=3e-3):
    assert got.shape == want.shape and np.isfinite(got).all()
    err, rng = np.abs(got - want), np.abs(want).max()
    assert err.max() <= max_rel * rng and err.mean() <= mean_rel * rng, (
        err.max() / rng, err.mean() / rng)


def jax_video(s, chunks, starts, path: Path, interval: int = 1) -> np.ndarray:
    """Frames the JAX package makes of latent chunks [F, C, H, W]: its
    chunked decode of each, the cascaded rollout's stitch (leading frames
    the previous chunk covered dropped), `to_uint8` and `save_video`, read
    back as the port reads."""
    # the one-program decode, which tests/test_vae.py holds equal to the
    # chunk-at-a-time one the JAX package's evaluate runs
    videos = [np.asarray(jax_decode_chunked(
        s["jvae"], s["vparams"], jnp.asarray(ch)[None].transpose(0, 2, 1, 3, 4) / 1.15258426,
        chunk_latent_frames=6, fused=True)[0]) for ch in chunks]
    keep, prev_end = [videos[0]], starts[0] + (videos[0].shape[1] - 1) * interval
    for start, v in zip(starts[1:], videos[1:]):
        keep.append(v[:, min(max(0, -(-(prev_end + 1 - start) // interval)), v.shape[1]):])
        prev_end = start + (v.shape[1] - 1) * interval
    video = np.concatenate([v for v in keep if v.shape[1]], axis=1)
    jevaluate.save_video(str(path), jevaluate.to_uint8(video), gif=False)
    return tvideo.read_video(path)


def compare_outputs(s, jdir: Path, tdir: Path, max_rel=2e-2, mean_rel=3e-3):
    """Equal file names and manifests, latents within the bf16 DiT's bound,
    every mp4 of the port as long as the JAX package's, and equal to what
    the JAX package makes of the port's own latents (`jax_video`): the
    decodes differ by f32 rounding, so a few values round to the other
    uint8 and the codec spreads that: mean difference <= 0.05 levels, and
    at most 1% of the values more than 1 level apart."""
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    for n in names:
        if n.endswith(".json"):
            assert json.loads((tdir / n).read_text()) == json.loads((jdir / n).read_text()), n
        elif n.endswith(".npz"):
            with np.load(jdir / n) as want, np.load(tdir / n) as got:
                assert got.files == want.files
                assert_latents_close(got["arr_0"], want["arr_0"], max_rel, mean_rel)
                starts = [0]
                if "chunk_starts" in want.files:
                    np.testing.assert_array_equal(got["chunk_starts"], want["chunk_starts"])
                    starts = got["chunk_starts"].tolist()
                lat = got["arr_0"]
            mp4 = tdir / n.replace("_latents.npz", ".mp4")
            if mp4.exists():
                got = tvideo.read_video(mp4)
                assert got.shape == tvideo.read_video(jdir / mp4.name).shape
                want = jax_video(s, np.split(lat, len(starts)), starts, tdir.parent / "want.mp4")
                d = np.abs(got.astype(int) - want)
                assert d.mean() <= 0.05 and (d > 1).mean() <= 1e-2, (n, d.mean(), (d > 1).mean())
    return names


def run_both(s, jcfg, tcfg, with_vae, draws, **jkw):
    jres = jevaluate.evaluate(jcfg, vae=s["jvae"] if with_vae else None,
                              vae_params=s["vparams"] if with_vae else None, **jkw)
    tres = tevaluate.evaluate(tcfg, vae=port_vae(s) if with_vae else None, device="cpu",
                              draws=draws, **jkw)
    assert tres == jres
    return Path(jcfg.evaluation.output_dir), Path(tcfg.evaluation.output_dir)


def test_evaluate_batch_depth_label_matches_jax(setup):
    """The occupancy-conditioned eval config, traj-image-depth-label mode:
    moments sampled from the draws, depth and label controls, latents and
    decoded mp4/gif per clip, the manifests."""
    s = setup
    jcfg, tcfg = configs(s, COND, "batch", ["evaluation.mode=traj-image-depth-label"])
    jdir, tdir = run_both(s, jcfg, tcfg, True, jax_draws(), max_batches=1)
    names = compare_outputs(s, jdir, tdir)
    assert sum(n.endswith("_latents.npz") for n in names) == 2  # one batch of 2
    assert {"manifest.json", "manifest_0.json", "00000_008.gif", "00000_008.mp4"} <= set(names)
    assert np.load(tdir / "00000_008_latents.npz")["arr_0"].shape == (3, 16, 4, 6)


def test_evaluate_quant_matches_jax(setup):
    """evaluation.quant=true: the port loads bf16, quantizes in place
    (quantize_model_); JAX quantizes the loaded tree."""
    s = setup
    jcfg, tcfg = configs(s, COND, "quant", ["evaluation.mode=traj-image-depth-label",
                                            "evaluation.quant=true"])
    jdir, tdir = run_both(s, jcfg, tcfg, False, jax_draws(), max_batches=1)
    assert len(compare_outputs(s, jdir, tdir, 4e-2, 3e-3)) == 4


def test_evaluate_raw_pixels_matches_jax(setup):
    """dataset.load_tensors=false: mp4 frames and render.npz depth/label maps
    VAE-encoded on the fly (depth repeated to 3 channels), zero prompt
    embeds substituted."""
    s = setup
    jcfg, tcfg = configs(s, COND, "raw", ["evaluation.mode=traj-image-depth-label",
                                          "dataset.load_tensors=false"])
    jdir, tdir = run_both(s, jcfg, tcfg, True, jax_draws(), max_batches=1)
    assert len(compare_outputs(s, jdir, tdir)) == 8


def _chunk_counts(cfg):
    from orv_tpu.pipelines.train import build_dataset

    ds = build_dataset(cfg, split="test", cascaded=True)
    eps = [str(x["episode_id"]) for x in ds.samples]
    return [eps.count(e) for e in sorted(set(eps))]


@pytest.mark.parametrize("with_vae", [False, True])
def test_evaluate_cascaded_matches_jax(setup, with_vae):
    """The reference cascaded config (raw pixels with a VAE; the pre-encoded
    moments without one, where the chaining latent frame (nxt + 3) // 4
    carries over): per-episode stitched latents, chunk_starts, the stitched
    mp4 with the ceil-division dedup of overlapping frames. One DDIM step a
    chunk: each chained chunk is conditioned on a frame that carries the
    previous chunk's bf16 difference, and with two steps a chunk the
    fourth reached 5.2% of the range; with one, every chunk stays within
    the bf16 DiT's bound (measured 0.6-1.75%)."""
    s = setup
    extra = ["evaluation.num_inference_steps=1"] + ([] if with_vae else
                                                     ["dataset.load_tensors=true"])
    jcfg, tcfg = configs(s, CASCADED, f"cascaded_{with_vae}", extra)
    counts = _chunk_counts(jcfg)
    assert counts == [4, 4]  # starts 1, 9, 17 and the regrown 22
    jdir, tdir = run_both(s, jcfg, tcfg, with_vae, jax_draws(chunks=counts))
    names = compare_outputs(s, jdir, tdir)
    assert "manifest_cascaded.json" in names
    with np.load(tdir / "00000_cascaded_latents.npz") as f:
        assert f["arr_0"].shape == (12, 16, 4, 6)
        assert f["chunk_starts"].tolist() == [0, 8, 16, 21]
    if with_vae:
        # 9 frames, then 8 + 8 new ones, then the regrown chunk's 5 (frames
        # 25-29): every frame of the 30-frame episode once
        assert tvideo.read_video(tdir / "00000_cascaded.mp4").shape[0] == 9 + 8 + 8 + 5


def test_generate_video_matches_jax(setup):
    """The demo path: the reference frame encoded (posterior mean), noise
    from the draws, DPM sampling without the stochastic term's draws
    mattering (DDIM is not offered there, so both sides draw it: the port's
    generator against JAX's r_samp differ, and the check is on a 1-step
    run whose last DPM step adds no noise), then the chunked decode."""
    s = setup
    from orv_tpu_torch.utils.checkpoint import load_pretrained as tload

    rng = np.random.default_rng(20)
    ref = rng.uniform(-1, 1, (32, 48, 3)).astype(np.float32)
    actions = (0.3 * rng.standard_normal((8, 7))).astype(np.float32)
    prompt = rng.standard_normal((8, 32)).astype(np.float32)
    jcfg = JaxDiTConfig(**DIT)
    kw = dict(num_frames=9, num_inference_steps=1, seed=3)
    want = jinference.generate_video(jcfg, s["params"], s["jvae"], s["vparams"], ref, actions,
                                     prompt, **kw)
    cfg, sd = tload(s["folder"], DiTConfig)
    model = ControlDiT(cfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(sd, strict=True)
    r_noise, _ = jax.random.split(jax.random.PRNGKey(3))
    draws = EvalDraws(noise=torch.tensor(np.asarray(jax.random.normal(r_noise, (1, 3, 16, 4, 6)))))
    got = tinference.generate_video(model, port_vae(s), ref, actions, prompt, draws=draws,
                                    device="cpu", **kw)
    assert got.shape == want.shape == (3, 9, 32, 48)
    assert_latents_close(got, np.asarray(want))


def test_inference_main_smoke_mode(tmp_path, monkeypatch):
    """`main` without checkpoints: the tiny random model over a demo folder,
    written as mp4 (the random full-size VAE at 32x48). The model it builds
    is JAX's smoke model, field by field: 4 heads of 16 (JAX's `main` is
    stopped where it builds its model, and its config read there)."""
    import dataclasses

    from PIL import Image

    built = {}

    class Stop(Exception):
        pass

    def jax_model(cfg, **kw):
        built["jax"] = cfg
        raise Stop

    def port_model(cfg, **kw):
        built.setdefault("port", cfg)
        return ControlDiT(cfg, **kw)

    monkeypatch.setattr(jinference, "ControlDiT", jax_model)
    monkeypatch.setattr(tinference, "ControlDiT", port_model)
    with pytest.raises(Stop):
        jinference.main(["--demo_root", str(tmp_path / "demo"), "--output_dir",
                         str(tmp_path / "jax_out")])

    rng = np.random.default_rng(21)
    ep = tmp_path / "demo" / "ep0"
    (ep / "rgb").mkdir(parents=True)
    for i in range(9):
        Image.fromarray(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)).save(
            ep / "rgb" / f"{i:03d}.png")
    (ep / "annotations.json").write_text(json.dumps(dict(
        state=rng.uniform(-1, 1, (9, 7)).tolist(),
        continuous_gripper_state=rng.uniform(0, 1, 9).tolist())))
    out = tinference.main(["--demo_root", str(tmp_path / "demo"), "--output_dir",
                           str(tmp_path / "out"), "--num_frames", "9",
                           "--num_inference_steps", "1", "--device", "cpu"])
    frames = tvideo.read_video(out)
    assert frames.shape == (9, 32, 48, 3)
    assert (tmp_path / "out" / "ep0.gif").exists()
    port = built["port"]
    assert (port.num_attention_heads, port.attention_head_dim) == (4, 16)
    assert port is tinference.SMOKE_DIT
    assert dataclasses.asdict(port) == dataclasses.asdict(built["jax"])


def test_refusals(setup, tmp_path):
    """A dp/fsdp/tp mesh axis past 1 without the ranks it needs and a
    msgpack-only folder raise, naming what to do; nothing is generated.
    (PAB runs since the model surface was ported:
    tests/test_torch_port_model_surface_serving.py; sp serving since context
    parallelism was: tests/test_torch_port_sp_train.py; dp/fsdp/tp serving
    since data and model parallelism were: tests/test_torch_port_mesh_entry.py.)"""
    s = setup
    for extra, match in ((["evaluation.mesh.tp=2"], "evaluation.mesh.tp=2 needs 2 ranks"),
                         (["evaluation.mesh.dp=2"], "evaluation.mesh.dp=2 needs 2 ranks")):
        _, tcfg = configs(s, COND, "refused", extra)
        with pytest.raises(ValueError, match=match):
            tevaluate.evaluate(tcfg, device="cpu")
    jax_only = tmp_path / "jax_only"
    export_pretrained(str(jax_only), s["params"], JaxDiTConfig(**DIT))
    with pytest.raises(ValueError, match="export_torch_pretrained"):
        load_pretrained(jax_only)
    _, tcfg = configs(s, COND, "refused", [f"transformer.pretrained_name_or_path={jax_only}"])
    with pytest.raises(ValueError, match="export_torch_pretrained"):
        tevaluate.evaluate(tcfg, device="cpu")
    assert not (s["root"] / "refused_port").exists() or not any(
        (s["root"] / "refused_port").glob("*.npz"))


def test_load_pretrained_reads_the_exported_folder(setup):
    """export_torch_pretrained's folder: its config.json gives the DiTConfig,
    its safetensors the state dict, which loads strictly and equals the
    bridge's."""
    s = setup
    cfg, sd = load_pretrained(s["folder"], DiTConfig)
    assert cfg == DiTConfig(**DIT)
    bridged = dit_params_from_jax(s["params"], cfg)
    assert sorted(sd) == sorted(bridged)
    for k, v in bridged.items():
        assert torch.equal(sd[k], v), k
    raw_cfg, _ = load_pretrained(s["folder"])
    assert raw_cfg["_class_name"] == "CogVideoXTransformer3DModelTraj"


def test_entry_points_need_cuda_unless_cpu_is_asked(setup, monkeypatch):
    s = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs(s, COND, "nocuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tevaluate.evaluate(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tevaluate.main(["--dataset_type", "bridgev2", f"dataset.data_root={s['data']}"])
    model = ControlDiT(DiTConfig(**DIT), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinference.generate_video(model, port_vae(s), np.zeros((32, 48, 3)), None,
                                  np.zeros((8, 32)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinference.main(["--demo_root", str(s["root"])])


def test_cli_modules_run_without_jax():
    """`python -m orv_tpu_torch.pipelines.{evaluate,inference,metrics} --help`
    in a fresh process, which must not import jax or orv_tpu."""
    code = ("import runpy, sys\n"
            "for m in ('evaluate', 'inference', 'metrics'):\n"
            "    sys.argv = ['x', '--help']\n"
            "    try:\n"
            "        runpy.run_module(f'orv_tpu_torch.pipelines.{m}', run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (m, e.code)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'orv_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.count("usage:") == 3
