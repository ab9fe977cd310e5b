"""The serving path's data and model layers against orv_tpu, on the CPU.

Configs (the port's copy of the yaml files, `load_config`,
`build_dit_config` and `build_dataset`), the rotation math, the
datasets' items, video IO, the safetensors reader and the weight bridge,
the VAE encode, the sampler's pixel preprocessing and the PSNR/SSIM
metrics. Inputs are written from a numpy seed into a temp dir; the JAX
side is the reference. Tolerances:
  * configs, dataset items, file pairing, safetensors tensors: equal;
  * relative actions: 1e-12 (f64, the same formulas);
  * raw-frame items: equal (both resize with OpenCV);
  * VAE encode (`Encoder3D`, `encode`, `encode_chunked`, `encode_auto`) in
    f32: 1e-4 (f32 convs accumulated in another order; measured 3e-6);
    in bf16: 2e-2 of the output's range, the bf16 DiT's bound (JAX sums
    a 3x3x3 conv's taps in bf16, torch in f32);
  * `preprocess_video`: 1e-5 (the same antialiased bilinear weights);
  * PSNR and SSIM: 1e-6 relative (both numpy f64 on the same frames).
"""

import dataclasses
import filecmp
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from orv_tpu import configs as jconfigs
from orv_tpu.data import dataset as jdataset
from orv_tpu.data import rotation as jrotation
from orv_tpu.models.vae import CausalVAE as JaxCausalVAE
from orv_tpu.models.vae import VAEConfig as JaxVAEConfig
from orv_tpu.models.vae import encode_auto as jax_encode_auto
from orv_tpu.models.vae import encode_chunked as jax_encode_chunked
from orv_tpu.pipelines import metrics as jmetrics
from orv_tpu.pipelines import sample as jsample
from orv_tpu.pipelines import train as jtrain
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.data import dataset as tdataset
from orv_tpu_torch.data import rotation as trotation
from orv_tpu_torch.models import CausalVAE, VAEConfig, encode_auto, encode_chunked
from orv_tpu_torch.models.weights import (load_diffusers_folder, read_safetensors,
                                          vae_params_from_jax)
from orv_tpu_torch.pipelines import metrics as tmetrics
from orv_tpu_torch.pipelines import sample as tsample
from orv_tpu_torch.pipelines import train as ttrain
from orv_tpu_torch.utils import video as tvideo
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX_CFG, PORT_CFG = REPO / "orv_tpu" / "config", REPO / "orv_tpu_torch" / "config"
CONFIG_FILES = sorted(str(p.relative_to(JAX_CFG)) for p in JAX_CFG.rglob("*.yaml"))
EVAL_FILES = [f for f in CONFIG_FILES if f.startswith(("eval/", "experiments/"))]
VAE = dict(block_out_channels=(8, 16, 16, 32), layers_per_block=1, norm_num_groups=4,
           latent_channels=16)
N_FRAMES, SEQ, LAT_HW, C_LAT = 30, 8, (4, 6), 16


def randomize(params, seed):
    """Every leaf -> seeded random f32: norm scales ~1, kernels ~N(0, 1/fan_in)
    (a 5-D conv kernel [kt, kh, kw, I, O] fans in over all but its last axis)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("scale", "norm_scale"):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name in ("kernel", "linear_kernel"):
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 5 else shape[-2]
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            v = 0.2 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


def write_dataset(root: Path, seed: int = 0, n_episodes: int = 2, split: str = "test"):
    """The eval configs' on-disk layout, from a numpy seed: annotation JSON,
    moments for every 9-frame slice start (latents, image latents, depth and
    label), prompt embeds, raw 32x48 frames as an mp4 (OpenCV) and a
    render.npz of depths and semantic labels per episode."""
    rng = np.random.default_rng(seed)
    emb = root / "embeddings_full" / split
    for d in ("latents", "image_latents", "depth_latents", "label_latents", "prompt_embeds"):
        (emb / d).mkdir(parents=True, exist_ok=True)
    (root / "annotations" / split).mkdir(parents=True, exist_ok=True)
    (root / "videos").mkdir(exist_ok=True)
    H, W = (8 * n for n in LAT_HW)
    F_lat = SEQ // 4 + 1
    for ep in range(n_episodes):
        eid = f"{ep:05d}"
        ann = dict(episode_id=eid, texts=[f"pick object {ep}"],
                   videos=[{"video_path": f"videos/{eid}.mp4"}],
                   state=rng.uniform(-1, 1, (N_FRAMES, 7)).tolist(),
                   continuous_gripper_state=rng.uniform(0, 1, N_FRAMES).tolist())
        (root / "annotations" / split / f"{eid}.json").write_text(json.dumps(ann))
        for start in range(N_FRAMES - SEQ):
            name = f"{eid}_{start:02d}_{SEQ + 1:02d}"
            for kind, f in (("latents", F_lat), ("image_latents", 1),
                            ("depth_latents", F_lat), ("label_latents", F_lat)):
                np.savez(emb / kind / f"{name}.npz",
                         rng.normal(size=(2 * C_LAT, f, *LAT_HW)).astype(np.float32))
        # smooth frames (codec-friendly): a moving gradient plus noise
        t = np.arange(N_FRAMES)[:, None, None, None]
        yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        base = 128 + 60 * np.sin(0.2 * xx[None, :, :, None] + 0.15 * t + ep
                                 + np.arange(3)[None, None, None, :])
        frames = np.clip(base + 40 * np.cos(0.25 * yy)[None, :, :, None]
                         + rng.normal(0, 4, (N_FRAMES, H, W, 3)), 0, 255).astype(np.uint8)
        assert tvideo.write_video(str(root / "videos" / f"{eid}.mp4"), frames, fps=8).endswith(
            ".mp4")
        (root / eid).mkdir(exist_ok=True)
        np.savez(root / eid / "render.npz",
                 depths=rng.uniform(0.0, 0.5, (N_FRAMES, 1, H, W)).astype(np.float32),
                 semantics=rng.integers(0, 60, (N_FRAMES, 1, H, W)).astype(np.int32),
                 is_labeled=np.ones(1, bool))
    np.savez(emb / "prompt_embeds" / "empty.npz", rng.normal(size=(8, 32)).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("serving_data"))


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_copy_is_byte_equal(name):
    assert filecmp.cmp(JAX_CFG / name, PORT_CFG / name, shallow=False)


def test_config_copy_holds_every_file():
    assert sorted(str(p.relative_to(PORT_CFG)) for p in PORT_CFG.rglob("*")
                  if p.is_file()) == CONFIG_FILES


@pytest.mark.parametrize("name", EVAL_FILES)
def test_load_config_matches_jax(name):
    kw = dict(dataset_type="bridgev2", debug_yaml="debug.yaml",
              overrides=["evaluation.num_inference_steps=4", "train.learning_rate=1e-5",
                         "dataset.video_size=[32, 48]", "evaluation.mesh.sp=2"])
    for base in ("base_eval.yaml", "base_train.yaml"):
        args = lambda d: (str(d / base), str(d / name))
        want = jconfigs.load_config(*args(JAX_CFG), kw["dataset_type"],
                                    str(JAX_CFG / kw["debug_yaml"]), kw["overrides"])
        got = tconfigs.load_config(*args(PORT_CFG), kw["dataset_type"],
                                   str(PORT_CFG / kw["debug_yaml"]), kw["overrides"])
        assert got == want and isinstance(got, tconfigs.Config)


def test_config_helpers_match_jax():
    base, over = {"a": {"b": 1, "c": [1, 2]}, "d": 2}, {"a": {"c": [3], "e": None}, "f": "x"}
    assert tconfigs.deep_merge(base, over) == jconfigs.deep_merge(base, over)
    items = ["x.y=1e-5", "x.z=[1, 2]", "w=null", "v=true", "u={'k': 3}", "s=text"]
    assert tconfigs.apply_dotted_overrides({}, items) == jconfigs.apply_dotted_overrides({}, items)
    cfg = tconfigs.Config({"a": {"b": {"c": 4}}})
    assert cfg.a.b.c == 4 and cfg.get_path("a.b.c") == 4 and cfg.get_path("a.x", 7) == 7
    assert tconfigs.default_config_dir() == PORT_CFG
    with pytest.raises(ValueError, match="key.path=value"):
        tconfigs.apply_dotted_overrides({}, ["novalue"])
    with pytest.raises(KeyError, match="dataset type"):
        tconfigs.load_config(str(PORT_CFG / "base_eval.yaml"), dataset_type="nope")


EVAL_CASES = [("eval/eval_traj_image_cond_2b_finetune.yaml", "bridgev2", []),
              ("eval/eval_traj_image_2b_finetune_cascaded.yaml", "bridgev2", []),
              ("eval/eval_traj_image_1.4b_scratch.yaml", "rt1", []),
              ("experiments/traj_image_5b_finetune.yaml", "droid", []),
              ("experiments/traj_image_depth_1.4b_finetune.yaml", "rt1",
               ["transformer.recon_action=true"])]


@pytest.mark.parametrize("name,dtype,over", EVAL_CASES)
def test_build_dit_config_matches_jax(name, dtype, over):
    load = lambda mod, d: mod.load_config(str(d / "base_eval.yaml"), str(d / name), dtype,
                                          overrides=over)
    want = jtrain.build_dit_config(load(jconfigs, JAX_CFG))
    got = ttrain.build_dit_config(load(tconfigs, PORT_CFG))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_build_dit_config_refuses_unknown_keys():
    cfg = tconfigs.load_config(str(PORT_CFG / "base_eval.yaml"),
                               overrides=["transformer.not_a_field=1"])
    with pytest.raises(ValueError, match="not_a_field"):
        ttrain.build_dit_config(cfg)


def _eval_cfg(mod, d, data_root, name="eval/eval_traj_image_cond_2b_finetune.yaml", over=()):
    return mod.load_config(str(d / "base_eval.yaml"), str(d / name), "bridgev2", overrides=[
        f"dataset.data_root={data_root}", f"dataset.sequence_length={SEQ}",
        "dataset.start_frame_interval=8", "dataset.video_size=[32, 48]",
        "dataset.ori_size=[32, 48]", *over])


@pytest.mark.parametrize("cascaded", [False, True])
@pytest.mark.parametrize("raw", [False, True])
def test_build_dataset_items_match_jax(data_root, cascaded, raw):
    """Every item of RobotDataset / CascadedRobotDataset as the eval config
    builds it, pre-encoded moments or raw frames (OpenCV resize on both
    sides), and their collated batch."""
    over = ["dataset.load_tensors=false"] if raw else []
    jds = jtrain.build_dataset(_eval_cfg(jconfigs, JAX_CFG, data_root, over=over), "test",
                               cascaded)
    tds = ttrain.build_dataset(_eval_cfg(tconfigs, PORT_CFG, data_root, over=over), "test",
                               cascaded)
    assert type(tds).__name__ == type(jds).__name__
    assert tds.samples == jds.samples and len(tds) == len(jds) > 2
    for i in range(len(tds)):
        _assert_items_equal(tds[i], jds[i])
    _assert_items_equal(tdataset.collate_control([tds[0], tds[1]]),
                        jdataset.collate_control([jds[0], jds[1]]))


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_dataset_config_and_ref_images_match_jax(data_root):
    """DatasetConfig's helpers, multi-ref image latents cut from the video
    moments, and the random slice subset."""
    kw = dict(data_root=str(data_root), split="test", sequence_length=SEQ,
              start_frame_interval={"test": 4}, ref_num=5, num_samples=3, seed=7)
    jds, tds = jdataset.RobotDataset(jdataset.DatasetConfig(**kw)), tdataset.RobotDataset(
        tdataset.DatasetConfig(**kw))
    assert tds.config.start_interval() == 4 and tds.config.ref_num_choices() == [5]
    assert tds.samples == jds.samples and len(tds) == 3
    for i in range(3):
        _assert_items_equal(tds[i], jds[i])
        assert tds[i]["image_latents"].shape[1] == 2


def test_demo_dataset_matches_jax(tmp_path):
    """Folder-per-episode demo frames (png), read by imageio or Pillow."""
    from PIL import Image

    rng = np.random.default_rng(3)
    ep = tmp_path / "demo_ep"
    (ep / "rgb").mkdir(parents=True)
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)).save(
            ep / "rgb" / f"{i:03d}.png")
    (ep / "annotations.json").write_text(json.dumps(dict(
        texts=["wave"], state=rng.uniform(-1, 1, (10, 7)).tolist(),
        continuous_gripper_state=rng.uniform(0, 1, 10).tolist())))
    kw = dict(data_root=str(tmp_path), sequence_length=8, start_frame_interval=10**6,
              load_video=True, video_size=(32, 48), ori_size=(32, 48))
    jds = jdataset.DemoRobotDataset(jdataset.DatasetConfig(**kw))
    tds = tdataset.DemoRobotDataset(tdataset.DatasetConfig(**kw))
    assert tds.samples == jds.samples and len(tds) == 1
    _assert_items_equal(tds[0], jds[0])


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (3, 30, 50, 3), dtype=np.uint8)
    for ori, size in (((30, 50), (16, 24)), ((30, 50), (40, 40)), (None, (32, 48))):
        np.testing.assert_array_equal(tdataset.video_transform(frames, ori, size),
                                      jdataset.video_transform(frames, ori, size))
    depth = rng.uniform(0, 1, (3, 36, 60)).astype(np.float32)
    np.testing.assert_array_equal(tdataset.cond_transform(depth, (30, 50), (16, 24)),
                                  jdataset.cond_transform(depth, (30, 50), (16, 24)))
    sem = rng.integers(0, 80, (2, 8, 8))
    np.testing.assert_array_equal(tdataset.apply_semantic_colormap(sem),
                                  jdataset.apply_semantic_colormap(sem))
    assert tdataset.generate_colors(12) == jdataset.generate_colors(12)
    assert tdataset.aspect_resize_hw((30, 50), (16, 24)) == jdataset.aspect_resize_hw(
        (30, 50), (16, 24))


@pytest.mark.parametrize("accumulate", [False, True])
def test_relative_actions_match_jax(accumulate):
    rng = np.random.default_rng(5)
    states, grip = rng.uniform(-3, 3, (20, 6)), rng.uniform(0, 1, 20)
    states[3, 4] = np.pi / 2  # a gimbal-lock pose
    np.testing.assert_allclose(trotation.relative_actions(states, grip, accumulate),
                               jrotation.relative_actions(states, grip, accumulate),
                               atol=1e-12, rtol=0)
    e = rng.uniform(-3, 3, (50, 3))
    np.testing.assert_allclose(trotation.rotm2euler(trotation.euler2rotm(e)),
                               jrotation.rotm2euler(jrotation.euler2rotm(e)), atol=1e-12, rtol=0)


# -- video IO ------------------------------------------------------------------

def test_video_io_round_trip(tmp_path):
    """mp4 and gif written and read back: the gif is lossless, the mp4
    within the codec's error of smooth frames."""
    t = np.arange(9)[:, None, None, None]
    frames = (128 + 100 * np.sin(0.2 * np.arange(48)[None, None, :, None] + 0.3 * t)
              * np.ones((9, 32, 48, 3))).astype(np.uint8)
    mp4 = tvideo.write_video(str(tmp_path / "clip.mp4"), frames)
    gif = tvideo.write_gif(str(tmp_path / "clip.mp4"), frames)
    assert mp4.endswith(".mp4") and gif.endswith(".gif")
    back = tvideo.read_video(mp4)
    assert back.shape == frames.shape and back.dtype == np.uint8
    assert np.abs(back.astype(int) - frames).mean() < 8
    np.testing.assert_array_equal(tvideo.read_video(mp4, [2, 0]), back[[2, 0]])
    np.testing.assert_array_equal(tvideo.read_video(gif)[..., :3], frames)


# -- safetensors and the weight bridge -----------------------------------------

def test_safetensors_reader_matches_safetensors(tmp_path):
    import ml_dtypes
    from safetensors import safe_open
    from safetensors.numpy import save_file

    rng = np.random.default_rng(6)
    sd = {"f32": rng.standard_normal((3, 4)).astype(np.float32),
          "f16": rng.standard_normal(5).astype(np.float16),
          "bf16": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
          "i8": rng.integers(-128, 128, (2, 3)).astype(np.int8),
          "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
          "i64": rng.integers(0, 1 << 40, (4,)).astype(np.int64),
          "empty": np.zeros((0, 3), np.float32), "scalar": np.array(3.0, np.float32)}
    path = tmp_path / "w.safetensors"
    save_file(sd, str(path), metadata={"format": "pt"})
    got = read_safetensors(path)
    assert sorted(got) == sorted(sd)
    with safe_open(str(path), framework="np") as f:
        for k in f.keys():
            want, g = f.get_tensor(k), got[k]
            if k == "bf16":
                assert g.dtype == torch.bfloat16
                g, want = g.view(torch.int16), want.view(np.int16)
            assert tuple(g.shape) == want.shape and np.array_equal(g.numpy(), want), k


def _jax_vae(seed=2):
    jv = JaxCausalVAE(JaxVAEConfig(**VAE), dtype=jnp.float32)
    params = randomize(jax.eval_shape(lambda: jv.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 1, 16, 16)))), seed)
    return jv, params


def _torch_state(params):
    """A JAX VAE tree as the torch state dict diffusers would hold: the JAX
    converter's inverse, checked by converting back."""
    from orv_tpu.models.weights import convert_vae_state_dict

    sd = {k: v.numpy() for k, v in vae_params_from_jax(params, VAEConfig(**VAE)).items()}
    back = convert_vae_state_dict(sd, JaxVAEConfig(**VAE))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    return sd


def test_vae_bridge_and_diffusers_folder(tmp_path):
    """vae_params_from_jax covers encoder and decoder (the JAX converter
    reads its output back to the same tree), and a diffusers folder of it,
    one file or sharded with an index, loads strictly."""
    from safetensors.numpy import save_file

    _, params = _jax_vae()
    sd = _torch_state(params)
    assert any(k.startswith("encoder.down_blocks.0.downsamplers.0.conv") for k in sd)
    one, sharded = tmp_path / "one", tmp_path / "sharded"
    one.mkdir(), sharded.mkdir()
    (one / "config.json").write_text(json.dumps({"latent_channels": 16}))
    save_file(sd, str(one / "diffusion_pytorch_model.safetensors"))
    keys = sorted(sd)
    shards = {"part-1.safetensors": keys[::2], "part-2.safetensors": keys[1::2]}
    for fname, ks in shards.items():
        save_file({k: sd[k] for k in ks}, str(sharded / fname))
    (sharded / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    for folder in (one, sharded):
        cfg, got = load_diffusers_folder(folder)
        assert cfg == ({"latent_channels": 16} if folder == one else {})
        vae = CausalVAE(VAEConfig(**VAE), dtype=torch.float32, device="cpu")
        vae.load_state_dict(got, strict=True)
        for k, v in vae.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k])
    del sd[keys[0]]
    save_file(sd, str(one / "diffusion_pytorch_model.safetensors"))
    with pytest.raises(RuntimeError, match="Missing key"):
        CausalVAE(VAEConfig(**VAE), dtype=torch.float32, device="cpu").load_state_dict(
            load_diffusers_folder(one)[1], strict=True)


# -- the VAE encode --------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_pair():
    jv, params = _jax_vae()
    tv = CausalVAE(VAEConfig(**VAE), dtype=torch.float32, device="cpu")
    tv.load_state_dict(vae_params_from_jax(params, VAEConfig(**VAE)))
    return jv, params, tv


@pytest.mark.parametrize("T", [1, 9, 17])
def test_encode_matches_jax(vae_pair, T):
    """One-shot `encode` (the encoder's odd-T first-frame rule) and
    `encode_auto` (one-shot up to 9 frames, chunked past) in f32."""
    jv, params, tv = vae_pair
    x = 0.5 * np.random.default_rng(T).standard_normal((1, 3, T, 32, 48)).astype(np.float32)
    want = np.asarray(jax_encode_auto(jv, params, jnp.asarray(x)))
    got = encode_auto(tv, torch.tensor(x), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == (1, 32, (T - 1) // 4 + 1, 4, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    one = np.asarray(jax.jit(lambda p, v: jv.apply(p, v, method=jv.encode))(params, x))
    with torch.inference_mode():
        np.testing.assert_allclose(tv.encode(torch.tensor(x)).numpy(), one, atol=1e-4, rtol=0)
    tv.clear_cache()
    assert all(m.conv_cache is None for m in tv.modules() if hasattr(m, "conv_cache"))


@pytest.mark.parametrize("T,chunk", [(9, 4), (17, 8)])
def test_encode_chunked_matches_jax(vae_pair, T, chunk):
    """Chunks [1, k, k, ...]: the conv caches carry across chunks, later
    chunks average frame pairs, GroupNorm statistics are per chunk."""
    jv, params, tv = vae_pair
    x = 0.5 * np.random.default_rng(T + chunk).standard_normal(
        (2, 3, T, 32, 48)).astype(np.float32)
    want = np.asarray(jax_encode_chunked(jv, params, jnp.asarray(x), chunk_frames=chunk))
    got = encode_chunked(tv, torch.tensor(x), chunk_frames=chunk, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    one = encode_auto(tv, torch.tensor(x), chunk_frames=T, device="cpu")  # one-shot
    assert not torch.allclose(got, one, atol=1e-4)  # the chunking is not the one-shot


def test_encode_bf16_matches_jax(vae_pair):
    jv0, params, _ = vae_pair
    jv = JaxCausalVAE(JaxVAEConfig(**VAE), dtype=jnp.bfloat16)
    tv = CausalVAE(VAEConfig(**VAE), dtype=torch.bfloat16, device="cpu")
    tv.load_state_dict(vae_params_from_jax(params, VAEConfig(**VAE)))
    x = 0.5 * np.random.default_rng(9).standard_normal((1, 3, 17, 32, 48)).astype(np.float32)
    want = np.asarray(jax_encode_auto(jv, params, jnp.asarray(x)))
    got = encode_auto(tv, torch.tensor(x), device="cpu").numpy()
    err, rng = np.abs(got - want), np.abs(want).max()
    assert err.max() <= 2e-2 * rng and err.mean() <= 3e-3 * rng, (err.max(), err.mean(), rng)


@pytest.mark.parametrize("shape,hw", [((9, 40, 60, 3), (32, 48)), ((2, 3, 3, 32, 48), (32, 48)),
                                      ((1, 3, 20, 30), (32, 48)), ((2, 16, 3, 4, 6), None)])
def test_preprocess_video_matches_jax(shape, hw):
    """Channels-last uint8 frames shrunk (antialiased), [-1, 1] tensors kept,
    [0, 1] stills grown and normalized, latents passed through."""
    rng = np.random.default_rng(len(shape))
    x = (rng.integers(0, 256, shape, dtype=np.uint8) if shape[-1] == 3
         else rng.uniform(-1 if shape[0] == 2 else 0, 1, shape).astype(np.float32))
    h, w = hw or (None, None)
    want = np.asarray(jsample.preprocess_video(jnp.asarray(x), h, w))
    got = tsample.preprocess_video(torch.tensor(x), h, w).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_encode_reference_pixels_matches_jax(vae_pair):
    jv, params, tv = vae_pair
    frames = np.random.default_rng(8).integers(0, 256, (1, 40, 60, 3), dtype=np.uint8)
    want = jsample.encode_reference_pixels(
        jax.jit(lambda p, x: jv.apply(p, x, method=jv.encode)), params, jnp.asarray(frames), 32,
        48)
    got = tsample.encode_reference_pixels(lambda x: encode_auto(tv, x, device="cpu"),
                                          torch.tensor(frames), 32, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# -- metrics ---------------------------------------------------------------------

def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(10)
    gt = rng.uniform(0, 1, (3, 40, 56, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    for a, b in ((pred[0], gt[0]), (pred[1, ..., 0], gt[1, ..., 0])):
        np.testing.assert_allclose(tmetrics.psnr(a, b), jmetrics.psnr(a, b), rtol=1e-6)
        np.testing.assert_allclose(tmetrics.ssim(a, b), jmetrics.ssim(a, b), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.video_psnr_ssim(pred, gt),
                               jmetrics.video_psnr_ssim(pred, gt), rtol=1e-6)
    assert tmetrics.psnr(gt, gt) == float("inf")
    np.testing.assert_array_equal(tmetrics.center_crop_resize(gt, 24),
                                  jmetrics.center_crop_resize(gt, 24))


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(11)
    real, fake = rng.standard_normal((40, 6)), rng.standard_normal((40, 6)) + 0.3
    np.testing.assert_allclose(tmetrics.fid_from_features(real, fake),
                               jmetrics.fid_from_features(real, fake), rtol=1e-9)
    feats = lambda x: np.asarray(x).reshape(len(x), -1)[:, :6].astype(np.float64)
    videos = [rng.uniform(0, 1, (17, 8, 8, 3)) for _ in range(8)]
    np.testing.assert_allclose(tmetrics.compute_fid(videos[:4], videos[4:], feats),
                               jmetrics.compute_fid(videos[:4], videos[4:], feats), rtol=1e-9)
    with pytest.raises(RuntimeError, match="feature extractor"):
        tmetrics.compute_fid(videos[:4], videos[4:])
    with pytest.raises(RuntimeError, match="feature extractor"):
        tmetrics.compute_fvd(videos[:4], videos[4:])


def test_metrics_main_writes_the_csv(tmp_path):
    """The CLI over mp4 pairs: both packages pair the same files and write
    the same CSV; with `--i3d_weights` (a folder) the port adds FVD (FID and
    FVD are held against JAX's in tests/test_torch_port_offline.py), and it
    refuses a weights file by name."""
    rng = np.random.default_rng(12)
    for d in ("gt", "pred"):
        (tmp_path / d).mkdir()
    frames = rng.integers(60, 200, (5, 32, 48, 3), dtype=np.uint8)
    for name in ("a", "b"):
        tvideo.write_video(str(tmp_path / "gt" / f"{name}.mp4"), frames)
        tvideo.write_video(str(tmp_path / "pred" / f"{name}.mp4"), frames // 2 + 40)
    tvideo.write_video(str(tmp_path / "pred" / "unpaired.mp4"), frames)
    args = lambda out: ["--gt_dir", str(tmp_path / "gt"), "--pred_dir", str(tmp_path / "pred"),
                        "--output_csv", str(tmp_path / out)]
    assert tmetrics.pair_files(tmp_path / "gt", tmp_path / "pred") == jmetrics.pair_files(
        tmp_path / "gt", tmp_path / "pred")
    tmetrics.main(args("port.csv"))
    jmetrics.main(args("jax.csv"))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    from test_torch_port_feature_extractors import write_feature_weights

    _, i3d = write_feature_weights(tmp_path / "weights")
    summary = tmetrics.main(args("fvd.csv") + ["--i3d_weights", str(i3d), "--device", "cpu"])
    assert np.isfinite(summary["fvd_5"])  # the clips' 5 frames: FVD at their one length
    assert (tmp_path / "fvd.csv").read_text().splitlines()[0] == "name,psnr,ssim,fvd_5"
    with pytest.raises(ValueError, match="w.pt is not a folder"):
        tmetrics.main(args("x.csv") + ["--inception_weights", str(tmp_path / "w.pt"),
                                       "--device", "cpu"])


def test_yaml_reader_is_pyyaml():
    """The port reads its config files with PyYAML's safe loader, as the JAX
    package does (the card has PyYAML), so no reader of its own is needed."""
    for name in CONFIG_FILES:
        assert tconfigs._read_yaml(str(PORT_CFG / name)) == (
            yaml.safe_load((JAX_CFG / name).read_text()) or {})
