"""The serving entry points on the rest of the DiT's surface, against
orv_tpu's, on the CPU.

`MultiViewRobotDataset` (seeded view sampling, `view_data_ratio`, the
collate's `num_views`), multiview `evaluate` (bf16 and W8A8, views stacked
on the frame axis, image latents padded per view), RoPE and PAB through
`evaluate` and `generate_video`, and the cascaded rollout in f32 compute at
2 and 4 DDIM steps a chunk, against the JAX functions on the same files
(written from a numpy seed), the same weights and the same draws, as
tests/test_torch_port_serving.py holds the single-view entry points.

Tolerances: the latents to 2e-2 of their range at most and 3e-3 of it on
average (W8A8 4e-2 and 3e-3), as tests/test_torch_port_serving.py; dataset
items and collated batches equal. The RoPE model (one 16-wide head, whose
bf16 outputs span 25-30: 3.0e-2 of the range at most against JAX in bf16)
and the cascade run the DiT in f32 in both packages (`f32_compute`), held
to 1e-3 of the range at most and 1e-4 on average: both packages round the
sampler's model inputs (latents, image latents, prompt, actions) to bf16
in f32 compute too, so an f32 difference that lands on a bf16 rounding
boundary moves an input by one bf16 step. Measured: RoPE 6.0e-7 and
5.1e-8 of the range.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu import configs as jconfigs
from orv_tpu.data import dataset as jdataset
from orv_tpu.models import ControlDiT as JaxControlDiT
from orv_tpu.models import DiTConfig as JaxDiTConfig
from orv_tpu.models.weights import export_torch_pretrained
from orv_tpu.pipelines import evaluate as jevaluate
from orv_tpu.pipelines import inference as jinference
from orv_tpu.utils.checkpoint import export_pretrained
from orv_tpu_torch import configs as tconfigs
from orv_tpu_torch.data import dataset as tdataset
from orv_tpu_torch.models import ControlDiT, DiTConfig
from orv_tpu_torch.parallel import EvalDraws
from orv_tpu_torch.pipelines import evaluate as tevaluate
from orv_tpu_torch.pipelines import inference as tinference
from orv_tpu_torch.utils.checkpoint import load_pretrained

from test_torch_port_serving import (CASCADED, COND, DIT, JAX_CFG, PORT_CFG, _chunk_counts,
                                     assert_latents_close, compare_outputs, configs, jax_draws,
                                     port_vae, run_both, setup)  # noqa: F401 (fixture)
from test_torch_port_serving_data import LAT_HW, SEQ, _assert_items_equal, randomize, write_dataset
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

MULTIVIEW = "eval/eval_traj_image_2b_multiview.yaml"
V = 2


def add_views(root, n_views: int = V, single_view=(), seed: int = 5, split: str = "test"):
    """Turn `write_dataset`'s layout into a multiview one: every latents and
    image-latents file `X.npz` is view 0 (the dataset falls back to the
    unsuffixed name), `X_{v}.npz` is view v, from a numpy seed; the
    episodes in `single_view` mark their views past 0 absent
    (`has_image_{v}: false`)."""
    rng = np.random.default_rng(seed)
    emb = root / "embeddings_full" / split
    for kind in ("latents", "image_latents"):
        for f in sorted((emb / kind).glob("*.npz")):
            shape = np.load(f)["arr_0"].shape
            for v in range(1, n_views):
                np.savez(f.with_name(f"{f.stem}_{v}.npz"),
                         rng.normal(size=shape).astype(np.float32))
    for eid in single_view:
        ann_file = root / "annotations" / split / f"{eid}.json"
        ann = json.loads(ann_file.read_text())
        ann.update({f"has_image_{v}": False for v in range(1, n_views)})
        ann_file.write_text(json.dumps(ann))
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_multiview_dataset_matches_jax(tmp_path, split):
    """Samples, the seeded view sampling (train), the single-view share cut
    to `view_data_ratio` (two of three episodes single-view: 0.67 > 0.4),
    every item and a collated batch of two."""
    root = add_views(write_dataset(tmp_path, seed=6, n_episodes=3, split=split),
                     single_view=("00001", "00002"), split=split)
    kw = dict(data_root=str(root), split=split, sequence_length=SEQ, sample_size=LAT_HW,
              start_frame_interval={split: 4}, max_n_view=V, n_view=V, seed=3)
    jds = jdataset.MultiViewRobotDataset(jdataset.DatasetConfig(**kw))
    tds = tdataset.MultiViewRobotDataset(tdataset.DatasetConfig(**kw))
    assert tds.samples == jds.samples and len(tds) == len(jds) > 4
    n_views = [s["n_view"] for s in tds.samples]
    assert set(n_views) == {1, 2}
    if split == "train":  # 6 slices an episode: single-view cut from 12 to 0.4 x 18
        assert (n_views.count(1), n_views.count(2)) == (7, 6)
        assert {s["n_view_use"] for s in tds.samples} == {1, 2}
    for i in range(len(tds)):
        _assert_items_equal(tds[i], jds[i])
    two = [i for i, s in enumerate(tds.samples) if s["n_view_use"] == 2][:2]
    batch = tdataset.collate_control([tds[i] for i in two])
    _assert_items_equal(batch, jdataset.collate_control([jds[i] for i in two]))
    assert batch["num_views"] == 2 and batch["latents"].shape[2] == 2 * (SEQ // 4 + 1)


@pytest.fixture(scope="module")
def mv_setup(tmp_path_factory):
    """Two episodes of two views from a numpy seed, and a seeded random
    multiview DiT (MVBlocks included) exported as the JAX package's flax
    folder and as a diffusers folder."""
    root = tmp_path_factory.mktemp("mv_serving")
    data = add_views(write_dataset(root / "data"))
    cfg = JaxDiTConfig(**dict(DIT, visual_guidance=False, multiview=True, max_n_view=V))
    F = SEQ // 4 + 1
    x = np.zeros((1, V * F, 32, *LAT_HW), np.float32)
    params = randomize(jax.eval_shape(lambda: JaxControlDiT(cfg, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(0), x, np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
        actions=np.zeros((1, SEQ, 7), np.float32), num_views=V)), seed=4)
    assert "mv_block" in params["params"]["blocks"]
    folder = root / "dit"
    export_pretrained(str(folder), params, cfg)
    export_torch_pretrained(str(folder), params, cfg)
    return dict(root=root, data=data, folder=folder)


def mv_configs(s, tag, extra=()):
    keys = ("num_attention_heads", "attention_head_dim", "num_layers", "text_embed_dim",
            "time_embed_dim", "max_text_seq_length")
    over = [f"dataset.data_root={s['data']}", "dataset.sequence_length=8",
            "dataset.start_frame_interval=8", f"dataset.max_n_view={V}",
            *(f"transformer.{k}={DIT[k]}" for k in keys),
            f"transformer.pretrained_name_or_path={s['folder']}",
            "evaluation.num_inference_steps=2", "evaluation.scheduler=ddim",
            "evaluation.batch_size=2", *extra]
    load = lambda mod, d, side: mod.load_config(
        str(d / "base_eval.yaml"), str(d / MULTIVIEW), "bridgev2",
        overrides=over + [f"evaluation.output_dir={s['root'] / f'{tag}_{side}'}"])
    return load(jconfigs, JAX_CFG, "jax"), load(tconfigs, PORT_CFG, "port")


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w8a8"])
def test_evaluate_multiview_matches_jax(mv_setup, quant):
    """The multiview eval config: MultiViewRobotDataset, V = 2 views stacked
    on the frame axis of the latents, image latents padded per view, the
    views' shared text, timestep and actions, MVBlocks; W8A8 quantizes the
    MVBlocks' attention projections too."""
    s = mv_setup
    jcfg, tcfg = mv_configs(s, f"mv_{quant}", ["evaluation.quant=true"] if quant else [])
    assert tevaluate.build_dit_config(tcfg).multiview
    jdir, tdir = run_both(s, jcfg, tcfg, False, jax_draws(), max_batches=1)
    names = compare_outputs(s, jdir, tdir, *((4e-2, 3e-3) if quant else (2e-2, 3e-3)))
    assert sum(n.endswith("_latents.npz") for n in names) == 2
    F = SEQ // 4 + 1
    assert np.load(tdir / "00000_008_latents.npz")["arr_0"].shape == (V * F, 16, *LAT_HW)


# the RoPE tables split a head 1/4 (t) + 3/8 (h) + 3/8 (w) over pairs: its
# width must be a multiple of 16, so the RoPE model has one head of 16
ROPE_DIT = dict(DIT, num_attention_heads=1, attention_head_dim=16,
                use_rotary_positional_embeddings=True)


@pytest.fixture(scope="module")
def rope_setup(setup):
    """The single-view serving setup with a seeded random RoPE model of
    one 16-wide head, exported as both packages read it."""
    cfg = JaxDiTConfig(**ROPE_DIT)
    x = np.zeros((1, SEQ // 4 + 1, 32, *LAT_HW), np.float32)
    params = randomize(jax.eval_shape(lambda: JaxControlDiT(cfg, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(0), x, np.zeros((1, 8, 32), np.float32), np.zeros((1,), np.int32),
        actions=np.zeros((1, SEQ, 7), np.float32), depths=x, labels=x)), seed=7)
    folder = setup["root"] / "rope_dit"
    export_pretrained(str(folder), params, cfg)
    export_torch_pretrained(str(folder), params, cfg)
    return dict(setup, params=params, folder=folder)


ROPE = ["transformer.num_attention_heads=1", "transformer.attention_head_dim=16",
        "transformer.use_rotary_positional_embeddings=true"]
PAB = ["evaluation.pab_skip=1", "evaluation.num_inference_steps=4"]


def f32_compute(monkeypatch):
    """Both packages' `evaluate` build their DiT computing in f32."""
    monkeypatch.setattr(jevaluate, "ControlDiT", lambda cfg, dtype=None, **kw: JaxControlDiT(
        cfg, dtype=jnp.float32, **kw))
    monkeypatch.setattr(tevaluate, "ControlDiT", lambda cfg, dtype=None, **kw: ControlDiT(
        cfg, dtype=torch.float32, **kw))


@pytest.mark.parametrize("extra", [ROPE, PAB, PAB + ["evaluation.quant=true"], ROPE + PAB],
                         ids=["rope_f32", "pab", "pab_w8a8", "rope_pab_f32"])
def test_evaluate_rope_and_pab_match_jax(rope_setup, setup, extra, request, monkeypatch):
    """The batch path with a RoPE model (its tables built for the clip's
    latent frames, f32 compute) and with PAB (4 DDIM steps, pab_skip=1:
    flags T T F T, bf16 and W8A8)."""
    rope = ROPE[0] in extra
    s = rope_setup if rope else setup
    extra = [*extra, f"transformer.pretrained_name_or_path={s['folder']}"]
    if rope:
        f32_compute(monkeypatch)
    jcfg, tcfg = configs(s, COND, f"surface_{request.node.callspec.id}",
                         ["evaluation.mode=traj-image-depth-label", *extra])
    jdir, tdir = run_both(s, jcfg, tcfg, False, jax_draws(), max_batches=1)
    bound = {True: (1e-3, 1e-4), False: (2e-2, 3e-3)}[rope]
    compare_outputs(s, jdir, tdir, *((4e-2, 3e-3) if "evaluation.quant=true" in extra
                                     else bound))


def test_generate_video_rope_and_pab_match_jax(rope_setup):
    """generate_video of a RoPE model with pab_skip=1 (one DPM step, whose
    flag is full: the collect path runs), against JAX's."""
    s = rope_setup
    rng = np.random.default_rng(20)
    ref = rng.uniform(-1, 1, (32, 48, 3)).astype(np.float32)
    actions = (0.3 * rng.standard_normal((8, 7))).astype(np.float32)
    prompt = rng.standard_normal((8, 32)).astype(np.float32)
    kw = dict(num_frames=9, num_inference_steps=1, seed=3, pab_skip=1)
    want = jinference.generate_video(JaxDiTConfig(**ROPE_DIT), s["params"], s["jvae"],
                                     s["vparams"], ref, actions, prompt, **kw)
    cfg, sd = load_pretrained(s["folder"], DiTConfig)
    assert cfg == DiTConfig(**ROPE_DIT)
    model = ControlDiT(cfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(sd, strict=True)
    r_noise, _ = jax.random.split(jax.random.PRNGKey(3))
    draws = EvalDraws(noise=torch.tensor(np.asarray(jax.random.normal(r_noise, (1, 3, 16, 4, 6)))))
    got = tinference.generate_video(model, port_vae(s), ref, actions, prompt, draws=draws,
                                    device="cpu", **kw)
    assert got.shape == want.shape == (3, 9, 32, 48)
    assert_latents_close(got, np.asarray(want))


@pytest.mark.parametrize("steps", [2, 4])
def test_cascaded_rollout_in_f32_matches_jax(setup, steps, monkeypatch):
    """The cascade's drift (bf16: 5.2% of the range at the fourth chained
    chunk with two DDIM steps a chunk) is bf16 compounding, not a
    divergence: with the DiT computing in f32 in both packages, 2 and 4
    DDIM steps a chunk over 4 chained chunks agree to f32 level."""
    s = setup
    f32_compute(monkeypatch)
    jcfg, tcfg = configs(s, CASCADED, f"cascaded_f32_{steps}",
                         [f"evaluation.num_inference_steps={steps}", "dataset.load_tensors=true"])
    counts = _chunk_counts(jcfg)
    assert counts == [4, 4]
    jdir, tdir = run_both(s, jcfg, tcfg, False, jax_draws(chunks=counts))
    compare_outputs(s, jdir, tdir, 1e-3, 1e-4)
