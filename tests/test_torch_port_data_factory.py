"""The port's data factory (orv_tpu_torch/pipelines/prepare_dataset.py)
against the JAX package's (orv_tpu/pipelines/prepare_dataset.py) on the same
seeded inputs, on the CPU (`device="cpu"`: the kernels' plain versions).

Equal bit for bit: the numpy geometry, the TSDF surface set, the voxel
label votes (ties included), the gaussians, the hash embedding, the label
post-process, the caption -> label map (k-means without scikit-learn) and
every file the eight actions write, but the render's depths (to 1e-5: the
rasterizer sums in another order; the share of pixels that differ is
reported). The stage pipeline's skip-if-exists, SIGTERM cleanup and
refusal of a stage it cannot send to a spawned worker are checked on the
port alone.
"""

import functools
import json
import multiprocessing as mp
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from orv_tpu.pipelines import prepare_dataset as jpd
from orv_tpu_torch.pipelines import prepare_dataset as tpd
from test_prepare_dataset import _make_episode
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)


def _frames(seed: int, F: int = 3, H: int = 24, W: int = 32):
    """Depth maps of a plane and a moving box, poses that move, K."""
    rng = np.random.default_rng(seed)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    depths, poses = [], []
    for f in range(F):
        d = np.full((H, W), 0.3, np.float32) + rng.uniform(-0.01, 0.01, (H, W)).astype(np.float32)
        d[8:16, 10 + f:18 + f] = 0.15
        d[0, 0] = 0.0  # a hole
        depths.append(d)
        p = np.eye(4)
        p[:3, 3] = rng.uniform(-0.01, 0.01, 3)
        poses.append(p)
    return depths, np.stack(poses), K


@pytest.mark.parametrize("seed", [0, 1])
def test_tsdf_surface_set_equals_jax(seed):
    depths, poses, K = _frames(seed)
    want = jpd.tsdf_fuse(depths, poses, K)
    got = tpd.tsdf_fuse(depths, poses, K, device="cpu")
    assert len(want) > 50
    np.testing.assert_array_equal(got, want)


def test_host_geometry_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(0, 0.01, (400, 3)), rng.normal(0, 1.0, (6, 3)) + 3.0])
    np.testing.assert_array_equal(tpd.statistical_outlier_removal(pts, k=8),
                                  jpd.statistical_outlier_removal(pts, k=8))
    mono, metric = rng.uniform(0.5, 2, (16, 16)), rng.uniform(0.5, 2, (16, 16))
    mask = rng.uniform(size=(16, 16)) > 0.3
    assert tpd.align_depth_scale(mono, metric, mask) == jpd.align_depth_scale(mono, metric, mask)
    for a, b in zip(tpd.compute_scale_and_shift(mono[None], metric[None], mask[None]),
                    jpd.compute_scale_and_shift(mono[None], metric[None], mask[None])):
        np.testing.assert_array_equal(a, b)
    E = rng.normal(size=(3, 3, 4))
    np.testing.assert_array_equal(tpd.align_multiview_extrinsics(E, 1.7, 0.2),
                                  jpd.align_multiview_extrinsics(E, 1.7, 0.2))
    ep = _make_episode(tmp_path)
    a, b = tpd.depth_unproject_backend(str(ep)), jpd.depth_unproject_backend(str(ep))
    for x, y in zip(a["points"], b["points"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_points_to_voxels_votes_equal_jax_with_ties(seed):
    """Clusters of points in single voxels with tied label counts (the
    smallest label wins), spread clouds and points outside the volume."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-0.19, 0.19, (60, 3)) + [0, 0, 0.2]
    pts, labels = [], []
    for i, c in enumerate(centres):
        k = 1 + i % 6
        pts.append(np.floor(c * 1000) / 1000 + 0.0005 + rng.uniform(-2e-4, 2e-4, (k, 3)))
        labels.append(rng.integers(0, 5, k) if i % 3 else np.array([3, 1, 1, 3, 2, 2][:k]))
    pts.append(rng.uniform(-0.3, 0.5, (500, 3)))
    labels.append(rng.integers(0, 12, 500))
    pts, labels = np.concatenate(pts).astype(np.float32), np.concatenate(labels)
    for kw in ({}, {"max_points": 2, "max_voxels": 100}):
        want = jpd.points_to_voxels(pts, labels, **kw)
        got = tpd.points_to_voxels(pts, labels, device="cpu", **kw)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_occupancy_to_gaussians_bitwise():
    rng = np.random.default_rng(4)
    coors = rng.integers(0, 400, (2000, 3)).astype(np.int32)
    labels = rng.integers(0, 15, 2000).astype(np.int32)
    want = jpd.occupancy_to_gaussians(coors, labels)
    got = tpd.occupancy_to_gaussians(coors, labels, device="cpu")
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x.numpy(), y)


def test_render_episode_matches_jax():
    """The render on two views: depths to 1e-4 and semantic labels equal but
    on a bounded share of pixels (the top view's voxel centres share depths,
    which the C++'s std::sort leaves in no set order: a pixel can stop after
    other tied splats; tests/test_torch_port_native_ops.py bounds the same
    effect); both shares are reported."""
    rng = np.random.default_rng(5)
    plane = np.stack([rng.uniform(-0.15, 0.15, 3000), rng.uniform(-0.15, 0.15, 3000),
                      np.full(3000, 0.02)], 1)
    blob = rng.normal([0, 0, 0.12], 0.015, (1500, 3))
    pts = np.concatenate([plane, blob])
    labels = np.concatenate([np.zeros(3000), np.ones(1500)]).astype(int)
    occ = jpd.occupancy_from_frames([pts, pts + 0.003], [labels, labels])
    occ_t = tpd.occupancy_from_frames([pts, pts + 0.003], [labels, labels], device="cpu")
    for a, b in zip(occ, occ_t):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    c2w = np.eye(4)
    c2w[:3, 3] = [0, -0.2, 0.2]
    a = np.radians(-130)
    c2w[:3, :3] = [[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]]
    top = np.eye(4)
    top[:3, :3] = np.diag([1.0, -1.0, -1.0])
    top[2, 3] = 0.35
    K = np.array([[80.0, 0, 32], [0, 80.0, 24], [0, 0, 1]])
    want = jpd.render_episode(occ, [c2w, top], [K, K], (48, 64))
    got = tpd.render_episode(occ, [c2w, top], [K, K], (48, 64), device="cpu")
    assert got["semantics"].dtype == np.uint8 and got["depths"].dtype == np.float32
    np.testing.assert_array_equal(got["is_labeled"], want["is_labeled"])
    np.testing.assert_allclose(got["depths"], want["depths"], atol=1e-4, rtol=0)
    sem_off = float((got["semantics"] != want["semantics"]).mean())
    print(f"render: depths differ by more than 1e-5 on "
          f"{(np.abs(got['depths'] - want['depths']) > 1e-5).mean():.2%} of the pixels (max "
          f"{np.abs(got['depths'] - want['depths']).max():.3g}), semantic labels on {sem_off:.2%}")
    assert sem_off <= 0.01 and {0, 1, 11} <= set(np.unique(got["semantics"]).tolist())


@pytest.mark.parametrize("n,D,k,pca_dim,seed", [
    (20, 16, 2, 8, 3),  # two clusters through the PCA branch
    (40, 64, 51, 128, 0),  # k capped at N: every caption its own label
    (90, 24, 7, 128, 1),  # overlapping clusters, several Lloyd iterations
    (300, 160, 12, 128, 2),  # the PCA branch at scikit-learn's "full" solver sizes
])
def test_cluster_label_vocab_equals_jax(n, D, k, pca_dim, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1.0, (max(k // 2, 2), D))
    embs = centres[rng.integers(0, len(centres), n)] + rng.normal(0, 0.6, (n, D))
    captions = [f"caption {i}" for i in range(n)]
    want = jpd.cluster_label_vocab(embs, captions, n_labels=k, pca_dim=pca_dim, seed=seed)
    assert tpd.cluster_label_vocab(embs, captions, n_labels=k, pca_dim=pca_dim,
                                   seed=seed) == want


def test_hash_embedding_and_label_post_process_bitwise():
    for text in ("red box", "Wooden Table", "", "a"):
        np.testing.assert_array_equal(tpd.hash_embedding(text), jpd.hash_embedding(text))
    rng = np.random.default_rng(6)
    frames = [{"masks": rng.uniform(size=(3, 12, 16)) > 0.6, "label_ids": np.array([3, 7, 61])}
              for _ in range(3)]
    got = tpd.postprocess_label_frames([dict(f) for f in frames])
    want = jpd.postprocess_label_frames([dict(f) for f in frames])
    for g, w in zip(got, want):
        for key in ("annotated_frame_color", "annotated_frame_index"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


ACTIONS = [["--action", "reconstruction", "--dense"], ["--action", "cameras"],
           ["--action", "align_cameras"], ["--action", "caption"],
           ["--action", "caption_post_process"], ["--action", "labeling"],
           ["--action", "labels_post_process"], ["--action", "render"]]


def test_eight_actions_write_what_jax_writes(tmp_path):
    """The eight actions through `main`, in the reference order, on two
    copies of one tiny episode set (one copy a package: a second run would
    skip); every written file compared array by array."""
    for pkg in ("jax", "port"):
        for ep in ("00000", "00001"):
            _make_episode(tmp_path / pkg, ep)
        labels = tmp_path / pkg / "00001" / "labels"  # per-point labels of the unfiltered clouds
        labels.mkdir()
        for f in range(3):
            np.save(labels / f"{f:05d}.npy", (np.arange(24 * 32) % 3).astype(np.int64))
    for argv in ACTIONS:
        jpd.main(argv + ["--data_root", str(tmp_path / "jax")])
        done = tpd.main(argv + ["--data_root", str(tmp_path / "port"), "--device", "cpu"])
        assert len(done) == 2, argv  # both episodes, or for caption_post_process both captions
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                       if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                        if p.is_file())
    # the JAX factory fails episode 00001 (its labels no longer match the
    # filtered points); the port filters them with the points
    extra = {Path("00001/occupancy.npz"), Path("00001/render.npz")}
    assert set(port_files) - set(jax_files) == extra and set(jax_files) <= set(port_files)
    for rel in jax_files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix != ".npz":
            assert a.read_bytes() == b.read_bytes(), rel
            continue
        x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        assert sorted(x.files) == sorted(y.files), rel
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (rel, k)
            if rel.name == "render.npz" and k == "depths":
                np.testing.assert_allclose(y[k], x[k], atol=1e-5, rtol=0)
                print(f"{rel} depths differ by ulps on {(x[k] != y[k]).mean():.2%} of the pixels")
            else:
                np.testing.assert_array_equal(y[k], x[k], err_msg=f"{rel}:{k}")


def test_no_captions_raises_by_cause(tmp_path):
    """Episodes whose captioner found no object: the JAX package fails on a
    name it never defined; the port says what is missing."""
    _make_episode(tmp_path, with_objects=False)
    (tmp_path / "00000" / "captions.json").write_text(json.dumps(
        tpd.objects_file_caption_backend(str(tmp_path / "00000"))))
    with pytest.raises(NameError):
        jpd.run_caption_post_process(str(tmp_path))
    with pytest.raises(ValueError, match="no captions"):
        tpd.run_caption_post_process(str(tmp_path))


def test_stage_pipeline_skips_existing_outputs(tmp_path):
    """Two stages under spawn: an episode whose first output exists skips
    that stage only; the downstream stage still runs on it."""
    for ep in ("a", "b", "c"):
        _make_episode(tmp_path, ep)
    (tmp_path / "b" / "captions.json").write_text(json.dumps(["pre"]))
    stages = [tpd.Stage("caption", functools.partial(tpd._caption_stage,
                                                     tpd.objects_file_caption_backend),
                        functools.partial(tpd._output_path, "captions.json")),
              tpd.Stage("cameras", functools.partial(tpd._cameras_stage, tpd.pose_cameras_backend),
                        functools.partial(tpd._output_path, "cameras.npz"))]
    keys = [str(tmp_path / ep) for ep in ("a", "b", "c")]
    assert sorted(tpd.run_stage_pipeline(stages, keys)) == keys
    assert json.loads((tmp_path / "b" / "captions.json").read_text()) == ["pre"]  # skipped
    assert json.loads((tmp_path / "a" / "captions.json").read_text()) == ["red box",
                                                                          "wooden table"]
    assert all((tmp_path / ep / "cameras.npz").exists() for ep in ("a", "b", "c"))


def test_stage_pipeline_refuses_a_stage_it_cannot_send():
    before = len(mp.active_children())
    stage = tpd.Stage("closure stage", lambda key: None, lambda key: key)
    with pytest.raises(TypeError, match="closure stage"):
        tpd.run_stage_pipeline([stage], ["a"])
    assert len(mp.active_children()) == before


def _write_and_wait(flag: str, key: str) -> None:
    """A stage that writes a partial output, signals, then hangs."""
    Path(key).write_text("partial")
    Path(flag).write_text("started")
    time.sleep(60)


def test_sigterm_removes_the_partial_output(tmp_path):
    ctx = mp.get_context("spawn")
    flag, out = tmp_path / "started", tmp_path / "out.txt"
    stage = tpd.Stage("slow", functools.partial(_write_and_wait, str(flag)), str)
    in_q, out_q, stats_q = ctx.Queue(), ctx.Queue(), ctx.Queue()
    proc = ctx.Process(target=tpd._stage_worker, args=(stage, in_q, out_q, stats_q))
    proc.start()
    in_q.put(str(out))
    deadline = time.time() + 60
    while not flag.exists() and time.time() < deadline:
        time.sleep(0.05)
    assert flag.exists() and out.exists()
    os.kill(proc.pid, signal.SIGTERM)
    proc.join(timeout=30)
    assert not proc.is_alive() and proc.exitcode == 1
    assert not out.exists()
