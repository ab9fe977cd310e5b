"""4D occupancy data factory: raw depth episodes -> labeled occupancy ->
semantic and depth condition maps (the `render.npz` that `encode_dataset`
and `RobotDataset(use_cond=True)` read).

Counterpart of `orv_tpu/pipelines/prepare_dataset.py`, with its public
names and its eight `--action`s:

  reconstruction        depth episodes -> per-frame point clouds -> outlier
                        removal -> (with --dense, a TSDF surface) ->
                        labeled 1 mm occupancy (voxel top-label vote)
  cameras               camera estimation (backend) + metric alignment
  align_cameras         the alignment stage of `cameras` alone
  caption               per-episode object captions (backend)
  caption_post_process  captions -> canonical label vocabulary (clustering)
  labeling              caption + vocabulary + mask tracks (backend) +
                        color/index maps
  labels_post_process   the color/index maps again from existing masks
  render                occupancy -> isotropic gaussians -> per-frame depth
                        and semantic maps (render.npz)

The device work runs on the card unless the caller names the CPU
(`--device cpu`, or `device="cpu"`): the voxelization and the Gaussian-splat
rasterizer are CUDA kernels (`ops/voxelize.py`, `ops/gaussian_raster.py`),
the TSDF fusion runs on the device in f64 (as the numpy does, so that its
|tsdf| < half-voxel surface set is the same set), and the per-voxel label
vote is vectorised on the device. The k-NN outlier filter stays on the host
(scipy's cKDTree, all cores). The caption clustering is PCA by SVD and
scikit-learn's k-means++ and Lloyd iteration re-written in numpy (the card's
machine has no scikit-learn), so the caption -> label map is the same.

Third-party perception models (MonST3R, VGGT, NKSR, GroundingDINO, SAM2,
QwenVL, a sentence-embedding model) are pluggable `Backend` callables
registered by name; the built-in ones read depth maps, poses, objects.txt
and ground-truth masks from the episode.

Every stage runs in its own process, started by multiprocessing's "spawn"
method (a forked child cannot use a card its parent has initialised), with
queues between stages, skip-if-exists outputs and SIGTERM cleanup of partial
output; a failing episode is logged with its traceback and skipped. Stage
functions must therefore be picklable (module-level functions, or
`functools.partial` of them): `run_stage_pipeline` refuses a stage that is
not, naming it, before any worker starts. Workers get the device as a
string and send their kernels' launch counts and `stats` back.

Usage:
  python -m orv_tpu_torch.pipelines.prepare_dataset --action reconstruction \
      --data_root DIR [--dense] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import multiprocessing as mp
import os
import pickle
import queue
import signal
import sys
import time
import traceback
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from orv_tpu_torch.utils.logging import CONSOLE

if TYPE_CHECKING:
    from orv_tpu_torch.utils.device import DeviceLike

# torch and the kernels are imported by the functions that run on a device:
# a host-only stage's spawned worker (cameras, captions, labeling) then
# starts without importing torch, which takes seconds

# reference occupancy volume: [-0.2,-0.2,0] .. [0.2,0.2,0.4] @ 1mm voxels
POINT_CLOUD_RANGE = (-0.2, -0.2, 0.0, 0.2, 0.2, 0.4)
VOXEL_SIZE = (0.001, 0.001, 0.001)
NUM_SEMANTIC_CHANNELS = 12
DEPTH_CLAMP = (0.01, 0.4)  # reference render depth clamp

# wall seconds of the timed parts ("<part>_s": outlier removal, TSDF,
# voxelization, render), summed over this process and the stage workers it
# ran, and the workers' largest peak of device memory ("worker_peak_bytes")
stats: Dict[str, float] = {}


@contextlib.contextmanager
def _timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats[f"{name}_s"] = stats.get(f"{name}_s", 0.0) + time.perf_counter() - t0


def _merge_stats(other: Dict[str, float]) -> None:
    for k, v in other.items():
        stats[k] = max(stats.get(k, 0), v) if k.endswith("_bytes") else stats.get(k, 0.0) + v


# ---------------------------------------------------------------------------
# pluggable perception backends
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str):
    def deco(fn):
        _BACKENDS[name] = fn
        return fn
    return deco


def get_backend(name: str) -> Callable:
    if name not in _BACKENDS:
        raise KeyError(
            f"perception backend '{name}' is not registered. Available: "
            f"{sorted(_BACKENDS)}. External models (MonST3R/VGGT/SAM2/...) "
            f"plug in via orv_tpu_torch.pipelines.prepare_dataset.register_backend "
            f"(a module-level function: stage workers are spawned processes)."
        )
    return _BACKENDS[name]


@register_backend("depth_unproject")
def depth_unproject_backend(episode_dir: str) -> Dict[str, np.ndarray]:
    """Built-in reconstruction backend for episodes that ship depth maps:
    {episode_dir}/depth/*.npy [H,W] metric + intrinsics.json + poses.npy
    [F,4,4] cam->world -> per-frame world-space points."""
    ep = Path(episode_dir)
    K = np.asarray(json.loads((ep / "intrinsics.json").read_text())["K"])
    poses = np.load(ep / "poses.npy")
    depth_files = sorted((ep / "depth").glob("*.npy"))
    pts_per_frame = []
    for i, df in enumerate(depth_files):
        d = np.load(df)
        H, W = d.shape
        v, u = np.mgrid[0:H, 0:W]
        z = d.reshape(-1)
        ok = z > 0
        x = (u.reshape(-1) - K[0, 2]) / K[0, 0] * z
        y = (v.reshape(-1) - K[1, 2]) / K[1, 1] * z
        cam = np.stack([x, y, z, np.ones_like(z)], 1)[ok]
        world = (poses[i] @ cam.T).T[:, :3]
        pts_per_frame.append(world.astype(np.float32))
    return {"points": pts_per_frame, "poses": poses, "intrinsics": K}


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def outlier_keep(points: np.ndarray, k: int = 16, std_ratio: float = 2.0) -> np.ndarray:
    """The points `statistical_outlier_removal` keeps, as a mask."""
    from scipy.spatial import cKDTree

    if len(points) <= k + 1:
        return np.ones(len(points), bool)
    with _timed("outlier_removal"):
        tree = cKDTree(points)
        d, _ = tree.query(points, k=k + 1, workers=-1)
        mean_d = d[:, 1:].mean(axis=1)
        thr = mean_d.mean() + std_ratio * mean_d.std()
        return mean_d < thr


def statistical_outlier_removal(points: np.ndarray, k: int = 16,
                                std_ratio: float = 2.0) -> np.ndarray:
    """Drop points whose mean k-NN distance exceeds mean + std_ratio*std
    (open3d's filter). On the host: scipy's cKDTree, queried on all cores
    (the same distances as one core)."""
    if len(points) <= k + 1:
        return points
    return points[outlier_keep(points, k, std_ratio)]


def align_depth_scale(mono_depth: np.ndarray, metric_points: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> float:
    """Least-squares scale between a monocular depth map and metric values:
    scale = sum(m*p*t) / sum(m*p^2)."""
    m = np.ones_like(mono_depth, dtype=bool) if mask is None else mask.astype(bool)
    p = mono_depth[m].astype(np.float64)
    t = metric_points[m].astype(np.float64)
    denom = float((p * p).sum())
    return float((p * t).sum() / denom) if denom > 0 else 1.0


def compute_scale_and_shift(prediction: np.ndarray, target: np.ndarray,
                            mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-map scale (shift pinned to 0) between predicted and target depth:
    scale = sum(m*p*t)/sum(m*p*p) over the (H, W) axes of [N, H, W] maps."""
    a_00 = np.sum(mask * prediction * prediction, axis=(1, 2))
    b_0 = np.sum(mask * prediction * target, axis=(1, 2))
    scale = np.zeros_like(b_0)
    valid = a_00 != 0
    scale[valid] = b_0[valid] / a_00[valid]
    return scale, np.zeros_like(scale)


def align_multiview_extrinsics(extrin: np.ndarray, scale: float,
                               shift: float = 0.0) -> np.ndarray:
    """Rescale estimated multiview extrinsics to metric scale: translations
    scale by `scale`, then every view shifts by the world-space offset that
    moves view-0's camera by `shift` along its z axis. extrin: [V, 3, 4] or
    [V, 4, 4] OpenCV world->cam. Returns [V, 4, 4]."""
    V = len(extrin)
    E = np.tile(np.eye(4, dtype=np.float64), (V, 1, 1))
    E[:, :3, :4] = np.asarray(extrin, np.float64)[:, :3, :4]
    global_shift = np.linalg.inv(E[0]) @ np.array([0.0, 0.0, float(shift), 1.0])
    E[:, :3, -1] = E[:, :3, -1] * float(scale) + global_shift[:3]
    return E


def tsdf_fuse(
    depths: Sequence[np.ndarray],  # per-frame [H, W] metric depth
    poses: np.ndarray,  # [F, 4, 4] cam->world
    K: np.ndarray,  # [3, 3]
    point_cloud_range=POINT_CLOUD_RANGE,
    voxel_size: float = 0.004,
    trunc: float = 0.012,
    min_weight: float = 1.0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Dense-surface stage (stands in for the reference's NKSR step): fuse a
    truncated signed distance volume from the depth maps and return the
    voxel centres where |tsdf| < half a voxel, as f32 points. On the device,
    in f64 as the numpy reference computes it."""
    import torch

    from orv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with _timed("tsdf_fuse"):
        lo = np.asarray(point_cloud_range[:3], np.float64)
        hi = np.asarray(point_cloud_range[3:], np.float64)
        dims = np.maximum(((hi - lo) / voxel_size).astype(int), 1)
        f64 = dict(dtype=torch.float64, device=dev)
        axes = [lo[j] + (torch.arange(int(dims[j]), **f64) + 0.5) * voxel_size for j in range(3)]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        tsdf = torch.zeros(len(grid), **f64)
        weight = torch.zeros(len(grid), **f64)
        for d, pose in zip(depths, poses):
            H, W = d.shape
            w2c = torch.as_tensor(np.linalg.inv(pose), **f64)
            dt = torch.as_tensor(np.asarray(d), device=dev)
            cam = grid @ w2c[:3, :3].T + w2c[:3, 3]
            z = cam[:, 2]
            zc = torch.clamp(z, min=1e-9)
            u = torch.round(cam[:, 0] / zc * float(K[0, 0]) + float(K[0, 2])).long()
            v = torch.round(cam[:, 1] / zc * float(K[1, 1]) + float(K[1, 2])).long()
            ok = (z > 1e-4) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            dz = torch.where(ok, dt[v.clamp(0, H - 1), u.clamp(0, W - 1)].double(),
                             torch.zeros_like(z))
            ok &= dz > 0
            sdf = torch.clamp((dz - z) / trunc, -1.0, 1.0)
            upd = ok & (dz - z > -trunc)
            tsdf = torch.where(upd, (tsdf * weight + sdf) / (weight + 1.0), tsdf)
            weight = torch.where(upd, weight + 1.0, weight)
        surf = (torch.abs(tsdf) < (voxel_size * 0.5) / trunc) & (weight >= min_weight)
        return grid[surf].float().cpu().numpy()


def points_to_voxels(
    points,  # [N, 3]
    labels,  # [N] int
    point_cloud_range=POINT_CLOUD_RANGE,
    voxel_size=VOXEL_SIZE,
    max_points: int = 16,
    max_voxels: int = 2_000_000,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (coors [M,3] zyx int32, voxel_labels [M] int32): hard voxelization
    of the labeled points, then each voxel's most frequent label among its
    kept points, the smallest on a tie (np.bincount(...).argmax()), counted
    for every voxel at once on the device."""
    import torch

    from orv_tpu_torch.ops.voxelize import voxelization
    from orv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with _timed("voxelize"):
        pts = torch.as_tensor(np.asarray(points), dtype=torch.float32, device=dev)
        lab = torch.as_tensor(np.asarray(labels), device=dev)
        if len(lab) and int(lab.min()) < 0:
            raise ValueError("points_to_voxels takes labels >= 0")
        cloud = torch.cat([pts.reshape(-1, 3), lab.float()[:, None]], 1)
        voxels, coors, nppv = voxelization(cloud, voxel_size, point_cloud_range,
                                           max_points=max_points, max_voxels=max_voxels)
        M = len(coors)
        vl = voxels[:, :, 3].long()
        kept = torch.arange(max_points, device=dev)[None, :] < nppv[:, None]
        n_lab = int(vl[kept].max()) + 1 if M else 1
        hist = torch.zeros((M, n_lab), dtype=torch.int32, device=dev)
        hist.scatter_add_(1, torch.where(kept, vl, torch.zeros_like(vl)), kept.int())
        out = hist.argmax(1).int()  # the first of equal counts
        return coors.cpu().numpy(), out.cpu().numpy()


def occupancy_from_frames(
    frame_points: Sequence[np.ndarray],
    frame_labels: Sequence[np.ndarray],
    device: DeviceLike = None,
    **kwargs,
) -> List[Dict[str, np.ndarray]]:
    """Per-frame labeled occupancy (the 4D sequence)."""
    out = []
    for pts, labs in zip(frame_points, frame_labels):
        coors, vl = points_to_voxels(pts, labs, device=device, **kwargs)
        out.append({"coors": coors, "labels": vl})
    return out


# ---------------------------------------------------------------------------
# render stage (the rasterizer kernels)
# ---------------------------------------------------------------------------

def occupancy_to_gaussians(coors, labels, point_cloud_range=POINT_CLOUD_RANGE,
                           voxel_size=VOXEL_SIZE, base_scale: float = 0.00023,
                           exp_scale: float = 3.7, device: DeviceLike = None):
    """Voxel centres -> isotropic gaussians with depth-bin-scaled radii
    (scale = base * bin^3.7 over z bins), as f32 tensors on the device:
    (centers [n,3], features [n,12] one-hot, rotations [n,4], scales [n,3],
    opacities [n]). The intermediates are f64, as in the reference, so the
    gaussians are its bits."""
    import torch

    from orv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(coors), device=dev).long()
    lab = torch.as_tensor(np.asarray(labels), device=dev).long()
    lo = [float(x) for x in point_cloud_range[:3]]
    vs = [float(x) for x in np.asarray(voxel_size)]
    grid_z = int(round((point_cloud_range[5] - point_cloud_range[2]) / np.asarray(voxel_size)[2]))
    centers = torch.stack([lo[0] + (c[:, 2].double() + 0.5) * vs[0],
                           lo[1] + (c[:, 1].double() + 0.5) * vs[1],
                           lo[2] + (c[:, 0].double() + 0.5) * vs[2]], 1).float()
    zbin = c[:, 0].double() + 1
    zbin = (zbin - 1) / max(grid_z - 1, 1) + 1  # normalize to [1, 2]
    scales = (base_scale * zbin ** exp_scale).float()
    n = len(centers)
    feat = torch.zeros((n, NUM_SEMANTIC_CHANNELS), dtype=torch.float32, device=dev)
    feat[torch.arange(n, device=dev), lab.clamp(0, NUM_SEMANTIC_CHANNELS - 1)] = 1.0
    rot = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(n, 1)
    return (centers, feat, rot, scales[:, None].repeat(1, 3).contiguous(),
            torch.ones(n, dtype=torch.float32, device=dev))


def render_episode(
    occupancy: Sequence[Dict[str, np.ndarray]],
    extrinsics: Sequence[np.ndarray],  # per view cam->world [4,4]
    intrinsics: Sequence[np.ndarray],  # per view [3,3]
    image_shape: Tuple[int, int],
    out_path: Optional[str] = None,
    alpha_threshold: float = 0.1,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Occupancy sequence -> {semantics uint8 [F,V,H,W], depths f32
    [F,V,H,W], is_labeled}. Depth clamped to [0.01, 0.4]; alpha < 0.1 ->
    background label 11 and depth 0 (then the clamp); the label is the
    first of equal feature channels."""
    import torch

    from orv_tpu_torch.ops.gaussian_raster import render_occupancy_view
    from orv_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    F, V = len(occupancy), len(extrinsics)
    H, W = image_shape
    semantics = np.zeros((F, V, H, W), np.uint8)
    depths = np.zeros((F, V, H, W), np.float32)
    with _timed("render"):
        for f, occ in enumerate(occupancy):
            centers, feat, rot, scales, opac = occupancy_to_gaussians(
                occ["coors"], occ["labels"], device=dev)
            rgb = torch.zeros((len(centers), 3), dtype=torch.float32, device=dev)
            for v in range(V):
                out = render_occupancy_view(extrinsics[v], intrinsics[v], image_shape,
                                            centers, rgb, feat, rot, scales, opac)
                alpha = out["render_alpha"]
                sem = out["render_feat"].argmax(0).to(torch.uint8)
                sem[alpha < alpha_threshold] = NUM_SEMANTIC_CHANNELS - 1  # background
                d = torch.where(alpha > alpha_threshold,
                                out["render_depth"] / torch.clamp(alpha, min=1e-6),
                                torch.zeros_like(alpha))
                depths[f, v] = torch.clamp(d, *DEPTH_CLAMP).cpu().numpy()
                semantics[f, v] = sem.cpu().numpy()
    result = {"semantics": semantics, "depths": depths, "is_labeled": np.ones(F, bool)}
    if out_path:
        np.savez(out_path, **result)
    return result


# ---------------------------------------------------------------------------
# label vocabulary clustering (PCA + scikit-learn's KMeans, in numpy)
# ---------------------------------------------------------------------------

def _pca(X: np.ndarray, n_components: int) -> np.ndarray:
    """scikit-learn's PCA(n_components).fit_transform with its exact "full"
    solver: U[:, :k] * S[:k] of the centred data's SVD (scipy's gesdd), the
    signs flipped so that each row of Vt has its largest entry positive."""
    from scipy import linalg

    Xc = np.array(X, dtype=np.float64, copy=True)
    Xc -= Xc.mean(axis=0)
    U, S, Vt = linalg.svd(Xc, full_matrices=False)
    signs = np.sign(Vt[np.arange(len(Vt)), np.argmax(np.abs(Vt), axis=1)])
    U *= signs[np.newaxis, :]
    return U[:, :n_components] * S[:n_components]


def _sq_distances(A: np.ndarray, B: np.ndarray, b_sq: np.ndarray) -> np.ndarray:
    """scikit-learn's _euclidean_distances(A, B, squared=True) in f64."""
    d = -2 * (A @ B.T)
    d += np.einsum("ij,ij->i", A, A)[:, None]
    d += b_sq[None, :]
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(X, n_clusters, rs, x_sq):
    """scikit-learn's _kmeans_plusplus with unit sample weights: the first
    centre drawn by `rs.choice`, then 2 + int(log k) local trials a centre."""
    n = len(X)
    w = np.ones(n)
    n_local_trials = 2 + int(np.log(n_clusters))
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    center_id = rs.choice(n, p=w / w.sum())
    centers[0] = X[center_id]
    closest = _sq_distances(centers[0, np.newaxis], X, x_sq)
    pot = closest @ w
    for c in range(1, n_clusters):
        rand_vals = rs.uniform(size=n_local_trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = _sq_distances(X[cand], X, x_sq)
        np.minimum(closest, d, out=d)
        cand_pot = d @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot, closest = cand_pot[best], d[best]
        centers[c] = X[cand[best]]
    return centers


def _sq_dist_rows(a: np.ndarray, b: np.ndarray) -> float:
    """scikit-learn's _euclidean_dense_dense (squared): 4-wide partial sums."""
    n4 = len(a) // 4 * 4
    r = 0.0
    for i in range(0, n4, 4):
        d = a[i:i + 4] - b[i:i + 4]
        r += ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + d[3] * d[3]
    for i in range(n4, len(a)):
        r += (a[i] - b[i]) * (a[i] - b[i])
    return r


def _lloyd_step(X, centers, labels, update=True):
    """One pass of scikit-learn's lloyd_iter_chunked_dense (chunks of 256,
    unit weights): labels by the nearest centre (the first on a tie), then
    the new centres, the empty clusters relocated to the farthest points."""
    k = len(centers)
    c_sq = np.einsum("ij,ij->i", centers, centers)
    new = np.zeros_like(centers)
    weight = np.zeros(k)
    for s in range(0, len(X), 256):
        chunk = X[s:s + 256]
        d = c_sq[None, :] + (-2.0) * (chunk @ centers.T)
        labels[s:s + 256] = np.argmin(d, axis=1)
        if update:
            for i in range(len(chunk)):
                new[labels[s + i]] += chunk[i]
                weight[labels[s + i]] += 1.0
    if not update:
        return None
    empty = np.where(weight == 0)[0]
    if len(empty):
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if np.max(dist) != 0:
            for new_id, idx in zip(empty, far):
                old_id = labels[idx]
                new[old_id] -= X[idx]
                new[new_id] = X[idx]
                weight[new_id] = 1.0
                weight[old_id] -= 1.0
    biggest = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            new[j] *= 1.0 / weight[j]
        else:
            new[j] = new[biggest]
    shift = np.array([np.sqrt(_sq_dist_rows(new[j], centers[j])) for j in range(k)])
    return new, shift


def _kmeans_single(X, centers, max_iter, tol):
    labels = np.full(len(X), -1, dtype=np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(max_iter):
        centers, shift = _lloyd_step(X, centers, labels)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        _lloyd_step(X, centers, labels, update=False)
    inertia = sum(_sq_dist_rows(X[i], centers[labels[i]]) for i in range(len(X)))
    return labels, inertia


def _same_clustering(a, b, k) -> bool:
    mapping = np.full(k, -1)
    for x, y in zip(a, b):
        if mapping[x] == -1:
            mapping[x] = y
        elif mapping[x] != y:
            return False
    return True


def _kmeans_labels(X: np.ndarray, n_clusters: int, seed: int = 0, n_init: int = 10,
                  max_iter: int = 300, tol: float = 1e-4) -> np.ndarray:
    """scikit-learn's KMeans(n_clusters, random_state=seed, n_init=n_init)
    .fit(X).labels_ (Lloyd, k-means++), in numpy: one RandomState(seed)
    stream shared by the n_init runs, the data centred first, tol scaled by
    the mean feature variance, the run of least inertia kept (a later run
    only if its inertia is smaller and its clustering differs)."""
    X = np.array(X, dtype=np.float64, order="C", copy=True)
    if len(X) < n_clusters:
        raise ValueError(f"n_samples={len(X)} should be >= n_clusters={n_clusters}")
    rs = np.random.RandomState(seed)
    tol = np.mean(np.var(X, axis=0)) * tol
    X -= X.mean(axis=0)
    x_sq = np.einsum("ij,ij->i", X, X)
    best_labels, best_inertia = None, None
    for _ in range(n_init):
        centers = _kmeans_plusplus(X, n_clusters, rs, x_sq)
        labels, inertia = _kmeans_single(X, centers, max_iter, tol)
        if best_inertia is None or (inertia < best_inertia
                                    and not _same_clustering(labels, best_labels, n_clusters)):
            best_labels, best_inertia = labels, inertia
    return best_labels


def cluster_label_vocab(
    caption_embeddings: np.ndarray,  # [N, D] (e.g. MiniLM sentence embs)
    captions: Sequence[str],
    n_labels: int = 51,
    pca_dim: int = 128,
    seed: int = 0,
) -> Dict[str, int]:
    """caption -> canonical label id via PCA + KMeans (the text-embedding
    model itself is an external backend; the clustering is owned here)."""
    X = caption_embeddings
    if X.shape[1] > pca_dim and X.shape[0] > pca_dim:
        X = _pca(X, pca_dim)
    k = min(n_labels, len(captions))
    return {c: int(l) for c, l in zip(captions, _kmeans_labels(X, k, seed=seed, n_init=10))}


# ---------------------------------------------------------------------------
# restartable multi-stage pipeline
# ---------------------------------------------------------------------------

@dataclass
class Stage:
    name: str
    fn: Callable[[str], Optional[str]]  # episode key -> output path (or None)
    output_of: Callable[[str], str]  # episode key -> expected output path


def _output_path(name: str, key: str) -> str:
    """`output_of` of a stage that writes {episode}/name."""
    return str(Path(key) / name)


def _stage_worker(stage: Stage, in_q, out_q, stats_q):
    current_output: List[str] = []

    def cleanup(signum, frame):
        # delete partial outputs so a restart redoes the episode cleanly
        for p in current_output:
            try:
                os.remove(p)
            except OSError:
                pass
        os._exit(1)

    signal.signal(signal.SIGTERM, cleanup)
    while True:
        key = in_q.get()
        if key is None:
            # the kernels and torch are in this process only if a stage used them
            build, torch = sys.modules.get("orv_tpu_torch.ops._build"), sys.modules.get("torch")
            peak = (torch.cuda.max_memory_allocated()
                    if torch is not None and torch.cuda.is_initialized() else 0)
            stats_q.put((build.launch_counts() if build else {},
                         {**stats, "worker_peak_bytes": peak}))
            out_q.put(None)
            return
        expected = stage.output_of(key)
        if os.path.exists(expected):  # skip-if-exists idempotency
            out_q.put(key)
            continue
        current_output = [expected]
        try:
            stage.fn(key)
        except Exception as e:  # noqa: BLE001 - a failing episode is skipped
            CONSOLE.log(f"[red]stage {stage.name} failed on {key}: {e}\n{traceback.format_exc()}")
            for p in current_output:
                if os.path.exists(p):
                    os.remove(p)
            continue
        current_output = []
        out_q.put(key)


def run_stage_pipeline(stages: List[Stage], episode_keys: List[str]):
    """Chain stages as concurrent spawned processes with queues between
    them; each episode flows stage1 -> stage2 -> ... as soon as its
    predecessor is done. Returns the keys that passed every stage; the
    workers' launch counts and `stats` are added to this process's."""
    for s in stages:
        try:
            pickle.dumps(s)
        except Exception as e:  # noqa: BLE001 - any pickling failure means the same
            raise TypeError(f"stage {s.name!r} cannot be sent to a spawned worker: its fn and "
                            f"output_of must be module-level functions or functools.partial of "
                            f"them ({type(e).__name__}: {e})") from e
    ctx = mp.get_context("spawn")
    queues = [ctx.Queue() for _ in range(len(stages) + 1)]
    stats_q = ctx.Queue()
    procs = [ctx.Process(target=_stage_worker, args=(s, queues[i], queues[i + 1], stats_q),
                         name=f"stage-{s.name}")
             for i, s in enumerate(stages)]
    for p in procs:
        p.start()
    for k in episode_keys:
        queues[0].put(k)
    queues[0].put(None)
    done = []
    while True:
        try:
            k = queues[-1].get(timeout=1.0)
        except queue.Empty:  # check that no worker died
            dead = [p.name for p in procs if p.exitcode not in (None, 0)]
            if dead:
                for p in procs:
                    p.terminate()
                raise RuntimeError(f"stage worker(s) {dead} died before the pipeline ended")
            continue
        if k is None:
            break
        done.append(k)
    for _ in stages:  # each worker posts its stats before passing the end on
        launches, worker_stats = stats_q.get()
        if launches:
            from orv_tpu_torch.ops import _build

            _build.add_launch_counts(launches)
        _merge_stats(worker_stats)
    for p in procs:
        p.join()
    return done


def _episode_dirs(data_root: str) -> List[str]:
    root = Path(data_root)
    return sorted(str(p.parent) for p in root.glob("*/intrinsics.json"))


def _labels_for(ep_dir: str, n_points_per_frame: List[int]) -> List[np.ndarray]:
    """Per-frame point labels: {ep}/labels/*.npy if present, else zeros
    (single 'scene' class); the labeling stage is a pluggable backend."""
    lab_dir = Path(ep_dir) / "labels"
    files = sorted(lab_dir.glob("*.npy")) if lab_dir.exists() else []
    if len(files) == len(n_points_per_frame):
        return [np.load(f) for f in files]
    return [np.zeros(n, dtype=np.int64) for n in n_points_per_frame]


def _device_name(device: DeviceLike) -> str:
    """The device as workers take it: a string, resolved in the parent."""
    from orv_tpu_torch.utils.device import resolve_device

    return str(resolve_device(device))


def _reconstruction_stage(recon, backend: str, dense: bool, voxel_kwargs, device: str,
                          ep_dir: str):
    out = Path(ep_dir) / "occupancy.npz"
    result = recon(ep_dir)
    keep = [outlier_keep(p) for p in result["points"]]
    pts = [p[m] for p, m in zip(result["points"], keep)]
    # per-point labels of the unfiltered clouds lose the dropped points too
    # (the JAX package fails such an episode: its labels no longer match)
    labels = [l[m] if len(l) == len(m) else l
              for l, m in zip(_labels_for(ep_dir, [len(p) for p in pts]), keep)]
    if dense:
        ep = Path(ep_dir)
        K = np.asarray(json.loads((ep / "intrinsics.json").read_text())["K"])
        poses = result.get("poses")
        if poses is None:
            raise ValueError(
                f"dense=True needs camera poses but reconstruction "
                f"backend '{backend}' returned none for {ep_dir}: use a "
                "pose-emitting backend or provide poses.npy"
            )
        depth_files = sorted((ep / "depth").glob("*.npy"))
        if len(depth_files) != len(poses):
            raise ValueError(
                f"{ep_dir}: {len(depth_files)} depth maps vs "
                f"{len(poses)} poses: TSDF fusion needs one pose per "
                "depth frame"
            )
        depths = [np.load(f) for f in depth_files]
        surf = tsdf_fuse(depths, poses, K, device=device)
        np.savez(ep / "dense_surface.npz", points=surf)
        bg = np.zeros(len(surf), np.int64)
        pts = [np.concatenate([p, surf]) for p in pts]
        labels = [np.concatenate([l, bg]) for l in labels]
    occ = occupancy_from_frames(pts, labels, device=device, **voxel_kwargs)
    np.savez(out,
             coors=np.concatenate([o["coors"] for o in occ]),
             labels=np.concatenate([o["labels"] for o in occ]),
             frame_sizes=np.array([len(o["coors"]) for o in occ]))


def run_reconstruction(data_root: str, backend: str = "depth_unproject",
                       dense: bool = False, device: DeviceLike = None, **voxel_kwargs):
    """Per-episode depth unprojection -> filtered points -> labeled
    occupancy .npz (restartable, skip-if-exists). `dense=True` adds the TSDF
    dense-surface stage (the reference's NKSR step): fused surface points
    are unioned into every frame's cloud with background label before
    voxelization."""
    fn = functools.partial(_reconstruction_stage, get_backend(backend), backend, dense,
                           voxel_kwargs, _device_name(device))
    stages = [Stage("reconstruction", fn, functools.partial(_output_path, "occupancy.npz"))]
    return run_stage_pipeline(stages, _episode_dirs(data_root))


def _render_stage(image_shape, kwargs, device: str, ep_dir: str):
    ep = Path(ep_dir)
    with np.load(ep / "occupancy.npz") as data:  # each key read once, not once a frame
        coors, labels, sizes = data["coors"], data["labels"], data["frame_sizes"]
    occ, off = [], 0
    for n in sizes:
        occ.append({"coors": coors[off:off + n], "labels": labels[off:off + n]})
        off += n
    K = np.asarray(json.loads((ep / "intrinsics.json").read_text())["K"])
    poses = np.load(ep / "poses.npy")
    render_episode(occ, [poses[0]], [K], image_shape, out_path=str(ep / "render.npz"),
                   device=device, **kwargs)


def run_render(data_root: str, image_shape=(240, 320), device: DeviceLike = None, **kwargs):
    """occupancy.npz + poses/intrinsics -> per-episode render.npz
    {semantics, depths, is_labeled}: every frame from the first pose, one
    view, as the reference renders."""
    fn = functools.partial(_render_stage, tuple(image_shape), kwargs, _device_name(device))
    stages = [Stage("render", fn, functools.partial(_output_path, "render.npz"))]
    return run_stage_pipeline(stages, _episode_dirs(data_root))


# ---------------------------------------------------------------------------
# cameras action
# ---------------------------------------------------------------------------

@register_backend("pose_cameras")
def pose_cameras_backend(episode_dir: str) -> Dict[str, np.ndarray]:
    """Built-in cameras backend for episodes that ship poses + depth: emits
    the reference cameras-npz layout {extrin [V,3,4] world->cam, intrin
    [V,3,3], depth_map [V,H,W]} from poses.npy/intrinsics.json. A VGGT-style
    multiview estimator plugs in via register_backend with the same output
    contract."""
    ep = Path(episode_dir)
    K = np.asarray(json.loads((ep / "intrinsics.json").read_text())["K"])
    poses = np.load(ep / "poses.npy")  # [F, 4, 4] cam->world
    depth_files = sorted((ep / "depth").glob("*.npy"))
    views = min(len(poses), len(depth_files)) or len(poses)
    extrin = np.stack([np.linalg.inv(poses[v])[:3, :4] for v in range(views)])
    depth_map = (np.stack([np.load(f) for f in depth_files[:views]])
                 if depth_files else np.zeros((views, 1, 1), np.float32))
    return {"extrin": extrin.astype(np.float32),
            "intrin": np.tile(K[None].astype(np.float32), (views, 1, 1)),
            "depth_map": depth_map.astype(np.float32)}


def _align_episode_cameras(ep_dir: str):
    """Metric alignment of one episode's estimated extrinsics against its
    metric depth (compute_scale_and_shift + align_multiview_extrinsics) ->
    aligned_cameras.npz. Shared by `--action cameras` (as its second stage)
    and `--action align_cameras`."""
    ep = Path(ep_dir)
    data = np.load(ep / "cameras.npz")
    est_depth = data["depth_map"][0]
    metric_files = sorted((ep / "depth").glob("*.npy"))
    if metric_files:
        metric = np.load(metric_files[0]).astype(np.float64)
        if metric.shape != est_depth.shape:  # backend may run at its own res
            sy = metric.shape[0] / est_depth.shape[0]
            sx = metric.shape[1] / est_depth.shape[1]
            yy = (np.arange(est_depth.shape[0]) * sy).astype(int)
            xx = (np.arange(est_depth.shape[1]) * sx).astype(int)
            metric = metric[yy][:, xx]
        mask = np.ones_like(metric)
        scale, shift = compute_scale_and_shift(
            est_depth[None].astype(np.float64), metric[None], mask[None])
        scale, shift = float(scale[0]), float(shift[0])
    else:
        scale, shift = 1.0, 0.0
    aligned = align_multiview_extrinsics(data["extrin"], scale, shift)
    np.savez(ep / "aligned_cameras.npz",
             aligned_extrin=aligned.astype(np.float32), intrin=data["intrin"])


def _cameras_stage(cams, ep_dir: str):
    np.savez(Path(ep_dir) / "cameras.npz", **cams(ep_dir))


def run_cameras(data_root: str, backend: str = "pose_cameras"):
    """--action cameras: per-episode camera estimation (pluggable backend)
    -> cameras.npz, then metric alignment -> aligned_cameras.npz
    (`--action align_cameras` re-runs the second stage alone)."""
    stages = [
        Stage("cameras", functools.partial(_cameras_stage, get_backend(backend)),
              functools.partial(_output_path, "cameras.npz")),
        Stage("align", _align_episode_cameras,
              functools.partial(_output_path, "aligned_cameras.npz")),
    ]
    return run_stage_pipeline(stages, _episode_dirs(data_root))


# ---------------------------------------------------------------------------
# labeling action (captions -> vocabulary -> mask tracks -> color maps; the
# VLM captioner and the GroundingDINO+SAM2 tracker are backends)
# ---------------------------------------------------------------------------

@register_backend("objects_file")
def objects_file_caption_backend(episode_dir: str) -> List[str]:
    """Built-in caption backend: reads `{ep}/objects.txt` (one object class
    per line), the contract a QwenVL captioner fulfills from pixels."""
    f = Path(episode_dir) / "objects.txt"
    if not f.exists():
        return []
    return sorted({ln.strip().lower() for ln in f.read_text().splitlines() if ln.strip()})


@register_backend("gt_masks")
def gt_masks_tracker_backend(episode_dir: str, track_labels: Sequence[str]):
    """Built-in tracker backend: loads `{ep}/masks/frame_*.npy` boolean
    [n_obj, H, W] stacks (per-frame instance masks, object order matching
    `{ep}/objects.txt`). A GroundingDINO+SAM2 tracker fulfills the same
    contract from pixels."""
    files = sorted((Path(episode_dir) / "masks").glob("frame_*.npy"))
    return [np.load(f).astype(bool) for f in files]


def hash_embedding(text: str, dim: int = 64) -> np.ndarray:
    """Deterministic bag-of-trigrams hashed embedding: the built-in stand-in
    for a sentence-embedding backend. crc32, not the builtin hash (salted per
    process), so that a resumed run clusters into the same vocabulary."""
    v = np.zeros(dim, np.float64)
    t = f"##{text.lower()}##"
    for i in range(len(t) - 2):
        h = zlib.crc32(t[i:i + 3].encode()) % dim
        v[h] += 1.0
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _caption_stage(cap, ep_dir: str):
    (Path(ep_dir) / "captions.json").write_text(json.dumps(cap(ep_dir)))


def run_caption(data_root: str, caption_backend: str = "objects_file"):
    """--action caption: per-episode captioning through the pluggable
    backend, written to {episode}/captions.json (skip-if-exists)."""
    stages = [Stage("caption", functools.partial(_caption_stage, get_backend(caption_backend)),
                    functools.partial(_output_path, "captions.json"))]
    return run_stage_pipeline(stages, _episode_dirs(data_root))


def run_caption_post_process(data_root: str,
                             embed_fn: Optional[Callable] = None,
                             n_labels: int = 51):
    """--action caption_post_process: cluster the per-episode captions into
    the canonical label vocabulary and write captions/labels.txt +
    captions/all_captions.jsonl. Requires `--action caption` to have run."""
    embed = embed_fn or hash_embedding
    eps = _episode_dirs(data_root)
    per_ep = {}
    for e in eps:
        f = Path(e) / "captions.json"
        if not f.exists():
            raise FileNotFoundError(
                f"{f} missing: run `--action caption` first (or the "
                "all-in-one `--action labeling`)")
        per_ep[e] = json.loads(f.read_text())
    return _cluster_and_write_vocab(data_root, eps, per_ep, embed, n_labels)


def build_label_vocab(data_root: str, caption_backend: str = "objects_file",
                      embed_fn: Optional[Callable] = None, n_labels: int = 51):
    """caption + caption_post_process in one call (the all-in-one
    `--action labeling` path)."""
    run_caption(data_root, caption_backend)
    return run_caption_post_process(data_root, embed_fn, n_labels)


def _cluster_and_write_vocab(data_root: str, eps, per_ep, embed, n_labels):
    vocab_captions = sorted({c for caps in per_ep.values() for c in caps})
    if not vocab_captions:
        # the JAX package raises NameError here (it formats an undefined name)
        raise ValueError(f"no captions to cluster: none of the {len(eps)} episodes' "
                         f"captions.json under {data_root} lists an object")
    embs = np.stack([embed(c) for c in vocab_captions])
    label_map = cluster_label_vocab(embs, vocab_captions, n_labels=n_labels)
    # canonical label list: representative caption per cluster id
    n_cluster = max(label_map.values()) + 1
    labels_txt = ["" for _ in range(n_cluster)]
    for c, l in label_map.items():
        if not labels_txt[l]:
            labels_txt[l] = c
    out_dir = Path(data_root) / "captions"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "labels.txt").write_text("\n".join(labels_txt) + "\n")
    with open(out_dir / "all_captions.jsonl", "w") as f:
        for e in eps:
            caps = per_ep[e]
            f.write(json.dumps({
                "episode_id": Path(e).name,
                "track_labels": caps,
                "label_ids": [label_map[c] for c in caps],
            }) + "\n")
    return label_map


def generate_colors(n: int = 60) -> List[Tuple[int, int, int]]:
    """Evenly-hued HSV palette, last color black (background): the wheel of
    data/dataset.py, which decodes these colors back at train time."""
    from orv_tpu_torch.data.dataset import generate_colors as _hsv_wheel

    colors = list(_hsv_wheel(n))
    colors[-1] = (0, 0, 0)
    return colors


def postprocess_label_frames(frames: List[Dict[str, np.ndarray]],
                             n_colors: int = 60):
    """Mask post-process: adds 'annotated_frame_color' [H,W,3] uint8
    (palette by label id, painted large-to-small in the FIRST frame's area
    order for temporal stability) and 'annotated_frame_index' [H,W] uint8
    (label ids, background 255) to each per-frame dict {masks [n,H,W] bool,
    label_ids [n]} in place."""
    palette = np.asarray(generate_colors(n_colors), np.uint8)
    order = None
    for fr in frames:
        masks = fr["masks"].astype(bool)
        label_ids = np.asarray(fr["label_ids"]).astype(np.int32)
        H, W = masks.shape[-2:]
        if order is None:  # fixed painting order -> no label flicker
            areas = masks.reshape(len(masks), -1).sum(1)
            order = np.flip(np.argsort(areas))
        color = np.zeros((H, W, 3), np.uint8)
        index = np.full((H, W), -1, np.int32)
        for di in order:
            color[masks[di]] = palette[label_ids[di] % n_colors]
            index[masks[di]] = label_ids[di]
        fr["annotated_frame_color"] = color
        fr["annotated_frame_index"] = index.astype(np.uint8)  # -1 -> 255
    return frames


def _labeling_stage(captions, tracker, ep_dir: str):
    ep = Path(ep_dir)
    meta = captions.get(ep.name)
    if meta is None:
        return
    mask_stacks = tracker(ep_dir, meta["track_labels"])
    frames = [{"masks": m,
               "track_labels": np.asarray(meta["track_labels"]),
               "object_ids": np.arange(1, len(m) + 1, dtype=np.uint8),
               "label_ids": np.asarray(meta["label_ids"], np.uint8)[: len(m)]}
              for m in mask_stacks]
    postprocess_label_frames(frames)
    out_dir = ep / "semantics"
    out_dir.mkdir(exist_ok=True)
    for i, fr in enumerate(frames):
        np.savez_compressed(out_dir / f"frame_{i:04d}.npz", **fr)
    (out_dir / ".done").write_text(str(len(frames)))


def run_labeling(data_root: str, caption_backend: str = "objects_file",
                 tracker_backend: str = "gt_masks"):
    """--action labeling: captions -> vocabulary clustering -> per-episode
    instance tracking (pluggable) -> color/index map post-process. Writes
    semantics/{episode}/frame_XXXX.npz {masks, track_labels, object_ids,
    label_ids, annotated_frame_color, annotated_frame_index}. A caption
    vocabulary already on disk (captions/all_captions.jsonl) is reused, so a
    failed tracking pass never re-runs captioning."""
    vocab_file = Path(data_root) / "captions" / "all_captions.jsonl"
    if vocab_file.exists():
        CONSOLE.log(f"labeling: reusing caption vocabulary {vocab_file}")
    else:
        build_label_vocab(data_root, caption_backend)
    with open(vocab_file) as f:
        captions = {j["episode_id"]: j for j in map(json.loads, f) if j["track_labels"]}
    fn = functools.partial(_labeling_stage, captions, get_backend(tracker_backend))
    stages = [Stage("labeling", fn, functools.partial(_output_path, "semantics/.done"))]
    return run_stage_pipeline(stages, _episode_dirs(data_root))


def _labels_post_process_stage(n_colors: int, ep_dir: str):
    out_dir = Path(ep_dir) / "semantics"
    files = sorted(out_dir.glob("frame_*.npz"))
    if not files:
        return
    frames = [dict(np.load(f, allow_pickle=False)) for f in files]
    postprocess_label_frames(frames, n_colors=n_colors)
    for f, fr in zip(files, frames):
        np.savez_compressed(f, **fr)
    (out_dir / ".post_done").write_text(str(len(frames)))


def run_labels_post_process(data_root: str, n_colors: int = 60):
    """--action labels_post_process: regenerate the annotated_frame_color /
    annotated_frame_index maps from the existing per-episode masks without
    re-running the tracker; rewrites the frame npz files in place, marked
    done via semantics/.post_done."""
    stages = [Stage("labels_post_process",
                    functools.partial(_labels_post_process_stage, n_colors),
                    functools.partial(_output_path, "semantics/.post_done"))]
    # only episodes that HAVE semantics (tracking ran) are candidates
    eps = [e for e in _episode_dirs(data_root)
           if (Path(e) / "semantics" / ".done").exists()]
    return run_stage_pipeline(stages, eps)


def run_align_cameras(data_root: str):
    """--action align_cameras: only the metric-alignment stage of `--action
    cameras`, re-runnable on its own against existing cameras.npz."""
    eps = _episode_dirs(data_root)
    missing = [e for e in eps if not (Path(e) / "cameras.npz").exists()]
    if missing:
        raise FileNotFoundError(
            f"{len(missing)} episode(s) lack cameras.npz (first: "
            f"{missing[0]}): run `--action cameras` first")
    stages = [Stage("align", _align_episode_cameras,
                    functools.partial(_output_path, "aligned_cameras.npz"))]
    return run_stage_pipeline(stages, eps)


ACTIONS = ("reconstruction", "cameras", "align_cameras", "caption", "caption_post_process",
           "labeling", "labels_post_process", "render")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # 8 separately restartable actions; `cameras` and `labeling` are
    # all-in-one supersets (estimate+align / caption+cluster+track+post)
    p.add_argument("--action", required=True, choices=ACTIONS)
    p.add_argument("--data_root", required=True)
    p.add_argument("--backend", default=None,
                   help="perception backend override (see register_backend)")
    p.add_argument("--tracker_backend", default="gt_masks")
    p.add_argument("--dense", action="store_true",
                   help="reconstruction: add the TSDF dense-surface stage")
    p.add_argument("--split", default="train")
    p.add_argument("--device", default=None,
                   help="device of the reconstruction and render (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.action == "reconstruction":
        done = run_reconstruction(args.data_root, args.backend or "depth_unproject",
                                  dense=args.dense, device=args.device)
    elif args.action == "render":
        done = run_render(args.data_root, device=args.device)
    elif args.action == "cameras":
        done = run_cameras(args.data_root, args.backend or "pose_cameras")
    elif args.action == "align_cameras":
        done = run_align_cameras(args.data_root)
    elif args.action == "caption":
        done = run_caption(args.data_root, args.backend or "objects_file")
    elif args.action == "caption_post_process":
        done = run_caption_post_process(args.data_root)
    elif args.action == "labeling":
        done = run_labeling(args.data_root, args.backend or "objects_file",
                            args.tracker_backend)
    elif args.action == "labels_post_process":
        done = run_labels_post_process(args.data_root)
    if args.action == "caption_post_process":
        # returns the caption->label map, not an episode list
        CONSOLE.log(f"caption_post_process: {len(done)} captions clustered")
    else:
        CONSOLE.log(f"{args.action}: {len(done)} episodes done")
    return done


if __name__ == "__main__":
    main()
