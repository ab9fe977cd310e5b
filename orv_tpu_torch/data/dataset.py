"""Robot-episode datasets feeding pre-encoded latents (or raw frames) to
evaluation and training.

Counterpart of `orv_tpu/data/dataset.py`, with the same sampling semantics
and numpy items:

  * annotation JSON per episode: {episode_id, texts, videos, state
    [T, >=6], continuous_gripper_state [T], has_image_k}
  * fixed-length slice extraction: windows of `sequence_length` frames at
    stride `sequence_interval`, window starts every
    start_frame_interval * sequence_interval frames; with
    `vae_has_first_single_frame` one extra leading frame is prepended so
    clips obey the causal-VAE 8n+1 rule
  * actions: relative end-effector deltas from states
    (accumulate=False step-wise), scaled by c_act_scaler=[20...20, 1]
  * latents loaded from disk as MOMENTS (2x16ch); file naming
    {episode:05d}_{start:02d}_{nframes:02d}[_view].npz (or reference .pt)

On-disk layout:
  data_root/annotations/{split}/*.json
  data_root/{embeddings_folder}/{split}/{latents,image_latents,
      depth_latents,label_latents,prompt_embeds}/<name>.npz

Raw frames are resized with OpenCV, as in the JAX package, so items agree
with it bit for bit. `BucketSampler` batches the training loader.
`MultiViewRobotDataset` stacks up to `max_n_view` views on the frame axis.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from orv_tpu_torch.data.rotation import relative_actions
from orv_tpu_torch.utils.logging import CONSOLE

C_ACT_SCALER = np.array([20.0, 20.0, 20.0, 20.0, 20.0, 20.0, 1.0])


def generate_colors(n: int = 60):
    """HSV color wheel (reference dataset.py:144-152); the last color is
    forced to black for the background label."""
    import colorsys

    out = []
    for i in range(n):
        r, g, b = colorsys.hsv_to_rgb(i / n, 0.75, 0.95)
        out.append((int(r * 255), int(g * 255), int(b * 255)))
    return out


COLORS60 = np.asarray(generate_colors(60), dtype=np.float32)
COLORS60[-1] = 0.0


def apply_semantic_colormap(sem: np.ndarray) -> np.ndarray:
    """Label-index map [F, H, W] -> color video [F, 3, H, W] in [0, 1]
    (reference _apply_semantic_colormap, dataset.py:642-658)."""
    return COLORS60[sem.astype(np.int64) % 60].transpose(0, 3, 1, 2) / 255.0


# -- raw-frame transforms (reference dataset.py:253-298) ---------------------

def aspect_resize_hw(ori_size, video_size) -> Tuple[int, int]:
    """Aspect-preserving intermediate size: the dimension that would leave
    letterboxing is scaled so the center crop to video_size is tight."""
    ori_h, ori_w = ori_size
    if (video_size[1] / video_size[0]) < (ori_w / ori_h):
        return video_size[0], int(ori_w * (video_size[0] / ori_h))
    return int(ori_h * (video_size[1] / ori_w)), video_size[1]


def _resize(frames: np.ndarray, hw, nearest: bool = False) -> np.ndarray:
    """[F, H, W(, C)] resize via cv2 (bilinear ~ torchvision Resize)."""
    import cv2

    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    out = [cv2.resize(f, (int(hw[1]), int(hw[0])), interpolation=interp)
           for f in frames]
    return np.stack(out)


def _center_crop(frames: np.ndarray, hw) -> np.ndarray:
    th, tw = int(hw[0]), int(hw[1])
    H, W = frames.shape[1], frames.shape[2]
    top, left = max(0, (H - th) // 2), max(0, (W - tw) // 2)
    out = frames[:, top:top + th, left:left + tw]
    if out.shape[1] != th or out.shape[2] != tw:  # pad when smaller
        ph, pw = th - out.shape[1], tw - out.shape[2]
        pad = ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
        out = np.pad(out, pad + ((0, 0),) * (out.ndim - 3))
    return out


def video_transform(frames_u8: np.ndarray, ori_size, video_size,
                    normalize: bool = True) -> np.ndarray:
    """[F, H, W, 3] uint8 -> float32 [F, 3, H', W'] in [-1, 1]: /255,
    aspect-preserving bilinear resize, center crop, normalize (reference
    video_transforms)."""
    x = frames_u8.astype(np.float32) / 255.0
    x = _resize(x, aspect_resize_hw(ori_size or frames_u8.shape[1:3], video_size))
    x = _center_crop(x, video_size)
    if normalize:
        x = x * 2.0 - 1.0
    return x.transpose(0, 3, 1, 2)


def cond_transform(maps: np.ndarray, ori_size, video_size,
                   nearest: bool = False) -> np.ndarray:
    """Reference depth/label_transforms: resize shorter side to ori_h,
    center-crop (ori_h, ori_w), then aspect resize + crop to video_size.
    maps: [F, H, W] (depth) or [F, 3, H, W] already-colored labels."""
    chan_first = maps.ndim == 4
    if chan_first:
        maps = maps.transpose(0, 2, 3, 1)
    ori_h, ori_w = ori_size
    h, w = maps.shape[1], maps.shape[2]
    if min(h, w) != ori_h:
        s = ori_h / min(h, w)
        maps = _resize(maps, (round(h * s), round(w * s)), nearest)
    maps = _center_crop(maps, (ori_h, ori_w))
    maps = _resize(maps, aspect_resize_hw((ori_h, ori_w), video_size), nearest)
    maps = _center_crop(maps, video_size)
    if chan_first:
        return maps.transpose(0, 3, 1, 2)
    return maps


@dataclasses.dataclass
class DatasetConfig:
    """Field names mirror the reference YAML dataset blocks
    (config/base_train.yaml)."""

    data_root: str = "./data"
    split: str = "train"
    num_samples: int = -1
    sample_mode: str = "random"
    seed: int = 42
    camera_ids: Sequence[int] = (0,)
    max_n_view: int = 1
    n_view: Optional[int] = None
    action_dim: int = 7
    sequence_interval: int = 1
    sequence_length: int = 16
    sample_frames: int = 17
    start_frame_interval: Any = 4  # int or {split: int}
    video_size: Tuple[int, int] = (320, 480)
    sample_size: Tuple[int, int] = (40, 60)
    caption_column: str = "texts"
    embeddings_folder: str = "embeddings_full"
    annotations_folder: str = "annotations"
    load_actions: bool = True
    load_tensors: bool = True
    slice_frame: bool = True
    drop_last: bool = True
    use_3dvae: bool = True
    vae_has_first_single_frame: bool = True
    use_cond: bool = False
    filter_by_cond: bool = False
    no_traj: bool = False
    empty_prompt: bool = True
    control_keys: Sequence[str] = ("depth", "label")
    accumulate_action: bool = False
    # multi-ref conditioning (reference ref_num / num_observation: [1,5,9],
    # dataset.py:609-633): int, or list sampled per batch by BucketSampler
    ref_num: Any = 1
    # raw-frame paths
    ori_size: Optional[Tuple[int, int]] = None  # source video (h, w)
    renderings_folder: str = "renderings"
    load_condGT: bool = False
    load_video: bool = False  # also return GT rgb frames (demo/eval compare)
    test_mode: bool = False

    def start_interval(self) -> int:
        if isinstance(self.start_frame_interval, dict):
            return int(self.start_frame_interval[self.split])
        return int(self.start_frame_interval)

    def ref_num_choices(self) -> List[int]:
        r = self.ref_num
        return [int(x) for x in r] if isinstance(r, (list, tuple)) else [int(r)]


def _load_tensor_file(path_base: str) -> Optional[np.ndarray]:
    """Load `<base>.npz` (ours) or `<base>.pt` (reference torch.save)."""
    npz = path_base + ".npz"
    if os.path.exists(npz):
        with np.load(npz) as f:
            return f[f.files[0]]
    pt = path_base + ".pt"
    if os.path.exists(pt):
        import torch

        t = torch.load(pt, map_location="cpu", weights_only=True)
        return t.float().numpy()
    return None


class RobotDataset:
    """Map-style dataset over fixed-length episode slices."""

    def __init__(self, config: DatasetConfig):
        self.config = config
        self.c_act_scaler = C_ACT_SCALER[: config.action_dim].copy()
        ann_dir = Path(config.data_root) / config.annotations_folder / config.split
        self.ann_files = sorted(str(p) for p in ann_dir.glob("*.json"))
        self._emb_dir = Path(config.data_root) / config.embeddings_folder / config.split
        self._init_sequences()
        CONSOLE.log(
            f"RobotDataset[{config.split}]: {len(self.ann_files)} episodes, "
            f"{len(self.samples)} samples"
        )

    # -- sample index ------------------------------------------------------

    def _slice_episode(self, ann: Dict, ann_file: str) -> List[Dict]:
        cfg = self.config
        n_frames = len(ann["state"])
        samples = []
        if cfg.slice_frame:
            start0 = cfg.sequence_interval if cfg.vae_has_first_single_frame else 0
            stride = cfg.start_interval() * cfg.sequence_interval
            for frame_i in range(start0, n_frames, stride):
                frame_ids = list(
                    range(frame_i, n_frames, cfg.sequence_interval)
                )[: cfg.sequence_length]
                if len(frame_ids) != cfg.sequence_length:
                    continue
                if cfg.vae_has_first_single_frame:
                    frame_ids.insert(0, frame_i - cfg.sequence_interval)
                samples.append(self._make_sample(ann, ann_file, frame_ids, True))
        else:
            if cfg.drop_last:
                crop = (n_frames // 8) * 8 + 1
                if crop > n_frames:
                    crop = (n_frames // 8 - 1) * 8 + 1
                n_frames = crop
            frame_ids = list(range(n_frames))
            samples.append(self._make_sample(ann, ann_file, frame_ids, False))
        return samples

    def _make_sample(self, ann, ann_file, frame_ids, is_sliced) -> Dict:
        prompts = ann.get(self.config.caption_column) or [""]
        return dict(
            episode_id=ann["episode_id"],
            ann_file=ann_file,
            prompt=prompts[0],
            frame_ids=frame_ids,
            start_frame_idx=frame_ids[0],
            num_frame=len(frame_ids),
            is_sliced=is_sliced,
        )

    def _init_sequences(self):
        samples: List[Dict] = []
        with ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(self._load_ann, f) for f in self.ann_files]
            for fut in as_completed(futs):
                samples.extend(fut.result())
        def ep_key(s):
            eid = str(s["episode_id"])
            return (0, int(eid)) if eid.isdigit() else (1, eid)

        samples.sort(key=lambda s: (ep_key(s), int(s["start_frame_idx"])))
        cfg = self.config
        if cfg.num_samples and cfg.num_samples > 0 and cfg.num_samples < len(samples):
            if cfg.sample_mode == "random":
                rng = random.Random(cfg.seed)
                keep = set(rng.sample(range(len(samples)), int(cfg.num_samples)))
                samples = [s for i, s in enumerate(samples) if i in keep]
            else:
                samples = samples[: int(cfg.num_samples)]
        self.samples = samples

    def _load_ann(self, ann_file: str) -> List[Dict]:
        try:
            with open(ann_file) as f:
                ann = json.load(f)
        except Exception:
            CONSOLE.log(f"failed to load {ann_file}; skipping")
            return []
        return self._slice_episode(ann, ann_file)

    def __len__(self):
        return len(self.samples)

    # -- item loading ------------------------------------------------------

    def _sample_name(self, sample: Dict, view: Optional[int] = None) -> str:
        eid = str(sample["episode_id"])
        eid = f"{int(eid):05d}" if eid.isdigit() else eid
        base = f"{eid}_{sample['frame_ids'][0]:02d}_{sample['num_frame']:02d}"
        return f"{base}_{view}" if view is not None else base

    def _load_latent(self, kind: str, sample: Dict, view: Optional[int] = None):
        base = str(self._emb_dir / kind / self._sample_name(sample, view))
        arr = _load_tensor_file(base)
        if arr is None and view == 0:  # single-view files may omit suffix
            arr = _load_tensor_file(str(self._emb_dir / kind / self._sample_name(sample)))
        return arr

    def _get_actions(self, ann: Dict, frame_ids: Sequence[int]) -> np.ndarray:
        states = np.asarray(ann["state"], dtype=np.float64)[list(frame_ids), :6]
        grip = np.asarray(ann["continuous_gripper_state"], dtype=np.float64)[list(frame_ids)]
        act = relative_actions(states, grip, accumulate=self.config.accumulate_action)
        return (act * self.c_act_scaler).astype(np.float32)

    # -- raw-frame paths (reference _get_frames / _get_cond_frames) ---------

    def _video_path(self, ann: Dict) -> str:
        v = ann.get("videos", [None])[0]
        if isinstance(v, dict):
            v = v.get("video_path")
        return str(Path(self.config.data_root) / v)

    def _render_path(self, sample: Dict) -> Optional[str]:
        """render.npz for the episode: the reference layout
        {data_root}/{renderings_folder}/render/{split}/{eid}.npz, else the
        factory's per-episode {data_root}/{eid}/render.npz."""
        cfg = self.config
        eid = str(sample["episode_id"])
        names = [eid, f"{int(eid):05d}" if eid.isdigit() else eid]
        for name in dict.fromkeys(names):
            p = Path(cfg.data_root) / cfg.renderings_folder / "render" / cfg.split / f"{name}.npz"
            if p.exists():
                return str(p)
            p = Path(cfg.data_root) / name / "render.npz"
            if p.exists():
                return str(p)
        return None

    def _get_raw_frames(self, sample: Dict, ann: Dict, ref_num: int) -> Dict[str, np.ndarray]:
        """Decode + transform raw video frames (reference _get_frames raw
        branch, dataset.py:697-716): videos [F, 3, H, W] in [-1, 1] and the
        first ref_num frames as the reference images."""
        from orv_tpu_torch.utils.video import read_video

        cfg = self.config
        frames = read_video(self._video_path(ann), sample["frame_ids"])
        vids = video_transform(frames, cfg.ori_size, cfg.video_size)
        return {"videos": vids.astype(np.float32),
                "image": vids[:ref_num].astype(np.float32)}

    def _get_cond_raw(self, sample: Dict, view_ids=(0,), num_view: int = 1) -> Dict[str, np.ndarray]:
        """Raw condition maps (reference _get_cond_frames raw branch,
        dataset.py:853-917): render.npz depths clamped [0.01,0.4]*2.5 and
        semantics through the 60-color map; or the GT variant from
        {renderings_folder}/points|semantics per-frame files."""
        cfg = self.config
        frame_ids = list(sample["frame_ids"])
        out: Dict[str, np.ndarray] = {}

        if not cfg.load_condGT:
            rp = self._render_path(sample)
            if rp is None:
                raise FileNotFoundError(f"no render.npz for episode {sample['episode_id']}")
            data = np.load(rp)
            ori = cfg.ori_size or tuple(data["depths"].shape[-2:])

            def pick_views(x):
                if x.ndim == 3:  # legacy [F*V, h, w]
                    x = x.reshape(-1, num_view, *x.shape[-2:])
                x = x[frame_ids]
                x = np.stack([x[:, v] for v in view_ids], axis=1)
                return x.transpose(1, 0, 2, 3).reshape(-1, *x.shape[-2:])  # [v*f,h,w]

            if "depth" in cfg.control_keys:
                d = pick_views(data["depths"].astype(np.float32))
                d = cond_transform(d, ori, cfg.video_size)[:, None]  # [F,1,H,W]
                out["depths"] = (np.clip(d, 0.01, 0.4) * 2.5).astype(np.float32)
            if "label" in cfg.control_keys and bool(np.asarray(data["is_labeled"]).all()):
                s = pick_views(data["semantics"])
                lab = apply_semantic_colormap(s)  # [F, 3, h, w]
                out["labels"] = cond_transform(
                    lab, ori, cfg.video_size, nearest=True).astype(np.float32)
        else:
            import fnmatch

            eid = str(sample["episode_id"])
            base = Path(cfg.data_root) / cfg.renderings_folder
            ori = cfg.ori_size
            if "depth" in cfg.control_keys:
                rdir = base / "points" / cfg.split / eid
                files = sorted(fnmatch.filter(os.listdir(rdir), "frame_*.npy"))
                d = np.stack([np.load(rdir / files[i]) for i in frame_ids]).astype(np.float32)
                out["depths"] = cond_transform(
                    d, ori or d.shape[-2:], cfg.video_size)[:, None].astype(np.float32)
            if "label" in cfg.control_keys:
                ldir = base / "semantics" / cfg.split / eid
                files = sorted(fnmatch.filter(os.listdir(ldir), "frame_*.npz"))
                lab = np.stack([
                    np.load(ldir / files[i])["annotated_frame_color"] for i in frame_ids
                ]).astype(np.float32).transpose(0, 3, 1, 2)
                out["labels"] = cond_transform(
                    lab, ori or lab.shape[-2:], cfg.video_size, nearest=True
                ).astype(np.float32)
        return out

    def _draw_ref_num(self, override: Optional[int] = None) -> int:
        if override is not None:
            return int(override)
        return random.choice(self.config.ref_num_choices())

    def __getitem__(self, idx) -> Dict[str, Any]:
        # a batch sampler may pass (index, ref_num, n_view) so batches stay
        # shape-homogeneous
        ref_num = n_view = None
        if isinstance(idx, tuple):
            idx, ref_num, n_view = (tuple(idx) + (None, None))[:3]
        try:
            return self._getitem(idx, ref_num=ref_num, n_view=n_view)
        except Exception:
            if os.environ.get("DEBUG"):
                raise
            # reference behavior: resample another index on a bad sample —
            # retried a few times so one resample landing on another (or the
            # same) bad sample doesn't kill a multi-day run
            last: Exception
            for _ in range(10):
                try:
                    return self._getitem(random.randrange(len(self.samples)),
                                         ref_num=ref_num, n_view=n_view)
                except Exception as e:  # noqa: BLE001
                    last = e
            raise last

    def _getitem(self, idx: int, ref_num: Optional[int] = None,
                 n_view: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.config
        sample = self.samples[idx]
        ref_num = self._draw_ref_num(ref_num)
        with open(sample["ann_file"]) as f:
            ann = json.load(f)

        out: Dict[str, Any] = dict(
            prompt="" if cfg.empty_prompt else sample["prompt"],
            metainfo=dict(
                episode_id=sample["episode_id"],
                start_frame_idx=sample["start_frame_idx"],
                num_frame=sample["num_frame"],
                ref_num=ref_num,
            ),
            num_views=1,
        )
        if cfg.load_actions and not cfg.no_traj:
            out["actions"] = self._get_actions(ann, sample["frame_ids"])

        if cfg.load_tensors:
            lat = self._load_latent("latents", sample, view=0)
            if lat is None:
                raise FileNotFoundError(
                    f"missing latents for {self._sample_name(sample)} in {self._emb_dir}"
                )
            out["latents"] = lat.astype(np.float32)  # [2C, F, H, W] moments
            out.update(self._image_latents(sample, ref_num, out["latents"]))
            emb = self._load_latent("prompt_embeds", sample, view=0)
            if emb is None:
                empty = str(self._emb_dir / "prompt_embeds" / "empty")
                arr = _load_tensor_file(empty)
                if arr is not None:
                    emb = arr
            if emb is not None:
                out["prompt_embeds"] = emb.astype(np.float32)
            if cfg.use_cond:
                for key in cfg.control_keys:
                    ctrl = self._load_latent(f"{key}_latents", sample, view=0)
                    if ctrl is None:
                        raise FileNotFoundError(f"missing {key} latents for sample {idx}")
                    out[f"latents_{key}"] = ctrl.astype(np.float32)
        else:
            out.update(self._get_raw_frames(sample, ann, ref_num))
            if cfg.use_cond and not cfg.test_mode:
                out.update(self._get_cond_raw(sample))
        return out

    def _image_latents(self, sample: Dict, ref_num: int, video_moments) -> Dict[str, Any]:
        """Reference-image latents for ref_num observed frames. Multi-ref
        files carry a _ref{r} suffix (written by encode_dataset --ref_nums);
        when absent, the first (r+3)//4 latent frames of the video moments
        stand in — exact for the causal VAE up to per-chunk GroupNorm
        statistics (reference dataset.py:609-633 + num_observation recipes)."""
        if ref_num <= 1:
            img = self._load_latent("image_latents", sample, view=0)
            return {} if img is None else {"image_latents": img.astype(np.float32)}
        name = self._sample_name(sample) + f"_ref{ref_num}"
        img = _load_tensor_file(str(self._emb_dir / "image_latents" / name))
        if img is None:
            img = video_moments[:, : (ref_num + 3) // 4]
        return {"image_latents": img.astype(np.float32)}


class CascadedRobotDataset(RobotDataset):
    """Long-horizon eval: consecutive slices of each episode labeled with
    `sample_index` / `is_last` / `next_start_frame_idx` so the eval loop can
    chain chunks, feeding the frame at next_start_frame_idx back as the
    next chunk's reference image (reference dataset.py:1227-1509)."""

    def _slice_episode(self, ann, ann_file):
        cfg = self.config
        n_frames = len(ann["state"])
        span = (cfg.sequence_length - 1) * cfg.sequence_interval + 1
        starts = list(range(cfg.sequence_interval, n_frames - span + 1, span))
        # regrow a final partial slice backward to full length
        last_start = starts[-1] + span if starts else cfg.sequence_interval
        if last_start + span > n_frames and last_start < n_frames:
            back_start = n_frames - span
            if back_start > 0:
                starts.append(back_start)
        elif last_start + span <= n_frames:
            starts.append(last_start)

        samples = []
        for si, frame_i in enumerate(starts):
            frame_ids = list(range(frame_i, n_frames, cfg.sequence_interval))[: cfg.sequence_length]
            if len(frame_ids) != cfg.sequence_length:
                continue
            if cfg.vae_has_first_single_frame:
                # the regrown last chunk can start before one interval of
                # history exists (back_start < interval) — clamp instead of
                # letting numpy fancy-indexing wrap -1 to the episode END
                frame_ids.insert(0, max(frame_i - cfg.sequence_interval, 0))
            s = self._make_sample(ann, ann_file, frame_ids, True)
            s["sample_index"] = si
            s["is_last"] = si == len(starts) - 1
            s["next_start_frame_idx"] = (
                None if si == len(starts) - 1
                else starts[si + 1] - cfg.sequence_interval - frame_ids[0]
            )
            samples.append(s)
        return samples

    def _getitem(self, idx, ref_num=None, n_view=None):
        out = super()._getitem(idx, ref_num=ref_num, n_view=n_view)
        s = self.samples[idx]
        out["metainfo"].update(
            sample_index=s["sample_index"], is_last=s["is_last"],
            next_start_frame_idx=s["next_start_frame_idx"],
        )
        return out


class MultiViewRobotDataset(RobotDataset):
    """n_view <= max_n_view views per sample; per-view latents are stacked
    along the frame axis `(v f)` (orv_tpu dataset.py:547). Item keys as
    the single-view dataset's, with `num_views` the sample's view count.

    View-count subsampling for training happens at sample level, seeded at
    init (`seed + 1`), so BucketSampler buckets stay shape-homogeneous;
    `view_data_ratio` caps the share of single-view samples when multiview
    data exists (`seed + 2`)."""

    # per-view-count data-ratio rebalancing: -1 leaves a view count alone
    view_data_ratio = {1: 0.4, 2: -1.0, 3: -1.0}

    def __init__(self, config: DatasetConfig, train_view_sampling: bool = True):
        self.train_view_sampling = train_view_sampling and config.split == "train"
        super().__init__(config)
        if self.train_view_sampling:
            self._rebalance_views()
            rng = random.Random(config.seed + 1)
            for s in self.samples:
                if s["n_view"] > 1:
                    s["n_view_use"] = rng.randint(1, s["n_view"])
                else:
                    s["n_view_use"] = s["n_view"]
        else:
            for s in self.samples:
                s["n_view_use"] = s["n_view"]

    def _rebalance_views(self):
        n_views = np.array([s["n_view"] for s in self.samples])
        counts = {v: int((n_views == v).sum()) for v in sorted(set(n_views.tolist()))}
        if sum(c > 0 for v, c in counts.items() if v > 1) == 0:
            return  # no multiview data: nothing to rebalance against
        total = len(self.samples)
        rng = random.Random(self.config.seed + 2)
        keep = np.ones(total, dtype=bool)
        for v, c in counts.items():
            ratio = self.view_data_ratio.get(int(v), -1.0)
            if ratio > 0 and c / total > ratio:
                idxs = np.where(n_views == v)[0].tolist()
                kept = set(rng.sample(idxs, min(c, int(ratio * total))))
                for i in idxs:
                    if i not in kept:
                        keep[i] = False
                CONSOLE.log(f"rebalance: n_view={v} {c} -> {len(kept)} samples")
        self.samples = [s for i, s in enumerate(self.samples) if keep[i]]

    def _make_sample(self, ann, ann_file, frame_ids, is_sliced):
        s = super()._make_sample(ann, ann_file, frame_ids, is_sliced)
        n_view = self.config.n_view or self.config.max_n_view
        for v in range(n_view):
            s[f"has_image_{v}"] = bool(ann.get(f"has_image_{v}", True))
        s["n_view"] = sum(s[f"has_image_{v}"] for v in range(n_view))
        return s

    def _getitem(self, idx, ref_num=None, n_view=None):
        cfg = self.config
        sample = self.samples[idx]
        if n_view is None:
            n_view = sample.get("n_view_use", sample["n_view"])
        n_view = min(int(n_view), sample["n_view"])
        ref_num = self._draw_ref_num(ref_num)

        with open(sample["ann_file"]) as f:
            ann = json.load(f)
        out: Dict[str, Any] = dict(
            prompt="" if cfg.empty_prompt else sample["prompt"],
            metainfo=dict(
                episode_id=sample["episode_id"],
                start_frame_idx=sample["start_frame_idx"],
                num_frame=sample["num_frame"],
                ref_num=ref_num,
            ),
            num_views=n_view,
        )
        if cfg.load_actions and not cfg.no_traj:
            out["actions"] = self._get_actions(ann, sample["frame_ids"])

        def stack_views(kind):
            per_view = [self._load_latent(kind, sample, view=v) for v in range(n_view)]
            if any(p is None for p in per_view):
                return None
            return np.concatenate([p.astype(np.float32) for p in per_view], axis=1)

        if cfg.load_tensors:
            lat = stack_views("latents")
            if lat is None:
                raise FileNotFoundError(f"missing multiview latents for sample {idx}")
            out["latents"] = lat  # [2C, V*F, H, W]
            img = stack_views("image_latents")
            if img is not None:
                out["image_latents"] = img
            emb = self._load_latent("prompt_embeds", sample, view=0)
            if emb is None:
                emb = _load_tensor_file(str(self._emb_dir / "prompt_embeds" / "empty"))
            if emb is not None:
                out["prompt_embeds"] = emb.astype(np.float32)
            if cfg.use_cond:
                for key in cfg.control_keys:
                    ctrl = stack_views(f"{key}_latents")
                    if ctrl is None:
                        raise FileNotFoundError(f"missing {key} latents for sample {idx}")
                    out[f"latents_{key}"] = ctrl
        return out


class DemoRobotDataset(RobotDataset):
    """Folder-per-episode demo layout (reference dataset.py:1512-1711):
    {data_root}/{episode}/rgb/*.png|jpg + {episode}/annotations.json with
    state / continuous_gripper_state / texts. Loads raw frames (no
    pre-encoded latents) for single-episode demo inference."""

    def __init__(self, config: DatasetConfig):
        self.config = config
        self.c_act_scaler = C_ACT_SCALER[: config.action_dim].copy()
        root = Path(config.data_root)
        self.ann_files = sorted(
            str(p) for p in root.glob("*/annotations.json")
        )
        self._emb_dir = root / "unused"
        self._init_sequences()
        CONSOLE.log(f"DemoRobotDataset: {len(self.ann_files)} episodes, "
                    f"{len(self.samples)} samples")

    def _load_ann(self, ann_file: str):
        try:
            with open(ann_file) as f:
                ann = json.load(f)
        except Exception:
            return []
        ann.setdefault("episode_id", Path(ann_file).parent.name)
        return self._slice_episode(ann, ann_file)

    def _frame_paths(self, ann_file: str):
        rgb = Path(ann_file).parent / "rgb"
        return sorted(list(rgb.glob("*.png")) + list(rgb.glob("*.jpg")))

    def _getitem(self, idx: int, ref_num=None, n_view=None):
        from orv_tpu_torch.utils.video import read_image

        cfg = self.config
        sample = self.samples[idx]
        with open(sample["ann_file"]) as f:
            ann = json.load(f)
        frames = self._frame_paths(sample["ann_file"])
        ref_path = frames[sample["frame_ids"][0]]
        ref = read_image(ref_path).astype(np.float32) / 255.0
        out = dict(
            prompt="" if cfg.empty_prompt else (ann.get(cfg.caption_column) or [""])[0],
            metainfo=dict(episode_id=str(sample["episode_id"]),
                          start_frame_idx=sample["start_frame_idx"],
                          num_frame=sample["num_frame"]),
            num_views=1,
            ref_image=ref * 2.0 - 1.0,  # [H, W, 3] in [-1, 1]
        )
        if cfg.load_video:
            # full GT rgb clip (reference demo dataset :1512-1711 loads all
            # frames so the demo can compare generated vs. real)
            imgs = np.stack([
                read_image(frames[i])
                for i in sample["frame_ids"]
            ])
            out["videos"] = video_transform(imgs, cfg.ori_size, cfg.video_size)
        if cfg.load_actions and not cfg.no_traj:
            out["actions"] = self._get_actions(ann, sample["frame_ids"])
        return out


class BucketSampler:
    """Groups samples into homogeneous (ref_num, n_view) batches: a fresh
    ref_num draw and the sample's view count key the bucket, and each
    yielded batch entry is an (index, ref_num, n_view) tuple the dataset
    honors in __getitem__, so every batch stacks to one shape. Flushes a
    bucket when it reaches batch_size; iterates forever when `infinite`.
    The draws come from `random.Random(seed)` in the JAX package's order,
    so both yield the same index lists."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, infinite: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.infinite = infinite

    def _key(self, i, rng) -> Tuple[int, int]:
        s = self.dataset.samples[i]
        ref_num = rng.choice(self.dataset.config.ref_num_choices())
        return (ref_num, s.get("n_view_use", s.get("n_view", 1)))

    def __iter__(self):
        rng = random.Random(self.seed)
        while True:
            order = list(range(len(self.dataset)))
            if self.shuffle:
                rng.shuffle(order)
            buckets: Dict[Tuple, List[Tuple]] = {}
            for i in order:
                key = self._key(i, rng)
                b = buckets.setdefault(key, [])
                b.append((i, key[0], key[1]))
                if len(b) == self.batch_size:
                    yield list(b)
                    b.clear()
            if not self.infinite:
                for b in buckets.values():  # flush remainders
                    if b:
                        yield list(b)
                return


def collate_control(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-sample dicts into batch arrays (reference
    CollateFunctionControl, dataset.py:2053-2150). Tensor keys stack to
    [B, ...]; metainfos/prompts stay lists."""
    batch: Dict[str, Any] = {}
    keys = items[0].keys()
    for k in keys:
        vals = [it[k] for it in items]
        if k in ("metainfo", "prompt"):
            batch[k + "s" if not k.endswith("s") else k] = vals
        elif k == "num_views":
            batch[k] = vals[0]
        elif isinstance(vals[0], np.ndarray):
            batch[k] = np.stack(vals, axis=0)
        else:
            batch[k] = vals
    return batch
