"""Raw robot-dataset extraction -> per-episode mp4 + annotation json
(DROID / BridgeV2 TFDS), in numpy and OpenCV.

Counterpart of `orv_tpu/pipelines/data_process.py`, the same code but for
the imports. The TFDS readers are pluggable `episode_source` iterators;
the droid and bridgev2 sources import tensorflow_datasets when they start
and raise by name without it. The writer side (multi-camera mp4 export
through `utils/video.py:write_video`, OpenCV's `mp4v` where imageio is
absent; the annotation schema: episode_id, texts, videos, state,
continuous_gripper_state, has_image_k; the bounded worker pool) matches
what `orv_tpu_torch.data.RobotDataset` consumes.

Usage:
  python -m orv_tpu_torch.pipelines.data_process --dataset bridgev2 \
      --tfds_dir <dir> --output_dir <dir> [--split train] [--max_episodes N]
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from orv_tpu_torch.utils.logging import CONSOLE
from orv_tpu_torch.utils.video import write_video

# episode dict schema expected from any source:
#   {"episode_id": str, "texts": [str], "frames": {cam_id: [T,H,W,3] uint8},
#    "state": [T, >=6], "continuous_gripper_state": [T], "action": optional,
#    "has_image": optional {cam_id: bool} — absent cameras recorded as
#    explicit has_image_k=False flags (BridgeV2 camera availability varies
#    per episode; the multiview dataset keys view sampling off these)}
EpisodeSource = Iterator[Dict]

_SOURCES: Dict[str, Callable[..., EpisodeSource]] = {}


def register_source(name: str):
    def deco(fn):
        _SOURCES[name] = fn
        return fn
    return deco


def _center_crop(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """[T, H, W, 3] -> center crop (reference torchvision CenterCrop
    semantics for the crop-only case: H >= h, W >= w)."""
    t = (frames.shape[1] - h) // 2
    l = (frames.shape[2] - w) // 2
    return frames[:, t:t + h, l:l + w]


def _tfds(source: str):
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:
        raise RuntimeError(f"the {source} source reads TFDS and needs tensorflow_datasets, "
                           "which does not import") from e
    return tfds


def _resize(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """[T, H, W, 3] -> bilinear resize to (h, w) via cv2."""
    if frames.shape[1] == h and frames.shape[2] == w:
        return frames
    import cv2

    return np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                     for f in frames])


@register_source("droid")
def droid_source(tfds_dir: str, split: str = "train") -> EpisodeSource:
    """DROID TFDS reader — requires tensorflow_datasets. Reference parity
    (data_process.py:40-118): THREE camera streams (exterior_image_1_left,
    exterior_image_2_left, wrist_image_left), all center-cropped to
    176x320; texts carry language_instruction 1/2/3; `action` is the
    concat of cartesian_velocity + gripper_position from action_dict;
    state/gripper from the observation stream."""
    tfds = _tfds("droid")
    ds = tfds.load("droid", data_dir=tfds_dir, split=split)
    cams = ("exterior_image_1_left", "exterior_image_2_left", "wrist_image_left")
    for i, ep in enumerate(tfds.as_numpy(ds)):
        steps = list(ep["steps"])
        texts = []
        for key in ("language_instruction", "language_instruction_2",
                    "language_instruction_3"):
            raw = steps[0].get(key, b"")
            texts.append(raw.decode() if isinstance(raw, bytes) else str(raw))
        action = None
        if "action_dict" in steps[0]:
            action = np.stack([
                np.concatenate([
                    np.asarray(s["action_dict"]["cartesian_velocity"]).reshape(-1),
                    np.asarray(s["action_dict"]["gripper_position"]).reshape(-1),
                ]) for s in steps
            ]).tolist()
        out = dict(
            episode_id=f"{i:05d}",
            texts=texts,
            frames={c: _center_crop(
                np.stack([s["observation"][cam] for s in steps]), 176, 320)
                for c, cam in enumerate(cams)},
            state=np.stack([s["observation"]["cartesian_position"] for s in steps]).tolist(),
            continuous_gripper_state=np.stack(
                [s["observation"]["gripper_position"] for s in steps]
            ).reshape(-1).tolist(),
        )
        if action is not None:
            out["action"] = action
        yield out


@register_source("bridgev2")
def bridgev2_source(tfds_dir: str, split: str = "train") -> EpisodeSource:
    """BridgeV2 TFDS reader — requires tensorflow_datasets. Reference
    parity (data_process.py:148-280): FOUR candidate camera streams
    image_0..image_3 with per-episode availability probed from the first
    frame's content (sum > 0), resized to 480x640; absent cameras are
    recorded as has_image_k=False in the annotation; texts gated on
    has_language; action from the step stream; gripper = state[6]."""
    tfds = _tfds("bridgev2")
    ds = tfds.load("bridge_dataset", data_dir=tfds_dir, split=split)
    for i, ep in enumerate(tfds.as_numpy(ds)):
        steps = list(ep["steps"])
        obs0 = steps[0]["observation"]
        has = {c: bool(np.sum(obs0[f"image_{c}"]) > 0.0) for c in range(4)
               if f"image_{c}" in obs0}
        meta = ep.get("episode_metadata", {})
        has_language = bool(meta.get("has_language", True))
        raw = steps[0].get("language_instruction", b"") if has_language else b""
        yield dict(
            episode_id=f"{i:05d}",
            texts=[raw.decode() if isinstance(raw, bytes) else str(raw)],
            frames={c: _resize(
                np.stack([s["observation"][f"image_{c}"] for s in steps]),
                480, 640)
                for c, present in sorted(has.items()) if present},
            has_image=has,
            state=np.stack([s["observation"]["state"][:6] for s in steps]).tolist(),
            continuous_gripper_state=np.stack(
                [s["observation"]["state"][6] for s in steps]
            ).reshape(-1).tolist(),
            action=np.stack([s["action"] for s in steps]).tolist(),
        )


def write_episode(episode: Dict, out_root: str, split: str, fps: int = 8) -> str:
    """One episode -> videos/*.mp4 + annotations/{split}/{id}.json."""
    out = Path(out_root)
    (out / "videos").mkdir(parents=True, exist_ok=True)
    (out / "annotations" / split).mkdir(parents=True, exist_ok=True)
    eid = episode["episode_id"]
    videos = []
    ann = dict(
        episode_id=eid,
        texts=episode.get("texts", [""]),
        state=episode["state"],
        continuous_gripper_state=episode["continuous_gripper_state"],
    )
    # per-camera availability: explicit flags for EVERY candidate camera
    # (reference BridgeV2 annotations carry has_image_0..3 incl. False —
    # the multiview dataset keys view sampling off them); absent cameras
    # keep their index slot in `videos` as "none" like the reference.
    has = dict(episode.get("has_image") or
               {cam_id: True for cam_id in episode["frames"]})
    multi = len(has) > 1
    for cam_id in sorted(has):
        ann[f"has_image_{cam_id}"] = bool(has[cam_id])
        if not has[cam_id] or cam_id not in episode["frames"]:
            videos.append("none")
            continue
        name = f"videos/{eid}_{cam_id}.mp4" if multi else f"videos/{eid}.mp4"
        written = write_video(str(out / name),
                              np.asarray(episode["frames"][cam_id], np.uint8), fps)
        videos.append(str(Path(written).relative_to(out)))
    ann["videos"] = videos
    if "action" in episode:
        ann["action"] = episode["action"]
    path = out / "annotations" / split / f"{eid}.json"
    path.write_text(json.dumps(ann))
    return str(path)


def extract(
    source: EpisodeSource,
    out_root: str,
    split: str = "train",
    num_workers: int = 4,
    max_episodes: Optional[int] = None,
    queue_depth: int = 8,
):
    """Bounded-queue worker pool over the episode stream (reference
    spawn-pool data_process.py:346-503). Skip-if-exists restartable."""
    q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
    written: List[str] = []
    lock = threading.Lock()

    def worker():
        while True:
            ep = q.get()
            if ep is None:
                return
            ann_path = Path(out_root) / "annotations" / split / f"{ep['episode_id']}.json"
            if ann_path.exists():
                continue
            try:
                p = write_episode(ep, out_root, split)
            except Exception as e:  # noqa: BLE001 — a bad episode must not
                # kill the worker: with the pool dead the bounded q.put in
                # the producer blocks forever and the sentinels never land
                CONSOLE.log(f"[yellow]extract: episode "
                            f"{ep.get('episode_id')} failed: "
                            f"{type(e).__name__}: {e} — skipped")
                continue
            with lock:
                written.append(p)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(num_workers)]
    for t in threads:
        t.start()
    n = 0
    for ep in source:
        q.put(ep)
        n += 1
        if max_episodes and n >= max_episodes:
            break
    for _ in threads:
        q.put(None)
    for t in threads:
        t.join()
    CONSOLE.log(f"extracted {len(written)} new episodes (of {n} streamed) -> {out_root}")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True, choices=sorted(_SOURCES))
    p.add_argument("--tfds_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_episodes", type=int, default=None)
    args = p.parse_args(argv)
    source = _SOURCES[args.dataset](args.tfds_dir, args.split)
    extract(source, args.output_dir, args.split, args.num_workers, args.max_episodes)


if __name__ == "__main__":
    main()
