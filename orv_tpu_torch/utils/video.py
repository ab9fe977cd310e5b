"""Video and image IO (mp4/gif) with imageio -> OpenCV -> Pillow fallbacks.

Counterpart of `orv_tpu/utils/video.py`, with the same chain of writers and
readers. Neither imageio nor its ffmpeg plugin is guaranteed to be
installed, so every path degrades to OpenCV (mp4 and frame reads) or Pillow
(gif and image reads).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def write_video(path: str, frames: np.ndarray, fps: int = 8) -> str:
    """frames [T, H, W, 3] uint8 -> mp4 (or .gif fallback). Returns the
    path actually written."""
    path = str(path)
    try:
        import imageio

        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    except Exception:
        pass
    try:
        import cv2

        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return path
    except Exception:
        pass
    return write_gif(path, frames, fps=fps)


def write_gif(path: str, frames: np.ndarray, fps: int = 8) -> str:
    """frames [T, H, W, 3] uint8 -> animated gif beside `path` (the
    evaluation exports one beside every mp4). Returns the gif's path."""
    path = str(Path(path).with_suffix(".gif"))
    try:
        import imageio
    except ImportError:
        from PIL import Image

        images = [Image.fromarray(np.asarray(f)) for f in frames]
        images[0].save(path, save_all=True, append_images=images[1:],
                       duration=1000.0 / max(fps, 1), loop=0)
        return path
    try:
        imageio.mimwrite(path, list(frames), fps=fps)
    except TypeError:  # imageio v3 gif writer takes duration, not fps
        imageio.mimwrite(path, list(frames), duration=1000.0 / max(fps, 1))
    return path


def read_video(path: str, frame_ids: Optional[Sequence[int]] = None) -> np.ndarray:
    """-> [T, H, W, 3] uint8 (all frames, or the requested ids in order)."""
    frames = _read_all(path)
    if frame_ids is not None:
        frames = [frames[i] for i in frame_ids]
    return np.stack(frames)


def _read_all(path: str) -> List[np.ndarray]:
    try:
        import imageio

        return [np.asarray(f) for f in imageio.mimread(path, memtest=False)]
    except Exception:
        pass
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise RuntimeError(f"could not read any frames from {path}")
    return frames


def read_image(path: str) -> np.ndarray:
    """One image file -> [H, W, C] uint8, as `imageio.imread` gives it."""
    try:
        import imageio

        return np.asarray(imageio.imread(path))
    except ImportError:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im)
