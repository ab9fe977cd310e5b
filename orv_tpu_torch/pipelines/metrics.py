"""Video quality metrics, in numpy and scipy, with the FID and FVD
feature networks in PyTorch.

Counterpart of `orv_tpu/pipelines/metrics.py`:

  * PSNR / SSIM: per-frame at 320x256 resize, data_range 1.0, averaged over
    frames then episodes
  * FID: the Fréchet distance over InceptionV3 pool3 features (2048-d) of
    the first 16 frames of each video
  * FVD: the Fréchet distance over I3D logits (400-d) at lengths 16..N

`compute_fid` and `compute_fvd` take the feature extractor as a callable
and raise without one; `main` builds them from `--inception_weights` and
`--i3d_weights`, folders of torchvision- / pytorch-i3d-named safetensors
(`models/feature_extractors.py`), and runs them in f32 with TF32 off.

Usage:
  python -m orv_tpu_torch.pipelines.metrics --gt_dir <dir> --pred_dir <dir> \
      [--output_csv metrics.csv] [--inception_weights <folder>] \
      [--i3d_weights <folder>] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from orv_tpu_torch.utils.logging import CONSOLE

METRIC_SIZE = (256, 320)  # (H, W) after resize, reference compute_metrics.py:63


def _resize_frame(frame: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize [H, W, C] float in [0,1]."""
    import cv2

    return cv2.resize(frame, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM over [H, W, C], skimage-default semantics (7x7 uniform
    window, unbiased covariance normalization, channels averaged) —
    implemented directly since skimage is not in the image."""
    from scipy.ndimage import uniform_filter

    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    NP = win_size**2
    cov_norm = NP / (NP - 1)  # unbiased
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    vals = []
    pad = (win_size - 1) // 2
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        ux = uniform_filter(x, win_size)
        uy = uniform_filter(y, win_size)
        uxx = uniform_filter(x * x, win_size)
        uyy = uniform_filter(y * y, win_size)
        uxy = uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
        vals.append(s[pad:-pad, pad:-pad].mean())  # crop the filter border
    return float(np.mean(vals))


def video_psnr_ssim(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """pred/gt [T, H, W, C] float in [0, 1] -> per-frame metrics averaged
    at the reference's 320x256 working size."""
    T = min(pred.shape[0], gt.shape[0])
    ps, ss = [], []
    for t in range(T):
        p = _resize_frame(pred[t], METRIC_SIZE)
        g = _resize_frame(gt[t], METRIC_SIZE)
        ps.append(psnr(p, g))
        ss.append(ssim(p, g))
    return float(np.mean(ps)), float(np.mean(ss))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (FID/FVD core)."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    return frechet_distance(*gaussian_stats(real), *gaussian_stats(fake))


def compute_fid(
    real_videos: Sequence[np.ndarray],
    fake_videos: Sequence[np.ndarray],
    features_fn: Optional[Callable] = None,
    num_frames: int = 16,
) -> float:
    """FID over the first `num_frames` frames of each video.
    features_fn: [N, H, W, 3] frames in [0,1] -> [N, D] features."""
    if features_fn is None:
        raise RuntimeError(
            "FID needs an image feature extractor (InceptionV3 pool3). Pass "
            "features_fn — pretrained weights are an external artifact."
        )
    def frames(videos):
        out = [v[: num_frames] for v in videos]
        return np.concatenate(out, axis=0)

    return fid_from_features(features_fn(frames(real_videos)), features_fn(frames(fake_videos)))


def compute_fvd(
    real_videos: Sequence[np.ndarray],
    fake_videos: Sequence[np.ndarray],
    features_fn: Optional[Callable] = None,
    lengths: Optional[Sequence[int]] = None,
) -> Dict[int, float]:
    """FVD at video lengths 16..N (reference :297-376).
    features_fn: [N, T, 224, 224, 3] in [0,1] -> [N, D]."""
    if features_fn is None:
        raise RuntimeError(
            "FVD needs a video feature extractor (I3D). Pass features_fn — "
            "pretrained weights are an external artifact."
        )
    max_t = min(min(v.shape[0] for v in real_videos), min(v.shape[0] for v in fake_videos))
    lengths = lengths or [l for l in (16, 32, 48, 64, max_t) if l <= max_t]
    out = {}
    for L in sorted(set(lengths)):
        r = np.stack([center_crop_resize(v[:L]) for v in real_videos])
        f = np.stack([center_crop_resize(v[:L]) for v in fake_videos])
        out[L] = fid_from_features(features_fn(r), features_fn(f))
    return out


def center_crop_resize(video: np.ndarray, size: int = 224) -> np.ndarray:
    """[T, H, W, C] -> [T, size, size, C] center crop then resize."""
    import cv2

    T, H, W, C = video.shape
    s = min(H, W)
    y, x = (H - s) // 2, (W - s) // 2
    out = np.empty((T, size, size, C), dtype=video.dtype)
    for t in range(T):
        out[t] = cv2.resize(video[t, y : y + s, x : x + s], (size, size),
                            interpolation=cv2.INTER_LINEAR)
    return out


# ---------------------------------------------------------------------------
# file pairing + CLI (reference :83-148)
# ---------------------------------------------------------------------------

def pair_files(gt_dir: str, pred_dir: str, suffix: str = ".mp4") -> List[Tuple[str, str]]:
    """Match prediction files to GT by shared stem (incl. per-view names)."""
    gt = {p.stem: p for p in Path(gt_dir).glob(f"*{suffix}")}
    pairs = []
    for p in sorted(Path(pred_dir).glob(f"*{suffix}")):
        if p.stem in gt:
            pairs.append((str(gt[p.stem]), str(p)))
    return pairs


def read_video(path: str) -> np.ndarray:
    """-> [T, H, W, 3] float32 in [0, 1]."""
    from orv_tpu_torch.utils.video import read_video as _rv

    return _rv(path).astype(np.float32) / 255.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--output_csv", default="metrics.csv")
    p.add_argument("--suffix", default=".mp4")
    p.add_argument("--inception_weights", default=None,
                   help="folder of InceptionV3 safetensors (torchvision naming): enables FID")
    p.add_argument("--i3d_weights", default=None,
                   help="folder of I3D safetensors (pytorch-i3d naming): enables FVD")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    args = p.parse_args(argv)

    pairs = pair_files(args.gt_dir, args.pred_dir, args.suffix)
    if not pairs:
        raise SystemExit(f"no (gt, pred) pairs found between {args.gt_dir} and {args.pred_dir}")
    rows = []
    gts, preds = [], []
    collect = bool(args.inception_weights or args.i3d_weights)
    for gt_path, pred_path in pairs:
        gt, pred = read_video(gt_path), read_video(pred_path)
        if collect:
            gts.append(gt)
            preds.append(pred)
        ps, ss = video_psnr_ssim(pred, gt)
        rows.append({"name": Path(pred_path).stem, "psnr": ps, "ssim": ss})
        CONSOLE.log(f"{Path(pred_path).stem}: PSNR {ps:.2f} SSIM {ss:.4f}")
    summary = {"name": "MEAN",
               "psnr": float(np.mean([r["psnr"] for r in rows])),
               "ssim": float(np.mean([r["ssim"] for r in rows]))}
    fields = ["name", "psnr", "ssim"]
    if collect:
        import torch

        # the feature networks run in f32, as the JAX package's do
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.inception_weights:
        from orv_tpu_torch.models.feature_extractors import inception_pool3_features

        fid = compute_fid(gts, preds, inception_pool3_features(args.inception_weights,
                                                               device=args.device))
        summary["fid"] = fid
        fields.append("fid")
        CONSOLE.log(f"FID: {fid:.3f}")
    if args.i3d_weights:
        from orv_tpu_torch.models.feature_extractors import i3d_features

        fvd = compute_fvd(gts, preds, i3d_features(args.i3d_weights, device=args.device))
        for L, val in fvd.items():
            summary[f"fvd_{L}"] = val
            fields.append(f"fvd_{L}")
            CONSOLE.log(f"FVD@{L}: {val:.3f}")
    with open(args.output_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
        w.writerow(summary)
    CONSOLE.log(f"wrote {args.output_csv} ({len(rows)} pairs)")
    return summary


if __name__ == "__main__":
    main()
