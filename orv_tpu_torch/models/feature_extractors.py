"""FID / FVD feature extractors, in PyTorch.

Counterpart of `orv_tpu/models/feature_extractors.py`:

  * InceptionV3 "pool3" (2048-d) for FID: torchvision's InceptionV3 as
    pytorch-fid wraps it, up to the global average pool (Mixed_7c with
    pytorch-fid's max pool, FIDInceptionE_2);
  * I3D (Kinetics-400 logits, 400-d) for FVD: pytorch-i3d's InceptionV1
    inflated to 3D, the head a spatial mean, the logits conv, then a
    temporal mean.

Layouts are PyTorch's channels-first (NCHW, NCDHW); the convolutions are
`nn.Conv2d` / `nn.Conv3d` (cuDNN on the card: the JAX package leaves them to
XLA, no Pallas kernel), in f32 as the JAX package runs them. Batch norm is
folded into each conv when the weights load (`fold_bn`, eps 1e-3), so a
`ConvBN` is conv + bias + ReLU. Module names follow the JAX modules
(`Mixed_5b.branch1x1.conv.weight`, `Mixed_3b.b0.conv.weight`, `logits.weight`).

Padding follows Flax's "SAME": the total pad of a dimension is
max((ceil(n / s) - 1) * s + k - n, 0), of which total // 2 goes before and
the rest after. With stride 1 and an odd kernel that is the symmetric
k // 2, which the conv pads itself; I3D's stride-2 conv (7^3 at 224: 2
before, 3 after) and stride-2 max pools pad explicitly, the pools with
-inf. Inception's average pools leave the pad out of the count.

The entry points read a folder of `*.safetensors` holding a torchvision /
pytorch-fid (Inception) or pytorch-i3d (I3D) state dict, as the JAX
package's do (`orv_tpu/models/weights.py:load_torch_state_dict` reads a
folder; its docstrings' ".pt/.pth" file reads as an empty dict there); a
file is refused by name.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from orv_tpu_torch.models.weights import load_diffusers_folder
from orv_tpu_torch.utils.device import DeviceLike, resolve_device


def same_pads(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int]):
    """Flax "SAME" pads [(before, after), ...] of each spatial dimension."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad(x, pads, value: float = 0.0):
    """F.pad of the trailing spatial dims by `pads` (first dim first)."""
    flat = [p for pair in reversed(pads) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


def max_pool_same(x, kernel, stride):
    """Flax `max_pool(..., padding="SAME")`: pad with -inf, then pool."""
    nd = len(kernel)
    x = _pad(x, same_pads(x.shape[-nd:], kernel, stride), float("-inf"))
    return (F.max_pool2d if nd == 2 else F.max_pool3d)(x, kernel, stride)


class ConvBN(nn.Module):
    """conv + (folded BN) bias + ReLU, 2-D or 3-D; `padding` "SAME" (Flax's)
    or "VALID"."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, ...], stride=None,
                 padding: str = "SAME", device=None):
        super().__init__()
        nd = len(kernel)
        self.kernel, self.stride = tuple(kernel), tuple(stride or (1,) * nd)
        self.same = padding == "SAME"
        # a symmetric SAME pad (stride 1, odd kernel) is left to the conv
        self.sym = self.same and all(s == 1 and k % 2 for k, s in zip(self.kernel, self.stride))
        conv = nn.Conv2d if nd == 2 else nn.Conv3d
        self.conv = conv(cin, cout, self.kernel, self.stride,
                         padding=tuple(k // 2 for k in self.kernel) if self.sym else 0,
                         bias=True, device=device)

    def forward(self, x):
        if self.same and not self.sym:
            x = _pad(x, same_pads(x.shape[-len(self.kernel):], self.kernel, self.stride))
        return F.relu(self.conv(x))


def fold_bn(kernel: np.ndarray, gamma, beta, mean, var, eps: float = 1e-3):
    """Fold BN into a torch-layout conv kernel [O, I, *k] and a bias:
    k' = k * g / sqrt(v + eps) per output channel, b' = beta - g * mean /
    sqrt(v + eps). The same products as the JAX package's `fold_bn` on its
    [*k, I, O] kernel, so the two agree bit for bit."""
    s = gamma / np.sqrt(var + eps)
    return kernel * s.reshape((-1,) + (1,) * (kernel.ndim - 1)), beta - mean * s


# ---------------------------------------------------------------------------
# InceptionV3 (pool3 / 2048-d, the FID network)
# ---------------------------------------------------------------------------

def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, device=None):
        super().__init__()
        c = lambda i, o, k: ConvBN(i, o, k, device=device)
        self.branch1x1 = c(cin, 64, (1, 1))
        self.branch5x5_1 = c(cin, 48, (1, 1))
        self.branch5x5_2 = c(48, 64, (5, 5))
        self.branch3x3dbl_1 = c(cin, 64, (1, 1))
        self.branch3x3dbl_2 = c(64, 96, (3, 3))
        self.branch3x3dbl_3 = c(96, 96, (3, 3))
        self.branch_pool = c(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, (3, 3), (2, 2), "VALID", device=device)
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1), device=device)
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), device=device)
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), (2, 2), "VALID", device=device)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, device=None):
        super().__init__()
        c = lambda i, o, k: ConvBN(i, o, k, device=device)
        self.branch1x1 = c(cin, 192, (1, 1))
        self.branch7x7_1 = c(cin, c7, (1, 1))
        self.branch7x7_2 = c(c7, c7, (1, 7))
        self.branch7x7_3 = c(c7, 192, (7, 1))
        self.branch7x7dbl_1 = c(cin, c7, (1, 1))
        self.branch7x7dbl_2 = c(c7, c7, (7, 1))
        self.branch7x7dbl_3 = c(c7, c7, (1, 7))
        self.branch7x7dbl_4 = c(c7, c7, (7, 1))
        self.branch7x7dbl_5 = c(c7, 192, (1, 7))
        self.branch_pool = c(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, (1, 1), device=device)
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), (2, 2), "VALID", device=device)
        self.branch7x7x3_1 = ConvBN(cin, 192, (1, 1), device=device)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), device=device)
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), device=device)
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), (2, 2), "VALID", device=device)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool: str = "avg", device=None):
        super().__init__()
        c = lambda i, o, k: ConvBN(i, o, k, device=device)
        self.branch1x1 = c(cin, 320, (1, 1))
        self.branch3x3_1 = c(cin, 384, (1, 1))
        self.branch3x3_2a = c(384, 384, (1, 3))
        self.branch3x3_2b = c(384, 384, (3, 1))
        self.branch3x3dbl_1 = c(cin, 448, (1, 1))
        self.branch3x3dbl_2 = c(448, 384, (3, 3))
        self.branch3x3dbl_3a = c(384, 384, (1, 3))
        self.branch3x3dbl_3b = c(384, 384, (3, 1))
        self.branch_pool = c(cin, 192, (1, 1))
        self.pool = pool  # pytorch-fid's FIDInceptionE_2 (Mixed_7c) max-pools

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = _avg_pool_same(x) if self.pool == "avg" else F.max_pool2d(x, 3, 1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Pool3(nn.Module):
    """torchvision InceptionV3 up to the global average pool: [N, 3, 299,
    299] in [-1, 1] -> [N, 2048]."""

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), (2, 2), "VALID", device=device)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3), padding="VALID", device=device)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), device=device)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1), padding="VALID", device=device)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3), padding="VALID", device=device)
        self.Mixed_5b = InceptionA(192, 32, device)
        self.Mixed_5c = InceptionA(256, 64, device)
        self.Mixed_5d = InceptionA(288, 64, device)
        self.Mixed_6a = InceptionB(288, device)
        self.Mixed_6b = InceptionC(768, 128, device)
        self.Mixed_6c = InceptionC(768, 160, device)
        self.Mixed_6d = InceptionC(768, 160, device)
        self.Mixed_6e = InceptionC(768, 192, device)
        self.Mixed_7a = InceptionD(768, device)
        self.Mixed_7b = InceptionE(1280, "avg", device)
        self.Mixed_7c = InceptionE(2048, "max", device)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# I3D (Kinetics-400, the FVD network)
# ---------------------------------------------------------------------------

class I3DMixed(nn.Module):
    """Inflated Inception module: [b0, (b1a -> b1b), (b2a -> b2b), (pool -> b3b)]."""

    def __init__(self, cin: int, ch: Tuple[int, int, int, int, int, int], device=None):
        super().__init__()
        c = lambda i, o, k: ConvBN(i, o, k, device=device)
        self.b0 = c(cin, ch[0], (1, 1, 1))
        self.b1a = c(cin, ch[1], (1, 1, 1))
        self.b1b = c(ch[1], ch[2], (3, 3, 3))
        self.b2a = c(cin, ch[3], (1, 1, 1))
        self.b2b = c(ch[3], ch[4], (3, 3, 3))
        self.b3b = c(cin, ch[5], (1, 1, 1))
        self.out_channels = ch[0] + ch[2] + ch[4] + ch[5]

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


_I3D_MIXED = (("Mixed_3b", (64, 96, 128, 16, 32, 32)), ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
              ("Mixed_4b", (192, 96, 208, 16, 48, 64)), ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
              ("Mixed_4d", (128, 128, 256, 24, 64, 64)), ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
              ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
              ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
              ("Mixed_5c", (384, 192, 384, 48, 128, 128)))
# the stride-2 max pool before each of these modules
_I3D_POOLS = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)), "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
              "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class I3D(nn.Module):
    """I3D, Kinetics-400 logits: [N, 3, T, 224, 224] in [-1, 1] (T >= 9)
    -> [N, 400]."""

    def __init__(self, num_classes: int = 400, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv3d_1a_7x7 = ConvBN(3, 64, (7, 7, 7), (2, 2, 2), device=device)
        self.Conv3d_2b_1x1 = ConvBN(64, 64, (1, 1, 1), device=device)
        self.Conv3d_2c_3x3 = ConvBN(64, 192, (3, 3, 3), device=device)
        cin = 192
        for name, ch in _I3D_MIXED:
            setattr(self, name, I3DMixed(cin, ch, device))
            cin = getattr(self, name).out_channels
        self.logits = nn.Conv3d(cin, num_classes, 1, bias=True, device=device)

    def forward(self, x):
        x = max_pool_same(self.Conv3d_1a_7x7(x), (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name, _ in _I3D_MIXED:
            if name in _I3D_POOLS:
                x = max_pool_same(x, *_I3D_POOLS[name])
            x = getattr(self, name)(x)
        # the spatial mean, the logits conv, then the temporal mean
        return self.logits(x.mean(dim=(3, 4), keepdim=True)).mean(dim=(2, 3, 4))


# ---------------------------------------------------------------------------
# torch state-dict converters (BN folded)
# ---------------------------------------------------------------------------

def _conv_bn(sd, out: Dict[str, torch.Tensor], key: str, conv_key: str, bn_key: str) -> None:
    """torch conv [O, I, *k] + BN -> `key.conv.{weight, bias}`, folded."""
    f32 = lambda name: np.asarray(sd[name], np.float32)
    k, b = fold_bn(f32(f"{conv_key}.weight"), f32(f"{bn_key}.weight"), f32(f"{bn_key}.bias"),
                   f32(f"{bn_key}.running_mean"), f32(f"{bn_key}.running_var"))
    out[f"{key}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(k))
    out[f"{key}.conv.bias"] = torch.from_numpy(np.ascontiguousarray(b))


_INCEPTION_BLOCKS = (
    (("Mixed_5b", "Mixed_5c", "Mixed_5d"),
     ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2",
      "branch3x3dbl_3", "branch_pool")),
    (("Mixed_6a",), ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3")),
    (("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"),
     ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
      "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")),
    (("Mixed_7a",), ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                     "branch7x7x3_3", "branch7x7x3_4")),
    (("Mixed_7b", "Mixed_7c"),
     ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
      "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool")),
)


def convert_inception_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch-fid InceptionV3 state dict
    (`Mixed_5b.branch1x1.conv.weight`, `....bn.running_var`, ...) -> the
    state dict of `InceptionV3Pool3` (BN folded)."""
    out: Dict[str, torch.Tensor] = {}
    for stem in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                 "Conv2d_4a_3x3"):
        _conv_bn(sd, out, stem, f"{stem}.conv", f"{stem}.bn")
    for names, branches in _INCEPTION_BLOCKS:
        for name in names:
            for br in branches:
                p = f"{name}.{br}"
                _conv_bn(sd, out, p, f"{p}.conv", f"{p}.bn")
    return out


def convert_i3d_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A pytorch-i3d state dict (`Conv3d_1a_7x7.conv3d.weight`,
    `Mixed_3b.b0.bn.running_mean`, `logits.conv3d.{weight,bias}`) -> the
    state dict of `I3D` (BN folded)."""
    out: Dict[str, torch.Tensor] = {}
    for stem in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        _conv_bn(sd, out, stem, f"{stem}.conv3d", f"{stem}.bn")
    for name, _ in _I3D_MIXED:
        for br in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b"):
            p = f"{name}.{br}"
            _conv_bn(sd, out, p, f"{p}.conv3d", f"{p}.bn")
    for leaf in ("weight", "bias"):
        out[f"logits.{leaf}"] = torch.as_tensor(
            np.asarray(sd[f"logits.conv3d.{leaf}"], np.float32))
    return out


# ---------------------------------------------------------------------------
# the entry points (compute_fid / compute_fvd features_fn factories)
# ---------------------------------------------------------------------------

def load_torch_state_dict(weights_path) -> Dict[str, torch.Tensor]:
    """A folder of `*.safetensors` -> its state dict; a file is refused."""
    path = Path(weights_path)
    if not path.is_dir():
        raise ValueError(f"{path} is not a folder: the feature extractors read a folder of "
                         "*.safetensors (a .pt/.pth file is not read)")
    return load_diffusers_folder(path)[1]


def _load(model: nn.Module, sd, convert) -> nn.Module:
    model.load_state_dict(convert({k: v.float().numpy() for k, v in sd.items()}), strict=True)
    return model.eval()


def inception_pool3_features(weights_path, batch: int = 32,
                             device: DeviceLike = None) -> Callable:
    """-> features_fn for compute_fid: frames [N, H, W, 3] in [0, 1] ->
    [N, 2048] f32; each frame resized to 299 x 299 with OpenCV's bilinear,
    then mapped to x * 2 - 1."""
    import cv2

    device = resolve_device(device)
    model = _load(InceptionV3Pool3(device=device), load_torch_state_dict(weights_path),
                  convert_inception_state_dict)

    @torch.inference_mode()
    def features_fn(frames: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(frames), batch):
            rs = np.stack([cv2.resize(f, (299, 299), interpolation=cv2.INTER_LINEAR)
                           for f in frames[i:i + batch]])
            x = torch.from_numpy(np.ascontiguousarray((rs * 2.0 - 1.0).astype(np.float32)))
            out.append(model(x.to(device).permute(0, 3, 1, 2)).cpu().numpy())
        return np.concatenate(out)

    return features_fn


def i3d_features(weights_path, batch: int = 8, device: DeviceLike = None) -> Callable:
    """-> features_fn for compute_fvd: videos [N, T, 224, 224, 3] in [0, 1]
    -> [N, 400] f32."""
    device = resolve_device(device)
    model = _load(I3D(device=device), load_torch_state_dict(weights_path), convert_i3d_state_dict)

    @torch.inference_mode()
    def features_fn(videos: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, len(videos), batch):
            x = torch.from_numpy(np.ascontiguousarray(
                (videos[i:i + batch] * 2.0 - 1.0).astype(np.float32)))
            out.append(model(x.to(device).permute(0, 4, 1, 2, 3)).cpu().numpy())
        return np.concatenate(out)

    return features_fn
