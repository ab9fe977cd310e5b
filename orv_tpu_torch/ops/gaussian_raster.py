"""Gaussian splat rasterizer: CUDA kernels (`csrc/gaussian_raster.cu`),
forward and backward, and their plain PyTorch version.

Counterpart of `orv_tpu/ops/gaussian_raster.py` over
`ops/native/gaussian_raster.cpp`, with its names: a settings dataclass,
`rasterize(...)` -> (color [3,H,W], feature [12,H,W], radii [N], depth
[H,W], alpha [H,W]), `rasterize_backward(...)` -> the dict of the six input
gradients, and the camera helpers. The tensors lie on one device: on CUDA
the kernels run (the forward counted in `rasterize.launches`, the backward
in `rasterize_backward.launches`); on the CPU `rasterize_plain` runs.

`rasterize` is differentiable in means3d, colors, opacities, scales,
rotations and features: on CUDA through `RasterizeFunction`, whose backward
is the backward kernel, on the CPU through autograd of `rasterize_plain`
(an oracle for the backward that is independent of the C++'s derivation).
Discrete choices (culling, radius, tile extent, the 0.99 alpha clamp) are
not differentiated, as in the C++ op.

The plain version repeats the C++'s f32 arithmetic in its order of
operations; it blends tile by tile (16 x 16) over depth-sorted tile lists,
as the kernel does, with its sums taken in another order. Equal depths are
ordered by gaussian index in both (the C++'s std::sort leaves their order
unspecified).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from orv_tpu_torch.ops import _build
from orv_tpu_torch.ops.scan import scan_blocks

NUM_FEATURE_CHANNELS = 12
TILE = 16
_ALPHA_MIN = float(np.float32(1.0) / np.float32(255.0))  # the C++'s 1.0f / 255.0f
_T_MIN = float(np.float32(1e-4))


@dataclasses.dataclass
class GaussianRasterizationSettings:
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    bg: np.ndarray  # [3]
    scale_modifier: float
    viewmatrix: np.ndarray  # [4,4] world->camera (row-major)
    projmatrix: np.ndarray  # [4,4] world->clip (view @ proj, row-major)
    sh_degree: int = 3
    campos: Optional[np.ndarray] = None
    prefiltered: bool = False
    debug: bool = False
    include_feature: bool = True


def _host_f32(x, n: int) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float32).reshape(n)


def _params(settings: GaussianRasterizationSettings) -> np.ndarray:
    """The kernels' camera block, f32 as the C++ op takes it: V (16), P (16),
    bg (3), tan_fovx, tan_fovy, scale_modifier."""
    return np.concatenate([_host_f32(settings.viewmatrix, 16), _host_f32(settings.projmatrix, 16),
                           _host_f32(settings.bg, 3),
                           np.asarray([settings.tanfovx, settings.tanfovy,
                                       settings.scale_modifier], np.float32)])


def _inputs(name, means3d, colors, opacities, scales, rotations, features):
    """The gaussians as float32 contiguous tensors on one device; raise on
    anything else."""
    n = means3d.shape[0]
    shapes = {"means3d": (means3d, (n, 3)), "colors": (colors, (n, 3)),
              "scales": (scales, (n, 3)), "rotations": (rotations, (n, 4))}
    if features is not None:
        shapes["features"] = (features, (n, NUM_FEATURE_CHANNELS))
    opacities = opacities.reshape(-1)
    shapes["opacities"] = (opacities, (n,))
    for what, (t, shape) in shapes.items():
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                or tuple(t.shape) != shape or t.device != means3d.device):
            raise ValueError(f"{name}: {what} must be a float32 tensor {shape} on "
                             f"{means3d.device}; got {getattr(t, 'dtype', type(t))} "
                             f"{tuple(getattr(t, 'shape', ()))}")
    if means3d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {means3d.device}")
    c = lambda t: None if t is None else t.contiguous()
    return (c(means3d), c(colors), c(opacities), c(scales), c(rotations), c(features))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """a / t rounded once (`a / t` on a tensor multiplies by its reciprocal)."""
    return torch.div(torch.tensor(a, dtype=t.dtype, device=t.device), t)


def _geometry_plain(settings, means3d, scales, rotations):
    """Per-gaussian preprocess (gaussian_raster.cpp:87-176) in f32, in the
    C++'s order of operations: valid, radii, pixel centre, depth, conic and
    the tile rectangle. Values of culled gaussians are kept finite (their
    depth and determinant replaced by 1) so that autograd gives them zeros."""
    p = [float(x) for x in _params(settings)]
    V, P = p[:16], p[16:32]
    tan_fovx, tan_fovy, smod = (np.float32(x) for x in p[35:38])
    H, W = settings.image_height, settings.image_width
    focal_x = float(np.float32(W) / (np.float32(2.0) * tan_fovx))
    focal_y = float(np.float32(H) / (np.float32(2.0) * tan_fovy))
    m0, m1, m2 = means3d.unbind(1)
    tx = V[0] * m0 + V[1] * m1 + V[2] * m2 + V[3]
    ty = V[4] * m0 + V[5] * m1 + V[6] * m2 + V[7]
    tz = V[8] * m0 + V[9] * m1 + V[10] * m2 + V[11]
    near = tz >= 0.2
    tz = torch.where(near, tz, torch.ones_like(tz))
    cx = P[0] * m0 + P[1] * m1 + P[2] * m2 + P[3]
    cy = P[4] * m0 + P[5] * m1 + P[6] * m2 + P[7]
    cw = P[12] * m0 + P[13] * m1 + P[14] * m2 + P[15]
    inv_w = 1.0 / (cw + 1e-7)
    pix_x = ((cx * inv_w + 1.0) * W - 1.0) * 0.5
    pix_y = ((cy * inv_w + 1.0) * H - 1.0) * 0.5

    q0, q1, q2, q3 = rotations.unbind(1)
    qlen = torch.sqrt(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3) + 1e-12
    w, x, y, z = (q / qlen for q in (q0, q1, q2, q3))
    R = [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y),
         2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x),
         2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)]
    sm = [s * float(smod) for s in scales.unbind(1)]
    M = [R[r * 3 + c] * sm[c] for r in range(3) for c in range(3)]
    c3 = [M[0] * M[0] + M[1] * M[1] + M[2] * M[2], M[0] * M[3] + M[1] * M[4] + M[2] * M[5],
          M[0] * M[6] + M[1] * M[7] + M[2] * M[8], M[3] * M[3] + M[4] * M[4] + M[5] * M[5],
          M[3] * M[6] + M[4] * M[7] + M[5] * M[8], M[6] * M[6] + M[7] * M[7] + M[8] * M[8]]

    limx = float(np.float32(1.3) * tan_fovx)
    limy = float(np.float32(1.3) * tan_fovy)
    ctx = torch.clamp(tx / tz, -limx, limx) * tz
    cty = torch.clamp(ty / tz, -limy, limy) * tz
    J00, J11 = _rdiv(focal_x, tz), _rdiv(focal_y, tz)
    J02 = -(focal_x * ctx) / (tz * tz)
    J12 = -(focal_y * cty) / (tz * tz)
    W9 = [V[0], V[1], V[2], V[4], V[5], V[6], V[8], V[9], V[10]]
    # T = J W; J's zero entries add exact zeros in the C++ and are left out
    T = [J00 * W9[c] + J02 * W9[6 + c] for c in range(3)] + \
        [J11 * W9[3 + c] + J12 * W9[6 + c] for c in range(3)]
    S9 = [c3[0], c3[1], c3[2], c3[1], c3[3], c3[4], c3[2], c3[4], c3[5]]
    TS = [T[r * 3] * S9[c] + T[r * 3 + 1] * S9[3 + c] + T[r * 3 + 2] * S9[6 + c]
          for r in range(2) for c in range(3)]
    a = TS[0] * T[0] + TS[1] * T[1] + TS[2] * T[2] + 0.3
    b = TS[0] * T[3] + TS[1] * T[4] + TS[2] * T[5]
    d = TS[3] * T[3] + TS[4] * T[4] + TS[5] * T[5] + 0.3
    det = a * d - b * b
    pos = det > 0
    inv_det = 1.0 / torch.where(pos, det, torch.ones_like(det))
    conic = torch.stack([d * inv_det, -b * inv_det, a * inv_det], -1)
    mid = 0.5 * (a + d)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam.detach())).to(torch.int32)

    ix, iy = torch.trunc(pix_x.detach()).int(), torch.trunc(pix_y.detach()).int()
    x0, x1 = (ix - radius).clamp(0, W), (ix + radius + 1).clamp(0, W)
    y0, y1 = (iy - radius).clamp(0, H), (iy + radius + 1).clamp(0, H)
    valid = near & pos & (radius > 0) & (x0 < x1) & (y0 < y1)
    rect = torch.stack([x0 // TILE, (x1 - 1) // TILE, y0 // TILE, (y1 - 1) // TILE], -1)
    return dict(valid=valid, radii=torch.where(valid, radius, torch.zeros_like(radius)),
                px=pix_x, py=pix_y, depth=tz, conic=conic, rect=rect)


def bin_plain(settings, means3d, scales, rotations):
    """Plain version of the kernels' binning (`_bin`): {ranges [tiles, 2],
    point_list [keys], touched [n], offsets [n], slot_of [keys]} int32. Each
    valid gaussian emits one key a tile of its rectangle, row by row, in
    gaussian order (offsets[i] on); a tile's list is its gaussians in depth
    order, equal depths by index (the order `rasterize_plain` blends in);
    slot_of maps each emitted key to its place in the lists."""
    geo = _geometry_plain(settings, means3d, scales, rotations)
    H, W = settings.image_height, settings.image_width
    dev = means3d.device
    n, tiles_x = means3d.shape[0], -(-W // TILE)
    n_tiles = tiles_x * -(-H // TILE)
    valid, rect = geo["valid"], geo["rect"].long()
    width = rect[:, 1] - rect[:, 0] + 1
    touched = torch.where(valid, width * (rect[:, 3] - rect[:, 2] + 1), torch.zeros_like(width))
    offsets = torch.cumsum(touched, 0) - touched
    m = int(touched.sum())
    g = torch.repeat_interleave(torch.arange(n, device=dev), touched)
    j = torch.arange(m, device=dev) - offsets[g]
    tile = (rect[g, 2] + j // width[g]) * tiles_x + rect[g, 0] + j % width[g]
    idx = torch.nonzero(valid).flatten()
    order = idx[torch.sort(geo["depth"].detach()[idx], stable=True).indices]
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[order] = torch.arange(len(order), device=dev)
    perm = torch.argsort(tile * max(n, 1) + rank[g])  # distinct keys
    slot_of = torch.empty(m, dtype=torch.long, device=dev)
    slot_of[perm] = torch.arange(m, device=dev)
    count = torch.bincount(tile, minlength=n_tiles)
    start = torch.cumsum(count, 0) - count
    return dict(ranges=torch.stack([start, start + count], 1).int(), point_list=g[perm].int(),
                touched=touched.int(), offsets=offsets.int(), slot_of=slot_of.int())


def _blend_weights_plain(xs, ys, px, py, conic, opac):
    """One tile's pixels (xs, ys [P] f32) over its L splats in depth order,
    as gaussian_raster.cpp:228-247: (weights w [P,L], final T [P], T after
    each splat [P,L], blended [P,L] bool (the splats a pixel blends before
    its stop), clamped [P,L] bool (alpha = 0.99 there))."""
    dx = px[None, :] - xs[:, None]
    dy = py[None, :] - ys[:, None]
    c0, c1, c2 = (c[None, :] for c in conic.unbind(-1))
    power = -0.5 * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy
    raw = opac[None, :] * torch.exp(power)
    alpha = torch.clamp(raw, max=0.99)
    keep = (power <= 0) & (alpha >= _ALPHA_MIN)
    a = torch.where(keep, alpha, torch.zeros_like(alpha))
    T_after = torch.cumprod(1.0 - a, dim=1)  # the C++'s running product, in order
    L = a.shape[1]
    stop = (T_after.detach() < _T_MIN)
    last = torch.where(stop.any(1), stop.int().argmax(1), torch.full_like(stop[:, 0], L - 1,
                                                                          dtype=torch.long))
    incl = torch.arange(L, device=a.device)[None, :] <= last[:, None]
    T_before = torch.cat([torch.ones_like(a[:, :1]), T_after[:, :-1]], 1)
    w = torch.where(incl, a * T_before, torch.zeros_like(a))
    T = T_after.gather(1, last[:, None])[:, 0]
    blended = (incl & keep).detach()
    return w, T, T_after, blended, blended & (raw.detach() >= 0.99)


def _blend_tile_plain(xs, ys, px, py, conic, opac, depth, colors, features):
    """One tile's pixels (xs, ys [P] f32) over its splats in depth order:
    (acc color [P,3], acc feature [P,12] or None, acc depth [P], T [P]),
    as gaussian_raster.cpp:228-247."""
    w, T = _blend_weights_plain(xs, ys, px, py, conic, opac)[:2]
    acc_f = None if features is None else w @ features
    return w @ colors, acc_f, w @ depth, T


def rasterize_plain(settings, means3d, colors, opacities, scales, rotations, features=None):
    """Plain PyTorch version of `rasterize` (same outputs), differentiable by
    autograd."""
    means3d, colors, opacities, scales, rotations, features = _inputs(
        "rasterize_plain", means3d, colors, opacities, scales, rotations, features)
    H, W = settings.image_height, settings.image_width
    dev = means3d.device
    geo = _geometry_plain(settings, means3d, scales, rotations)
    bg = torch.from_numpy(_host_f32(settings.bg, 3)).to(dev)
    idx = torch.nonzero(geo["valid"]).flatten()
    order = idx[torch.sort(geo["depth"].detach()[idx], stable=True).indices]  # ties: by index
    rect = geo["rect"][order]
    px, py, dep = geo["px"][order], geo["py"][order], geo["depth"][order]
    conic, opac, col = geo["conic"][order], opacities[order], colors[order]
    feat = None if features is None else features[order]
    out_c = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
    out_f = torch.zeros((NUM_FEATURE_CHANNELS, H, W), dtype=torch.float32, device=dev)
    out_d = torch.zeros((H, W), dtype=torch.float32, device=dev)
    out_a = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for ty in range(-(-H // TILE)):
        for tx in range(-(-W // TILE)):
            y0, y1, x0, x1 = ty * TILE, min(H, ty * TILE + TILE), tx * TILE, min(W, tx * TILE + TILE)
            sel = torch.nonzero((rect[:, 0] <= tx) & (tx <= rect[:, 1]) & (rect[:, 2] <= ty)
                                & (ty <= rect[:, 3])).flatten()
            if len(sel) == 0:
                out_c[:, y0:y1, x0:x1] = bg[:, None, None]
                continue
            yy, xx = torch.meshgrid(torch.arange(y0, y1, device=dev, dtype=torch.float32),
                                    torch.arange(x0, x1, device=dev, dtype=torch.float32),
                                    indexing="ij")
            acc_c, acc_f, acc_d, T = _blend_tile_plain(
                xx.reshape(-1), yy.reshape(-1), px[sel], py[sel], conic[sel], opac[sel],
                dep[sel], col[sel], None if feat is None else feat[sel])
            shape = (y1 - y0, x1 - x0)
            out_c[:, y0:y1, x0:x1] = (acc_c + T[:, None] * bg).T.reshape(3, *shape)
            if acc_f is not None:
                out_f[:, y0:y1, x0:x1] = acc_f.T.reshape(NUM_FEATURE_CHANNELS, *shape)
            out_d[y0:y1, x0:x1] = acc_d.reshape(shape)
            out_a[y0:y1, x0:x1] = (1.0 - T).reshape(shape)
    return out_c, out_f, geo["radii"], out_d, out_a


def forward_state_plain(settings, means3d, opacities, scales, rotations):
    """The forward's state that the backward kernel reads, from the plain
    blend (`_blend_weights_plain`): {"T": each pixel's final transmittance
    [H,W] f32, "last": the list position (in `bin_plain`'s point list) of the
    last splat it blends, -1 for none [H,W] int32, "pairs": the splats it
    blends [H,W] int32, "clamped": those of them at alpha = 0.99 [H,W]
    int32, "marginal": [H,W] bool, where a running T up to the stop lies
    within 1e-5 of 1e-4 relative (rounding can move the stop there)}."""
    opacities = opacities.reshape(-1)
    H, W = settings.image_height, settings.image_width
    dev = means3d.device
    with torch.no_grad():
        geo = _geometry_plain(settings, means3d, scales, rotations)
        idx = torch.nonzero(geo["valid"]).flatten()
        order = idx[torch.sort(geo["depth"][idx], stable=True).indices]  # ties: by index
        rect = geo["rect"][order]
        px, py, conic, opac = geo["px"][order], geo["py"][order], geo["conic"][order], \
            opacities[order]
        T = torch.ones((H, W), dtype=torch.float32, device=dev)
        last = torch.full((H, W), -1, dtype=torch.int32, device=dev)
        pairs, clamped = (torch.zeros((H, W), dtype=torch.int32, device=dev) for _ in range(2))
        marginal = torch.zeros((H, W), dtype=torch.bool, device=dev)
        start = 0
        for ty in range(-(-H // TILE)):
            for tx in range(-(-W // TILE)):
                sel = torch.nonzero((rect[:, 0] <= tx) & (tx <= rect[:, 1]) & (rect[:, 2] <= ty)
                                    & (ty <= rect[:, 3])).flatten()
                if len(sel) == 0:
                    continue
                y0, y1, x0, x1 = ty * TILE, min(H, ty * TILE + TILE), tx * TILE, \
                    min(W, tx * TILE + TILE)
                yy, xx = torch.meshgrid(torch.arange(y0, y1, device=dev, dtype=torch.float32),
                                        torch.arange(x0, x1, device=dev, dtype=torch.float32),
                                        indexing="ij")
                _, t, t_after, blended, clamp = _blend_weights_plain(
                    xx.reshape(-1), yy.reshape(-1), px[sel], py[sel], conic[sel], opac[sel])
                L = blended.shape[1]
                pos = torch.arange(L, device=dev)[None, :]
                lst = torch.where(blended, pos, torch.full_like(pos, -1)).amax(1)
                shape = (y1 - y0, x1 - x0)
                T[y0:y1, x0:x1] = t.reshape(shape)
                last[y0:y1, x0:x1] = torch.where(lst >= 0, lst + start, lst).int().reshape(shape)
                pairs[y0:y1, x0:x1] = blended.sum(1).int().reshape(shape)
                clamped[y0:y1, x0:x1] = clamp.sum(1).int().reshape(shape)
                near = ((t_after - _T_MIN).abs() <= 1e-5 * _T_MIN) & (pos <= lst[:, None])
                marginal[y0:y1, x0:x1] = near.any(1).reshape(shape)
                start += len(sel)
    return dict(T=T, last=last, pairs=pairs, clamped=clamped, marginal=marginal)


def rasterize_backward_emulated(settings, means3d, colors, opacities, scales, rotations,
                                grad_color, grad_depth=None, grad_alpha=None, features=None,
                                grad_feature=None):
    """The backward kernel's order of operations in plain PyTorch, for the
    tests (the same dict as `rasterize_backward`): each pixel walks back to
    front from the plain forward's state (`forward_state_plain`), the
    transmittance before a splat the one after it over 1 - alpha, the
    payload behind it carried; each warp's sum over its 32 pixels (8x4),
    the warps that hit a splat added in warp order into its (tile,
    gaussian) slot; each gaussian's slots added in `bin_plain`'s key order;
    the screen-space sums taken to means3d, scales and rotations by
    autograd through `_geometry_plain`. All tiles step together, one list
    position a step."""
    means3d, colors, opacities, scales, rotations, features = _inputs(
        "rasterize_backward_emulated", means3d, colors, opacities, scales, rotations, features)
    H, W = settings.image_height, settings.image_width
    dev = means3d.device
    f32 = dict(dtype=torch.float32, device=dev)
    with_feat = features is not None and grad_feature is not None
    n_g = _GRAD_SLOT if with_feat else _GEOM_SLOT
    leaves = [t.detach().clone().requires_grad_(True) for t in (means3d, scales, rotations)]
    with torch.enable_grad():
        geo = _geometry_plain(settings, *leaves)
    binned = bin_plain(settings, means3d, scales, rotations)
    state = forward_state_plain(settings, means3d, opacities, scales, rotations)
    tiles_x = -(-W // TILE)
    n_tiles = tiles_x * -(-H // TILE)
    # each tile's pixels [tiles, 256] as the kernel lays them out: thread t's
    # warp t // 32 holds an 8x4 block, two blocks a row
    t = torch.arange(TILE * TILE, device=dev)
    lane, warp = t % 32, t // 32
    tile = torch.arange(n_tiles, device=dev)[:, None]
    xs = tile % tiles_x * TILE + (warp % 2) * 8 + lane % 8
    ys = tile // tiles_x * TILE + (warp // 2) * 4 + lane // 8
    inside = (xs < W) & (ys < H)
    pix = torch.where(inside, ys * W + xs, torch.zeros_like(xs))
    gd = torch.zeros((H, W), **f32) if grad_depth is None else grad_depth
    ga = torch.zeros((H, W), **f32) if grad_alpha is None else grad_alpha
    z = lambda v: torch.where(inside, v, torch.zeros_like(v))
    dC = [z(grad_color[k].reshape(-1)[pix]) for k in range(3)]
    dF = [z(grad_feature[k].reshape(-1)[pix]) for k in range(NUM_FEATURE_CHANNELS)] \
        if with_feat else []
    dD, dA = z(gd.reshape(-1)[pix]), z(ga.reshape(-1)[pix])
    T_final = torch.where(inside, state["T"].reshape(-1)[pix], torch.ones_like(dD))
    last = torch.where(inside, state["last"].reshape(-1)[pix].long(), torch.full_like(pix, -1))
    bg = [float(v) for v in _host_f32(settings.bg, 3)]
    bg_dot = bg[0] * dC[0] + bg[1] * dC[1] + bg[2] * dC[2]
    fx, fy = xs.float(), ys.float()
    ranges = binned["ranges"].long()
    block_last = last.amax(1)
    point_list = binned["point_list"].long()
    px, py, dep, conic = (geo[k].detach() for k in ("px", "py", "depth", "conic"))
    opac = opacities.reshape(-1)
    partial = torch.zeros((point_list.shape[0], n_g), **f32)
    T_run, suffix = T_final.clone(), torch.zeros_like(T_final)
    for step in range(int((block_last - ranges[:, 0] + 1).clamp(min=0).max())):
        k = block_last - step  # [tiles]
        on = k >= ranges[:, 0]
        g = point_list[torch.where(on, k, torch.zeros_like(k))][:, None]
        dx = px[g] - fx
        dy = py[g] - fy
        c0, c1, c2 = (conic[g, i] for i in range(3))
        power = -0.5 * (c0 * dx * dx + c2 * dy * dy) - c1 * dx * dy
        G = torch.exp(power)
        o = opac[g]
        alpha = torch.clamp(o * G, max=0.99)
        hit = (on[:, None] & (k[:, None] <= last) & (power <= 0) & (alpha >= _ALPHA_MIN))
        one_m = 1.0 - alpha
        T = T_run / one_m
        w = alpha * T
        col = colors[g[:, 0]]
        payload = col[:, 0:1] * dC[0] + col[:, 1:2] * dC[1] + col[:, 2:3] * dC[2] + dep[g] * dD
        v = [w * dC[0], w * dC[1], w * dC[2], None, None, None, w * dD, None, None, None]
        for i in range(len(dF)):
            payload = payload + features[g[:, 0], i:i + 1] * dF[i]
            v.append(w * dF[i])
        d_alpha = T * payload - (suffix + T_final * bg_dot) / one_m + (T_final / one_m) * dA
        local = o * G < 0.99  # alpha = min(0.99, o G): the clamp kills local gradients
        d_power = d_alpha * o * G
        v[3] = d_alpha * G
        v[7], v[8], v[9] = (d_power * (-0.5 * dx * dx), d_power * (-dx * dy),
                            d_power * (-0.5 * dy * dy))
        v[4] = d_power * (-(c0 * dx + c1 * dy))
        v[5] = d_power * (-(c2 * dy + c1 * dx))
        for i in (3, 4, 5, 7, 8, 9):
            v[i] = torch.where(local, v[i], torch.zeros_like(v[i]))
        vals = torch.where(hit[..., None], torch.stack(v, -1), torch.zeros(()))
        suffix = torch.where(hit, suffix + w * payload, suffix)
        T_run = torch.where(hit, T, T_run)
        warp_sums = vals.reshape(n_tiles, 8, 32, n_g).sum(2)
        total = warp_sums[:, 0]
        for wi in range(1, 8):
            total = total + warp_sums[:, wi]  # a warp that hit nothing adds zeros
        partial[k[on]] = total[on]
    touched, offsets = binned["touched"].long(), binned["offsets"].long()
    sums = torch.zeros((means3d.shape[0], n_g), **f32)
    slot_of = binned["slot_of"].long()
    for u in range(int(touched.max()) if len(touched) else 0):
        has = u < touched
        slot = slot_of[torch.where(has, offsets + u, torch.zeros_like(offsets))]
        sums = sums + torch.where(has[:, None], partial[slot], torch.zeros(()))
    screen = sums[:, 4:10]
    outs = [geo["px"], geo["py"], geo["depth"], geo["conic"]]
    g_means, g_scales, g_rots = torch.autograd.grad(
        outs, leaves, [screen[:, 0], screen[:, 1], screen[:, 2], screen[:, 3:6]],
        allow_unused=True)
    g_feat = sums[:, _GEOM_SLOT:] if with_feat else torch.zeros(
        (means3d.shape[0], NUM_FEATURE_CHANNELS), **f32)
    return dict(means3d=g_means, colors=sums[:, :3].contiguous(), features=g_feat.contiguous(),
                opacities=sums[:, 3].contiguous(), scales=g_scales, rotations=g_rots)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_PRE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 12)
_BIN_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 7)
_FWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7)
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 18)


_OCC_ARGS = [ctypes.c_int, ctypes.c_void_p]
_GRAD_SLOT = 3 + 1 + 6 + NUM_FEATURE_CHANNELS  # a (tile, gaussian) key's partial sums
_GEOM_SLOT = 3 + 1 + 6  # without features


def _host_params(settings):
    arr = (ctypes.c_float * 38)(*_params(settings))
    return arr, ctypes.addressof(arr)


# keys a block of tile_sort_kernel sorts in shared memory (csrc/gaussian_raster.cu: kSortCap)
TILE_SORT_CAP = 4096


def tile_sort_chunks(length: int) -> int:
    """Chunks tile_sort_kernel sorts a tile's list of `length` keys in: one
    (sorted in shared memory, written in place) up to TILE_SORT_CAP; past
    it, sorted chunks of TILE_SORT_CAP keys merged by rank."""
    return max(1, -(-length // TILE_SORT_CAP))


def _bin(settings, means3d, scales, rotations, opacities, with_slots: bool = True):
    """(a) preprocess and (b) binning on the card: radii and the per-gaussian
    blend inputs, the tiles' ranges and the depth-ordered point list; for
    the backward (`with_slots`), each gaussian's key count and first key
    (`touched`, `offsets`) and the sorted place of each of its keys
    (`slot_of`)."""
    n = means3d.shape[0]
    H, W = settings.image_height, settings.image_width
    dev = means3d.device
    n_tiles = -(-H // TILE) * -(-W // TILE)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    radii, touched, offsets = (torch.empty((n,), **i32) for _ in range(3))
    xy, conic_op, depth = (torch.empty((n, 2), **f32), torch.empty((n, 4), **f32),
                           torch.empty((n,), **f32))
    rect = torch.empty((n, 4), **i32)
    tile_count, tile_start = torch.empty((n_tiles,), **i32), torch.empty((n_tiles + 1,), **i32)
    block_sums = torch.empty((max(scan_blocks(max(n, n_tiles + 1)), 1), 2), **i32)
    total = torch.empty((2,), **i32)
    params, params_ptr = _host_params(settings)
    stream = torch.cuda.current_stream().cuda_stream
    err = _build.kernel("orv_raster_preprocess", _PRE_ARGS)(
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(), opacities.data_ptr(), n,
        params_ptr, H, W, radii.data_ptr(), xy.data_ptr(), conic_op.data_ptr(),
        depth.data_ptr(), rect.data_ptr(), touched.data_ptr(), offsets.data_ptr(),
        tile_count.data_ptr(), tile_start.data_ptr(), block_sums.data_ptr(), total.data_ptr(),
        stream)
    _build.check(err, "raster preprocess")
    m = _build.read_int(total[0], "rasterize")
    keys = torch.empty((m,), dtype=torch.int64, device=dev)
    ranges, point_list = torch.empty((n_tiles, 2), **i32), torch.empty((m,), **i32)
    slot_of = torch.empty((m,), **i32) if with_slots else None
    err = _build.kernel("orv_raster_bin", _BIN_ARGS)(
        n, touched.data_ptr(), offsets.data_ptr(), rect.data_ptr(), depth.data_ptr(), H, W,
        tile_start.data_ptr(), tile_count.data_ptr(), keys.data_ptr(), ranges.data_ptr(),
        point_list.data_ptr(), None if slot_of is None else slot_of.data_ptr(), stream)
    _build.check(err, "raster bin")
    del params
    return dict(radii=radii, xy=xy, conic_op=conic_op, depth=depth, ranges=ranges,
                point_list=point_list, touched=touched, offsets=offsets, slot_of=slot_of)


def _forward_kernel(settings, binned, colors, features, state: bool = False):
    """(c) the blend: ((color, feature, depth, alpha), state): with `state`,
    the backward's {"T": each pixel's final transmittance [H,W] f32, "last":
    the list position of the last splat it blends, -1 for none [H,W]
    int32}, else None. Counts no launch: its callers do."""
    H, W = settings.image_height, settings.image_width
    dev = colors.device
    out_c = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    out_f = (torch.empty if features is not None else torch.zeros)(
        (NUM_FEATURE_CHANNELS, H, W), dtype=torch.float32, device=dev)
    out_d = torch.empty((H, W), dtype=torch.float32, device=dev)
    out_a = torch.empty((H, W), dtype=torch.float32, device=dev)
    st = dict(T=torch.empty((H, W), dtype=torch.float32, device=dev),
              last=torch.empty((H, W), dtype=torch.int32, device=dev)) if state else None
    params, params_ptr = _host_params(settings)
    err = _build.kernel("orv_raster_forward", _FWD_ARGS)(
        binned["ranges"].data_ptr(), binned["point_list"].data_ptr(), binned["xy"].data_ptr(),
        binned["conic_op"].data_ptr(), binned["depth"].data_ptr(), colors.data_ptr(),
        None if features is None else features.data_ptr(), params_ptr, H, W, out_c.data_ptr(),
        None if features is None else out_f.data_ptr(), out_d.data_ptr(), out_a.data_ptr(),
        st["T"].data_ptr() if state else None, st["last"].data_ptr() if state else None,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "raster forward")
    del params
    return (out_c, out_f, out_d, out_a), st


def _backward_kernel(settings, binned, state, means3d, colors, opacities, scales, rotations,
                     features, grad_color, grad_feature, grad_depth, grad_alpha):
    """(d) the backward from the forward's `state`: the six gradients, in
    rasterize_backward's dict. Each tile sums a splat's gradients over its
    pixels into the splat's key slot (`partial`, written whole by the
    kernel), and each gaussian's slots are added in a fixed order: two runs
    give the same bits."""
    n = means3d.shape[0]
    H, W = settings.image_height, settings.image_width
    dev = means3d.device
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    keys = binned["point_list"].shape[0]
    g_means, g_scales, g_rots = e(n, 3), e(n, 3), e(n, 4)
    grads = [None if g is None else g.float().contiguous()
             for g in (grad_color, grad_feature, grad_depth, grad_alpha)]
    for g, shape in zip(grads, ((3, H, W), (NUM_FEATURE_CHANNELS, H, W), (H, W), (H, W))):
        if g is not None and (tuple(g.shape) != shape or g.device != dev):
            raise ValueError(f"rasterize_backward: a gradient {tuple(g.shape)} on {g.device} "
                             f"where {shape} on {dev} is due")
    gc, gf, gd, ga = grads
    gd = z(H, W) if gd is None else gd
    ga = z(H, W) if ga is None else ga
    with_feat = features is not None and gf is not None
    # the kernels write every gradient whole; the features' only with features
    accum, g_colors, g_opac = e(n, 6), e(n, 3), e(n)
    g_feats = (e if with_feat else z)(n, NUM_FEATURE_CHANNELS)
    partial = e(keys, _GRAD_SLOT if with_feat else _GEOM_SLOT)
    params, params_ptr = _host_params(settings)
    err = _build.kernel("orv_raster_backward", _BWD_ARGS)(
        binned["ranges"].data_ptr(), binned["point_list"].data_ptr(), binned["xy"].data_ptr(),
        binned["conic_op"].data_ptr(), binned["depth"].data_ptr(), means3d.data_ptr(),
        scales.data_ptr(), rotations.data_ptr(), colors.data_ptr(),
        features.data_ptr() if with_feat else None, n, params_ptr, H, W, gc.data_ptr(),
        gf.data_ptr() if with_feat else None, gd.data_ptr(), ga.data_ptr(),
        state["T"].data_ptr(), state["last"].data_ptr(), accum.data_ptr(),
        g_means.data_ptr(), g_colors.data_ptr(), g_feats.data_ptr(), g_opac.data_ptr(),
        g_scales.data_ptr(), g_rots.data_ptr(), binned["touched"].data_ptr(),
        binned["offsets"].data_ptr(), binned["slot_of"].data_ptr(), partial.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "raster backward")
    _build.count(rasterize_backward)
    del params
    return dict(means3d=g_means, colors=g_colors, features=g_feats, opacities=g_opac,
                scales=g_scales, rotations=g_rots)


def backward_occupancy(with_features: bool = True) -> Tuple[int, int]:
    """(blocks of the backward kernel a multiprocessor of the current card
    holds, its dynamic shared memory a block in bytes)."""
    out = torch.zeros(2, dtype=torch.int32)
    _build.check(_build.kernel("orv_raster_backward_occupancy", _OCC_ARGS)(
        int(with_features), out.data_ptr()), "raster backward occupancy")
    return int(out[0]), int(out[1])


class RasterizeFunction(torch.autograd.Function):
    """`rasterize` on CUDA: the forward kernels, and the backward kernel for
    the gradients of color, feature, depth and alpha (radii is not
    differentiable). Where a gradient is due, the forward also writes the
    backward's state (`ctx.state`)."""

    @staticmethod
    def forward(ctx, means3d, colors, opacities, scales, rotations, features, settings):
        grad = any(ctx.needs_input_grad[:6])
        binned = _bin(settings, means3d, scales, rotations, opacities, with_slots=grad)
        (color, feature, depth, alpha), ctx.state = _forward_kernel(settings, binned, colors,
                                                                    features, state=grad)
        _build.count(rasterize)
        ctx.settings, ctx.binned, ctx.with_features = settings, binned, features is not None
        ctx.save_for_backward(means3d, colors, opacities, scales, rotations, features)
        ctx.mark_non_differentiable(binned["radii"])
        return color, feature, binned["radii"], depth, alpha

    @staticmethod
    def backward(ctx, d_color, d_feature, _d_radii, d_depth, d_alpha):
        means3d, colors, opacities, scales, rotations, features = ctx.saved_tensors
        g = _backward_kernel(ctx.settings, ctx.binned, ctx.state, means3d, colors, opacities,
                             scales, rotations, features, d_color, d_feature, d_depth, d_alpha)
        return (g["means3d"], g["colors"], g["opacities"], g["scales"], g["rotations"],
                g["features"] if ctx.with_features else None, None)


def rasterize(settings: GaussianRasterizationSettings, means3d, colors, opacities, scales,
              rotations, features=None):
    """-> (color [3,H,W], feature [12,H,W], radii [N] int32, depth [H,W],
    alpha [H,W]) on the inputs' device (float32 tensors: means3d [N,3],
    colors [N,3], opacities [N] or [N,1], scales [N,3], rotations [N,4] as
    (w, x, y, z), features [N,12] or None)."""
    means3d, colors, opacities, scales, rotations, features = _inputs(
        "rasterize", means3d, colors, opacities, scales, rotations, features)
    if means3d.device.type == "cpu":
        return rasterize_plain(settings, means3d, colors, opacities, scales, rotations, features)
    with torch.cuda.device(means3d.device):
        return RasterizeFunction.apply(means3d, colors, opacities, scales, rotations, features,
                                       settings)


rasterize.launches = 0


def rasterize_backward(settings: GaussianRasterizationSettings, means3d, colors, opacities,
                       scales, rotations, grad_color, grad_depth=None, grad_alpha=None,
                       features=None, grad_feature=None):
    """-> {means3d [N,3], colors [N,3], features [N,12], opacities [N],
    scales [N,3], rotations [N,4]}: the gradients of sum(color * grad_color)
    + sum(depth * grad_depth) + sum(alpha * grad_alpha) (+ sum(feature *
    grad_feature) where both are given). On CUDA the backward kernel, after
    the forward's blend for its state (one launch counted), on the CPU
    autograd through `rasterize_plain`."""
    means3d, colors, opacities, scales, rotations, features = _inputs(
        "rasterize_backward", means3d, colors, opacities, scales, rotations, features)
    if means3d.device.type == "cpu":
        return rasterize_backward_plain(settings, means3d, colors, opacities, scales, rotations,
                                        grad_color, grad_depth, grad_alpha, features,
                                        grad_feature)
    with torch.cuda.device(means3d.device):
        binned = _bin(settings, means3d, scales, rotations, opacities)
        _, state = _forward_kernel(settings, binned, colors, None, state=True)
        return _backward_kernel(settings, binned, state, means3d, colors, opacities, scales,
                                rotations, features, grad_color, grad_feature, grad_depth,
                                grad_alpha)


rasterize_backward.launches = 0


def rasterize_backward_plain(settings, means3d, colors, opacities, scales, rotations,
                             grad_color, grad_depth=None, grad_alpha=None, features=None,
                             grad_feature=None):
    """Plain version of `rasterize_backward` (the same dict): autograd
    through `rasterize_plain`."""
    means3d, colors, opacities, scales, rotations, features = _inputs(
        "rasterize_backward_plain", means3d, colors, opacities, scales, rotations, features)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (means3d, colors, opacities, scales, rotations)]
    feat = None if features is None else features.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        color, feature, _, depth, alpha = rasterize_plain(settings, *leaves[:2], leaves[2],
                                                          *leaves[3:], feat)
        loss = (color * grad_color).sum()
        if grad_depth is not None:
            loss = loss + (depth * grad_depth).sum()
        if grad_alpha is not None:
            loss = loss + (alpha * grad_alpha).sum()
        if feat is not None and grad_feature is not None:
            loss = loss + (feature * grad_feature).sum()
        inputs = leaves + ([feat] if feat is not None else [])
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    g = [torch.zeros_like(t) if d is None else d for t, d in zip(inputs, grads)]
    g_feat = g[5] if feat is not None else torch.zeros(
        (means3d.shape[0], NUM_FEATURE_CHANNELS), dtype=torch.float32, device=means3d.device)
    return dict(means3d=g[0], colors=g[1], features=g_feat, opacities=g[2], scales=g[3],
                rotations=g[4])


# ---------------------------------------------------------------------------
# camera helpers (reference gs_render.py:97-221 semantics)
# ---------------------------------------------------------------------------

def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_projection_matrix_from_intrinsics(
    fx: float, fy: float, cx: float, cy: float, width: int, height: int,
    near: float = 0.1, far: float = 200.0,
) -> np.ndarray:
    """OpenGL-style projection from pinhole intrinsics (row-major, not
    transposed: the rasterizer takes row-major matrices)."""
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2 * fx / width
    P[1, 1] = 2 * fy / height
    P[0, 2] = 2 * (cx / width) - 1
    P[1, 2] = 2 * (cy / height) - 1
    P[2, 2] = far / (far - near)
    P[2, 3] = -(far * near) / (far - near)
    P[3, 2] = 1.0
    return P


def view_settings(extrinsics, intrinsics, image_shape: Tuple[int, int],
                  bg_color: Sequence[float] = (0, 0, 0)) -> GaussianRasterizationSettings:
    """The settings of one pinhole view (cam->world extrinsics [4,4],
    intrinsics [3,3]), in f64 on the host as the reference builds them."""
    height, width = image_shape
    fx, fy = float(intrinsics[0][0]), float(intrinsics[1][1])
    cx, cy = float(intrinsics[0][2]), float(intrinsics[1][2])
    w2c = np.linalg.inv(np.asarray(extrinsics, dtype=np.float64))
    proj = get_projection_matrix_from_intrinsics(fx, fy, cx, cy, width, height)
    return GaussianRasterizationSettings(
        image_height=height, image_width=width,
        tanfovx=math.tan(focal2fov(fx, width) * 0.5),
        tanfovy=math.tan(focal2fov(fy, height) * 0.5),
        bg=np.asarray(bg_color, dtype=np.float32), scale_modifier=1.0,
        viewmatrix=w2c, projmatrix=proj @ w2c,
    )


def render_occupancy_view(
    extrinsics: np.ndarray,  # [4,4] camera->world
    intrinsics: np.ndarray,  # [3,3]
    image_shape: Tuple[int, int],
    pts_xyz: torch.Tensor,
    pts_rgb: torch.Tensor,
    feat: torch.Tensor,
    rotations: torch.Tensor,
    scales: torch.Tensor,
    opacity: torch.Tensor,
    bg_color: Sequence[float] = (0, 0, 0),
):
    """One occupancy condition-map render (reference gs_render.render), on
    the gaussians' device."""
    settings = view_settings(extrinsics, intrinsics, image_shape, bg_color)
    color, feature, radii, depth, alpha = rasterize(
        settings, pts_xyz, pts_rgb, opacity, scales, rotations, feat)
    return dict(render_color=color, render_feat=feature, radii=radii,
                render_depth=depth, render_alpha=alpha)
