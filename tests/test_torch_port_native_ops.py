"""The port's plain voxelization and Gaussian-splat rasterizer against the
JAX package's C++ ops (orv_tpu/ops/native, compiled by g++ and loaded with
ctypes, as tests/test_native_ops.py runs them), on the CPU.

Tolerances:
  * voxelization, hard and dynamic: bitwise (the same f32 arithmetic);
  * rasterizer forward: radii bitwise, the images to 1e-5 absolute (the same
    f32 operations in the same order; the C++ may contract products into
    FMAs and sums its blend in order, the port by matrix products);
  * rasterizer backward: each gradient to 1e-4 of its largest magnitude,
    both the port's (autograd through `rasterize_plain`) and the C++'s
    derivation against each other;
  * camera helpers: 1e-12.
Scenes with exact depth ties (voxel centres) report the share of pixels
past the forward tolerance: the C++'s std::sort leaves equal depths in an
unspecified order, the port orders them by gaussian index.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke
from orv_tpu.ops import gaussian_raster as jraster
from orv_tpu.ops import voxelize as jvox
from orv_tpu_torch.ops import gaussian_raster as traster
from orv_tpu_torch.ops import voxelize as tvox
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)

VS = (0.05, 0.05, 0.1)
CR = (0.0, -2.0, -1.0, 4.0, 2.0, 3.0)


def _boundary_x() -> np.float32:
    """An f32 x in the grid whose cell floor(x / vs) differs between f32
    and f64 arithmetic."""
    for k in range(1, 80):
        x0 = np.float32(k * VS[0])
        for x in (np.nextafter(x0, np.float32(0)), x0, np.nextafter(x0, np.float32(9))):
            f32 = np.floor((x - np.float32(CR[0])) / np.float32(VS[0]))
            f64 = np.floor((np.float64(x) - CR[0]) / VS[0])
            if f32 != f64:
                return x
    raise AssertionError("no boundary point")


def _cloud(seed: int, n: int = 6000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 5, (n, 4)).astype(np.float32)  # some outside the grid
    pts[: n // 2, :3] = rng.uniform(0, 0.4, (n // 2, 3))  # dense: many points a voxel
    pts[n // 3, 0] = _boundary_x()
    return pts


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_points,max_voxels", [(8, 2000), (2, 50), (35, 20000)])
def test_port_hard_voxelization_equals_the_cpp_op_bitwise(seed, max_points, max_voxels):
    pts = _cloud(seed)
    want = jvox.voxelization(pts, VS, CR, max_points=max_points, max_voxels=max_voxels)
    got = tvox.voxelization(torch.tensor(pts), VS, CR, max_points=max_points,
                            max_voxels=max_voxels)
    for w, g in zip(want, got):
        assert w.shape == tuple(g.shape) and w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), w)
    if max_voxels == 50:  # both limits bind
        assert len(got[1]) == 50 and int(got[2].max()) == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_port_dynamic_voxelization_equals_the_cpp_op_bitwise(seed):
    pts = _cloud(seed)
    got = tvox.voxelization(torch.tensor(pts), VS, CR, max_points=-1).numpy()
    np.testing.assert_array_equal(got, jvox.voxelization(pts, VS, CR, max_points=-1))
    assert (got[pts[:, 0] < 0] == -1).all()


def test_cell_boundary_point_follows_the_cpp_op_not_voxelization_np():
    """At a point whose cell differs between f32 and f64 arithmetic, the port
    gives the C++ op's cell and voxelization_np (f64) another."""
    pt = np.array([[_boundary_x(), 0.01, 0.55, 0.0]], np.float32)
    cpp = jvox.voxelization(pt, VS, CR, max_points=-1)
    port = tvox.voxelization(torch.tensor(pt), VS, CR, max_points=-1).numpy()
    np.testing.assert_array_equal(port, cpp)
    assert not np.array_equal(jvox.voxelization_np(pt, VS, CR, max_points=-1), cpp)


def _jax_settings(settings):
    return jraster.GaussianRasterizationSettings(**dataclasses.asdict(settings))


SCENES = [(300, 64, 96, 0), (300, 37, 53, 1), (1, 16, 16, 2)]


@pytest.mark.parametrize("features", [True, False])
@pytest.mark.parametrize("n,H,W,seed", SCENES)
def test_port_rasterize_matches_the_cpp_op(n, H, W, seed, features):
    settings, a = chip_smoke.raster_scene(n, H, W, seed)
    feats = a["features"] if features else None
    want = jraster.rasterize(_jax_settings(settings), a["means3d"], a["colors"],
                             a["opacities"], a["scales"], a["rotations"], feats)
    t = {k: torch.tensor(v) for k, v in a.items()}
    got = traster.rasterize(settings, t["means3d"], t["colors"], t["opacities"], t["scales"],
                            t["rotations"], t["features"] if features else None)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)
    if n == 300:  # the scene reaches every branch of the preprocess
        geo = traster._geometry_plain(settings, t["means3d"], t["scales"], t["rotations"])
        tz = torch.tensor(a["means3d"]) @ torch.tensor(settings.viewmatrix[2, :3]).float() \
            + float(settings.viewmatrix[2, 3])
        assert (tz < 0.2).sum() >= 20 and (want[2][tz.numpy() < 0.2] == 0).all()
        limx = 1.3 * settings.tanfovx
        view = a["means3d"] @ settings.viewmatrix[:3, :3].T + settings.viewmatrix[:3, 3]
        clamped = np.abs(view[:, 0] / view[:, 2]) > limx
        assert (clamped & geo["valid"].numpy()).sum() >= 3  # the J clamp on drawn splats
        assert ((want[2] == 0) & (tz.numpy() >= 0.2)).sum() >= 5  # off screen


@pytest.mark.parametrize("features", [True, False])
@pytest.mark.parametrize("n,H,W,seed", SCENES[:2])
def test_port_rasterize_backward_matches_the_cpp_backward(n, H, W, seed, features):
    """The port's backward (autograd through rasterize_plain) and the C++'s
    derivation, each gradient to 1e-4 of its largest magnitude; autograd
    through `rasterize` gives the port's `rasterize_backward`."""
    settings, a = chip_smoke.raster_scene(n, H, W, seed)
    rng = np.random.default_rng(seed + 7)
    gc = rng.normal(size=(3, H, W)).astype(np.float32)
    gd = rng.normal(size=(H, W)).astype(np.float32)
    ga = rng.normal(size=(H, W)).astype(np.float32)
    gf = rng.normal(size=(12, H, W)).astype(np.float32)
    feats = a["features"] if features else None
    want = jraster.rasterize_backward(_jax_settings(settings), a["means3d"], a["colors"],
                                      a["opacities"], a["scales"], a["rotations"], gc, gd, ga,
                                      feats, gf if features else None)
    t = {k: torch.tensor(v) for k, v in a.items()}
    args = (t["means3d"], t["colors"], t["opacities"], t["scales"], t["rotations"])
    tf = t["features"] if features else None
    got = traster.rasterize_backward(settings, *args, torch.tensor(gc), torch.tensor(gd),
                                     torch.tensor(ga), tf, torch.tensor(gf) if features else None)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got[k].numpy() - w).max()) <= 1e-4 * scale, k
    leaves = [x.clone().requires_grad_(True) for x in args]
    color, feature, _, depth, alpha = traster.rasterize(settings, *leaves, tf)
    loss = ((color * torch.tensor(gc)).sum() + (depth * torch.tensor(gd)).sum()
            + (alpha * torch.tensor(ga)).sum())
    if features:
        loss = loss + (feature * torch.tensor(gf)).sum()
    loss.backward()
    for k, leaf in zip(("means3d", "colors", "opacities", "scales", "rotations"), leaves):
        torch.testing.assert_close(leaf.grad, got[k], atol=0, rtol=0)


def _state_scene(which: str):
    """(settings, arrays): "sparse", the 300-gaussian 64 x 96 scene; "dense",
    2000 gaussians at 37 x 53 (ragged tiles), every fifth at opacity 1, so
    that pixels stop at T < 1e-4 and blended splats sit at the 0.99 clamp."""
    if which == "sparse":
        return chip_smoke.raster_scene(*SCENES[0])
    settings, a = chip_smoke.raster_scene(2000, 37, 53, 3)
    a["opacities"][::5] = 1.0
    return settings, a


@pytest.mark.parametrize("which", ["sparse", "dense"])
def test_port_forward_state_follows_the_cpp_forward(which):
    """The backward's state from the plain blend: 1 - T is the C++'s alpha
    (1e-5, as the forward's tolerance); a pixel blends no splat (last -1)
    exactly where the C++'s alpha is 0; the splat at `last` lies in the
    pixel's tile list and blends the pixel."""
    settings, a = _state_scene(which)
    H, W = settings.image_height, settings.image_width
    want = jraster.rasterize(_jax_settings(settings), a["means3d"], a["colors"],
                             a["opacities"], a["scales"], a["rotations"], None)
    t = {k: torch.tensor(v) for k, v in a.items()}
    state = traster.forward_state_plain(settings, t["means3d"], t["opacities"], t["scales"],
                                        t["rotations"])
    np.testing.assert_allclose(1.0 - state["T"].numpy(), want[4], atol=1e-5, rtol=0)
    last = state["last"].numpy()
    np.testing.assert_array_equal(last < 0, want[4] == 0)
    np.testing.assert_array_equal(state["pairs"].numpy() > 0, last >= 0)
    binned = traster.bin_plain(settings, t["means3d"], t["scales"], t["rotations"])
    geo = traster._geometry_plain(settings, t["means3d"], t["scales"], t["rotations"])
    y, x = np.nonzero(last >= 0)
    tile = (y // traster.TILE) * -(-W // traster.TILE) + x // traster.TILE
    ranges = binned["ranges"].numpy()
    k = last[y, x]
    assert ((ranges[tile, 0] <= k) & (k < ranges[tile, 1])).all()
    g = binned["point_list"].numpy()[k]
    dx = geo["px"].numpy()[g] - x.astype(np.float32)
    dy = geo["py"].numpy()[g] - y.astype(np.float32)
    c = geo["conic"].numpy()[g]
    power = np.float32(-0.5) * (c[:, 0] * dx * dx + c[:, 2] * dy * dy) - c[:, 1] * dx * dy
    alpha = np.minimum(np.float32(0.99), a["opacities"][g] * np.exp(power))
    assert (power <= 0).all() and (alpha >= np.float32(1.0) / np.float32(255.0)).all()
    if which == "dense":
        assert (state["T"] < 1e-4).sum() > 100 and state["clamped"].sum() > 0


@pytest.mark.parametrize("features", [True, False])
@pytest.mark.parametrize("which", ["sparse", "dense"])
def test_port_backward_kernel_order_matches_the_cpp_backward(which, features):
    """The backward kernel's order in plain PyTorch
    (`rasterize_backward_emulated`: back to front from the forward's state,
    warp sums added in warp order, each gaussian's slots in key order)
    against the C++'s derivation and against autograd through
    `rasterize_plain`, each gradient to 1e-4 of its largest magnitude; the
    dense scene has stopped pixels, clamped alphas and ragged tiles."""
    settings, a = _state_scene(which)
    H, W = settings.image_height, settings.image_width
    rng = np.random.default_rng(H + W)
    gc = rng.normal(size=(3, H, W)).astype(np.float32)
    gd = rng.normal(size=(H, W)).astype(np.float32)
    ga = rng.normal(size=(H, W)).astype(np.float32)
    gf = rng.normal(size=(12, H, W)).astype(np.float32)
    feats = a["features"] if features else None
    want = jraster.rasterize_backward(_jax_settings(settings), a["means3d"], a["colors"],
                                      a["opacities"], a["scales"], a["rotations"], gc, gd, ga,
                                      feats, gf if features else None)
    t = {k: torch.tensor(v) for k, v in a.items()}
    args = (t["means3d"], t["colors"], t["opacities"], t["scales"], t["rotations"])
    grads = (torch.tensor(gc), torch.tensor(gd), torch.tensor(ga))
    tf, tgf = (t["features"], torch.tensor(gf)) if features else (None, None)
    got = traster.rasterize_backward_emulated(settings, *args, *grads, tf, tgf)
    plain = traster.rasterize_backward_plain(settings, *args, *grads, tf, tgf)
    for k, w in want.items():
        for ref in (w, plain[k].numpy()):
            scale = max(float(np.abs(ref).max()), 1e-30)
            assert float(np.abs(got[k].numpy() - ref).max()) <= 1e-4 * scale, k
    if not features:
        assert not got["features"].any()


def test_port_rasterize_on_voxel_centres_with_depth_ties():
    """A tabletop slab of 1 mm voxels in four labelled quadrants, seen
    straight down: each layer's centres share one depth exactly. Where the
    C++'s unspecified order of equal depths differs from the port's index
    order, a pixel can stop (T < 1e-4) after other splats: alpha and depth
    move by up to 1e-4, and where the tied splats' labels differ (the
    quadrants' borders) the features and the semantic label move. The
    share of pixels past the 1e-5 tolerance is reported; the bounds below
    hold it to those causes."""
    from orv_tpu_torch.pipelines import prepare_dataset as tpd

    y, x = np.mgrid[150:250, 150:250]
    coors = np.concatenate([np.stack([np.full(x.size, z), y.ravel(), x.ravel()], 1)
                            for z in (200, 201)]).astype(np.int32)
    labels = (1 + (coors[:, 2] >= 200) + 2 * (coors[:, 1] >= 200)).astype(np.int32)
    centers, feat, rot, scales, opac = tpd.occupancy_to_gaussians(coors, labels, device="cpu")
    pose = np.eye(4)
    pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
    pose[2, 3] = 0.5
    K = np.array([[300.0, 0, 48], [0, 300.0, 32], [0, 0, 1]])
    settings = traster.view_settings(pose, K, (64, 96))
    n = len(centers)
    depth = (torch.tensor(settings.viewmatrix[2, :3]).float() @ centers.T
             + float(settings.viewmatrix[2, 3]))
    assert len(torch.unique(depth)) <= 4  # exact ties
    want = jraster.rasterize(_jax_settings(settings), centers.numpy(), np.zeros((n, 3), np.float32),
                             opac.numpy(), scales.numpy(), rot.numpy(), feat.numpy())
    got = traster.rasterize(settings, centers, torch.zeros(n, 3), opac, scales, rot, feat)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    diff = {k: np.abs(g.numpy() - w) for k, g, w in zip(("color", "feature", "depth", "alpha"),
                                                         got[:2] + got[3:], want[:2] + want[3:])}
    off = np.zeros(want[3].shape, bool)
    for d in diff.values():
        off |= (d > 1e-5).reshape(-1, *off.shape).any(0)
    sem_off = float((got[1].argmax(0).numpy() != want[1].argmax(0)).mean())
    feat_off = float((diff["feature"] > 1e-3).any(0).mean())
    print(f"depth ties: {off.mean():.2%} of the pixels differ by more than 1e-5 (largest: alpha "
          f"{diff['alpha'].max():.3g}, depth {diff['depth'].max():.3g}, feature "
          f"{diff['feature'].max():.3g}); features past 1e-3 on {feat_off:.2%}, the semantic "
          f"label on {sem_off:.2%}")
    assert diff["color"].max() <= 1e-5
    assert diff["alpha"].max() <= 1e-4 and diff["depth"].max() <= 1e-4
    assert feat_off <= 0.1 and sem_off <= 0.02  # the borders: about 6% of this image


def test_camera_helpers_match_the_jax_package():
    for focal, pixels in ((450.0, 480), (123.4, 77)):
        assert traster.focal2fov(focal, pixels) == pytest.approx(
            jraster.focal2fov(focal, pixels), abs=1e-12)
    args = (450.0, 452.5, 240.3, 159.7, 320, 240)
    np.testing.assert_allclose(traster.get_projection_matrix_from_intrinsics(*args),
                               jraster.get_projection_matrix_from_intrinsics(*args), atol=1e-12)
    pose = np.eye(4)
    pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
    pose[:3, 3] = [0.01, -0.02, 0.4]
    K = np.array([[450.0, 0, 240.0], [0, 450.0, 160.0], [0, 0, 1]])
    s = traster.view_settings(pose, K, (240, 320))
    w2c = np.linalg.inv(pose)
    proj = jraster.get_projection_matrix_from_intrinsics(450.0, 450.0, 240.0, 160.0, 320, 240)
    np.testing.assert_allclose(s.viewmatrix, w2c, atol=1e-12)
    np.testing.assert_allclose(s.projmatrix, proj @ w2c, atol=1e-12)
    assert s.tanfovx == pytest.approx(math.tan(jraster.focal2fov(450.0, 320) * 0.5), abs=1e-12)
    assert s.tanfovy == pytest.approx(math.tan(jraster.focal2fov(450.0, 240) * 0.5), abs=1e-12)
