"""Times the data factory's kernels (hard voxelization, the splat
rasterizer's forward and backward) at the factory's frame-0 shapes, for this
checkout and for other checkouts, in turns on one card.

    python3 scripts/time_factory_kernels.py [--against NAME=DIR ...] [--rounds 1]

The data: chip_smoke.py's two seeded depth episodes (`write_factory_episodes`)
through `prepare_dataset`'s reconstruction (--dense), as phase 4d of the
smoke makes them; then frame 0's cloud (153,600 points with their labels)
and frame 0's occupancy as gaussians (about 77,000), the render's 240x320
view of the first pose, and phase 4d's 3000-gaussian scene at 61x93, with
each scene's blended (pixel, splat) pairs from the plain forward (the
operations' bound), saved once to an npz. Each checkout ("change" for
this one, NAME for each --against DIR, e.g. a parent commit unpacked with
`git archive`) then runs in a process of its own, its `orv_tpu_torch` first on
the path and its kernels built from its own sources, in the order of the
checkouts and then back (parent, change, change, parent), `--rounds` times.
A process holds each kernel against its plain version (voxelization bitwise,
the forward to 1e-5, the backward to 1e-4 of each largest gradient with
seeded gradients, and bitwise on a second run; the gaussians are isotropic
at the identity rotation, so their rotation gradient is zero, the plain
version's exactly, and the kernel's is held to 1e-4 of its terms' size, 4
|dL/ds| s), prints the ptxas lines (registers, shared memory, spills) of
its rasterizer kernels, then prints for each kernel (the backward also at
3000 gaussians, 61x93) its device time a call (torch.profiler, the mean of
10 calls after two warm-up calls), the host's wall time a call (to the
synchronize) and the call's device time by kernel, beside its bound: the
larger of its bytes at 3.35 TB/s and its f32 operations at 67 TFLOP/s
(chip_smoke.py's count a blended pair). The last lines compare the
forward's outputs at frame 0 across every run, bitwise, the first other
checkout's backward gradients at frame 0 with the first's, and give each
kernel's median per checkout and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 10
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12  # f32 outside the tensor cores, FLOP/s
SMALL = (3000, 61, 93)  # phase 4d's second backward shape: gaussians, H, W


def make_data(path: Path) -> None:
    """Frame 0's cloud and gaussians from the factory's own reconstruction."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from orv_tpu_torch.ops import gaussian_raster as gr
    from orv_tpu_torch.pipelines import prepare_dataset as pd

    root = Path(tempfile.mkdtemp(prefix="orv_factory_time_"))
    try:
        data = root / "data"
        cs.write_factory_episodes(data)
        t0 = time.perf_counter()
        with cs.spawned_workers_skip_this_script():
            pd.main(["--action", "reconstruction", "--dense", "--data_root", str(data)])
        print(f"data: reconstruction {time.perf_counter() - t0:.1f} s", flush=True)
        ep = data / "00000"
        pts = pd.depth_unproject_backend(str(ep))["points"][0]
        labels = np.load(ep / "labels" / "00000.npy")
        occ = np.load(ep / "occupancy.npz")
        n0 = int(occ["frame_sizes"][0])
        gauss = pd.occupancy_to_gaussians(occ["coors"][:n0], occ["labels"][:n0], device="cuda")
        names = ("centers", "features", "rotations", "scales", "opacities")
        pose = np.load(ep / "poses.npy")[0]
        settings = gr.view_settings(pose, cs.FACTORY_K, cs.FACTORY_RENDER)
        centers, feat, rot, scales, opac = gauss
        pairs = gr.forward_state_plain(settings, centers, opac, scales, rot)["pairs"].sum()
        small_settings, small = cs.raster_scene(SMALL[0], *SMALL[1:], seed=SMALL[2])
        st = {k: torch.tensor(v, device="cuda") for k, v in small.items()}
        small_pairs = gr.forward_state_plain(small_settings, st["means3d"], st["opacities"],
                                             st["scales"], st["rotations"])["pairs"].sum()
        fields = ("image_height", "image_width", "tanfovx", "tanfovy", "bg", "scale_modifier",
                  "viewmatrix", "projmatrix")
        np.savez(path, cloud=np.concatenate([pts, labels[:, None].astype(np.float32)], 1),
                 pose=pose, K=cs.FACTORY_K, hw=np.asarray(cs.FACTORY_RENDER),
                 pairs=int(pairs), small_pairs=int(small_pairs),
                 **{f"small_settings_{k}": getattr(small_settings, k) for k in fields},
                 **{f"small_{k}": v for k, v in small.items()},
                 **{k: t.cpu().numpy() for k, t in zip(names, gauss)})
    finally:
        shutil.rmtree(root, ignore_errors=True)


PROFILED = "time_factory_kernels profiled calls"


def device_ms(fn, args, n: int = CALLS):
    """(device ms a call, {kernel: ms a call}, {PyTorch operator: ms a call})
    by torch.profiler over n calls, as chip_smoke.py's `profiled_events`
    counts them: two calls and 20 ms before, 20 ms after, only kernels that
    start inside a range around the n calls (a profiler can lose the records
    of calls near the ends of its session). The operators are those that
    launched device work (the wrappers' own kernels go through ctypes and
    have none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize()
        time.sleep(0.02)
        with record_function(PROFILED):
            time.sleep(0.002)  # device timestamps may lie a little off the host's
            for _ in range(n):
                fn(*args)
            torch.cuda.synchronize()
            time.sleep(0.002)
        time.sleep(0.02)
    events = prof.events()
    (t0, t1), = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == PROFILED and e.device_type != DeviceType.CUDA]
    by, ops = {}, {}
    for e in events:
        if not t0 <= e.time_range.start <= t1 or e.name == PROFILED:
            continue
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            name = re.split(r"[(<]", e.name.replace("(anonymous namespace)::", ""))[0]
            name = name.split("::")[-1].replace("void ", "").strip()[:40]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / n / 1e3
        elif e.name.startswith("aten::") and e.device_time_total > 0:
            ops[e.name] = ops.get(e.name, 0.0) + e.device_time_total / n / 1e3
    if not by:
        raise RuntimeError("torch.profiler recorded no device time")
    return sum(by.values()), by, ops


def wall_ms(fn, args, n: int = CALLS) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def ptxas_lines(log: str) -> list:
    """The ptxas lines (registers, shared memory, spills) of the rasterizer's
    kernels in a build log, each after its kernel's name."""
    out, source, kernel = [], None, None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif source == "gaussian_raster.cu" and "entry function" in line:
            # the mangled name: <length><name>, then ILb1E / ILb0E for <true> / <false>
            m = re.search(r"\d+([a-z][a-z_]*_kernel)(ILb([01])E)?", line)
            kernel = m and m.group(1) + (
                "" if m.group(3) is None else f"<{'true' if m.group(3) == '1' else 'false'}>")
        elif source == "gaussian_raster.cu" and kernel and re.search(r"registers|spill", line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return out


def time_tree(tree: Path, data: Path, name: str, out: Path) -> None:
    """One checkout's checks and times (run in a process of its own); the
    forward's outputs at frame 0 go to `out`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from orv_tpu_torch.ops import _build
    from orv_tpu_torch.ops import gaussian_raster as gr
    from orv_tpu_torch.ops import voxelize as vx
    from orv_tpu_torch.pipelines import prepare_dataset as pd

    assert Path(vx.__file__).resolve().is_relative_to(tree.resolve()), vx.__file__
    d = np.load(data)
    cloud = torch.tensor(d["cloud"], device="cuda").contiguous()  # as points_to_voxels gives it
    gs = {k: torch.tensor(d[k], device="cuda") for k in
          ("centers", "features", "rotations", "scales", "opacities")}
    hw = tuple(int(x) for x in d["hw"])
    settings = gr.view_settings(d["pose"], d["K"], hw)
    t0 = time.perf_counter()
    _build.library()
    print(f"{name}: kernels built or loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in ptxas_lines(_build.build_log):
        print(f"{name} ptxas {line}", flush=True)
    if hasattr(gr, "backward_occupancy"):
        print(f"{name} occupancy of the backward kernel (blocks a multiprocessor, dynamic "
              f"shared memory): {gr.backward_occupancy(True)}", flush=True)
    vox_args = (pd.VOXEL_SIZE, pd.POINT_CLOUD_RANGE, 16, 2_000_000)
    fwd_args = (gs["centers"], torch.zeros_like(gs["centers"]), gs["opacities"], gs["scales"],
                gs["rotations"], gs["features"])
    g = torch.Generator(device="cuda").manual_seed(4)
    grads = dict(grad_color=torch.randn(3, *hw, generator=g, device="cuda"),
                 grad_depth=torch.randn(*hw, generator=g, device="cuda"),
                 grad_alpha=torch.randn(*hw, generator=g, device="cuda"),
                 grad_feature=torch.randn(12, *hw, generator=g, device="cuda"))

    got = vx.hard_voxelize(cloud, *vox_args)
    want = vx.voxelization_plain(cloud, *vox_args)
    vox_ok = all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want))
    M = len(got[1])
    got = gr.rasterize(settings, *fwd_args)
    np.savez(out, **{k: v.cpu().numpy() for k, v in zip(("color", "feature", "radii", "depth",
                                                         "alpha"), got)})
    want = gr.rasterize_plain(settings, *fwd_args)
    fwd_err = max((a - b).abs().max().item()
                  for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]))
    bwd = lambda: gr.rasterize_backward(settings, *fwd_args[:5], features=gs["features"], **grads)
    got, again = bwd(), bwd()
    np.savez(out.with_name(out.stem + "_bwd.npz"), **{k: v.cpu().numpy() for k, v in got.items()})
    want = gr.rasterize_backward_plain(settings, *fwd_args[:5], features=gs["features"], **grads)
    rel = {k: (got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1e-30)
           for k in want}
    # isotropic gaussians at the identity rotation: a zero rotation gradient, the plain
    # version's exactly, the kernel's rounding, held to 1e-4 of its terms' size 4 |dL/ds| s
    scale = 4 * (want["scales"].abs().amax(1) * gs["scales"].abs().amax(1)).max().item()
    rel["rotations"] = got["rotations"].abs().max().item() / scale
    bwd_rel = max(rel.values())
    bwd_bits = all(torch.equal(got[k], again[k]) for k in got)
    # phase 4d's 3000-gaussian scene at 61x93
    small_settings = gr.GaussianRasterizationSettings(**{
        k[len("small_settings_"):]: (v.item() if v.ndim == 0 else v)
        for k, v in d.items() if k.startswith("small_settings_")})
    sg = {k: torch.tensor(d[f"small_{k}"], device="cuda") for k in
          ("means3d", "colors", "opacities", "scales", "rotations", "features")}
    shw = (SMALL[1], SMALL[2])
    small_grads = dict(grad_color=torch.randn(3, *shw, generator=g, device="cuda"),
                       grad_depth=torch.randn(*shw, generator=g, device="cuda"),
                       grad_alpha=torch.randn(*shw, generator=g, device="cuda"),
                       grad_feature=torch.randn(12, *shw, generator=g, device="cuda"))
    small_args = tuple(sg[k] for k in ("means3d", "colors", "opacities", "scales", "rotations"))
    small_bwd = lambda: gr.rasterize_backward(small_settings, *small_args,
                                              features=sg["features"], **small_grads)
    got, again = small_bwd(), small_bwd()
    want = gr.rasterize_backward_plain(small_settings, *small_args, features=sg["features"],
                                       **small_grads)
    small_rel = max((got[k] - want[k]).abs().max().item()
                    / max(want[k].abs().max().item(), 1e-30) for k in want)
    bwd_bits &= all(torch.equal(got[k], again[k]) for k in got)
    bwd_rel = max(bwd_rel, small_rel)
    print(f"{name}: {len(cloud)} points -> {M} voxels, hard voxelization bitwise {vox_ok}; "
          f"{len(gs['centers'])} gaussians at {hw[0]}x{hw[1]}: forward max_abs_err "
          f"{fwd_err:.3g} (tol 1e-5), backward error of the largest gradient {bwd_rel:.3g} "
          f"(tol 1e-4), a second run bitwise equal {bwd_bits}", flush=True)
    ok = vox_ok and fwd_err <= 1e-5 and bwd_rel <= 1e-4 and bwd_bits

    n_g = len(gs["centers"])
    bwd_bytes = lambda n, hw: n * (3 + 3 + 1 + 3 + 4 + 12) * 4 * 2 + 17 * math.prod(hw) * 4
    nbytes = {"voxelize_hard": cloud.numel() * 4 + M * (16 * 4 * 4 + 3 * 4 + 4),
              "gaussian_raster_fwd": n_g * (3 + 3 + 1 + 3 + 4 + 12) * 4 + 17 * math.prod(hw) * 4
              + n_g * 4,
              "gaussian_raster_bwd": bwd_bytes(n_g, hw),
              "gaussian_raster_bwd_3000": bwd_bytes(SMALL[0], shw)}
    # f32 operations: the blended (pixel, splat) pairs times chip_smoke.py's count a pair
    # (RASTER_FWD_PAIR_OPS, RASTER_BWD_PAIR_OPS)
    fwd_pair, bwd_pair = 52 + 8, 121 + 8
    f32_ops = {"voxelize_hard": 0, "gaussian_raster_fwd": int(d["pairs"]) * fwd_pair,
               "gaussian_raster_bwd": int(d["pairs"]) * bwd_pair,
               "gaussian_raster_bwd_3000": int(d["small_pairs"]) * bwd_pair}
    calls = {"voxelize_hard": (lambda: vx.hard_voxelize(cloud, *vox_args), ()),
             "gaussian_raster_fwd": (lambda: gr.rasterize(settings, *fwd_args), ()),
             "gaussian_raster_bwd": (bwd, ()),
             "gaussian_raster_bwd_3000": (small_bwd, ())}
    result = dict(name=name, ok=ok, voxels=M, gaussians=n_g, kernels={})
    for k, (fn, args) in calls.items():
        ms, by, ops = device_ms(fn, args)
        wall = wall_ms(fn, args)
        t_bytes, t_ops = nbytes[k] / PEAK_BYTES * 1e3, f32_ops[k] / PEAK_F32 * 1e3
        bound, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        result["kernels"][k] = dict(ms=ms, wall_ms=wall, bound_ms=bound, bound_by=bound_by,
                                    split=by)
        parts = ", ".join(f"{kk} {v:.4f}" for kk, v in sorted(by.items(), key=lambda kv: -kv[1]))
        launched = ", ".join(f"{kk} {v:.4f}" for kk, v in ops.items()) or "none"
        print(f"{name} time {k}: {ms:.4f} ms of device time a call (bound {bound:.4f}, "
              f"{bound_by}: {nbytes[k]} bytes, {f32_ops[k]} f32 operations), "
              f"{wall:.4f} ms of wall; {parts}; PyTorch operators' device time {launched}",
              flush=True)
    print("RESULT " + json.dumps(result), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.tree:
        time_tree(Path(opts.tree), Path(opts.data), opts.name, Path(opts.out))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_factory_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    trees = {}
    for spec in opts.against:
        nm, _, d = spec.partition("=")
        if not nm or not d or nm == "change" or not (Path(d) / "orv_tpu_torch").is_dir():
            ap.error(f"--against takes NAME=DIR of a checkout; got {spec!r}")
        trees[nm] = Path(d).resolve()
    trees["change"] = ROOT
    work = Path(tempfile.mkdtemp(prefix="orv_factory_time_"))
    try:
        data = work / "frame0.npz"
        make_data(data)
        order = list(trees) + list(reversed(trees)) if len(trees) > 1 else list(trees) * 2
        results = {nm: [] for nm in trees}
        outs = []  # (checkout, its forward's outputs at frame 0)
        env = dict(os.environ, PYTHONPATH="")
        for _ in range(opts.rounds):
            for nm in order:
                out = work / f"forward_{len(outs)}.npz"
                outs.append((nm, out))
                p = subprocess.run([sys.executable, __file__, "--tree", str(trees[nm]), "--data",
                                    str(data), "--name", nm, "--out", str(out)],
                                   env=env, cwd=str(trees[nm]),
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                   timeout=900)
                for line in p.stdout.splitlines():
                    if line.startswith("RESULT "):
                        results[nm].append(json.loads(line[7:]))
                    else:
                        print(line, flush=True)
                if p.returncode != 0:
                    print(f"{nm}: exit code {p.returncode}", flush=True)
                    return 1
        import numpy as np

        first = np.load(outs[0][1])
        same = [all(np.array_equal(np.load(o)[k], first[k]) for k in first.files) for _, o in outs]
        print(f"the forward's outputs at frame 0, bitwise equal to {outs[0][0]}'s first run: "
              + ", ".join(f"{nm} {ok}" for (nm, _), ok in zip(outs, same)), flush=True)
        # how far each checkout's backward at frame 0 lies from the first's
        bwd = [(nm, np.load(o.with_name(o.stem + "_bwd.npz"))) for nm, o in outs]
        for nm, b in bwd[1:]:
            if nm != bwd[0][0]:
                print(f"the backward at frame 0, {nm} against {bwd[0][0]}: the largest "
                      "difference over the largest gradient " + ", ".join(
                          f"{k} {np.abs(b[k] - bwd[0][1][k]).max() / max(np.abs(bwd[0][1][k]).max(), 1e-30):.3g}"
                          for k in b.files), flush=True)
                break
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = all(same)
    for nm, runs in results.items():
        ok &= all(r["ok"] for r in runs)
        for k in runs[0]["kernels"]:
            ms = [r["kernels"][k]["ms"] for r in runs]
            wall = [r["kernels"][k]["wall_ms"] for r in runs]
            print(f"median {nm} {k}: {statistics.median(ms):.4f} ms of device time "
                  f"({', '.join(f'{x:.4f}' for x in ms)}), {statistics.median(wall):.4f} ms of "
                  f"wall, bound {runs[0]['kernels'][k]['bound_ms']:.4f} "
                  f"({runs[0]['kernels'][k]['bound_by']})", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    print(f"checks {'passed' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
