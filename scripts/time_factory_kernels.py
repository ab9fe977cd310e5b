"""Times the data factory's kernels (hard voxelization, the splat
rasterizer's forward and backward) at the factory's frame-0 shapes, for this
checkout and for other checkouts, in turns on one card.

    python3 scripts/time_factory_kernels.py [--against NAME=DIR ...] [--rounds 1]

The data: chip_smoke.py's two seeded depth episodes (`write_factory_episodes`)
through `prepare_dataset`'s reconstruction (--dense), as phase 4d of the
smoke makes them; then frame 0's cloud (153,600 points with their labels)
and frame 0's occupancy as gaussians (about 77,000), the render's 240x320
view of the first pose, saved once to an npz. Each checkout ("change" for
this one, NAME for each --against DIR, e.g. a parent commit unpacked with
`git archive`) then runs in a process of its own, its `orv_tpu_torch` first on
the path and its kernels built from its own sources, in the order of the
checkouts and then back (parent, change, change, parent), `--rounds` times.
A process holds each kernel against its plain version (voxelization bitwise,
the forward to 1e-5, the backward to 1e-4 of each largest gradient with
seeded gradients, and bitwise on a second run; the gaussians are isotropic
at the identity rotation, so their rotation gradient is zero, the plain
version's exactly, and the kernel's is held to 1e-4 of its terms' size, 4
|dL/ds| s), then prints for each kernel
its device time a call (torch.profiler, the mean of 10 calls after two
warm-up calls), the host's
wall time a call (to the synchronize) and the call's device time by kernel.
The last lines give each kernel's median per checkout and the card's name
and power limit.
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


def make_data(path: Path) -> None:
    """Frame 0's cloud and gaussians from the factory's own reconstruction."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
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
        np.savez(path, cloud=np.concatenate([pts, labels[:, None].astype(np.float32)], 1),
                 pose=np.load(ep / "poses.npy")[0], K=cs.FACTORY_K,
                 hw=np.asarray(cs.FACTORY_RENDER),
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


def time_tree(tree: Path, data: Path, name: str) -> None:
    """One checkout's checks and times (run in a process of its own)."""
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
    want = gr.rasterize_plain(settings, *fwd_args)
    fwd_err = max((a - b).abs().max().item()
                  for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]))
    bwd = lambda: gr.rasterize_backward(settings, *fwd_args[:5], features=gs["features"], **grads)
    got, again = bwd(), bwd()
    want = gr.rasterize_backward_plain(settings, *fwd_args[:5], features=gs["features"], **grads)
    rel = {k: (got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1e-30)
           for k in want}
    # isotropic gaussians at the identity rotation: a zero rotation gradient, the plain
    # version's exactly, the kernel's rounding, held to 1e-4 of its terms' size 4 |dL/ds| s
    scale = 4 * (want["scales"].abs().amax(1) * gs["scales"].abs().amax(1)).max().item()
    rel["rotations"] = got["rotations"].abs().max().item() / scale
    bwd_rel = max(rel.values())
    bwd_bits = all(torch.equal(got[k], again[k]) for k in got)
    print(f"{name}: {len(cloud)} points -> {M} voxels, hard voxelization bitwise {vox_ok}; "
          f"{len(gs['centers'])} gaussians at {hw[0]}x{hw[1]}: forward max_abs_err "
          f"{fwd_err:.3g} (tol 1e-5), backward error of the largest gradient {bwd_rel:.3g} "
          f"(tol 1e-4), a second run bitwise equal {bwd_bits}", flush=True)
    ok = vox_ok and fwd_err <= 1e-5 and bwd_rel <= 1e-4 and bwd_bits

    n_g = len(gs["centers"])
    nbytes = {"voxelize_hard": cloud.numel() * 4 + M * (16 * 4 * 4 + 3 * 4 + 4),
              "gaussian_raster_fwd": n_g * (3 + 3 + 1 + 3 + 4 + 12) * 4 + 17 * math.prod(hw) * 4
              + n_g * 4,
              "gaussian_raster_bwd": n_g * (3 + 3 + 1 + 3 + 4 + 12) * 4 * 2
              + 17 * math.prod(hw) * 4}
    calls = {"voxelize_hard": (lambda: vx.hard_voxelize(cloud, *vox_args), ()),
             "gaussian_raster_fwd": (lambda: gr.rasterize(settings, *fwd_args), ()),
             "gaussian_raster_bwd": (bwd, ())}
    result = dict(name=name, ok=ok, voxels=M, gaussians=n_g, kernels={})
    for k, (fn, args) in calls.items():
        ms, by, ops = device_ms(fn, args)
        wall = wall_ms(fn, args)
        bound = nbytes[k] / PEAK_BYTES * 1e3
        result["kernels"][k] = dict(ms=ms, wall_ms=wall, bound_ms=bound, split=by)
        parts = ", ".join(f"{kk} {v:.4f}" for kk, v in sorted(by.items(), key=lambda kv: -kv[1]))
        launched = ", ".join(f"{kk} {v:.4f}" for kk, v in ops.items()) or "none"
        print(f"{name} time {k}: {ms:.4f} ms of device time a call (bound {bound:.4f}, bytes), "
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
    opts = ap.parse_args()
    if opts.tree:
        time_tree(Path(opts.tree), Path(opts.data), opts.name)
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
        env = dict(os.environ, PYTHONPATH="")
        for _ in range(opts.rounds):
            for nm in order:
                p = subprocess.run([sys.executable, __file__, "--tree", str(trees[nm]), "--data",
                                    str(data), "--name", nm], env=env, cwd=str(trees[nm]),
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = True
    for nm, runs in results.items():
        ok &= all(r["ok"] for r in runs)
        for k in runs[0]["kernels"]:
            ms = [r["kernels"][k]["ms"] for r in runs]
            wall = [r["kernels"][k]["wall_ms"] for r in runs]
            print(f"median {nm} {k}: {statistics.median(ms):.4f} ms of device time "
                  f"({', '.join(f'{x:.4f}' for x in ms)}), {statistics.median(wall):.4f} ms of "
                  f"wall, bound {runs[0]['kernels'][k]['bound_ms']:.4f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    print(f"checks {'passed' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
