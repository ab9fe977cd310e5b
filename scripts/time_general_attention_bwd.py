"""Times the general attention backward's two kernels, dq and dk/dv
(orv_tpu_torch/ops/csrc/flash_attn_general_bwd.cu), in f32 at the f32
fine-tune's shapes, for this checkout and for other checkouts, in turns on
one card.

    python3 scripts/time_general_attention_bwd.py [--against NAME=DIR ...] [--rounds 1]

Each checkout ("change" for this one, NAME for each --against DIR, e.g. a
parent commit unpacked with `git archive`) runs in a process of its own, its
`orv_tpu_torch` first on the path and its kernels built from its own
sources, in the order of the checkouts and then back (parent, change,
change, parent), `--rounds` times. A process prints the ptxas lines of its
general backward's instances (registers, shared memory, spills) and, where
the checkout has `attention.general_bwd_instance`, the launched instance's
registers, local memory and dynamic shared memory. Then at each shape, the
training shape [1,30,3226,64] x 3226 and the ring's call [1,30,226,64] x
1950 with an lse cotangent, from one seed, it holds dq, dk and dv against
`flash_attention_bwd_plain` (each within 1e-4 of its range) and bitwise on
a second run; times dq and dk/dv with chip_smoke.py's `device_ms` (calls in
one CUDA graph, inputs rotated past the L2) beside their bound (f32 FMAs at
67 TFLOP/s: dq 6, dk/dv 8 Sq Skv Dh a head) and SDPA's memory-efficient
backward on the same f32 q, k, v (dq + dk + dv in one call; it takes no lse
cotangent); and saves the general forward's outputs (both modes) and the
backward's. The last lines compare the forward's outputs across every run
bitwise (they must be equal), give how far each other checkout's backward
lies from the first's, each kernel's median per checkout and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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
PEAK_F32 = 67e12  # f32 FMAs outside the tensor cores, FLOP/s
# (label, q shape [B, H, Sq, Dh], Skv, with an lse cotangent)
SHAPES = (("training", (1, 30, 3226, 64), 3226, False),
          ("ring", (1, 30, 226, 64), 1950, True))
GENERAL_BWD = re.compile(r"(flash_general_d\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)E")


def ptxas_lines(log: str) -> list:
    """The ptxas lines (registers, shared memory, spills) of the general
    backward's instances in a build log, each after its instance's name."""
    out, source, kernel = [], None, None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif source == "flash_attn_general_bwd.cu" and "entry function" in line:
            m = GENERAL_BWD.search(line)
            kernel = m and f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, {m.group(3)}>"
        elif source == "flash_attn_general_bwd.cu" and kernel and re.search(r"registers|spill",
                                                                          line):
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return out


def load_chip_smoke():
    """This checkout's chip_smoke.py (its timers and plain references), over
    whatever `orv_tpu_torch` comes first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def sdpa_backward_ms(cs, q, k, v, do) -> float:
    """SDPA's memory-efficient backward (its flash kernel takes no f32) on
    f32 q, k, v: the forward on the capture stream, its backward timed."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa_call():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        cs.capture_stream().wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(cs.capture_stream()), sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            o_lib = torch.nn.functional.scaled_dot_product_attention(*leaves)
        return o_lib, leaves, do.clone()

    B, H, sq, dh = q.shape
    calls = [sdpa_call() for _ in range(cs.n_copies(2 * cs.attn_bytes(B * H, sq, k.shape[2], dh,
                                                                      4)))]
    torch.cuda.synchronize()
    ms = cs.device_ms(lambda o, leaves, d: torch.autograd.grad(o, leaves, d, retain_graph=True),
                      calls, 10, "SDPA memory-efficient backward (f32)")
    del calls
    return ms


def time_tree(tree: Path, name: str, out_path: Path) -> None:
    """One checkout's checks and times (run in a process of its own); its
    forward's and backward's outputs go to `out_path`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from orv_tpu_torch.ops import _build, attention

    assert Path(attention.__file__).resolve().is_relative_to(tree.resolve()), attention.__file__
    cs = load_chip_smoke()
    t0 = time.perf_counter()
    _build.library()
    print(f"{name}: kernels built or loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in ptxas_lines(_build.build_log):
        print(f"{name} ptxas {line}", flush=True)
    if hasattr(attention, "general_bwd_instance"):
        for dkv in (False, True):
            print(f"{name} launched instance at head dim 64, f32, {'dk/dv' if dkv else 'dq'}: "
                  f"{attention.general_bwd_instance(64, torch.float32, dkv)}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(23)
    result, saved = dict(name=name, ok=True, kernels={}), {}
    for label, (B, H, sq, dh), skv, with_dlse in SHAPES:
        q, do = (torch.randn(B, H, sq, dh, device="cuda", generator=g) for _ in range(2))
        k, v = (torch.randn(B, H, skv, dh, device="cuda", generator=g) for _ in range(2))
        dlse = torch.randn(B, H, sq, device="cuda", generator=g) if with_dlse else None
        out, lse = attention.flash_attention(q, k, v, static_max=24.0)
        online = attention.flash_attention(q, k, v)
        got = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
        again = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
        want = cs.plain_bwd_by_batch(q, k, v, out, lse, do, dlse)
        errs = {n: cs.within_range(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = same and all(e[2] for e in errs.values())
        result["ok"] &= ok
        what = f"f32 {[B, H, sq, dh]} x {skv}{' with dlse' if with_dlse else ''}"
        print(f"{name} {label} {what}: " + ", ".join(
            f"{n} max_abs_err {e[0]:.3g} (range {e[1]:.3g}, tol 1e-4 of it)" for n, e in
            errs.items()) + f"; a second run bitwise equal {same}", flush=True)
        saved.update({f"{label}_{n}": t.cpu().numpy() for n, t in (
            ("fwd_out", out), ("fwd_lse", lse), ("online_out", online[0]),
            ("online_lse", online[1]), ("dq", got[0]), ("dk", got[1]), ("dv", got[2]))})
        scale = dh ** -0.5
        _, delta = attention.flash_attention_general_bwd_dq(q, k, v, out, lse, do, scale, dlse)
        lib_ms = sdpa_backward_ms(cs, q, k, v, do)
        for kname, fn, args, n_products in (
                ("dq", attention.flash_attention_general_bwd_dq,
                 (q, k, v, out, lse, do, scale, dlse), 3),
                ("dkv", attention.flash_attention_general_bwd_dkv,
                 (q, k, v, do, lse, delta, scale), 4)):
            ms = cs.call_ms(f"{name} {kname}", fn, args, 10)
            bound = n_products * 2.0 * sq * skv * dh * B * H / PEAK_F32 * 1e3
            result["kernels"][f"{kname} {label}"] = dict(ms=ms, bound_ms=bound, sdpa_ms=lib_ms)
            print(f"{name} time {kname} {label} {what}: {ms:.4f} ms of device time a call, "
                  f"bound {bound:.4f} (operations, {100 * bound / ms:.1f}% of it); SDPA's "
                  f"memory-efficient backward (dq + dk + dv) {lib_ms:.4f}", flush=True)
        del q, k, v, do, out, lse, online, got, again, want, delta
        torch.cuda.empty_cache()
    np.savez(out_path, **saved)
    print("RESULT " + json.dumps(result), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.tree:
        time_tree(Path(opts.tree), opts.name, Path(opts.out))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_general_attention_bwd: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    trees = {}
    for spec in opts.against:
        nm, _, d = spec.partition("=")
        if not nm or not d or nm == "change" or not (Path(d) / "orv_tpu_torch").is_dir():
            ap.error(f"--against takes NAME=DIR of a checkout; got {spec!r}")
        trees[nm] = Path(d).resolve()
    trees["change"] = ROOT
    work = Path(tempfile.mkdtemp(prefix="orv_general_bwd_time_"))
    try:
        order = list(trees) + list(reversed(trees)) if len(trees) > 1 else list(trees) * 2
        results = {nm: [] for nm in trees}
        outs = []  # (checkout, its outputs)
        env = dict(os.environ, PYTHONPATH="")
        for _ in range(opts.rounds):
            for nm in order:
                out = work / f"outputs_{len(outs)}.npz"
                outs.append((nm, out))
                p = subprocess.run([sys.executable, __file__, "--tree", str(trees[nm]), "--name",
                                    nm, "--out", str(out)], env=env, cwd=str(trees[nm]),
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
        fwd = [k for k in first.files if "fwd" in k or "online" in k]
        same = [all(np.array_equal(np.load(o)[k], first[k]) for k in fwd) for _, o in outs]
        print(f"the general forward's outputs (both modes, both shapes), bitwise equal to "
              f"{outs[0][0]}'s first run: " + ", ".join(
                  f"{nm} {ok}" for (nm, _), ok in zip(outs, same)), flush=True)
        for nm, o in outs[1:]:
            if nm != outs[0][0]:
                b = np.load(o)
                print(f"the backward, {nm} against {outs[0][0]}: the largest difference over "
                      "the largest gradient " + ", ".join(
                          f"{k} {np.abs(b[k] - first[k]).max() / np.abs(first[k]).max():.3g}"
                          for k in first.files if k not in fwd), flush=True)
                break
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = all(same)
    medians = {}
    for nm, runs in results.items():
        ok &= all(r["ok"] for r in runs)
        for k in runs[0]["kernels"]:
            ms = [r["kernels"][k]["ms"] for r in runs]
            lib = [r["kernels"][k]["sdpa_ms"] for r in runs]
            medians[nm, k] = statistics.median(ms)
            print(f"median {nm} {k}: {medians[nm, k]:.4f} ms ({', '.join(f'{x:.4f}' for x in ms)})"
                  f", bound {runs[0]['kernels'][k]['bound_ms']:.4f}, SDPA's backward "
                  f"{statistics.median(lib):.4f} ({', '.join(f'{x:.4f}' for x in lib)})",
                  flush=True)
        for label, *_ in SHAPES:
            pair = medians[nm, f"dq {label}"] + medians[nm, f"dkv {label}"]
            print(f"median {nm} dq + dk/dv {label}: {pair:.4f} ms", flush=True)
    for nm in trees:
        if nm != "change":
            for k in results["change"][0]["kernels"]:
                print(f"{k}: {nm} / change {medians[nm, k] / medians['change', k]:.3f}x",
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    print(f"checks {'passed' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
