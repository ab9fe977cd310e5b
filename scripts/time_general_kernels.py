"""Times the general kernels an f32 model spends most in: the attention
forward (orv_tpu_torch/ops/csrc/flash_attn_general.cu, both softmax modes),
the attention backward's dq and dk/dv (flash_attn_general_bwd.cu), the adaLN
backward and forward (adaln_general.cu) and the gated residual's f32
instance (gated_residual.cu), in f32 at the f32 fine-tune's shapes, for this
checkout and for other checkouts, in turns on one card.

    python3 scripts/time_general_kernels.py [--against NAME=DIR ...] [--rounds 1] [--f32-train N]
        [--only attention adaln_bwd adaln_fwd]

Each checkout ("change" for this one, NAME for each --against DIR, e.g. a
parent commit unpacked with `git archive`) runs in a process of its own, its
`orv_tpu_torch` first on the path and its kernels built from its own
sources, in the order of the checkouts and then back (parent, change,
change, parent), `--rounds` times. A process prints the ptxas lines of the
instances it launches (registers, shared memory, spills) and, where the
checkout has `attention.general_fwd_instance` / `general_bwd_instance`, the
launched instances' registers, local memory and dynamic shared memory. Then,
from one seed:
- the forward at the training shape [1,30,3226,64] x 3226 (static max and
  online) and at the ring's call [1,30,226,64] x 1950 (online): out and lse
  against `flash_attention_plain` (out within 1e-4 of its range, lse within
  1e-4) and bitwise on a second run, timed beside SDPA on the same f32 q, k,
  v and the bound (f32 FMAs at 67 TFLOP/s, 4 Sq Skv Dh a head);
- the backward at both shapes (the ring's with an lse cotangent), fed the
  same saved forward (out, lse) in every checkout (the first run's, static
  max): dq, dk and dv against `flash_attention_bwd_plain` (each within 1e-4
  of its range) and bitwise on a second run; dq and dk/dv timed beside
  their bound (dq 6, dk/dv 8 Sq Skv Dh a head) and SDPA's memory-efficient
  backward (dq + dk + dv in one call; it takes no lse cotangent);
- the adaLN backward at [5,600,1920]: dx, A and B against
  `modulate_norm_bwd_plain` (each within 1e-4 of its range) and bitwise on a
  second run, timed beside its bound (bytes at 3.35 TB/s) and ATen's
  LayerNorm backward at the R = 1 form [1,3000,1920] (chip_smoke.py's
  `mn_bwd_library_ms`, which also times the kernel there);
- the adaLN forward at [5,600,1920] and at the PAB harness's video stream
  [2,96,32] (rows 32 wide), and the gated residual's f32 instance at
  [5,600,1920] and at the text stream's [1,226,1920] (its gate a row-strided
  chunk of [R, 3D], as the modulation linear leaves it): against their
  plain versions (the forward within 1e-4 of its range, the gated residual
  bitwise) and bitwise on a second run, timed beside their bounds (bytes at
  3.35 TB/s) and their yardsticks: addcmul for the gated residual,
  F.layer_norm at the forward's R = 1 form [1,3000,1920] (chip_smoke.py's
  `mn_fwd_library_ms`: the coefficients folded into one weight and bias
  outside the timed call; it also times the kernel there); then the bf16
  Hopper forward (row 6) at the flagship's [13,600,1920] and F.layer_norm at
  its R = 1 form [1,7800,1920] in bf16; where the checkout reports them, the
  launched instances and plans (chip_smoke.py's `general_mn_report`,
  `general_gr_report`);
- with --f32-train N, N runs of chip_smoke.py's phase 5b (`f32_train_phase`:
  pipelines/train.py:train with train.mixed_precision=no on the 2B recipe
  at full width, B=1 x 2 micro-steps, phase 5's seeded data), each one's s
  an optimizer step (the tracker's s_per_it summed over its micro-steps).
Times are chip_smoke.py's `device_ms` (calls in one CUDA graph, inputs
rotated past the L2). --only runs some of the three groups (attention,
adaln_bwd, adaln_fwd: the adaLN forward, the gated residual and row 6). The
last lines compare the outputs across every run: the attention backward's
and the gated residual's bitwise (their inputs and arithmetic are the
same), the attention forward's and the adaLN backward's within 1e-4 of the
first run's range (a checkout may sum in another order), the adaLN
forward's within 1e-6; then each kernel's median per checkout, the ratios
to this checkout, and the card's name and power limit.
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
PEAK_BYTES = 3.35e12  # device memory, bytes/s
# (label, q shape [B, H, Sq, Dh], Skv, forward modes timed, with an lse cotangent)
SHAPES = (("training", (1, 30, 3226, 64), 3226, (24.0, None), False),
          ("ring", (1, 30, 226, 64), 1950, (None,), True))
ADALN_SHAPE = (5, 600, 1920)
MN_SHAPES = ((5, 600, 1920), (2, 96, 32))  # the adaLN forward, f32
GR_SHAPES = ((5, 600, 1920), (1, 226, 1920))  # the gated residual, f32
ROW6_SHAPE = (13, 600, 1920)  # the bf16 Hopper forward at the flagship
GROUPS = ("attention", "adaln_bwd", "adaln_fwd")
LAUNCHED = re.compile(r"(flash_general_\w+?_kernel)IfLi64E(?:Lb([01])E)?(?:Li(\d+)E)?|"
                      r"(mn_general_bwd\w*?_kernel)IfE|(general_chunk_sums_kernel)|"
                      r"(mn_general_fwd_kernel)IfLi(\d+)ELi(\d+)E|(gr_general_fwd_kernel)")
SOURCES = ("flash_attn_general.cu", "flash_attn_general_bwd.cu", "adaln_general.cu",
           "gated_residual.cu")


def ptxas_lines(log: str) -> list:
    """The ptxas lines (registers, shared memory, spills) of the f32
    instances the script may launch (attention at capacity 64, the adaLN
    backward's kernels, every f32 instance of the adaLN forward, the gated
    residual's f32 kernel) in a build log, each after its instance's name."""
    out, source, kernel = [], None, None
    for line in log.splitlines():
        if line.startswith("== "):
            source, kernel = line[3:].strip(), None
        elif "entry function" in line:
            m = LAUNCHED.search(line) if source in SOURCES else None
            mode = {"0": ", static max", "1": ", online"}.get(m and m.group(2), "")
            mode += f", {m.group(3)} rows" if m and m.group(3) else ""
            kernel = m and (f"{m.group(1)}<f32, 64{mode}>" if m.group(1) else
                            f"{m.group(4)}<f32>" if m.group(4) else
                            f"{m.group(6)}<f32, {m.group(7)} lanes, {m.group(8)} chunks>"
                            if m.group(6) else m.group(5) or m.group(9))
        elif kernel and re.search(r"registers|spill", line):
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


def time_tree(tree: Path, name: str, work: Path, out_path: Path, f32_train: int,
              only: tuple) -> None:
    """One checkout's checks and times of the groups in `only` (run in a
    process of its own); its outputs go to `out_path`, the backward's saved
    inputs to (or, after the first run, from) `work`."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from orv_tpu_torch.ops import _build, adaln, attention

    assert Path(attention.__file__).resolve().is_relative_to(tree.resolve()), attention.__file__
    cs = load_chip_smoke()
    t0 = time.perf_counter()
    _build.library()
    print(f"{name}: kernels built or loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in ptxas_lines(_build.build_log):
        print(f"{name} ptxas {line}", flush=True)
    f32 = torch.float32
    if hasattr(attention, "general_fwd_instance") and "attention" in only:
        for online in (False, True):
            print(f"{name} launched instance: {cs.general_fwd_report(f32, 64, online)}",
                  flush=True)
    if hasattr(attention, "general_bwd_instance") and "attention" in only:
        for kname in ("dq", "dkv"):
            print(f"{name} launched instance: {cs.general_bwd_report(kname, f32, 64)}",
                  flush=True)
    g = torch.Generator(device="cuda").manual_seed(23)
    result, saved = dict(name=name, ok=True, kernels={}), {}

    def record(key, ms, bound, lib, lib_name):
        result["kernels"][key] = dict(ms=ms, bound_ms=bound, lib_ms=lib, lib=lib_name)
        print(f"{name} time {key}: {ms:.4f} ms of device time a call, bound {bound:.4f} "
              f"({100 * bound / ms:.1f}% of it); {lib_name} {lib:.4f}", flush=True)

    for label, (B, H, sq, dh), skv, modes, with_dlse in SHAPES if "attention" in only else ():
        q, do = (torch.randn(B, H, sq, dh, device="cuda", generator=g) for _ in range(2))
        k, v = (torch.randn(B, H, skv, dh, device="cuda", generator=g) for _ in range(2))
        dlse = torch.randn(B, H, sq, device="cuda", generator=g) if with_dlse else None
        what = f"f32 {[B, H, sq, dh]} x {skv}"
        sdpa_ms = cs.call_ms("SDPA", torch.nn.functional.scaled_dot_product_attention,
                             (q, k, v), 10)
        bound = 4.0 * sq * skv * dh * B * H / PEAK_F32 * 1e3
        for static_max in modes:
            mode = "online" if static_max is None else "static max"
            out, lse = attention.flash_attention(q, k, v, static_max=static_max)
            again = attention.flash_attention(q, k, v, static_max=static_max)
            ref, ref_lse = cs.plain_by_batch(attention.flash_attention_plain, q, k, v,
                                             static_max=static_max)
            err, span, ok = cs.within_range(out, ref)
            lse_err = cs.max_err(lse, ref_lse)
            same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
            result["ok"] &= ok and lse_err <= 1e-4 and same
            print(f"{name} {label} forward {mode} {what}: out max_abs_err {err:.3g} (range "
                  f"{span:.3g}, tol 1e-4 of it), lse {lse_err:.3g} (tol 1e-4); a second run "
                  f"bitwise equal {same}", flush=True)
            saved[f"{label}_fwd_{mode}_out"] = out.cpu().numpy()
            saved[f"{label}_fwd_{mode}_lse"] = lse.cpu().numpy()
            ms = cs.call_ms(f"{name} fwd", lambda *a, sm=static_max: attention.flash_attention(
                *a, static_max=sm), (q, k, v), 10)
            record(f"forward {mode} {label}", ms, bound, sdpa_ms, "SDPA f32")
        # the backward's inputs: the first run's forward (static max), the same in every run
        inputs = work / f"bwd_inputs_{label}.npz"
        if not inputs.exists():
            out, lse = attention.flash_attention(q, k, v, static_max=24.0)
            np.savez(inputs, out=out.cpu().numpy(), lse=lse.cpu().numpy())
        held = np.load(inputs)
        out, lse = (torch.from_numpy(held[n]).cuda() for n in ("out", "lse"))
        got = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
        again = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
        want = cs.plain_bwd_by_batch(q, k, v, out, lse, do, dlse)
        errs = {n: cs.within_range(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        result["ok"] &= same and all(e[2] for e in errs.values())
        print(f"{name} {label} backward {what}{' with dlse' if with_dlse else ''}: " + ", ".join(
            f"{n} max_abs_err {e[0]:.3g} (range {e[1]:.3g}, tol 1e-4 of it)" for n, e in
            errs.items()) + f"; a second run bitwise equal {same}", flush=True)
        saved.update({f"{label}_bwd_{n}": t.cpu().numpy() for n, t in zip(("dq", "dk", "dv"),
                                                                          got)})
        scale = dh ** -0.5
        _, delta = attention.flash_attention_general_bwd_dq(q, k, v, out, lse, do, scale, dlse)
        lib_ms = sdpa_backward_ms(cs, q, k, v, do)
        for kname, fn, args, n_products in (
                ("dq", attention.flash_attention_general_bwd_dq,
                 (q, k, v, out, lse, do, scale, dlse), 3),
                ("dkv", attention.flash_attention_general_bwd_dkv,
                 (q, k, v, do, lse, delta, scale), 4)):
            ms = cs.call_ms(f"{name} {kname}", fn, args, 10)
            record(f"{kname} {label}", ms, n_products * 2.0 * sq * skv * dh * B * H / PEAK_F32
                   * 1e3, lib_ms, "SDPA's memory-efficient backward (dq + dk + dv)")
        del q, k, v, do, out, lse, got, again, want, delta
        torch.cuda.empty_cache()

    if "adaln_bwd" in only:
        R, S, D = ADALN_SHAPE
        x, do, _, scale, _, _, ns, _ = cs.general_adaln_inputs(g, R, S, D, f32)
        got = adaln.modulate_norm_bwd(x, do, scale, ns)
        again = adaln.modulate_norm_bwd(x, do, scale, ns)
        want = adaln.modulate_norm_bwd_plain(x, do, scale, ns)
        errs = {n: cs.within_range(a, b) for n, a, b in zip(("dx", "A", "B"), got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        result["ok"] &= same and all(e[2] for e in errs.values())
        print(f"{name} adaLN backward f32 [{R},{S},{D}]: " + ", ".join(
            f"{n} max_abs_err {e[0]:.3g} (range {e[1]:.3g}, tol 1e-4 of it)" for n, e in
            errs.items()) + f"; a second run bitwise equal {same}", flush=True)
        saved.update({f"adaln_{n}": t.cpu().numpy() for n, t in zip(("dx", "A", "B"), got)})
        n = R * S * D
        bound = (3 * n * 4 + R * D * 4 + D * 4 + 2 * R * D * 4) / PEAK_BYTES * 1e3  # as phase 2's
        aten_ms, r1_ms = cs.mn_bwd_library_ms(g, R * S, D, dtype=f32)
        ms = cs.call_ms(f"{name} adaLN backward", adaln.modulate_norm_bwd, (x, do, scale, ns), 50)
        record("adaLN backward", ms, bound, aten_ms,
               f"ATen's LayerNorm backward at the R = 1 form [1,{R * S},{D}] (the kernel there "
               f"{r1_ms:.4f})")
        result["kernels"]["adaLN backward at R = 1"] = dict(ms=r1_ms, bound_ms=bound,
                                                            lib_ms=aten_ms, lib="ATen")
        del x, do, scale, ns, got, again, want
        torch.cuda.empty_cache()
    if "adaln_fwd" in only:
        adaln_forward_times(name, cs, g, record, result, saved)
    result["f32_train"] = []
    if f32_train:
        root = Path(tempfile.mkdtemp(dir=work, prefix=f"train_{name}_"))
        cs.write_train_data(root / "data")
        for _ in range(f32_train):
            shutil.rmtree(root / "f32", ignore_errors=True)
            cs.f32_train_phase(root)
            _, _, micro = cs.f32_metrics(root / "f32" / "run")
            result["f32_train"].append(sum(micro))
        print(f"{name} f32 train (phase 5b) s/optimizer step: "
              + ", ".join(f"{x:.4f}" for x in result["f32_train"]), flush=True)
    np.savez(out_path, **saved)
    print("RESULT " + json.dumps(result), flush=True)


def adaln_forward_times(name, cs, g, record, result, saved) -> None:
    """The adaLN forward (MN_SHAPES) and the gated residual's f32 instance
    (GR_SHAPES) checked, saved and timed beside their bounds and yardsticks;
    row 6 and its F.layer_norm at the R = 1 form in bf16 (time_tree's
    `record`, `result` and `saved`)."""
    import torch

    from orv_tpu_torch.ops import adaln

    f32 = torch.float32
    reports = hasattr(adaln, "modulate_norm_general_info")
    for R, S, D in MN_SHAPES:
        x, _, _, scale, shift, _, ns, nb = cs.general_adaln_inputs(g, R, S, D, f32)
        out = adaln.modulate_norm(x, scale, shift, ns, nb)
        again = adaln.modulate_norm(x, scale, shift, ns, nb)
        err, span, ok = cs.within_range(out, adaln.modulate_norm_plain(x, scale, shift, ns, nb))
        same = torch.equal(out, again)
        result["ok"] &= ok and same
        print(f"{name} adaLN forward f32 [{R},{S},{D}]: max_abs_err {err:.3g} (range {span:.3g}, "
              f"tol 1e-4 of it); a second run bitwise equal {same}", flush=True)
        if reports:
            print(f"{name} launched instance: {cs.general_mn_report(R, S, D, f32)}", flush=True)
        saved[f"mn_{R}x{S}x{D}"] = out.cpu().numpy()
        n = R * S * D
        bound = (2 * n * 4 + 2 * R * D * 4 + 2 * D * 4) / PEAK_BYTES * 1e3  # as phase 2's
        ms = cs.call_ms(f"{name} adaLN forward", adaln.modulate_norm, (x, scale, shift, ns, nb),
                        50)
        if R * S == 3000:
            lib_ms, r1_ms = cs.mn_fwd_library_ms(g, R * S, D, dtype=f32)
            record(f"adaLN forward [{R},{S},{D}]", ms, bound, lib_ms,
                   f"F.layer_norm at the R = 1 form [1,{R * S},{D}] (the kernel there "
                   f"{r1_ms:.4f})")
            result["kernels"]["adaLN forward at R = 1"] = dict(ms=r1_ms, bound_ms=bound,
                                                               lib_ms=lib_ms, lib="F.layer_norm")
        else:
            record(f"adaLN forward [{R},{S},{D}]", ms, bound, float("nan"), "no yardstick")
    for R, S, D in GR_SHAPES:
        x, _, y, _, _, gate, _, _ = cs.general_adaln_inputs(g, R, S, D, f32)
        out = adaln.gated_residual(x, y, gate)
        again = adaln.gated_residual(x, y, gate)
        err = cs.max_err(out, adaln.gated_residual_plain(x, y, gate))
        same = torch.equal(out, again)
        result["ok"] &= err == 0.0 and same
        print(f"{name} gated residual f32 [{R},{S},{D}]: max_abs_err {err:.3g} (tol 0); a "
              f"second run bitwise equal {same}", flush=True)
        if reports:
            print(f"{name} launched instance: {cs.general_gr_report(R, S, D)}", flush=True)
        saved[f"gr_{R}x{S}x{D}"] = out.cpu().numpy()
        bound = (3 * R * S * D * 4 + R * D * 4) / PEAK_BYTES * 1e3  # as phase 2's
        ms = cs.call_ms(f"{name} gated residual", adaln.gated_residual, (x, y, gate), 50)
        record(f"gated residual [{R},{S},{D}]", ms, bound,
               cs.call_ms("addcmul", cs.addcmul, (x, y, gate), 50), "addcmul")
    R, S, D = ROW6_SHAPE
    bf16 = torch.bfloat16
    x, _, _, scale, shift, _, ns, nb = cs.general_adaln_inputs(g, R, S, D, bf16)
    ms = cs.call_ms(f"{name} row 6", adaln.modulate_norm, (x, scale, shift, ns, nb), 50)
    bound = (2 * R * S * D * 2 + 2 * R * D * 2 + 2 * D * 4) / PEAK_BYTES * 1e3
    lib_ms, r1_ms = cs.mn_fwd_library_ms(g, R * S, D, dtype=bf16)
    record(f"row 6 bf16 [{R},{S},{D}]", ms, bound, lib_ms,
           f"F.layer_norm bf16 at the R = 1 form [1,{R * S},{D}] (the kernel there {r1_ms:.4f})")
    torch.cuda.empty_cache()


def compare(outs) -> bool:
    """The outputs of every run against the first's: the attention
    backward's and the gated residual's bitwise, the attention forward's and
    the adaLN backward's within 1e-4 of the first run's range (lse within
    1e-4), the adaLN forward's within 1e-6. Prints one line a kind; returns
    whether all hold."""
    import numpy as np

    first = np.load(outs[0][1])
    ok = True
    for kind, keys, rel in (
            ("the backward (bitwise)", [k for k in first.files if "_bwd_" in k], 0.0),
            ("the forward (1e-4 of the range; lse 1e-4)",
             [k for k in first.files if "_fwd_" in k], 1e-4),
            ("the adaLN backward (1e-4 of the range)",
             [k for k in first.files if k.startswith("adaln_")], 1e-4),
            ("the adaLN forward (1e-6 of the range)",
             [k for k in first.files if k.startswith("mn_")], 1e-6),
            ("the gated residual (bitwise)", [k for k in first.files if k.startswith("gr_")],
             0.0)):
        if not keys:
            continue
        worst, holds = {}, []
        for nm, o in outs[1:]:
            b = np.load(o)
            for k in keys:
                diff = float(np.abs(b[k].astype(np.float64) - first[k]).max())
                span = float(first[k].max() - first[k].min())
                tol = 1e-4 if k.endswith("_lse") else rel * span
                worst[k] = max(worst.get(k, 0.0), diff / (span or 1.0))
                holds.append(diff <= tol)
        ok &= all(holds)
        verdict = "holds" if all(holds) else "FAILS"
        print(f"{kind}, every run against {outs[0][0]}'s first: {verdict}; the largest "
              "difference over the range " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()),
              flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--f32-train", type=int, default=0, metavar="N",
                    help="runs of phase 5b (the f32 train) a checkout's process")
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=list(GROUPS),
                    help="the groups of kernels to run (all by default)")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.tree:
        time_tree(Path(opts.tree), opts.name, Path(opts.work), Path(opts.out), opts.f32_train,
                  tuple(opts.only))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_general_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    trees = {}
    for spec in opts.against:
        nm, _, d = spec.partition("=")
        if not nm or not d or nm == "change" or not (Path(d) / "orv_tpu_torch").is_dir():
            ap.error(f"--against takes NAME=DIR of a checkout; got {spec!r}")
        trees[nm] = Path(d).resolve()
    trees["change"] = ROOT
    work = Path(tempfile.mkdtemp(prefix="orv_general_time_"))
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
                                    nm, "--work", str(work), "--out", str(out), "--f32-train",
                                    str(opts.f32_train), "--only", *opts.only], env=env,
                                   cwd=str(trees[nm]), stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True, timeout=900)
                for line in p.stdout.splitlines():
                    if line.startswith("RESULT "):
                        results[nm].append(json.loads(line[7:]))
                    else:
                        print(line, flush=True)
                if p.returncode != 0:
                    print(f"{nm}: exit code {p.returncode}", flush=True)
                    return 1
        ok = compare(outs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    medians = {}
    for nm, runs in results.items():
        ok &= all(r["ok"] for r in runs)
        for k in runs[0]["kernels"]:
            ms = [r["kernels"][k]["ms"] for r in runs]
            lib = [r["kernels"][k]["lib_ms"] for r in runs]
            medians[nm, k] = statistics.median(ms)
            print(f"median {nm} {k}: {medians[nm, k]:.4f} ms ({', '.join(f'{x:.4f}' for x in ms)})"
                  f", bound {runs[0]['kernels'][k]['bound_ms']:.4f}, {runs[0]['kernels'][k]['lib']}"
                  f" {statistics.median(lib):.4f} ({', '.join(f'{x:.4f}' for x in lib)})",
                  flush=True)
        for label, *_ in SHAPES if "attention" in opts.only else ():
            pair = medians[nm, f"dq {label}"] + medians[nm, f"dkv {label}"]
            print(f"median {nm} dq + dk/dv {label}: {pair:.4f} ms", flush=True)
        steps = [x for r in runs for x in r["f32_train"]]
        if steps:
            print(f"median {nm} f32 train s/optimizer step: {statistics.median(steps):.4f} "
                  f"({', '.join(f'{x:.4f}' for x in steps)})", flush=True)
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
