"""Times design variants and cuts of the general attention backward
(orv_tpu_torch/ops/csrc/flash_attn_general_bwd.cu) against each other, in
turns on one card, in f32 at the training shape [1,30,3226,64] x 3226.

    python3 scripts/time_general_attention_bwd_variants.py [--only NAME ...]

Each variant is the committed source with text substitutions (VARIANTS, in
the source or in the general.cuh its loops come from; a substitution that
matches neither raises), built with nvcc into its own library under
orv_tpu_torch/ops/_build/variants/general_bwd/ (one nvcc each, all started
together) and called through its C entry points with ctypes. A design variant is held against
`flash_attention_bwd_plain` (dq, dk and dv within 1e-4 of each range); a cut
drops a part of the kernel and is timed only, to show that part's share.
The script prints each variant's ptxas lines at capacity 64 (registers,
spills), then times dq and dk/dv of every variant with chip_smoke.py's
`call_ms` in the order of VARIANTS and back, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from orv_tpu_torch.ops import attention  # noqa: E402
from orv_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

SOURCE = "flash_attn_general_bwd.cu"
_SCORES = "#pragma unroll 4\n  for (int d = 0; d < kDh; d += 4) {"
_GRADS = "#pragma unroll 4\n  for (int c = 0; c < kN; ++c) {"
# name -> (is a cut, [(text, replacement), ...])
VARIANTS = {
    "committed": (False, []),
    "exp2f": (False, [("ex2(((prod", "exp2f(((prod")]),  # the library's exponential
    "unroll2": (False, [(_SCORES, _SCORES.replace("unroll 4", "unroll 2")),
                        (_GRADS, _GRADS.replace("unroll 4", "unroll 2"))]),
    "cut_scores": (True, [("scores<kDh, S, kMJ, R / 8, kTile / kMJ>(s,",
                           "if (0) scores<kDh, S, kMJ, R / 8, kTile / kMJ>(s,")]),
    "cut_gradients": (True, [("products<kTile, PS,", "if (0) products<kTile, PS,"),
                             ("products<kTile / 2, PS,", "if (0) products<kTile / 2, PS,")]),
    "cut_exp": (True, [("ex2(((prod ? other : mine) * scale - row_lse) * kLog2e)",
                        "((prod ? other : mine) * scale - row_lse)")]),
}
SHAPE, SKV = (1, 30, 3226, 64), 3226


def build(name: str, edits) -> subprocess.Popen:
    """Write the variant's source and its copy of general.cuh (whose shared
    loops an edit may change instead) and start its nvcc."""
    d = BUILD_DIR / "variants" / "general_bwd" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    texts = {f: (CSRC / f).read_text() for f in (SOURCE, "general.cuh")}
    for old, new in edits:
        where = [f for f, text in texts.items() if old in text]
        if not where:
            raise RuntimeError(f"variant {name}: {old!r} is in neither {SOURCE} nor general.cuh")
        texts[where[0]] = texts[where[0]].replace(old, new)
    for f, text in texts.items():
        (d / f).write_text(text)
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                             str(d / SOURCE)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_general_attention_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    names = opts.only or list(VARIANTS)
    procs = {n: build(n, VARIANTS[n][1]) for n in names}
    fns = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {n}:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"(flash_general_d\w+?_kernel)IfLi64E", line)
            if "entry function" in line:
                kernel = m and m.group(1)
            elif kernel and re.search(r"registers|spill", line):
                print(f"{n} ptxas {kernel}<f32, 64>: {line.split(':', 1)[-1].strip()}",
                      flush=True)
        lib = ctypes.CDLL(str(BUILD_DIR / "variants" / "general_bwd" / n / "lib.so"))
        dq, dkv = lib.orv_flash_attn_general_bwd_dq, lib.orv_flash_attn_general_bwd_dkv
        dq.argtypes, dkv.argtypes = attention._GENERAL_DQ_ARGS, attention._GENERAL_DKV_ARGS
        dq.restype = dkv.restype = ctypes.c_int
        fns[n] = (dq, dkv)

    g = torch.Generator(device="cuda").manual_seed(23)
    B, H, sq, dh = SHAPE
    q, do = (torch.randn(*SHAPE, device="cuda", generator=g) for _ in range(2))
    k, v = (torch.randn(B, H, SKV, dh, device="cuda", generator=g) for _ in range(2))
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
    scale = dh ** -0.5

    def dq_call(n, q, k, v, out, lse, do):
        dq = torch.empty_like(q)
        delta = torch.empty(B, H, sq, device="cuda")
        err = fns[n][0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), None, dq.data_ptr(), delta.data_ptr(), B * H, sq, SKV,
                        dh, scale, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"variant {n} dq: CUDA error {err}"
        return dq, delta

    def dkv_call(n, q, k, v, do, lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = fns[n][1](q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, sq, SKV, dh, scale,
                        1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"variant {n} dk/dv: CUDA error {err}"
        return dk, dv

    want = cs.plain_bwd_by_batch(q, k, v, out, lse, do)
    ok, deltas = True, {}
    for n in names:
        dq, deltas[n] = dq_call(n, q, k, v, out, lse, do)
        dk, dv = dkv_call(n, q, k, v, do, lse, deltas[n])
        if VARIANTS[n][0]:
            print(f"{n}: a cut, not checked", flush=True)
            continue
        errs = [cs.within_range(a, b) for a, b in zip((dq, dk, dv), want)]
        ok &= all(e[2] for e in errs)
        print(f"{n}: max_abs_err dq {errs[0][0]:.3g}, dk {errs[1][0]:.3g}, dv {errs[2][0]:.3g} "
              f"(tol 1e-4 of ranges {', '.join(f'{e[1]:.3g}' for e in errs)}); "
              f"{'ok' if all(e[2] for e in errs) else 'DISAGREES'}", flush=True)
    times = {n: {"dq": [], "dkv": []} for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n]["dq"].append(cs.call_ms(f"{n} dq", lambda *a, n=n: dq_call(n, *a),
                                             (q, k, v, out, lse, do), 10))
            times[n]["dkv"].append(cs.call_ms(f"{n} dkv", lambda *a, n=n: dkv_call(n, *a),
                                              (q, k, v, do, lse, deltas[n]), 10))
    for n in names:
        print(f"time {n}{' (cut)' if VARIANTS[n][0] else ''} f32 {list(SHAPE)} x {SKV}: dq "
              + ", ".join(f"{x:.4f}" for x in times[n]["dq"]) + " ms; dk/dv "
              + ", ".join(f"{x:.4f}" for x in times[n]["dkv"]) + " ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    print(f"checks {'passed' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
