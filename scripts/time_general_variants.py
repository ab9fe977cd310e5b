"""Times design variants and cuts of four general kernels against each
other, in turns on one card, in f32 at the f32 fine-tune's shapes: the
general attention forward (orv_tpu_torch/ops/csrc/flash_attn_general.cu;
static max at [1,30,3226,64] x 3226, online at the ring's [1,30,226,64] x
1950), the general adaLN backward (orv_tpu_torch/ops/csrc/adaln_general.cu;
[5,600,1920] and its R = 1 form [1,3000,1920]), the general adaLN forward
(adaln_general.cu; [5,600,1920], the PAB harness's [2,96,32], 13 row
groups [13,600,1920] and the text stream's [1,226,1920]) and the
gated residual's f32 instance (gated_residual.cu; [5,600,1920] and the text
stream's [1,226,1920], the gate a row-strided chunk of [R, 3D]).

    python3 scripts/time_general_variants.py [--only NAME ...]

Each variant is a committed source with text substitutions (VARIANTS; a
substitution that no longer matches the source raises), built with nvcc into
its own library under orv_tpu_torch/ops/_build/variants/general/ (one nvcc
each, all started together) and called through its C entry points with
ctypes. A design variant is held against its plain version (each output
within 1e-4 of its range; the gated residual's bitwise); a cut drops a
part of the kernel and is timed only, to show that part's share. The
script prints each variant's ptxas lines (registers, spills) of the f32
instances it times, then times every variant with chip_smoke.py's `call_ms`
in the order of VARIANTS and back, beside SDPA's f32 forward, ATen's
LayerNorm backward at the R = 1 form and addcmul, and the card's name and
power limit.
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

from orv_tpu_torch.ops import adaln, attention  # noqa: E402
from orv_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

FWD, ADALN, GR = "flash_attn_general.cu", "adaln_general.cu", "gated_residual.cu"
MN = "adaln_general.cu (forward)"  # the same source, its forward entry point called
_ROWS = "    if (tid < R) {  // row tid: its max, p in key order, l"
_DX = "    // (3) dx, and the tile's rows in order into the group's sums\n    pass("
_STAGE = "  stage_coef<kPer>(coef, p, vrow, dc);\n"
_ST = "    __stcs(reinterpret_cast<uint4*>(orow + c), C::pack(o));"
# name -> (source, is a cut, [(text, replacement), ...])
VARIANTS = {
    "fwd": (FWD, False, []),
    "fwd_cut_pv": (FWD, True, [("general::products<kTile, PS, S, kMD, kE>(o,",
                                "if (0) general::products<kTile, PS, S, kMD, kE>(o,")]),
    "fwd_cut_rows": (FWD, True, [(_ROWS, _ROWS.replace("tid < R", "tid < 0"))]),
    "fwd_cut_scores": (FWD, True, [("general::scores<kDh, S, kMJ, R / 8, kTile / kMJ>(s,",
                                    "if (0) general::scores<kDh, S, kMJ, R / 8, kTile / kMJ>(s,")]),
    "adaln": (ADALN, False, []),
    "adaln_blocks1": (ADALN, False, [("kBwdBlocksPerSm = 2;", "kBwdBlocksPerSm = 1;")]),
    "adaln_blocks3": (ADALN, False, [("kBwdBlocksPerSm = 2;", "kBwdBlocksPerSm = 3;")]),
    "adaln_rows4_chunks2": (ADALN, False, [("kTileRows = 2;", "kTileRows = 4;"),
                                           ("kChunks = 4;", "kChunks = 2;")]),
    "adaln_cut_finish": (ADALN, True, [("cooperative_groups::this_grid().sync();", "return;")]),
    "adaln_cut_dx": (ADALN, True, [(_DX, _DX.replace("    pass(", "    if (0) pass("))]),
    # the gated residual's f32 instance: rows whose loads issue at once, plain
    # (caching) loads and stores instead of streaming ones; cut: no gate load
    "gr": (GR, False, []),
    "gr_rows2": (GR, False, [("kF32Rows = 4;", "kF32Rows = 2;")]),
    "gr_rows8": (GR, False, [("kF32Rows = 4;", "kF32Rows = 8;"),
                             ("kF32MinBlocks = 4;", "kF32MinBlocks = 2;")]),
    "gr_cached": (GR, False, [("a[i] = __ldcs(x + at);", "a[i] = x[at];"),
                              ("b[i] = __ldcs(y + at);", "b[i] = y[at];"),
                              ("__stcs(out + (long)(row + i * m) * d4, o);",
                               "out[(long)(row + i * m) * d4] = o;")]),
    "gr_cut_gate": (GR, True, [("  if (g_bf16) {\n    const bf16* gp",
                                "  g[0] = g[1] = g[2] = g[3] = 0.5f;\n  if (0) {\n"
                                "    const bf16* gp"),
                               ("  } else {\n    const float* gp",
                                "  } else if (0) {\n    const float* gp")]),
    # the adaLN forward: 8 warps (8 rows) a block, the coefficients staged
    # through registers before the rows' loads issue (the route of bf16 ones),
    # caching loads and stores; cut: no staging
    "mn": (MN, False, []),
    "mn_warps8": (MN, False, [("kFwdWarps = 4;", "kFwdWarps = 8;"),
                              ("kHeld <= 16 ? 4 : 2)", "kHeld <= 16 ? 2 : 1)")]),
    "mn_regs_stage": (MN, False, [("const int coef_async = !v_bf16",
                                   "const int coef_async = 0 && !v_bf16")]),
    "mn_cached": (MN, False, [("? __ldcs(reinterpret_cast<const uint4*>(xr + q * kE))",
                               "? *reinterpret_cast<const uint4*>(xr + q * kE)"),
                              (_ST + "\n  }\n  past(",
                               "    *reinterpret_cast<uint4*>(orow + c) = C::pack(o);\n  }\n"
                               "  past(")]),
    "mn_cut_stage": (MN, True, [(_STAGE, "")]),
}
FWD_SHAPES = (((1, 30, 3226, 64), 3226, 24.0), ((1, 30, 226, 64), 1950, None))
ADALN_SHAPES = ((5, 600, 1920), (1, 3000, 1920))
MN_SHAPES = ((5, 600, 1920), (2, 96, 32), (13, 600, 1920), (1, 226, 1920))
GR_SHAPES = ((5, 600, 1920), (1, 226, 1920))


def source_file(source: str) -> str:
    return ADALN if source == MN else source


def build(name: str) -> subprocess.Popen:
    """Write the variant's source and start its nvcc."""
    source, _, edits = VARIANTS[name]
    source = source_file(source)
    d = BUILD_DIR / "variants" / "general" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = (CSRC / source).read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in {source}")
        src = src.replace(old, new)
    (d / source).write_text(src)
    shutil.copy(CSRC / "general.cuh", d)
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                             str(d / source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(name: str, log: str) -> None:
    """Print the ptxas lines of the variant's f32 instances it times."""
    want = {FWD: r"flash_general_fwd_kernelIfLi64ELb[01]ELi\d+E",
            ADALN: r"mn_general_bwd_kernelIfE", MN: r"mn_general_fwd_kernelIfLi\d+ELi\d+E",
            GR: r"gr_general_fwd_kernel"}[
        VARIANTS[name][0]]
    hit = False
    for line in log.splitlines():
        if "entry function" in line:
            hit = re.search(want, line) is not None
            kernel = re.search(want, line).group(0) if hit else None
        elif hit and re.search(r"registers|spill", line):
            print(f"{name} ptxas {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)


class Fwd:
    """A forward variant's C entry point, called as the wrapper calls it."""

    def __init__(self, lib):
        self.fn = lib.orv_flash_attn_general
        self.fn.argtypes, self.fn.restype = attention._GENERAL_ARGS, ctypes.c_int

    def __call__(self, q, k, v, static_max):
        B, H, S, D = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        err = self.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      B * H, S, k.shape[2], D, D ** -0.5,
                      0.0 if static_max is None else static_max, int(static_max is None), 1,
                      torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"CUDA error {err}"
        return out, lse


class AdaLN:
    """An adaLN-backward variant's C entry points, planned as the wrapper plans."""

    def __init__(self, lib):
        self.limits = lib.orv_modulate_norm_bwd_general_limits
        self.limits.argtypes, self.limits.restype = adaln._MNB_GENERAL_LIMITS_ARGS, ctypes.c_int
        self.fn = lib.orv_modulate_norm_bwd_general
        self.fn.argtypes, self.fn.restype = adaln._MNB_GENERAL_ARGS, ctypes.c_int
        self.plans = {}

    def __call__(self, x, do, scale, ns):
        R, S, D = x.shape
        if (R, S, D) not in self.plans:
            out = (ctypes.c_int * 2)()
            assert self.limits(D, 1, ctypes.addressof(out)) == 0
            self.plans[R, S, D] = adaln.bwd_plan(R, S, out[0], out[1])
        rows, grid, n_part = self.plans[R, S, D]
        dx = torch.empty_like(x)
        part = torch.empty((n_part, 2, D), dtype=torch.float32, device=x.device)
        ab = torch.empty((R, 2, D), dtype=torch.float32, device=x.device)
        err = self.fn(x.data_ptr(), do.data_ptr(), scale.data_ptr(), scale.stride(0),
                      ns.data_ptr(), dx.data_ptr(), part.data_ptr(), ab.data_ptr(), R, S, D,
                      rows, grid, 1e-5, 0, 0, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"CUDA error {err}"
        return dx, ab[:, 0], ab[:, 1]


class Mn:
    """An adaLN-forward variant's C entry point, called as the wrapper calls it."""

    def __init__(self, lib):
        self.fn = lib.orv_modulate_norm_general
        self.fn.argtypes, self.fn.restype = adaln._MN_GENERAL_ARGS, ctypes.c_int

    def __call__(self, x, scale, shift, ns, nb):
        R, S, D = x.shape
        out = torch.empty_like(x)
        err = self.fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), scale.stride(0),
                      ns.data_ptr(), nb.data_ptr(), out.data_ptr(), R, S, D, 1e-5, 0, 0, 1,
                      torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"CUDA error {err}"
        return (out,)


class Gr:
    """A gated-residual variant's f32 entry point, called as the wrapper calls it."""

    def __init__(self, lib):
        self.fn = lib.orv_gated_residual_f32
        self.fn.argtypes, self.fn.restype = adaln._GR_ARGS, ctypes.c_int

    def __call__(self, x, y, gate):
        R, S, D = x.shape
        out = torch.empty_like(x)
        err = self.fn(x.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0),
                      out.data_ptr(), R, S, D, 0, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"CUDA error {err}"
        return (out,)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_general_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    names = opts.only or list(VARIANTS)
    procs = {n: build(n) for n in names}
    fns = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {n}:\n{log}")
        ptxas_lines(n, log)
        lib = ctypes.CDLL(str(BUILD_DIR / "variants" / "general" / n / "lib.so"))
        fns[n] = {FWD: Fwd, ADALN: AdaLN, MN: Mn, GR: Gr}[VARIANTS[n][0]](lib)

    g = torch.Generator(device="cuda").manual_seed(24)
    cases = []  # (label, source, args, plain outputs)
    for (B, H, sq, dh), skv, static_max in FWD_SHAPES:
        q = torch.randn(B, H, sq, dh, device="cuda", generator=g)
        k, v = (torch.randn(B, H, skv, dh, device="cuda", generator=g) for _ in range(2))
        mode = "online" if static_max is None else "static max"
        label = f"fwd f32 {[B, H, sq, dh]} x {skv} {mode}"
        cases.append((label, FWD, (q, k, v, static_max),
                      cs.plain_by_batch(attention.flash_attention_plain, q, k, v,
                                        static_max=static_max)))
    for R, S, D in ADALN_SHAPES:
        x, do, _, scale, _, _, ns, _ = cs.general_adaln_inputs(g, R, S, D, torch.float32)
        cases.append((f"adaLN backward f32 [{R},{S},{D}]", ADALN, (x, do, scale, ns),
                      adaln.modulate_norm_bwd_plain(x, do, scale, ns)))
    for R, S, D in MN_SHAPES:
        x, _, _, scale, shift, _, ns, nb = cs.general_adaln_inputs(g, R, S, D, torch.float32)
        cases.append((f"adaLN forward f32 [{R},{S},{D}]", MN, (x, scale, shift, ns, nb),
                      (adaln.modulate_norm_plain(x, scale, shift, ns, nb),)))
    for R, S, D in GR_SHAPES:
        x, _, y, _, _, gate, _, _ = cs.general_adaln_inputs(g, R, S, D, torch.float32)
        cases.append((f"gated residual f32 [{R},{S},{D}]", GR, (x, y, gate),
                      (adaln.gated_residual_plain(x, y, gate),)))
    ok = True
    for n in names:
        for label, source, args, want in cases:
            if VARIANTS[n][0] != source or VARIANTS[n][1]:
                continue
            got = fns[n](*args)
            again = fns[n](*args)
            errs = [cs.within_range(a, b, 0.0 if source == GR else 1e-4)
                    for a, b in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok &= same and all(e[2] for e in errs)
            print(f"{n} {label}: max_abs_err " + ", ".join(
                f"{e[0]:.3g} (range {e[1]:.3g})" for e in errs)
                + f"; a second run bitwise equal {same}", flush=True)
    times = {(n, c[0]): [] for n in names for c in cases if VARIANTS[n][0] == c[1]}
    for order in (names, names[::-1]):
        for n in order:
            for label, source, args, _ in cases:
                if VARIANTS[n][0] == source:
                    times[n, label].append(cs.call_ms(f"{n} {label}", fns[n], args,
                                                      10 if source == FWD else 50))
    yardsticks = {GR: ("addcmul", cs.addcmul)}
    for (n, label), ms in times.items():
        print(f"time {n}{' (cut)' if VARIANTS[n][1] else ''} {label}: "
              + ", ".join(f"{x:.4f}" for x in ms) + " ms", flush=True)
    for label, source, args, _ in cases:
        if source == FWD:
            ms = cs.call_ms("SDPA", torch.nn.functional.scaled_dot_product_attention, args[:3], 10)
            print(f"time SDPA {label}: {ms:.4f} ms", flush=True)
        if source in yardsticks:
            what, fn = yardsticks[source]
            print(f"time {what} {label}: {cs.call_ms(what, fn, args, 50):.4f} ms", flush=True)
    ran = {VARIANTS[n][0] for n in names}
    if ADALN in ran:
        cs.mn_bwd_library_ms(g, 3000, 1920, dtype=torch.float32)
    if MN in ran:
        cs.mn_fwd_library_ms(g, 3000, 1920, dtype=torch.float32)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    print(f"checks {'passed' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
