"""Times design variants of the two adaLN forwards against each other on one
NVIDIA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/time_adaln_variants.py [--against NAME=DIR ...]

Each variant is the committed kernel (orv_tpu_torch/ops/csrc/
adaln_fwd_sm90.cuh behind modulate_norm.cu and modulate_norm_q8.cu) with one
design choice changed by text substitutions of the header:
  final         as committed: tiles of 4 rows, a ring of 2 stages, up to 16
                chunks of 128 columns held in registers, bf16 rows written
                back into their stage and sent out by one bulk store each;
  stores        bf16 out by 8-byte stores from registers, not by a bulk
                store (the int8 mode is the same as final);
  rows8         tiles of 8 rows (consumer warps), not 4;
  stages3/4     a ring of 3 or 4 stages, not 2;
  rows8_stages4 both: the first configuration of this design (D <= 2048);
  held1         one chunk held in registers: every other chunk is re-read
                from the stage in each pass, and the int8 mode recomputes
                its y for the quantizing pass;
  held8         8 chunks held in registers, not 16;
  coef_one_round  the four coefficient rows loaded in one round trip at the
                block's start, not in two (ns and nb, then scale and shift).
Cuts of the final kernel are timed beside them but not checked: cut_launch
returns at once; cut_ring only streams x through the ring; cut_no_stores
does all but the stores; cut_rows_stores does the row work and the stores on
whatever the ring holds, loading no tile; cut_rows the row work alone.
Each --against NAME=DIR (a checkout of another commit, e.g. one unpacked
with `git archive`) adds that checkout's modulate_norm.cu and
modulate_norm_q8.cu as the variant NAME; its outputs are compared with the
final kernel's bit for bit. Its width limit is read from its
orv_tpu_torch/ops/adaln.py (MAX_D or MAX_D_FORWARD; D <= 2048 where both are absent,
as before the forwards took wider rows): its C entry may launch on rows its
wrapper refuses.
Each is built with nvcc into its own library under
orv_tpu_torch/ops/_build/variants/adaln/ (all at once, one nvcc each), checked
against `modulate_norm_plain` and `modulate_norm_q8_plain` at the smoke's
tolerances at [13,600,1920] and, where the build takes that width, at
[4,600,3072] (a variant's C entry refuses widths past its own limit), then timed at [13,600,1920] in turns (in order, reversed, in
order, reversed) by `chip_smoke.device_ms`: 50 calls captured in one CUDA
graph, inputs rotating over copies that keep the 50 MB L2 cold. The final
kernel and the --against builds that take D = 3072 are timed at [4,600,3072]
the same way. It prints each variant's registers (over its kernels) and
spills, its errors, its times and their median against the bytes' bound,
the final kernel's time from torch.profiler's device durations as a check on
the timer (and each --against build's), and the card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    PEAK_BYTES,
    adaln_inputs,
    device_ms,
    n_copies,
    nbytes,
    profiled_ms,
)
from orv_tpu_torch.ops import adaln  # noqa: E402
from orv_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

HEADER = "adaln_fwd_sm90.cuh"
ENTRIES = ("modulate_norm.cu", "modulate_norm_q8.cu")
# the bf16 rows out by 8-byte stores from registers, not written back into
# their stage and sent out by a bulk store
_STORES = [("  if constexpr (kMode == OutMode::kBf16) {  // y back into the stage, out by one bulk "
            "store\n",
            "  if constexpr (kMode == OutMode::kBf16) {\n"
            "    bf16* __restrict__ orow = static_cast<bf16*>(p.out) + row * d;\n"),
           ("*reinterpret_cast<uint2*>(xr + col(i)) =", "*reinterpret_cast<uint2*>(orow + col(i)) ="),
           ("    sm90::fence_proxy_async();  // the stage's new bytes, to the bulk store\n"
            "    __syncwarp();\n"
            "    if (lane == 0) {\n"
            "      sm90::bulk_store(static_cast<bf16*>(p.out) + row * d, xr, (uint32_t)d * 2);\n"
            "      sm90::bulk_commit();\n"
            "      sm90::bulk_wait_read<0>();  // the stage may be refilled after this\n"
            "    }\n"
            "    __syncwarp();\n", "")]
_ROWS8 = [("constexpr int kRows = 4;", "constexpr int kRows = 8;")]
VARIANTS = {
    "final": [],
    "stores": _STORES,
    "rows8": _ROWS8,
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "stages4": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    # 8 rows of 4 stages fit in shared memory only up to D = 2048
    "rows8_stages4": _ROWS8 + [("constexpr int kStages = 2;", "constexpr int kStages = 4;"),
                               ("constexpr int kMaxNV = 32;", "constexpr int kMaxNV = 16;")],
    "held1": [("constexpr int kCache = 16;", "constexpr int kCache = 1;")],
    "held8": [("constexpr int kCache = 16;", "constexpr int kCache = 8;")],
    "coef_one_round": [(
        "    load_coef<kDMax, kThreads>(coef, d, 0, norm, threadIdx.x);\n"
        "    load_coef<kDMax, kThreads>(coef, d, 2, mod, threadIdx.x);",
        "    const CoefSrc all[4] = {norm[0], norm[1], mod[0], mod[1]};\n"
        "    load_coef<kDMax, kThreads>(coef, d, 0, all, threadIdx.x);")],
}
# Cuts of the final kernel, timed beside the variants but not checked (their
# outputs are wrong by design): they split its time into the launch, the
# copy ring, the row work and the stores.
_NO_LOADS = [("    sm90::mbar_wait(&full[st], (n / kStages) & 1);\n    if (row < p.s)",
              "    if (row < p.s)"), ("issue(n);", "(void)n;")]
_NO_STORES = [("      *reinterpret_cast<uint2*>(xr + col(i)) = "
               "pack_bf16x4(y4(xc[i], i, mean, inv));",
               "      if (const uint2 v = pack_bf16x4(y4(xc[i], i, mean, inv)); "
               "v.x == 0x7fc17fc1u)\n        *reinterpret_cast<uint2*>(xr + col(i)) = v;"),
              ("      sm90::bulk_store(static_cast<bf16*>(p.out) + row * d, xr, (uint32_t)d * 2);\n",
               ""),
              ("      *reinterpret_cast<uint32_t*>(orow + col(i)) = pack_s8x4(xc[i], q);",
               "      if (const uint32_t v = pack_s8x4(xc[i], q); v == 0x7f7f7f7fu)\n"
               "        *reinterpret_cast<uint32_t*>(orow + col(i)) = v;")]
CUTS = {
    "cut_launch": [("  extern __shared__ __align__(128) uint8_t smem[];",
                    "  if (p.s > 0) return;\n  extern __shared__ __align__(128) uint8_t smem[];")],
    "cut_ring": [("    if (row < p.s)\n      modulate_row",
                  "    if (row < 0)\n      modulate_row")],
    "cut_no_stores": _NO_STORES,
    "cut_rows": _NO_LOADS + _NO_STORES,
    "cut_rows_stores": _NO_LOADS,
}
SHAPE = (13, 600, 1920)
WIDE = (4, 600, 3072)


def build(name: str, csrc: Path, edits) -> subprocess.Popen:
    """Write the variant's sources (every header of `csrc`, the edits applied
    to the kernel's) and start its nvcc."""
    d = BUILD_DIR / "variants" / "adaln" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for src in list(csrc.glob("*.cuh")) + [csrc / e for e in ENTRIES]:
        shutil.copy(src, d / src.name)
    if edits:
        text = (d / HEADER).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the header no longer holds {old!r}")
            text = text.replace(old, new)
        (d / HEADER).write_text(text)
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                             *(str(d / e) for e in ENTRIES)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launcher(lib: ctypes.CDLL, q8: bool):
    """fn(x, scale, shift, ns, nb) -> out (or (xq, xscale)) through the
    library's C entry, as the wrapper calls it."""
    fn = lib.orv_modulate_norm_q8 if q8 else lib.orv_modulate_norm
    fn.argtypes, fn.restype = (adaln._MNQ_ARGS if q8 else adaln._MN_ARGS), ctypes.c_int

    def launch(x, scale, shift, ns, nb):
        R, S, D = x.shape
        flags = (int(scale.dtype == torch.bfloat16), int(ns.dtype == torch.bfloat16))
        ptrs = (x.data_ptr(), scale.data_ptr(), shift.data_ptr(), scale.stride(0),
                ns.data_ptr(), nb.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        if q8:
            out = (torch.empty((R, S, D), dtype=torch.int8, device=x.device),
                   torch.empty((R, S), dtype=torch.float32, device=x.device))
            err = fn(*ptrs, out[0].data_ptr(), out[1].data_ptr(), R, S, D, 1e-5, *flags, stream)
        else:
            out = torch.empty_like(x)
            err = fn(*ptrs, out.data_ptr(), R, S, D, 1e-5, *flags, stream)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out
    return launch


def agrees(launch, q8: bool, args) -> str:
    """The smoke's check of one mode on args; raises on a disagreement."""
    got = launch(*args)
    if q8:
        ref_q, ref_s = adaln.modulate_norm_q8_plain(*args)
        diff = (got[0].int() - ref_q.int()).abs()
        flips = (diff != 0).float().mean().item()
        s_err = ((got[1] - ref_s).abs() / ref_s).max().item()
        ok = diff.max().item() <= 1 and flips <= 1e-3 and s_err <= 1e-6
        what = f"xq max diff {diff.max().item()}, {flips:.3g} differ, xscale rel err {s_err:.3g}"
    else:
        ref = adaln.modulate_norm_plain(*args)
        d = (got.float() - ref.float()).abs()
        ok = bool((d <= 2e-2 + 1e-2 * ref.float().abs()).all())
        what = f"max_abs_err {d.max().item():.3g}"
    if not ok:
        raise RuntimeError(f"disagrees with its plain version at {list(args[0].shape)}: {what}")
    return what


def takes(launch, args) -> bool:
    """Whether the build launches on args: False where its C entry refuses
    the width (cudaErrorInvalidValue), else raises what the launch raised."""
    try:
        launch(*args)
    except RuntimeError as e:
        if str(e) == "launch failed with CUDA error 1":
            return False
        raise
    return True


def bit_diff(a, b) -> str:
    """How many elements of two outputs (or output tuples) differ in their
    bits."""
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return ", ".join(f"{int((x.view(torch.uint8) != y.view(torch.uint8)).sum())} of "
                     f"{x.numel() * x.element_size()} bytes differ" for x, y in zip(a, b))


def time_in_turns(fns, names, q8: bool, args, shape) -> None:
    """Times names' launches of one mode at args in turns and prints each
    median against the bytes' bound."""
    R, S, D = shape
    mode = "modulate_norm_q8" if q8 else "modulate_norm"
    out = fns[names[0], q8](*args)
    calls = [args] + [tuple(t.clone() if i == 0 else t for i, t in enumerate(args))
                      for _ in range(n_copies(nbytes(args[0]) + nbytes(out)) - 1)]
    times = {name: [] for name in names}
    for order in (names, names[::-1], names, names[::-1]):
        for name in order:
            times[name].append(device_ms(fns[name, q8], calls, 50, f"{name} {mode}"))
    moved = R * S * D * (2 + (1 if q8 else 2)) + (R * S * 4 if q8 else 0)
    bound = moved / PEAK_BYTES * 1e3
    for name in names:
        ts = sorted(times[name])
        med = (ts[1] + ts[2]) / 2
        print(f"time {name} {mode} {list(shape)}: {' '.join(f'{t:.4f}' for t in times[name])} "
              f"ms, median {med:.4f}, {bound / med:.1%} of the bytes' bound ({bound:.4f} ms)",
              flush=True)
    for name in names:
        if name == "final" or name in AGAINST:
            print(f"profiler {name} {mode} {list(shape)}: "
                  f"{profiled_ms(fns[name, q8], calls, 50):.4f} ms a call (device durations)",
                  flush=True)


AGAINST: dict[str, Path] = {}  # name: the checkout's csrc
AGAINST_MAX_D: dict[str, int] = {}


def max_d(checkout: Path) -> int:
    """The widest rows a checkout's adaLN forwards take, by its wrapper."""
    m = re.search(r"^MAX_D(?:_FORWARD)? = (\d+)$",
                  (checkout / "orv_tpu_torch" / "ops" / "adaln.py").read_text(), re.M)
    return int(m.group(1)) if m else 2048


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="a checkout whose adaLN forwards to check and time too, as NAME")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_adaln_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for spec in opts.against:
        name, _, d = spec.partition("=")
        if not name or not d or name in VARIANTS or name in CUTS:
            ap.error(f"--against takes NAME=DIR with a NAME no variant has; got {spec!r}")
        AGAINST[name] = Path(d).resolve() / "orv_tpu_torch" / "ops" / "csrc"
        AGAINST_MAX_D[name] = max_d(Path(d).resolve())
    sources = {name: (CSRC, edits) for name, edits in {**VARIANTS, **CUTS}.items()}
    sources.update({name: (csrc, []) for name, csrc in AGAINST.items()})
    procs = {name: build(name, csrc, edits) for name, (csrc, edits) in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spilled = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        print(f"{name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, {spilled} bytes "
              f"of spill stores and loads", flush=True)
        libs[name] = ctypes.CDLL(str(BUILD_DIR / "variants" / "adaln" / name / "lib.so"))

    g = torch.Generator(device="cuda").manual_seed(0)
    R, S, D = SHAPE
    modes = {False: adaln_inputs(g, R, S, D, 1.0, False),
             True: adaln_inputs(g, R, S, D, 2.0, False)}
    wides = {False: adaln_inputs(g, *WIDE, 1.0, False), True: adaln_inputs(g, *WIDE, 2.0, False)}
    fns, wide_names = {}, {False: [], True: []}
    for name, lib in libs.items():
        for q8, args in modes.items():
            fns[name, q8] = launcher(lib, q8)
            if name in CUTS:
                continue
            wide_ok = (AGAINST_MAX_D[name] >= WIDE[2] if name in AGAINST
                       else takes(fns[name, q8], wides[q8]))
            shapes = [args] + ([wides[q8]] if wide_ok else [])
            print(f"{name} {'modulate_norm_q8' if q8 else 'modulate_norm'}: " + "; ".join(
                f"{list(a[0].shape)} {agrees(fns[name, q8], q8, a)}" for a in shapes)
                + ("" if len(shapes) > 1 else f"; takes no D = {WIDE[2]}"), flush=True)
            if len(shapes) > 1 and (name == "final" or name in AGAINST):
                wide_names[q8].append(name)
            if name in AGAINST:
                for a in shapes:
                    print(f"bits {name} vs final {'modulate_norm_q8' if q8 else 'modulate_norm'} "
                          f"{list(a[0].shape)}: {bit_diff(fns[name, q8](*a), fns['final', q8](*a))}",
                          flush=True)

    for q8, args in modes.items():
        time_in_turns(fns, list(libs), q8, args, SHAPE)
    for q8, args in wides.items():
        if len(wide_names[q8]) > 1:
            time_in_turns(fns, wide_names[q8], q8, args, WIDE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
