"""Times design variants of the two adaLN backward kernels against each other
on one NVIDIA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/time_adaln_bwd_variants.py [--against NAME=DIR ...]

Each variant is the committed kernel (orv_tpu_torch/ops/csrc/
adaln_bwd_sm90.cuh behind modulate_norm_bwd.cu and gated_residual_bwd.cu)
with one design choice changed by text substitutions of the header:
  final       as committed: tiles of up to 12 rows (modulate_norm_bwd) or 8
              (gated_residual_bwd), a ring of 2 stages, the
              sums over S in registers (gated_residual_bwd) or in shared
              memory (modulate_norm_bwd), one cooperative launch whose grid
              syncs and then adds the row-group segments' partials;
  rows8/10/14 modulate_norm_bwd's tiles of up to 8, 10 or 14 rows (a
              consumer warp each), not 12 (the widest instance holding all
              16 chunks at 8 and 10, which leave it registers enough);
  gr_rows4/12 gated_residual_bwd's tiles of up to 4 or 12 rows, not 8;
  stages3     a ring of 3 stages, not 2;
  acc_regs    modulate_norm_bwd's sums over S in each thread's registers, not
              in its columns of a shared [2, D] slice;
  two         two launches: the kernel writes the partials, a second kernel
              on the same grid adds them (no cooperative launch, no grid
              sync), as the first design's separate sum did;
  stagger     the producer issues a block's second tile only once its first
              has landed, so that every SM's first tile comes first;
  ring16      the ring right after the barriers and coefficients in shared
              memory (16-byte aligned at least), not rounded to 128 bytes.
A plan variant launches the final kernel with another plan than the
wrapper's `bwd_plan`: plan_whole takes whole tiles at every shape, not
fewer rows where whole tiles leave resident blocks idle (at the text
stream's [1,226,1920]: 29 blocks of 8-row tiles, not 113 of 2).
Cuts of the final kernel are timed beside them but not checked (their
outputs are wrong by design): cut_launch returns at once; cut_sync drops the
grid sync and the finish; cut_finish keeps the sync and drops the finish;
cut_ring only streams the tiles in and out through the ring; cut_rows does
the row work on whatever the ring holds, loading and storing no tile;
cut_no_stores does all but the output's bulk stores.
Each --against NAME=DIR (a checkout of another commit, e.g. one unpacked
with `git archive`) adds that checkout's two entry files as the variant
NAME, called through its own C interface (the first design's, with a chunk
of 16 rows a block and a second launch for the sums, where its csrc has no
adaln_bwd_sm90.cuh); dx and dy are compared with the final kernel's bit for
bit, the sums at the smoke's tolerance.
Every build goes into its own library under
orv_tpu_torch/ops/_build/variants/adaln_bwd/ (all at once, one nvcc each).
Each checked variant is held against `modulate_norm_bwd_plain` and
`gated_residual_bwd_plain` at the smoke's tolerances (dx by RMS, dy exactly,
the sums to 1e-4 RMS) at [5,600,1920], [1,226,1920] and, where it takes
that width, [4,600,3072], with a second run bitwise equal; then all are
timed in turns (in order, reversed, in order, reversed) by
`chip_smoke.device_ms` (50 calls in one CUDA graph, inputs rotating over
copies that keep the 50 MB L2 cold): modulate_norm_bwd at [5,600,1920],
gated_residual_bwd at [5,600,1920] and [1,226,1920]. It prints each build's
registers and spills, the errors, the times and their medians against the
bytes' bound, the final kernel's time from torch.profiler's device
durations as a check on the timer, and the card.
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

from chip_smoke import PEAK_BYTES, device_ms, n_copies, nbytes, profiled_ms  # noqa: E402
from orv_tpu_torch.ops import adaln  # noqa: E402
from orv_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

HEADER = "adaln_bwd_sm90.cuh"
ENTRIES = ("modulate_norm_bwd.cu", "gated_residual_bwd.cu")
_SYNC = ("  cooperative_groups::this_grid().sync();  // the partials, to the blocks that add them\n"
         "  finish<kMode>(p);\n")
_LAUNCH = ("  void* args[] = {&p};\n"
           "  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), "
           "dim3(grid),\n"
           "                                          dim3(block_threads(m)), args,\n"
           "                                          smem_bytes(m, p.d, rows), "
           "(cudaStream_t)stream);\n")
_TWO = [(_SYNC, ""),
        ("// ---- the host side ----\n",
         "template <Mode kMode>\n"
         "__global__ void __launch_bounds__(block_threads(kMode))\n"
         "finish_kernel(const __grid_constant__ Params p) { finish<kMode>(p); }\n\n"
         "// ---- the host side ----\n"),
        (_LAUNCH,
         "  const cudaStream_t s = (cudaStream_t)stream;\n"
         "  kernel<<<grid, block_threads(m), smem_bytes(m, p.d, rows), s>>>(p);\n"
         "  const cudaError_t err = cudaGetLastError();\n"
         "  if (err != cudaSuccess) return (int)err;\n"
         "  if (m == Mode::kModulateNorm)\n"
         "    finish_kernel<Mode::kModulateNorm><<<grid, block_threads(m), 0, s>>>(p);\n"
         "  else\n"
         "    finish_kernel<Mode::kGatedResidual><<<grid, block_threads(m), 0, s>>>(p);\n"
         "  return (int)cudaGetLastError();\n")]
VARIANTS = {
    "final": [],
    "rows8": [("constexpr int kRows = 12;", "constexpr int kRows = 8;"),
              ("constexpr int kWideHeld = 12;", "constexpr int kWideHeld = 16;")],
    "rows10": [("constexpr int kRows = 12;", "constexpr int kRows = 10;"),
               ("constexpr int kWideHeld = 12;", "constexpr int kWideHeld = 16;")],
    "rows14": [("constexpr int kRows = 12;", "constexpr int kRows = 14;")],
    "gr_rows4": [("constexpr int kGrRows = 8;", "constexpr int kGrRows = 4;")],
    "gr_rows12": [("constexpr int kGrRows = 8;", "constexpr int kGrRows = 12;")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # modulate_norm_bwd's A and B in registers, not in shared memory
    "acc_regs": [("float4* acc4 = reinterpret_cast<float4*>(acc);",
                  "float4 ra[kVecs], rb[kVecs];"),
                 ("acc4[d4 + q]", "rb[k]"), ("acc4[q]", "ra[k]")],
    "two": _TWO,
    "stagger": [("    for (int n = 0; n < kStages && n < nt; ++n) load(n);",
                 "    for (int n = 0; n < kStages && n < nt; ++n) {\n      load(n);\n"
                 "      if (n == 0) sm90::mbar_wait(&full[0], 0);\n    }")],
    "ring16": [("+ 127) / 128 * 128;", ");")],
}
# modulate_norm_bwd's three phases, each skipped by a false condition
_P1 = [("    if (warp < tl.valid) {\n      st = row_stats",
        "    if (warp < 0) {\n      st = row_stats")]
_P2 = [("      if (q < d4) {\n        float4 a = acc4[q]",
        "      if (q < 0) {\n        float4 a = acc4[q]")]
_P3 = [("    if (warp < tl.valid)\n      row_dx", "    if (warp < 0)\n      row_dx")]
_GR_ROWS = [("    for (int i = 0; i < tl.valid; ++i) {\n#pragma unroll\n      for (int k",
             "    for (int i = 0; i < 0; ++i) {\n#pragma unroll\n      for (int k")]
_NO_STORES = [("        sm90::bulk_store(p.out + tl.row0 * d, ring + (m % kStages) * stage,\n"
               "                         (uint32_t)(tl.valid * d * 2));\n"
               "        sm90::bulk_commit();\n"
               "        sm90::bulk_wait_read<0>();  // the stage may be refilled after this\n", "")]
CUTS = {
    "cut_p1": _P1,
    "cut_p2": _P2,
    "cut_p3": _P3,
    "cut_div": [(f"warp_sum({v}) / d", f"__fdividef(warp_sum({v}), (float)d)")
                for v in ("sum", "sq", "gsum", "gxsum")],
    "cut_fence": [("    sm90::fence_proxy_async();  // the stage's new bytes, to the bulk store\n",
                   "")],
    "cut_launch": [("  extern __shared__ __align__(128) uint8_t smem[];\n  uint64_t* full",
                    "  if (p.s > 0) return;\n  extern __shared__ __align__(128) uint8_t smem[];\n"
                    "  uint64_t* full")],
    "cut_sync": [(_SYNC, "")],
    "cut_finish": [("  finish<kMode>(p);\n", "")],
    "cut_ring": _P1 + _P2 + _P3 + _GR_ROWS,
    "cut_rows": [("    if (lane == 0) {  // the producer",
                  "    if (lane == 0 && p.s < 0) {  // the producer"),
                 ("for (int n = 0; n < kStages && n < nt; ++n) load(n);", "(void)load;"),
                 ("sm90::mbar_wait(&full[n % kStages]",
                  "if (0) sm90::mbar_wait(&full[n % kStages]")],
    "cut_no_stores": _NO_STORES,
}
PLANS = {"plan_whole": "final"}
MN, WIDE = (5, 600, 1920), (4, 600, 3072)
GR = ((5, 600, 1920), (1, 226, 1920))


def build(name: str, csrc: Path, edits) -> subprocess.Popen:
    """Write the variant's sources (every header of `csrc`, the edits applied
    to the kernel's) and start its nvcc."""
    d = BUILD_DIR / "variants" / "adaln_bwd" / name
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


def _fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _check(err):
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def launchers(lib: ctypes.CDLL, plan: str = ""):
    """(mn(x, dout, scale, ns) -> (dx, A, B), gr(dout, y, gate) -> (dy,
    dgate)) through the library's C entries, as the wrappers call them, with
    the wrapper's plan or a plan variant's."""
    limits = {k: _fn(lib, f"orv_{k}_limits", adaln._LIMITS_ARGS)
              for k in ("modulate_norm_bwd", "gated_residual_bwd")}
    mn = _fn(lib, "orv_modulate_norm_bwd", adaln._MNB_ARGS)
    gr = _fn(lib, "orv_gated_residual_bwd", adaln._GRB_ARGS)
    cache = {}

    def tiling(kind, R, S, D):
        if (kind, D) not in cache:
            out = (ctypes.c_int * 2)()
            _check(limits[kind](D, ctypes.addressof(out)))
            cache[kind, D] = (out[0], out[1])
        max_rows, resident = cache[kind, D]
        rows, grid, n_part = adaln.bwd_plan(R, S, max_rows, resident)
        if plan == "plan_whole":
            rows = max_rows
            grid = min(R * -(-S // rows), resident)
            n_part = grid + R - 1
        return rows, grid, n_part

    def mn_launch(x, do, scale, ns):
        R, S, D = x.shape
        rows, grid, n_part = tiling("modulate_norm_bwd", R, S, D)
        mn_launch.plans[R, S, D] = (rows, grid)
        dx = torch.empty_like(x)
        part = torch.empty((n_part, 2, D), dtype=torch.float32, device=x.device)
        ab = torch.empty((R, 2, D), dtype=torch.float32, device=x.device)
        _check(mn(x.data_ptr(), do.data_ptr(), scale.data_ptr(), scale.stride(0), ns.data_ptr(),
                  dx.data_ptr(), part.data_ptr(), ab.data_ptr(), R, S, D, rows, grid, 1e-5,
                  int(scale.dtype == torch.bfloat16), int(ns.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream))
        return dx, ab[:, 0], ab[:, 1]

    def gr_launch(do, y, gate):
        R, S, D = y.shape
        rows, grid, n_part = tiling("gated_residual_bwd", R, S, D)
        gr_launch.plans[R, S, D] = (rows, grid)
        dy = torch.empty_like(y)
        part = torch.empty((n_part, D), dtype=torch.float32, device=y.device)
        dgate = torch.empty((R, D), dtype=torch.float32, device=y.device)
        _check(gr(do.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), dy.data_ptr(),
                  part.data_ptr(), dgate.data_ptr(), R, S, D, rows, grid,
                  int(gate.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream))
        return dy, dgate
    mn_launch.plans, gr_launch.plans = {}, {}
    return mn_launch, gr_launch


def first_design_launchers(lib: ctypes.CDLL):
    """The same for a checkout of the first design: 16 rows a block, the
    partials summed by a second launch."""
    mn = _fn(lib, "orv_modulate_norm_bwd", [ctypes.c_void_p] * 3 + [ctypes.c_long]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    gr = _fn(lib, "orv_gated_residual_bwd", [ctypes.c_void_p] * 3 + [ctypes.c_long]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def mn_launch(x, do, scale, ns):
        R, S, D = x.shape
        dx = torch.empty_like(x)
        part = torch.empty((R, -(-S // 16), 2, D), dtype=torch.float32, device=x.device)
        ab = torch.empty((R, 2, D), dtype=torch.float32, device=x.device)
        _check(mn(x.data_ptr(), do.data_ptr(), scale.data_ptr(), scale.stride(0), ns.data_ptr(),
                  dx.data_ptr(), part.data_ptr(), ab.data_ptr(), R, S, D, 16, 1e-5,
                  int(scale.dtype == torch.bfloat16), int(ns.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream))
        return dx, ab[:, 0], ab[:, 1]

    def gr_launch(do, y, gate):
        R, S, D = y.shape
        dy = torch.empty_like(y)
        part = torch.empty((R, -(-S // 16), D), dtype=torch.float32, device=y.device)
        dgate = torch.empty((R, D), dtype=torch.float32, device=y.device)
        _check(gr(do.data_ptr(), y.data_ptr(), gate.data_ptr(), gate.stride(0), dy.data_ptr(),
                  part.data_ptr(), dgate.data_ptr(), R, S, D, 16,
                  int(gate.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream))
        return dy, dgate
    return mn_launch, gr_launch


def rel_rms(got, want) -> float:
    d, r = got.float() - want.float(), want.float()
    return (d.pow(2).mean().sqrt() / r.pow(2).mean().sqrt()).item()


def agrees(kind: str, fn, args) -> str:
    """The smoke's check of one kernel on args, and a second run bitwise
    equal; raises on a disagreement."""
    got, again = fn(*args), fn(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if kind == "mn":
        want = adaln.modulate_norm_bwd_plain(*args)
        d, rms = (got[0].float() - want[0].float()), want[0].float().pow(2).mean().sqrt().item()
        errs = (d.abs().max().item() / rms, rel_rms(got[0], want[0]), rel_rms(got[1], want[1]),
                rel_rms(got[2], want[2]))
        ok = errs[0] <= 0.1 and errs[1] <= 1e-2 and errs[2] <= 1e-4 and errs[3] <= 1e-4
        what = (f"dx max {errs[0]:.3g} RMS(ref), rel RMS {errs[1]:.3g}; A/B rel RMS "
                f"{errs[2]:.3g} / {errs[3]:.3g}")
    else:
        want = adaln.gated_residual_bwd_plain(*args)
        exact, rel = torch.equal(got[0], want[0]), rel_rms(got[1], want[1])
        ok, what = exact and rel <= 1e-4, f"dy exact {exact}, dgate rel RMS {rel:.3g}"
    if not (ok and same):
        raise RuntimeError(f"{kind} disagrees at {list(args[0].shape)}: {what}, repeat {same}")
    return what + ", repeat bitwise equal"


def bit_diff(a, b) -> str:
    """How many elements of two bf16 outputs differ in their bits, and the
    sums' relative RMS difference."""
    n = int((a[0].view(torch.int16) != b[0].view(torch.int16)).sum())
    out = f"{n} of {a[0].numel()} differ"
    return out + "; sums rel RMS " + ", ".join(f"{rel_rms(x, y):.3g}" for x, y in zip(a[1:], b[1:]))


def time_in_turns(fns, names, what: str, args, moved: int) -> None:
    """Times names' launches at args in turns and prints each median against
    the bytes' bound."""
    out = fns[names[0]](*args)
    calls = [args] + [tuple(t.clone() if i < 2 else t for i, t in enumerate(args))
                      for _ in range(n_copies(nbytes(args[:2]) + nbytes(out)) - 1)]
    times = {name: [] for name in names}
    for order in (names, names[::-1], names, names[::-1]):
        for name in order:
            times[name].append(device_ms(fns[name], calls, 50, f"{name} {what}"))
    bound = moved / PEAK_BYTES * 1e3
    for name in names:
        ts = sorted(times[name])
        med = (ts[1] + ts[2]) / 2
        print(f"time {name} {what}: {' '.join(f'{t:.4f}' for t in times[name])} ms, median "
              f"{med:.4f}, {bound / med:.1%} of the bytes' bound ({bound:.4f} ms)", flush=True)
    print(f"profiler final {what}: {profiled_ms(fns['final'], calls, 50):.4f} ms a call "
          f"(device durations)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="a checkout whose adaLN backwards to check and time too, as NAME")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_adaln_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    against = {}
    for spec in opts.against:
        name, _, d = spec.partition("=")
        if not name or not d or name in VARIANTS or name in CUTS or name in PLANS:
            ap.error(f"--against takes NAME=DIR with a NAME no variant has; got {spec!r}")
        against[name] = Path(d).resolve() / "orv_tpu_torch" / "ops" / "csrc"
    sources = {name: (CSRC, edits) for name, edits in {**VARIANTS, **CUTS}.items()}
    sources.update({name: (csrc, []) for name, csrc in against.items()})
    procs = {name: build(name, csrc, edits) for name, (csrc, edits) in sources.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spilled = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        spills = re.findall(r"entry function '\w*?((?:modulate_norm|gated_residual)_bwd_kernel"
                            r"ILi\d+E)[^\n]*\n[^\n]*\n[^\n]*?(\d+) bytes spill stores", log)
        spilled_in = [k for k, n in spills if int(n)]
        shown = {k: r for k, r in re.findall(
            r"entry function '\w*?((?:modulate_norm|gated_residual)_bwd_kernel\w*?ILi\d+E)"
            r"[^\n]*\n(?:[^\n]*\n){2}[^\n]*Used (\d+) registers", log)
            if k.endswith(("ILi15E", "ILi1E")) and ("modulate" in k) == k.endswith("ILi15E")}
        print(f"{name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers ({shown}), "
              f"{spilled} bytes of spill stores and loads {spilled_in or ''}", flush=True)
        lib = ctypes.CDLL(str(BUILD_DIR / "variants" / "adaln_bwd" / name / "lib.so"))
        first = name in against and not (against[name] / HEADER).exists()
        fns[name] = first_design_launchers(lib) if first else launchers(lib)
    for plan, base in PLANS.items():
        lib = ctypes.CDLL(str(BUILD_DIR / "variants" / "adaln_bwd" / base / "lib.so"))
        fns[plan] = launchers(lib, plan)

    g = torch.Generator(device="cuda").manual_seed(0)

    def mn_args(R, S, D):
        x = (2 * torch.randn(R, S, D, device="cuda", generator=g) + 0.3).bfloat16()
        do = torch.randn(R, S, D, device="cuda", generator=g).bfloat16()
        _, scale, _ = (0.3 * torch.randn(R, 3 * D, device="cuda", generator=g)).bfloat16(
        ).chunk(3, dim=-1)
        return x, do, scale, 1 + 0.1 * torch.randn(D, device="cuda", generator=g)

    def gr_args(R, S, D):
        do, y = (torch.randn(R, S, D, device="cuda", generator=g).bfloat16() for _ in range(2))
        return do, y, torch.randn(R, 3 * D, device="cuda", generator=g).bfloat16()[:, 2 * D:]

    mn_shapes = {s: mn_args(*s) for s in (MN, (1, 226, 1920), WIDE)}
    gr_shapes = {s: gr_args(*s) for s in (*GR, WIDE)}
    for name, (mn_fn, gr_fn) in fns.items():
        if name in CUTS:
            continue
        first = name in against and not (against[name] / HEADER).exists()
        for kind, fn, shapes in (("mn", mn_fn, mn_shapes), ("gr", gr_fn, gr_shapes)):
            for shape, args in shapes.items():
                if first and kind == "mn" and shape[2] > 2048:
                    continue  # the first design's adaLN backward takes D <= 2048
                what = agrees(kind, fn, args)
                plan = getattr(fn, "plans", {}).get(shape, "16 rows a block")
                print(f"{name} {kind} {list(shape)} (rows, grid {plan}): {what}", flush=True)
                if name in against:
                    final = fns["final"][0 if kind == "mn" else 1](*args)
                    print(f"bits {name} vs final {kind} {list(shape)}: "
                          f"{bit_diff(fn(*args), final)}", flush=True)

    names = list(fns)
    R, S, D = MN
    time_in_turns({n: f[0] for n, f in fns.items()}, names, f"modulate_norm_bwd {list(MN)}",
                  mn_shapes[MN], 3 * R * S * D * 2 + R * D * 2 + D * 4 + 2 * R * D * 4)
    for shape in GR:
        R, S, D = shape
        time_in_turns({n: f[1] for n, f in fns.items()}, names,
                      f"gated_residual_bwd {list(shape)}", gr_shapes[shape],
                      3 * R * S * D * 2 + R * D * 2 + R * D * 4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
