"""Times design variants of the int8-QK^T flash forward against each other
on one NVIDIA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/time_flash_q8_variants.py

Each variant is the committed kernel (`Mode::kQ8` of
orv_tpu_torch/ops/csrc/flash_fwd_sm90.cuh behind flash_attn_q8.cu) with
design choices undone by text substitutions:
  final         as committed;
  scale_global  each consumer loads the tile's key-block scale from global
                memory as the tile's product starts, where the producer
                stores it in shared memory beside the K tile;
  convert_iadd  the s32 scores are converted to f32 by an exact integer-add
                trick (1.5 * 2^23 + s, less 1.5 * 2^23), not by I2F;
  first         both of the above: the kernel's first design;
  stages6       a K/V ring of 6 stages, not 4.
Each is built with nvcc into its own library under
orv_tpu_torch/ops/_build/variants/, checked against
`flash_attention_q8_plain` at [1,30,8026,64] (the smoke's bound), then
timed in turns (in order, reversed, in order, reversed), 20 launches a turn
captured in one CUDA graph and replayed between two CUDA events
(`chip_smoke.device_ms`; one call reads and writes 92 MB, more than the 50 MB
L2, so the inputs are not rotated). It prints each
variant's registers and spills, its errors, its times and their median,
SDPA's time on the same bf16 q, k and v, and the card.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms, q8_attention_errors  # noqa: E402
from orv_tpu_torch.ops import attention  # noqa: E402
from orv_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

SCALE_GLOBAL = [
    ("        // the arrive below releases this store to the consumers that wait on k_full\n"
     "        if constexpr (kQ8) sm.k_scale[st] = sk_r[t / prm.tiles_per_kblock];\n", ""),
    ("    mbar_wait(&sm.k_full[t % kStages], (t / kStages) & 1);\n"
     "    if constexpr (kQ8) sk_t = sm.k_scale[t % kStages];\n",
     "    if constexpr (kQ8) sk_t = sk_r[t / prm.tiles_per_kblock];\n"
     "    mbar_wait(&sm.k_full[t % kStages], (t / kStages) & 1);\n"),
]
CONVERT_IADD = [("__int2float_rn((int)s[i])",
                 "(__int_as_float((int)(s[i] + 0x4B400000u)) - 12582912.0f)")]
VARIANTS = {
    "final": [],
    "scale_global": SCALE_GLOBAL,
    "convert_iadd": CONVERT_IADD,
    "first": SCALE_GLOBAL + CONVERT_IADD,
    "stages6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
}


def build(name: str, edits) -> subprocess.Popen:
    """Write the variant's sources and start its nvcc."""
    d = BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    header = (CSRC / "flash_fwd_sm90.cuh").read_text()
    for old, new in edits:
        if header.count(old) != 1:
            raise RuntimeError(f"variant {name}: the header no longer holds {old!r}")
        header = header.replace(old, new)
    (d / "flash_fwd_sm90.cuh").write_text(header)
    for source in ("sm90_common.cuh", "flash_attn_q8.cu"):
        shutil.copy(CSRC / source, d / source)
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                             str(d / "flash_attn_q8.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_flash_q8_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    procs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        print(f"{name}: " + " | ".join(line.strip() for line in log.splitlines()
                                       if re.search(r"registers|spill|C75\d\d", line)), flush=True)
        fn = ctypes.CDLL(str(BUILD_DIR / "variants" / name / "lib.so")).orv_flash_attn_q8
        fn.argtypes, fn.restype = attention._Q8_ARGS, ctypes.c_int
        fns[name] = fn

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 30, 8026, 64, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    k = k + 0.5  # a token mean for the smoothing to take out, as the smoke's check
    ref = attention.flash_attention_q8_plain(q, k, v)
    k8, sk_r, block_k = attention.prepare_k_q8(k)
    out = torch.empty_like(q)

    def launch(name: str) -> None:
        err = fns[name](q.data_ptr(), k8.data_ptr(), sk_r.data_ptr(), v.data_ptr(),
                        out.data_ptr(), 30, 8026, 8026, k8.shape[2], block_k, sk_r.shape[1],
                        64 ** -0.5, attention.QK_NORM_LOGIT_BOUND,
                        torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"variant {name}: launch failed with error {err}")

    for name in fns:
        out.zero_()
        launch(name)
        torch.cuda.synchronize()
        err, rel, ok = q8_attention_errors(out, ref)
        print(f"{name}: max_abs_err {err:.3g}, rel RMS err {rel:.3g}, agrees {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"variant {name} disagrees with flash_attention_q8_plain")

    names = list(fns)
    times = {name: [] for name in names}
    for order in (names, names[::-1], names, names[::-1]):
        for name in order:
            times[name].append(device_ms(lambda: launch(name), [()], 20, name))
    for name in names:
        ts = sorted(times[name])
        print(f"time {name} [1,30,8026,64]: {' '.join(f'{t:.4f}' for t in times[name])} ms, "
              f"median {(ts[1] + ts[2]) / 2:.4f}", flush=True)
    sdpa = device_ms(torch.nn.functional.scaled_dot_product_attention, [(q, k, v)], 20, "SDPA")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"SDPA on bf16 q, k, v: {sdpa:.4f} ms; card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
