"""Device-time breakdown of one flagship ControlDiT forward of the PyTorch
port (orv_tpu_torch), bf16 and W8A8, on one NVIDIA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/profile_torch_step.py

It builds chip_smoke.py's flagship DiT (seeded random weights) and inputs,
times one bf16 forward, quantizes the DiT in place (`quantize_model_`) and
times one W8A8 forward (`quant=True, attn_impl="flash_q8"`). Each forward
runs once to warm up, once timed on the host clock (ending in a
synchronize) and once under torch.profiler. For each it prints the wall
time, the summed device time of its kernels, the idle share (1 - device /
wall of the profiled run), the device time by kind of kernel and the top
kernels by device time.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import FLAGSHIP, LATENT, flagship_inputs  # noqa: E402
from orv_tpu_torch.models import ControlDiT  # noqa: E402
from orv_tpu_torch.models.quantize import quantize_model_  # noqa: E402

# kernel name -> kind, first match wins
KINDS = [
    ("flash_attn_q8 (CUDA, this repo)", re.compile(r"flash_fwd_q8")),
    ("flash_attn_static_max (CUDA, this repo)", re.compile(r"flash_fwd_static_max")),
    ("modulate_norm_q8 (CUDA, this repo)", re.compile(r"modulate_norm_q8")),
    ("modulate_norm (CUDA, this repo)", re.compile(r"modulate_norm")),
    ("gated_residual (CUDA, this repo)", re.compile(r"gated_residual")),
    ("int8 GEMM (cuBLASLt via torch._int_mm)", re.compile(r"(?i)(i8|s8|imma|int8).*(gemm|xmma)"
                                                            r"|(gemm|xmma).*(i8|s8|imma|int8)")),
    ("bf16 GEMM (cuBLAS via F.linear)", re.compile(r"(?i)gemm|xmma|cutlass|cublas|nvjet")),
    ("elementwise, reductions, copies (plain PyTorch)", re.compile(r".")),
]


def kind(name: str) -> str:
    return next(k for k, pat in KINDS if pat.search(name))


def forward_fn(dit, inp):
    x = torch.cat([inp["lat"].bfloat16(), inp["img"]], dim=2)
    t = torch.full((1,), 999, device="cuda")

    def run():
        with torch.inference_mode():
            return dit(x, inp["enc"], t, actions=inp["actions"], depths=inp["depths"],
                       labels=inp["labels"])
    return run


def breakdown(name: str, run) -> None:
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    per_kernel, per_kind = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        per_kernel[e.name][0] += us
        per_kernel[e.name][1] += 1
        per_kind[kind(e.name)] += us
    device = sum(per_kind.values()) / 1e6
    if device == 0.0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"== {name} forward: wall {wall * 1e3:.1f} ms (profiled {wall_prof * 1e3:.1f} ms), "
          f"device {device * 1e3:.1f} ms, idle share {1 - device / wall_prof:.3f}", flush=True)
    for k, us in sorted(per_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.3f} ms  {us / 1e6 / device:6.1%}  {k}", flush=True)
    print("  top kernels (ms, launches):", flush=True)
    for n, (us, c) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.3f} {c:5d}  {n[:110]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_step: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.manual_seed(0)
    dit = ControlDiT(FLAGSHIP, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    inp = flagship_inputs(g)
    run = forward_fn(dit, inp)
    breakdown("bf16", run)
    quantize_model_(dit)
    breakdown("W8A8", run)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"latents {LATENT}, card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
