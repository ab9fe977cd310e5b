"""Device-time breakdown of one flagship ControlDiT forward of the PyTorch
port (orv_tpu_torch), bf16, sequence-parallel and W8A8, and of one
optimizer step of the 2B fine-tune recipe, on one NVIDIA GPU.

Run from the repository root on the machine with the card:

    python3 scripts/profile_torch_step.py

It builds chip_smoke.py's flagship DiT (seeded random weights) and inputs,
times one bf16 forward, then the same DiT at sp=4 (`LocalRing(4)`: four
ranks as threads time-sharing the one card, each repeating the work outside
attention) and one joint ring attention at [1,30,226+7800,64] with the
online kernel, quantizes the DiT in place (`quantize_model_`) and
times one W8A8 forward (`quant=True, attn_impl="flash_q8"`). Then, that
model freed, it builds chip_smoke.py's 2B-recipe training model (f32
parameters, bf16 compute) and times one optimizer step of two micro-steps
through `make_train_step`. Each piece runs once to warm up, once timed on
the host clock (ending in a synchronize) and once under torch.profiler. For each it prints the wall
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

from chip_smoke import (  # noqa: E402
    FLAGSHIP,
    LATENT,
    RECIPE_2B,
    TRAIN_LR,
    TRAIN_OPT,
    flagship_inputs,
    recipe_batch,
)
from orv_tpu_torch.models import ControlDiT  # noqa: E402
from orv_tpu_torch.models.quantize import quantize_model_  # noqa: E402
from orv_tpu_torch.ops.ring_attention import joint_ring_attention  # noqa: E402
from orv_tpu_torch.parallel import (  # noqa: E402
    TrainState,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from orv_tpu_torch.parallel.sp import LocalRing  # noqa: E402
from orv_tpu_torch.schedulers import make_schedule  # noqa: E402

# kernel name -> kind, first match wins
KINDS = [
    ("flash_attn_bwd dq (CUDA, this repo)", re.compile(r"flash_bwd_dq")),
    ("flash_attn_bwd dk/dv (CUDA, this repo)", re.compile(r"flash_bwd_dkv")),
    ("modulate_norm_bwd (CUDA, this repo)", re.compile(r"modulate_norm_bwd")),
    ("gated_residual_bwd (CUDA, this repo)", re.compile(r"gated_residual_bwd")),
    ("backward row sums (CUDA, this repo)", re.compile(r"sum_chunks")),
    ("flash_attn_q8 (CUDA, this repo)", re.compile(r"flash_fwd_q8")),
    ("flash_attn_static_max (CUDA, this repo)", re.compile(r"flash_fwd_static_max")),
    ("flash_attn_online (CUDA, this repo)", re.compile(r"flash_fwd_online")),
    ("modulate_norm_q8 (CUDA, this repo)", re.compile(r"modulate_norm_q8")),
    ("modulate_norm (CUDA, this repo)", re.compile(r"modulate_norm")),
    ("gated_residual (CUDA, this repo)", re.compile(r"gated_residual")),
    ("int8 GEMM (cuBLASLt via torch._int_mm)", re.compile(r"(?i)(i8|s8|imma|int8).*(gemm|xmma)"
                                                            r"|(gemm|xmma).*(i8|s8|imma|int8)")),
    ("bf16 GEMM (cuBLAS via F.linear)", re.compile(r"(?i)gemm|xmma|cutlass|cublas|nvjet")),
    ("AdamW and clip (torch._foreach_*, plain PyTorch)", re.compile(r"multi_tensor|foreach")),
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
    print(f"== {name}: wall {wall * 1e3:.1f} ms (profiled {wall_prof * 1e3:.1f} ms), "
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
    breakdown("bf16 forward", run)
    comm = LocalRing(4)
    dit.set_sp(comm)
    breakdown("bf16 forward at sp=4 (LocalRing: 4 ranks on one card)", lambda: comm.run(run))
    dit.set_sp(None)
    q, k, v = (torch.randn(1, 30, 226 + 7800, 64, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    breakdown("joint_ring_attention [1,30,226+7800,64], static_max=None, sp=4 on one card",
              lambda: comm.run(lambda: joint_ring_attention(q, k, v, 226, comm)))
    del q, k, v
    quantize_model_(dit)
    breakdown("W8A8 forward", run)
    del dit, run
    torch.cuda.empty_cache()

    torch.manual_seed(0)
    model = ControlDiT(RECIPE_2B, dtype=torch.bfloat16, param_dtype=torch.float32)
    tx = make_optimizer(make_lr_schedule(**TRAIN_LR), **TRAIN_OPT)
    state = TrainState.create(model, tx)
    step = make_train_step(tx, make_schedule(), recon_action=True)
    batch, gen = recipe_batch(), torch.Generator(device="cuda").manual_seed(20)

    def optimizer_step():
        for _ in range(TRAIN_OPT["grad_accum_steps"]):
            step(state, batch, gen)
    breakdown(f"2B recipe optimizer step ({TRAIN_OPT['grad_accum_steps']} micro-steps)",
              optimizer_step)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"latents {LATENT}, card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
