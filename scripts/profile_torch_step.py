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
model freed, it profiles one optimizer step of the 2B fine-tune recipe
inside a short run of the training entry point itself
(`pipelines/train.py:train`, NO_INIT_VAL, `max_train_steps` of 3 optimizer
steps): the port's base_train.yaml + experiments/traj_image_2b_finetune.yaml
on bridgev2 slices that chip_smoke.write_train_data writes to a temp dir,
B=4 x 2 micro-steps, random init (f32 parameters, bf16 compute). A wrapper
of the module's `make_train_step` marks the optimizer steps' ends: the
first warms up, the second is timed on the host clock and the third runs
under torch.profiler, each from the end of the optimizer step before, so
that it holds all the loop does between (the threaded loader, `to_device`,
the seeded draws; the recipe logs every 10th micro-step only). The run's
final checkpoint and export are written but not profiled. The forwards run
once to warm up, once timed on the host clock (ending in a synchronize)
and once under torch.profiler. For each piece it prints the wall time, the
summed device time of its kernels, the idle share (1 - device / wall of
the profiled run), the device time by kind of kernel and the top
kernels by device time.

Last it profiles one micro-step of the stage-3 multiview recipe
(`experiments/traj_image_2b_multiview.yaml`'s model: the 2B DiT with 30
MVBlocks, seeded random weights, per-block remat, only the `mv_blocks`
training) at the recipe's B=3 with 3 views of 5 latent frames, by hand:
the loss, its backward and one applied optimizer update (accumulation 1),
synchronized between the three. Besides the breakdown it splits the
device time by region (forward, backward, optimizer) and names the
recompute: the forward kinds' kernels (flash forward, adaLN forward,
gated residual) that ran inside the backward, and the forward region's
device time, which the recompute repeats (its GEMMs cannot be told from
the backward's by name).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    FLAGSHIP,
    LATENT,
    MULTIVIEW_2B,
    RECIPE_2B,
    flagship_inputs,
    train_config,
    write_train_data,
)
from orv_tpu_torch.models import ControlDiT  # noqa: E402
from orv_tpu_torch.parallel import (LossDraws, TrainState, diffusion_loss,  # noqa: E402
                                    make_lr_schedule, make_optimizer)
from orv_tpu_torch.parallel.train_step import global_norm, grad_params  # noqa: E402
from orv_tpu_torch.models.quantize import quantize_model_  # noqa: E402
from orv_tpu_torch.ops.ring_attention import joint_ring_attention  # noqa: E402
from orv_tpu_torch.parallel.sp import LocalRing  # noqa: E402
from orv_tpu_torch.pipelines import train as train_mod  # noqa: E402
from orv_tpu_torch.schedulers import make_schedule  # noqa: E402

# kernel name -> kind, first match wins. The adaLN backwards add their sums
# over S inside their one launch (csrc/adaln_bwd_sm90.cuh), so their time
# includes what the first design's second launch, `sum_chunks_kernel`, took.
KINDS = [
    ("flash_attn_bwd dq (CUDA, this repo)", re.compile(r"flash_bwd_dq")),
    ("flash_attn_bwd dk/dv (CUDA, this repo)", re.compile(r"flash_bwd_dkv")),
    ("modulate_norm_bwd (CUDA, this repo)", re.compile(r"modulate_norm_bwd_kernel")),
    ("gated_residual_bwd (CUDA, this repo)", re.compile(r"gated_residual_bwd_kernel")),
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


# the stage-3 micro-step's regions (`record_function` ranges), and the forward
# kinds whose kernels inside the backward are the recompute's
REGIONS = ("forward", "backward", "optimizer")
FORWARD_KINDS = re.compile(r"flash_fwd_static_max|modulate_norm|gated_residual")  # and no "bwd"


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


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def breakdown(name: str, run) -> None:
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profiler() as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    report(name, wall, wall_prof, prof)


def device_events(prof):
    """The profile's device events, less the ranges of `record_function`
    that it also records on the device timeline (`REGIONS`)."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in REGIONS]


def report(name: str, wall: float, wall_prof: float, prof) -> None:
    per_kernel, per_kind = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for e in device_events(prof):
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


class OptimizerSteps:
    """Wraps pipelines/train.py's `make_train_step`: the step function it
    returns marks the end of every `accum`-th micro-step, an optimizer
    step's. The first optimizer step warms up, the second is timed on the
    host clock, the third runs under torch.profiler."""

    def __init__(self, accum: int):
        self.accum, self.calls, self.t0 = accum, 0, 0.0
        self.wall = self.wall_prof = self.prof = None
        self.orig = train_mod.make_train_step

    def __enter__(self):
        def make_train_step(*args, **kwargs):
            fn = self.orig(*args, **kwargs)

            def step(*a, **k):
                out = fn(*a, **k)
                self.calls += 1
                if self.calls % self.accum == 0:
                    self.boundary(self.calls // self.accum)
                return out
            return step
        train_mod.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        train_mod.make_train_step = self.orig
        if self.prof is not None and self.wall_prof is None:
            self.prof.stop()

    def boundary(self, k: int) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        if k == 2:
            self.wall = now - self.t0
            self.prof = profiler()
            self.prof.start()
        elif k == 3:
            self.wall_prof = now - self.t0
            self.prof.stop()
        self.t0 = time.perf_counter()




def stage3_micro_step(views: int = 3, batch_size: int = 3) -> None:
    """One stage-3 micro-step by its regions (module docstring)."""
    torch.manual_seed(0)
    model = ControlDiT(MULTIVIEW_2B, dtype=torch.bfloat16, param_dtype=torch.float32, remat=True)
    tx = make_optimizer(make_lr_schedule("constant", 2e-4, warmup_steps=0),
                        trainable_predicate=train_mod.mv_blocks_only)
    state = TrainState.create(model, tx)
    g = torch.Generator(device="cuda").manual_seed(1)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    batch = dict(latents=rand(batch_size, 32, views * 5, 40, 60),
                 image_latents=rand(batch_size, 32, views, 40, 60),
                 prompt_embeds=0.1 * rand(batch_size, 226, 4096),
                 actions=0.1 * rand(batch_size, 16, 7))
    sched, params = make_schedule(), grad_params(model)

    def run():
        draws = LossDraws.draw(g, batch)
        with record_function("forward"):
            loss, _ = diffusion_loss(model, batch, sched, draws, num_views=views)
            torch.cuda.synchronize()
        with record_function("backward"):
            loss.backward()
            torch.cuda.synchronize()
        with record_function("optimizer"):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            for p in params:
                p.grad = None
            global_norm(grads)
            tx.update(grads, state.opt_state, params)
            torch.cuda.synchronize()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with profiler() as prof:
        t0 = time.perf_counter()
        run()
        wall_prof = time.perf_counter() - t0
    report(f"stage-3 micro-step (2B + 30 MVBlocks, remat, mv_blocks train; B={batch_size} x "
           f"{views} views x 5 latent frames, one applied AdamW update)", wall, wall_prof, prof)
    starts = {e.name: e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CPU and e.name in REGIONS}
    bounds = [starts[r] for r in REGIONS]
    device, recompute = defaultdict(float), 0.0
    for e in device_events(prof):
        i = sum(e.time_range.start >= b for b in bounds[1:3])
        us = e.time_range.elapsed_us()
        device[REGIONS[i]] += us
        if REGIONS[i] == "backward" and FORWARD_KINDS.search(e.name) and "bwd" not in e.name:
            recompute += us
    total = sum(device.values())
    print("  by region (device ms, share): " + ", ".join(
        f"{r} {device[r] / 1e3:.1f} ({device[r] / total:.1%})" for r in REGIONS)
        + f"; the forward kinds' kernels inside the backward (the recompute's flash forwards, "
        f"adaLN forwards and gated residuals) {recompute / 1e3:.1f} ms ({recompute / total:.1%}); "
        f"the recompute repeats the blocks' forward, about the forward region's "
        f"{device['forward'] / 1e3:.1f} ms ({device['forward'] / total:.1%} of the step); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)


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

    root = Path(tempfile.mkdtemp(prefix="orv_profile_"))
    os.environ["NO_INIT_VAL"] = "1"
    try:
        write_train_data(root / "data")
        cfg = train_config(root / "data", root / "out")
        bs, accum = int(cfg.train.train_batch_size), int(cfg.train.gradient_accumulation_steps)
        cfg = train_config(root / "data", root / "out", [f"train.max_train_steps={3 * accum}"])
        assert train_mod.build_dit_config(cfg) == RECIPE_2B, train_mod.build_dit_config(cfg)
        with OptimizerSteps(accum) as steps:
            train_mod.train(cfg)
        if steps.wall_prof is None:
            raise RuntimeError(f"train made {steps.calls} micro-steps through make_train_step, "
                               f"not the {3 * accum} to profile")
        report(f"2B recipe optimizer step inside pipelines/train.py:train (B={bs} x {accum} "
               "micro-steps: loader, to_device, draws, make_train_step)",
               steps.wall, steps.wall_prof, steps.prof)
    finally:
        os.environ.pop("NO_INIT_VAL", None)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    stage3_micro_step()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"latents {LATENT}, card: {smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
