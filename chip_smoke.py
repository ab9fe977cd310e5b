"""Drives the PyTorch/CUDA port (orv_tpu_torch) on one NVIDIA GPU and checks it.

Run from the repository root on the machine with the card:

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no result:
  1. build the CUDA kernels from orv_tpu_torch/ops/csrc (nvcc, sm_90a, one
     process per source, all at once) and print their registers and spills,
     those of the seven Hopper kernels (the bf16 static-max and online and
     the int8 modes of flash_fwd_sm90.cuh, the backward's dq and dk/dv, the
     two adaLN forwards of adaln_fwd_sm90.cuh) again, by kernel, with any
     ptxas notice about a wgmma pipeline; a spill or such a notice there
     fails the run;
  2. hold each of the ten kernels against its plain PyTorch version on the
     card, at the flagship or training shapes and at small ragged ones (the
     adaLN forwards also at the text stream's [1,226,1920], the training
     [5,600,1920] with f32 norm params, and rows 3072 and 4096 wide), and
     time kernel, plain version and the nearest single PyTorch call by
     device time alone (`device_ms`: many calls captured in one CUDA graph,
     their inputs rotating over copies that keep the L2 cold), with the
     host's time per call of the adaLN and gated-residual wrappers and of
     addcmul on lines of their own; the
     flash backward check must also reject a planted fault (dlse ignored),
     give the same bits on a second run, and agree at the ring's Sq != Skv
     shapes (226 x 1950, 1950 x 226, with dlse);
     the online-softmax forward runs at (1,2,300), at the ring's Sq != Skv
     shapes (226 x 1950, 1950 x 226), where it must agree with the
     static-max kernel, and at the flagship shape with q and k scaled until
     logits pass 150, where the static-max kernel must come out non-finite
     or wrong; one backward runs through its lse; time the W8A8 path's int8
     prep outside the kernels (prepare_k_q8, quantize_tokens); print each bf16
     forward's achieved TFLOP/s and its time over SDPA's at the flagship, the
     training shape [1,30,3226,64] (static max) and the ring's 226 x 1950
     and 1950 x 226 calls (online), the int8 forward's TOP/s, share of
     its bound and time over SDPA's at the flagship, and the backward
     kernels' TFLOP/s and shares of their bounds at the training shape
     with their sum over SDPA's flash backward;
  3. a tiny ControlDiT, bf16 and W8A8 (quant=True, attn_impl="flash_q8"), and
     a small VAE decode on the card against the same weights on the CPU
     (plain versions, f32); one train step of a tiny recon_action ControlDiT
     on the card (bf16 compute, backward kernels) and on the CPU (f32, plain
     versions) from the same weights and draws: loss and grad norm must
     agree, and every parameter that gets a gradient on the CPU must get a
     nonzero one on the card; then one bf16 ControlDiT forward at the
     flagship config (2B: 30 layers x 30 heads x 64, 6-chunk adaLN, visual
     guidance, seeded random weights) with launch counts of exactly
     30 / 60 / 120;
  3b. the ring on the card through LocalRing(4), four ranks as threads
     time-sharing the one card: joint_ring_attention at [1,30,226+7800,64]
     with static_max=None against the resident online flash_attention (28
     online launches, no static-max ones); the same flagship DiT at
     sp=LocalRing(4) against its resident forward, all four ranks' outputs
     bitwise equal, launches per rank static-max / modulate_norm /
     gated_residual / online = 210 / 60 / 120 / 0; 2 DPM steps of
     make_sampler at sp=4 against the same 2 steps resident;
  4. generation through the entry points, bf16 then W8A8: make_sampler (4
     DPM steps) and decode_chunked (6 latent frames a chunk) to 49x320x480
     frames. Between the two, the same flagship DiT is quantized in place
     (quantize_model_, no second copy) and one W8A8 forward must launch
     flash_q8 / modulate_norm_q8 / gated_residual = 30 / 60 / 120 and none
     of the bf16 attention and modulate_norm;
  5. training, the serving models freed first: the 2B fine-tune recipe
     (orv_tpu/config/experiments/traj_image_2b_finetune.yaml on
     base_train.yaml: 30 layers x 30 heads x 64, 6-chunk adaLN,
     recon_action, f32 parameters and bf16 compute, AdamW with clip 1.0,
     cosine_with_restarts and accumulation 2; B cut to 1 per micro-step)
     at full width, seeded random weights: one warm-up optimizer step, then
     3 timed ones, through make_train_step, then one more by hand to split
     a micro-step into forward, backward and optimizer. One micro-step must
     launch flash fwd / dq / dk-dv / modulate_norm / its backward /
     gated_residual / its backward = 30 / 30 / 30 / 60 / 60 / 120 / 119
     (the last block's text-stream output is unused, so autograd skips
     the backward of its last gated residual);
     loss and parameters must stay finite and the parameters must move;
  6. the card's name and power limit, the kernels' JSON line (launches:
     the sum over the two generation runs for the forward kernels, over the
     3 timed optimizer steps for the backward ones, the ring attention run
     of phase 3b for the online forward), and last the result line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time

import torch

from orv_tpu_torch.models import CausalVAE, ControlDiT, DiTConfig, VAEConfig, decode_chunked
from orv_tpu_torch.models.layers import quantize_tokens
from orv_tpu_torch.models.quantize import quantize_linear_params, quantize_model_
from orv_tpu_torch.ops import _build, adaln, attention
from orv_tpu_torch.ops.ring_attention import joint_ring_attention
from orv_tpu_torch.parallel import (
    LossDraws,
    TrainState,
    diffusion_loss,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from orv_tpu_torch.parallel.sp import LocalRing
from orv_tpu_torch.parallel.train_step import global_norm, trainable
from orv_tpu_torch.pipelines import SamplerConfig, decode_latents, make_sampler
from orv_tpu_torch.schedulers import make_schedule

# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12
FLAGSHIP = DiTConfig(num_attention_heads=30, attention_head_dim=64, num_layers=30,
                     in_channels=32, out_channels=16, text_embed_dim=4096, time_embed_dim=512,
                     modulate_encoder_hidden_states=True, visual_guidance=True)
LATENT = (13, 16, 40, 60)  # frames, channels, height, width (bench_phases.py:104-113)
STEPS = 4
KERNELS = (attention.flash_attention, adaln.modulate_norm, adaln.gated_residual,
           attention.flash_attention_q8, adaln.modulate_norm_q8,
           attention.flash_attention_bwd_dq, attention.flash_attention_bwd_dkv,
           adaln.modulate_norm_bwd, adaln.gated_residual_bwd,
           attention.flash_attention_online_kernel)
BF16_FORWARD = (30, 60, 120, 0, 0, 0, 0, 0, 0, 0)  # launches of one flagship forward, in KERNELS order
Q8_FORWARD = (0, 0, 120, 30, 60, 0, 0, 0, 0, 0)
SP = 4  # ranks of the in-process ring, all on the one card
# launches of one rank's flagship forward at sp=4: each block's joint ring runs
# 7 static-max attentions (video queries: text, local chunk, 3 rotated chunks;
# text queries: text, local chunk)
SP_FORWARD = (7 * 30, 60, 120, 0, 0, 0, 0, 0, 0, 0)


def train_micro_step_counts(num_layers: int):
    """Launches of one training micro-step, in KERNELS order. The last
    block's text-stream output feeds nothing (the head reads the video
    stream only), so autograd never runs the backward of that block's
    final text-stream gated residual: 4L - 1 of them for 4L forwards."""
    L = num_layers
    return (L, 2 * L, 4 * L, 0, 0, L, L, 2 * L, 4 * L - 1, 0)


TRAIN_MICRO_STEP = train_micro_step_counts(30)  # one micro-step of the 2B recipe
# the 2B fine-tune recipe: traj_image_2b_finetune.yaml on base_train.yaml
RECIPE_2B = DiTConfig(num_attention_heads=30, attention_head_dim=64, num_layers=30,
                      in_channels=32, out_channels=16, text_embed_dim=4096, time_embed_dim=512,
                      modulate_encoder_hidden_states=True, recon_action=True)
TRAIN_LATENT = (16, 5, 40, 60)  # bridgev2 17x320x480 clips: channels, frames, height, width
TRAIN_OPT = dict(optimizer="adamw", beta1=0.9, beta2=0.95, epsilon=1e-8, weight_decay=1e-3,
                 max_grad_norm=1.0, grad_accum_steps=2)
TRAIN_LR = dict(name="cosine_with_restarts", learning_rate=1e-4, warmup_steps=1000,
                total_steps=30000, num_cycles=1)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


L2_SPAN = 100 << 20  # bytes touched between two uses of one input copy (the L2 holds 50 MB)
_capture_stream = None


def capture_stream() -> torch.cuda.Stream:
    """The side stream on which `device_ms` captures its graphs."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    return _capture_stream


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def nbytes(obj) -> int:
    """Bytes of the distinct storages of the tensors in obj (nested tuples)."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in _tensors(obj)}.values())


def _copy(obj):
    """obj with every tensor copied into new memory of the same strides."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_strided(obj.shape, obj.stride(), dtype=obj.dtype,
                                   device=obj.device).copy_(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_copy(o) for o in obj)
    return obj


def n_copies(per_call_bytes: int) -> int:
    """Copies of a call's inputs that a rotation needs so that the calls
    between two uses of one copy touch more than L2_SPAN bytes (at most 128:
    calls under 0.8 MB find part of their inputs in the L2)."""
    return min(2 + L2_SPAN // max(per_call_bytes, 1), 128)


def device_ms(fn, calls, n: int, what: str) -> float:
    """Mean device time of one call fn(*c), c rotating over `calls` (argument
    tuples; see n_copies): n calls, rounded up to whole rotations, captured
    in one CUDA graph (their outputs kept, as a caller's would be), replayed
    three times between two CUDA events. No host work falls between the
    events. A call that cannot be captured is timed instead by the sum of its
    device durations in torch.profiler over n calls; a line says so."""
    n = len(calls) * -(-n // len(calls))
    fn(*calls[0])  # warm-up: builds, lazy initialization
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    try:
        with torch.cuda.graph(graph, stream=capture_stream()):
            for i in range(n):
                outs.append(fn(*calls[i % len(calls)]))
    except RuntimeError as e:
        del graph, outs
        torch.cuda.synchronize()
        ms = profiled_ms(fn, calls, n)
        print(f"timer {what}: not captured in a CUDA graph ({str(e).splitlines()[0][:100]}); "
              f"{ms:.4f} ms a call from torch.profiler's device durations", flush=True)
        return ms
    graph.replay()
    total = 0.0
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    del graph, outs
    return total / (3 * n)


def profiled_ms(fn, calls, n: int) -> float:
    """Sum of the device durations torch.profiler records over n calls
    rotating over `calls`, over n."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*calls[i % len(calls)])
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(us > 0, "torch.profiler recorded no device time")
    return us / 1e3 / n


def call_ms(what: str, fn, args=(), n: int = 20) -> float:
    """`device_ms` of fn(*args), the inputs copied as often as n_copies asks
    for one call's inputs and outputs."""
    out = fn(*args)
    torch.cuda.synchronize()
    calls = [args] + [_copy(args) for _ in range(n_copies(nbytes(args) + nbytes(out)) - 1)]
    return device_ms(fn, calls, n, what)


def host_us(what: str, fn, args, n: int = 200) -> None:
    """Print the host's time per call of fn(*args): perf_counter around n
    back-to-back calls, before the synchronize. It is the part a host-timed
    launch would add to a kernel's device time."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    print(f"host {what}: {us:.1f} us a call ({n} calls back to back, before the synchronize)",
          flush=True)


def bound_ms(nbytes: float, bf16: float = 0.0, int8: float = 0.0, f32: float = 0.0):
    """The larger of the bytes' time and the operations' time, each kind of
    operation at its own peak rate."""
    t_ops = bf16 / PEAK_BF16_FLOPS + int8 / PEAK_INT8_OPS + f32 / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def within(got, want, atol: float, rtol: float) -> bool:
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


def check_attention(g, shape, timed: bool):
    q, k, v = (torch.randn(*shape, 64, device="cuda", generator=g).bfloat16() for _ in range(3))
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
    ref, ref_lse = attention.flash_attention_plain(q, k, v, static_max=24.0)
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    print(f"kernel flash_attn_static_max {list(q.shape)}: max_abs_err out {err:.3g} "
          f"(tol 1e-2), lse {lse_err:.3g} (tol 1e-3)", flush=True)
    check(err <= 1e-2 and lse_err <= 1e-3, f"flash attention disagrees at {shape}")
    if not timed:
        return None
    BH, S = shape[0] * shape[1], shape[2]
    bms, by = bound_ms(4 * BH * S * 64 * 2 + BH * S * 4, bf16=4.0 * S * S * 64 * BH)
    rec = dict(name="flash_attn_static_max", route="cuda",
               source="orv_tpu_torch/ops/csrc/flash_attn_static_max.cu",
               replaces="orv_tpu/ops/attention.py:124", max_abs_err=err,
               ms=call_ms("flash_attn_static_max", lambda *a: attention.flash_attention(
                   *a, static_max=24.0), (q, k, v), 10),
               plain_ms=call_ms("flash_attention_plain (static max)", lambda *a: (
                   attention.flash_attention_plain(*a, static_max=24.0)), (q, k, v), 3),
               bound_ms=bms, bound_by=by,
               library_ms=call_ms("SDPA", torch.nn.functional.scaled_dot_product_attention,
                                  (q, k, v), 10))
    return rec


def max_logit(q, k) -> float:
    """The largest attention logit f32(bf16(q * scale) . k), head by head."""
    qs = q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    return max((qs[:, h].float() @ k[:, h].float().transpose(-1, -2)).max().item()
               for h in range(q.shape[1]))


def check_attention_online(g, heads: int, sq: int, skv: int, logit_scale: float, timed: bool):
    """The online-softmax kernel (flash_attention's default) against its
    plain version: out to 1e-2 + 1e-2|ref| (one bf16 rounding: sharp
    softmaxes at large logits give outputs as large as v's), lse to 1e-3 +
    1e-6|lse|. With logit_scale 1
    the logits stay bounded and the static-max kernel must agree with it
    (out 1e-2, lse 1e-3); scaled, the largest logit must pass 150 and the
    static-max kernel must come out non-finite or outside that bound."""
    rand = lambda n: torch.randn(1, heads, n, 64, device="cuda", generator=g)
    q, k = ((logit_scale * rand(n)).bfloat16() for n in (sq, skv))
    v = rand(skv).bfloat16()
    out, lse = attention.flash_attention(q, k, v)
    ref, ref_lse = attention.flash_attention_plain(q, k, v)
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    print(f"kernel flash_attn_online {list(q.shape)} x kv {list(k.shape)}: max_abs_err out "
          f"{err:.3g} (tol 1e-2 + 1e-2|ref|), lse {lse_err:.3g} (tol 1e-3 + 1e-6|lse|)",
          flush=True)
    check(within(out, ref, 1e-2, 1e-2) and within(lse, ref_lse, 1e-3, 1e-6),
          f"online flash attention disagrees at {(heads, sq, skv)}")
    static, static_lse = attention.flash_attention(q, k, v, static_max=24.0)
    s_err, s_lse_err = max_err(static, out), max_err(static_lse, lse)
    static_ok = bool(torch.isfinite(static.float()).all()) and s_err <= 1e-2 and s_lse_err <= 1e-3
    if logit_scale == 1.0:
        print(f"  static-max kernel on the same bounded inputs: out {s_err:.3g} (tol 1e-2), "
              f"lse {s_lse_err:.3g} (tol 1e-3) from the online kernel", flush=True)
        check(static_ok, f"the static-max and online kernels disagree at {(heads, sq, skv)}")
    else:
        top = max_logit(q, k)
        print(f"  largest logit {top:.1f} (must pass 150); static-max kernel: finite "
              f"{bool(torch.isfinite(static.float()).all())}, max_abs_err out {s_err:.3g}, "
              f"rejected: {not static_ok}", flush=True)
        check(top >= 150.0 and not static_ok,
              f"the large-logit inputs do not need the running max at {(heads, sq, skv)}")
    if not timed:
        return None
    BH, scale = heads, 64 ** -0.5
    bms, by = bound_ms(2 * BH * (sq + skv) * 64 * 2 + BH * sq * 4, bf16=4.0 * sq * skv * 64 * BH)
    return dict(name="flash_attn_online", route="cuda",
                source="orv_tpu_torch/ops/csrc/flash_attn_online.cu",
                replaces="orv_tpu/ops/attention.py:62", max_abs_err=err,
                ms=call_ms("flash_attn_online", attention.flash_attention_online_kernel,
                           (q, k, v, scale), 10),
                plain_ms=call_ms("flash_attention_plain (online)", attention.flash_attention_plain,
                                 (q, k, v), 3),
                bound_ms=bms, bound_by=by,
                library_ms=call_ms("SDPA", torch.nn.functional.scaled_dot_product_attention,
                                   (q, k, v), 10))


def forward_rate(name: str, heads: int, sq: int, skv: int, ms: float, library_ms: float) -> None:
    """Print a bf16 forward's achieved TFLOP/s (4*Sq*Skv*64*H FLOP) and its
    time over SDPA's on the same inputs."""
    tflops = 4.0 * sq * skv * 64 * heads / (ms * 1e-3) / 1e12
    print(f"rate {name} [1,{heads},{sq},64] x {skv} keys: {ms:.4f} ms, {tflops:.1f} TFLOP/s "
          f"({tflops * 1e12 / PEAK_BF16_FLOPS:.1%} of the bf16 peak); SDPA {library_ms:.4f} ms, "
          f"kernel / SDPA {ms / library_ms:.2f}", flush=True)


def q8_rate(rec, heads: int, s: int) -> None:
    """Print the int8 forward's achieved rate: 2*S^2*64*H int8 operations
    (Q.K^T) plus as many bf16 FLOP (P.V) over its time, its share of the
    bound, and its time over SDPA's on bf16 q, k and v."""
    tops = 4.0 * s * s * 64 * heads / (rec["ms"] * 1e-3) / 1e12
    print(f"rate flash_attn_q8 [1,{heads},{s},64]: {rec['ms']:.4f} ms, {tops:.1f} TOP/s (int8 "
          f"Q.K^T + bf16 P.V), {rec['bound_ms'] / rec['ms']:.1%} of the bound "
          f"({rec['bound_ms']:.4f} ms, {rec['bound_by']}); SDPA {rec['library_ms']:.4f} ms, "
          f"kernel / SDPA {rec['ms'] / rec['library_ms']:.2f}", flush=True)


def time_forward(g, heads: int, sq: int, skv: int, static_max):
    """(kernel ms, SDPA ms) of one bf16 forward over [1, heads, sq, 64]
    queries and skv keys: the static-max kernel, or the online one for
    static_max=None."""
    q = torch.randn(1, heads, sq, 64, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(1, heads, skv, 64, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    if static_max is None:
        fn = lambda *a: attention.flash_attention_online_kernel(*a, 64 ** -0.5)
    else:
        fn = lambda *a: attention.flash_attention(*a, static_max=static_max)
    return (call_ms(f"forward {heads}x{sq}x{skv}", fn, (q, k, v), 10),
            call_ms("SDPA", torch.nn.functional.scaled_dot_product_attention, (q, k, v), 10))


HOPPER_SOURCES = ("flash_attn_static_max.cu", "flash_attn_online.cu", "flash_attn_q8.cu",
                  "flash_attn_bwd.cu", "modulate_norm.cu", "modulate_norm_q8.cu")
# a kernel's name, and an adaLN forward instance's chunks of 128 columns held
# in registers
KERNEL_NAME = re.compile(
    r"((?:flash_(?:fwd|bwd)_\w*?|modulate_norm(?:_q8)?)_kernel)(?:E|ILi(\d+)E)")
SHOWN_HELD = ("15", "16")  # D = 1920, and D = 2048-4096, of the 16 instances checked


def hopper_build_report() -> None:
    """The ptxas report of the Hopper kernels: the TMA + wgmma ones (the
    three forwards, each entry file one mode of flash_fwd_sm90.cuh's kernel,
    and the backward's dq and dk/dv kernels) and the two bulk-copy adaLN
    forwards (adaln_fwd_sm90.cuh, one instance per held-chunk count,
    SHOWN_HELD printed). Registers and spills of each kernel, and any notice that ptxas
    serialized or fenced a wgmma pipeline (C75xx); either of the last two, in
    any instance, fails the run."""
    if not _build.build_log:
        print("Hopper kernels: no build log (the library was built before)", flush=True)
        return
    source, kernel, held, faults = None, "", None, []
    for line in _build.build_log.splitlines():
        if line.startswith("== "):
            source, kernel, held = line[3:].strip(), "", None
        elif source not in HOPPER_SOURCES:
            continue
        elif "entry function" in line:
            name = KERNEL_NAME.search(line)
            kernel, held = (name.group(1), name.group(2)) if name else ("?", None)
        elif re.search(r"registers|spill|C75\d\d", line):
            name = KERNEL_NAME.search(line)  # a notice names its function
            what = f"{source} {name.group(1) if name else kernel}" + (f"<{held}>" if held else "")
            head = re.split(r" (?:in|for) the function", line)[0].strip()
            if held is None or held in SHOWN_HELD:
                print(f"ptxas {what}: {head}", flush=True)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if re.search(r"C75\d\d", line) or (spills and any(map(int, spills.groups()))):
                faults.append(f"{what}: {line.strip()}")
    check(not faults, f"a Hopper kernel spilled or its wgmma pipeline was serialized: {faults}")


def check_attention_online_bwd(g, shape) -> None:
    """One backward through the online forward's (out, lse): the dq and
    dk/dv kernels take its out, lse and a dlse, against
    flash_attention_bwd_plain on the same out and lse (`rms_agree`)."""
    q, k, v, do = (torch.randn(*shape, 64, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    dlse = torch.randn(*shape, device="cuda", generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (attention.flash_attention_online_kernel.launches,
              attention.flash_attention_bwd_dq.launches, attention.flash_attention_bwd_dkv.launches)
    out, lse = attention.flash_attention(*leaves)
    ((out.float() * do.float()).sum() + (lse * dlse).sum()).backward()
    after = (attention.flash_attention_online_kernel.launches,
             attention.flash_attention_bwd_dq.launches, attention.flash_attention_bwd_dkv.launches)
    want = attention.flash_attention_bwd_plain(q, k, v, out.detach(), lse.detach(), do,
                                               dlse=dlse)
    rel = [rms_errors(leaf.grad, w)[1] for leaf, w in zip(leaves, want)]
    print(f"online forward + flash backward {list(q.shape)} with dlse: rel RMS err dq/dk/dv "
          f"{rel[0]:.3g} / {rel[1]:.3g} / {rel[2]:.3g} (tol 1e-2, max 0.1 RMS), launches "
          f"online/dq/dkv {tuple(a - b for a, b in zip(after, before))}", flush=True)
    check(all(rms_agree(leaf.grad, w) for leaf, w in zip(leaves, want))
          and tuple(a - b for a, b in zip(after, before)) == (1, 1, 1),
          f"the backward through the online forward disagrees at {shape}")


def adaln_inputs(g, R, S, D, x_scale: float, norm_f32: bool):
    """(x, scale, shift, ns, nb) of an adaLN forward: x [R, S, D] bf16; shift
    and scale as the modulation linear leaves them, row-strided bf16 chunks
    of [R, 3D]; the norm params [D] bf16, or f32 as under f32 parameters."""
    x = (x_scale * torch.randn(R, S, D, device="cuda", generator=g)).bfloat16()
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, device="cuda", generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    ns = 1 + 0.1 * torch.randn(D, device="cuda", generator=g)
    nb = 0.1 * torch.randn(D, device="cuda", generator=g)
    return (x, scale, shift) + ((ns, nb) if norm_f32 else (ns.bfloat16(), nb.bfloat16()))


def check_modulate_norm(g, R, S, D, timed: bool, norm_f32: bool = False):
    args = adaln_inputs(g, R, S, D, 1.0, norm_f32)
    out = adaln.modulate_norm(*args)
    ref = adaln.modulate_norm_plain(*args)
    err = max_err(out, ref)
    print(f"kernel modulate_norm [{R}, {S}, {D}]{' f32 norm params' if norm_f32 else ''}: "
          f"max_abs_err {err:.3g} (tol 2e-2 + 1e-2|ref|)", flush=True)
    check(within(out, ref, 2e-2, 1e-2), f"modulate_norm disagrees at {(R, S, D)}")
    if not timed:
        return None
    host_us(f"modulate_norm [{R}, {S}, {D}]", adaln.modulate_norm, args)
    bms, by = bound_ms(2 * R * S * D * 2 + 2 * R * D * 2 + 2 * D * 2, f32=10.0 * R * S * D)
    return dict(name="modulate_norm", route="cuda", source="orv_tpu_torch/ops/csrc/modulate_norm.cu",
                replaces="orv_tpu/ops/adaln.py:52", max_abs_err=err,
                ms=call_ms("modulate_norm", adaln.modulate_norm, args, 50),
                plain_ms=call_ms("modulate_norm_plain", adaln.modulate_norm_plain, args, 10),
                bound_ms=bms, bound_by=by, library_ms=None)


def addcmul(x, y, gate):
    """x + y * gate[r] in one PyTorch call: the gated residual's yardstick."""
    return torch.addcmul(x, y, gate[:, None])


def check_gated_residual(g, R, S, D, timed: bool):
    x, y = (torch.randn(R, S, D, device="cuda", generator=g).bfloat16() for _ in range(2))
    gate = torch.randn(R, 3 * D, device="cuda", generator=g).bfloat16()[:, 2 * D:]
    out = adaln.gated_residual(x, y, gate)
    ref = adaln.gated_residual_plain(x, y, gate)
    err = max_err(out, ref)
    print(f"kernel gated_residual [{R}, {S}, {D}]: max_abs_err {err:.3g} "
          f"(tol 1e-2 + 1e-2|ref|)", flush=True)
    check(within(out, ref, 1e-2, 1e-2), f"gated_residual disagrees at {(R, S, D)}")
    if not timed:
        return None
    host_us(f"gated_residual [{R}, {S}, {D}]", adaln.gated_residual, (x, y, gate))
    host_us(f"addcmul [{R}, {S}, {D}]", addcmul, (x, y, gate))
    bms, by = bound_ms(3 * R * S * D * 2 + R * D * 2, f32=2.0 * R * S * D)
    return dict(name="gated_residual", route="cuda", source="orv_tpu_torch/ops/csrc/gated_residual.cu",
                replaces="orv_tpu/ops/adaln.py:248", max_abs_err=err,
                ms=call_ms("gated_residual", adaln.gated_residual, (x, y, gate), 50),
                plain_ms=call_ms("gated_residual_plain", adaln.gated_residual_plain,
                                 (x, y, gate), 10),
                bound_ms=bms, bound_by=by,
                library_ms=call_ms("addcmul", addcmul, (x, y, gate), 50))


def q8_attention_errors(out, ref):
    """(max abs error, relative RMS error, agrees) of an int8-QK^T attention
    output against its plain version. Both bounds scale with the output:
    the max error at most 0.1 of RMS(ref), the RMS error at most 1e-2 of it.
    Rounding the f32 output to bf16 alone gives a relative RMS of about
    1.7e-3; using block 0's k scale for every key block gives about 0.1."""
    d, r = out.float() - ref.float(), ref.float()
    rms = r.pow(2).mean().sqrt().item()
    err, rel = d.abs().max().item(), d.pow(2).mean().sqrt().item() / rms
    return err, rel, err <= 0.1 * rms and rel <= 1e-2


def check_attention_q8(g, shape, timed: bool):
    q, k, v = (torch.randn(*shape, 64, device="cuda", generator=g).bfloat16() for _ in range(3))
    k = k + 0.5  # a token mean for the smoothing to take out
    out = attention.flash_attention_q8(q, k, v)
    ref = attention.flash_attention_q8_plain(q, k, v)
    err, rel, ok = q8_attention_errors(out, ref)
    print(f"kernel flash_attn_q8 {list(q.shape)}: max_abs_err out {err:.3g} (tol 0.1*RMS(ref) "
          f"= {0.1 * ref.float().pow(2).mean().sqrt().item():.3g}), rel RMS err {rel:.3g} "
          f"(tol 1e-2)", flush=True)
    check(ok, f"int8 flash attention disagrees at {shape}")
    BH, S = shape[0] * shape[1], shape[2]
    prep = attention.prepare_k_q8(k)
    scale = 64 ** -0.5
    if prep[1].shape[1] > 1:  # the check must reject one k scale for all key blocks
        k8, sk_r, block_k = prep
        bad = attention.flash_attention_q8_kernel(
            q, (k8, sk_r[:, :1].expand_as(sk_r).contiguous(), block_k), v, S, scale)
        bad_err, bad_rel, bad_ok = q8_attention_errors(bad, ref)
        print(f"  planted fault (block 0's k scale for every block): max_abs_err {bad_err:.3g}, "
              f"rel RMS err {bad_rel:.3g}, rejected: {not bad_ok}", flush=True)
        check(not bad_ok, f"the int8 attention check passes a planted fault at {shape}")
    if not timed:
        return None, None
    k8_bytes = prep[0].numel() + prep[1].numel() * 4
    bms, by = bound_ms(3 * BH * S * 64 * 2 + k8_bytes, int8=2.0 * S * S * 64 * BH,
                       bf16=2.0 * S * S * 64 * BH)
    rec = dict(name="flash_attn_q8", route="cuda", source="orv_tpu_torch/ops/csrc/flash_attn_q8.cu",
               replaces="orv_tpu/ops/attention.py:174", max_abs_err=err,
               ms=call_ms("flash_attn_q8", attention.flash_attention_q8_kernel,
                          (q, prep, v, S, scale), 10),
               plain_ms=call_ms("flash_attention_q8_plain", attention.flash_attention_q8_plain,
                                (q, k, v), 3),
               bound_ms=bms, bound_by=by,
               library_ms=call_ms("SDPA", torch.nn.functional.scaled_dot_product_attention,
                                  (q, k, v), 10))
    return rec, call_ms("prepare_k_q8", attention.prepare_k_q8, (k,), 10)


def check_modulate_norm_q8(g, R, S, D, timed: bool, norm_f32: bool = False):
    args = adaln_inputs(g, R, S, D, 2.0, norm_f32)
    xq, xs = adaln.modulate_norm_q8(*args)
    ref_q, ref_s = adaln.modulate_norm_q8_plain(*args)
    diff = (xq.int() - ref_q.int()).abs()
    flips, s_err = (diff != 0).float().mean().item(), ((xs - ref_s).abs() / ref_s).max().item()
    print(f"kernel modulate_norm_q8 [{R}, {S}, {D}]{' f32 norm params' if norm_f32 else ''}: "
          f"xq max diff {diff.max().item()} (tol 1), {flips:.3g} of entries differ (tol 1e-3), "
          f"xscale rel err {s_err:.3g} (tol 1e-6)", flush=True)
    check(diff.max().item() <= 1 and flips <= 1e-3 and s_err <= 1e-6,
          f"modulate_norm_q8 disagrees at {(R, S, D)}")
    if not timed:
        return None
    host_us(f"modulate_norm_q8 [{R}, {S}, {D}]", adaln.modulate_norm_q8, args)
    bms, by = bound_ms(R * S * D * (2 + 1) + R * S * 4 + 2 * R * D * 2 + 2 * D * 2,
                       f32=14.0 * R * S * D)
    return dict(name="modulate_norm_q8", route="cuda",
                source="orv_tpu_torch/ops/csrc/modulate_norm_q8.cu",
                replaces="orv_tpu/ops/adaln.py:190", max_abs_err=float(diff.max().item()),
                ms=call_ms("modulate_norm_q8", adaln.modulate_norm_q8, args, 50),
                plain_ms=call_ms("modulate_norm_q8_plain", adaln.modulate_norm_q8_plain, args, 10),
                bound_ms=bms, bound_by=by, library_ms=None)


def rms_errors(got, want):
    """(max abs error, RMS error over RMS(ref), RMS(ref)) of got against want."""
    d, r = got.float() - want.float(), want.float()
    rms = r.pow(2).mean().sqrt().item()
    return d.abs().max().item(), d.pow(2).mean().sqrt().item() / rms, rms


def rms_agree(got, want, max_rel: float = 0.1, rms_rel: float = 1e-2) -> bool:
    """max error <= max_rel RMS(ref) and RMS error <= rms_rel RMS(ref). At
    the defaults, the backward kernels' bound: one bf16 rounding of an output
    gives an RMS error of about 1e-3; ignoring dlse gives errors of order
    RMS(ref)."""
    err, rel, rms = rms_errors(got, want)
    return err <= max_rel * rms and rel <= rms_rel


def check_attention_bwd(g, shape, with_dlse: bool, timed: bool, skv=None):
    """The flash backward kernels (dq, dk/dv) against their plain version,
    each output against its own RMS (`rms_agree`), over q [B, H, Sq, 64]
    (shape = (B, H, Sq)) and skv keys (Sq if not given); a second run must
    give the same bits (no atomics). With dlse, the same run with dlse
    ignored (a planted fault) must fail that check for dq and dk. Timed:
    records for both kernels; the plain time is the whole plain backward,
    the library time SDPA's flash backward (dq, dk, dv)."""
    B, H, sq = shape
    skv = sq if skv is None else skv
    q, do = (torch.randn(B, H, sq, 64, device="cuda", generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, H, skv, 64, device="cuda", generator=g).bfloat16() for _ in range(2))
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
    dlse = torch.randn(*shape, device="cuda", generator=g) if with_dlse else None
    got = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    want = attention.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse=dlse)
    again = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    what = f"{list(q.shape)} x kv {skv}{' with dlse' if with_dlse else ''}"
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err, rel, rms = rms_errors(a, b)
        errs[name] = err
        print(f"kernel flash_attn_bwd {name} {what}: max_abs_err {err:.3g} (tol 0.1*RMS(ref) = "
              f"{0.1 * rms:.3g}), rel RMS err {rel:.3g} (tol 1e-2)", flush=True)
        check(rms_agree(a, b), f"flash backward {name} disagrees at {what}")
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"  second run bitwise equal: {same}", flush=True)
    check(same, f"two runs of the flash backward differ at {what}")
    if with_dlse:
        bad = attention.flash_attention_bwd(q, k, v, out, lse, do)
        rel = [rms_errors(a, b)[1] for a, b in zip(bad, want)]
        rejected = [not rms_agree(a, b) for a, b in zip(bad, want)]
        print(f"  planted fault (dlse ignored): rel RMS err dq/dk/dv {rel[0]:.3g} / {rel[1]:.3g} "
              f"/ {rel[2]:.3g}, rejected {rejected}", flush=True)
        check(rejected[0] and rejected[1], f"the flash backward check passes a planted fault "
                                           f"at {what}")
    if not timed:
        return []
    BH, S = B * H, sq
    scale, tensor, row_bytes = 64 ** -0.5, BH * S * 64 * 2, BH * S * 4
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa_call():  # a forward on the capture stream, whose backward the graph takes
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        capture_stream().wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(capture_stream()), sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            o_lib = torch.nn.functional.scaled_dot_product_attention(*leaves)
        return o_lib, leaves, do.clone()

    calls = [sdpa_call() for _ in range(n_copies(8 * tensor + row_bytes))]
    torch.cuda.synchronize()
    lib_ms = device_ms(lambda o, leaves, d: torch.autograd.grad(o, leaves, d, retain_graph=True),
                       calls, 10, "SDPA flash backward")
    del calls
    plain_ms = call_ms("flash_attention_bwd_plain", attention.flash_attention_bwd_plain,
                       (q, k, v, out, lse, do), 3)
    _, delta = attention.flash_attention_bwd_dq(q, k, v, out, lse, do, scale)
    recs = []
    # dq: reads q, k, v, o, dO and lse, writes dq and delta; dk/dv: reads q,
    # k, v, dO, lse and delta, writes dk and dv
    for name, fn, args, n_products, replaces, err in (
            ("flash_attn_bwd_dq", attention.flash_attention_bwd_dq,
             (q, k, v, out, lse, do, scale), 3, ":389", errs["dq"]),
            ("flash_attn_bwd_dkv", attention.flash_attention_bwd_dkv,
             (q, k, v, do, lse, delta, scale), 4, ":432", max(errs["dk"], errs["dv"]))):
        bms, by = bound_ms(6 * tensor + 2 * row_bytes, bf16=n_products * 2.0 * S * S * 64 * BH)
        recs.append(dict(name=name, route="cuda", source="orv_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                         replaces="orv_tpu/ops/attention.py" + replaces, max_abs_err=err,
                         ms=call_ms(name, fn, args, 10), plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms))
    return recs


def bwd_rate(recs, heads: int, s: int) -> None:
    """Print each flash backward kernel's achieved TFLOP/s (3 and 4 products
    of 2*S^2*64*H FLOP) and share of its bound, and the two kernels' time
    over SDPA's flash backward."""
    parts = []
    for r, n_products in zip(recs, (3, 4)):
        tflops = n_products * 2.0 * s * s * 64 * heads / (r["ms"] * 1e-3) / 1e12
        parts.append(f"{r['name']} {r['ms']:.4f} ms, {tflops:.1f} TFLOP/s, "
                     f"{r['bound_ms'] / r['ms']:.1%} of its bound ({r['bound_ms']:.4f} ms)")
    total, lib = recs[0]["ms"] + recs[1]["ms"], recs[0]["library_ms"]
    print(f"rate flash_attn_bwd [1,{heads},{s},64]: " + "; ".join(parts) + f"; dq + dk/dv "
          f"{total:.4f} ms, SDPA backward {lib:.4f} ms, (dq + dk/dv) / SDPA {total / lib:.2f}",
          flush=True)


def check_modulate_norm_bwd(g, R, S, D, timed: bool):
    """dx against its RMS (`rms_agree`); the f32 row sums A and B, which
    only the summation order separates: max error <= 1e-3 and RMS error
    <= 1e-4 of RMS(ref). scale is a row-strided bf16 chunk and ns f32, as
    in the f32-parameter training model."""
    x = (2 * torch.randn(R, S, D, device="cuda", generator=g) + 0.3).bfloat16()
    do = torch.randn(R, S, D, device="cuda", generator=g).bfloat16()
    _, scale, _ = (0.3 * torch.randn(R, 3 * D, device="cuda", generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    ns = 1 + 0.1 * torch.randn(D, device="cuda", generator=g)
    got = adaln.modulate_norm_bwd(x, do, scale, ns)
    want = adaln.modulate_norm_bwd_plain(x, do, scale, ns)
    ok = [rms_agree(got[0], want[0])] + [rms_agree(a, b, 1e-3, 1e-4)
                                          for a, b in zip(got[1:], want[1:])]
    errs = [rms_errors(a, b) for a, b in zip(got, want)]
    print(f"kernel modulate_norm_bwd [{R}, {S}, {D}]: dx max_abs_err {errs[0][0]:.3g} "
          f"(tol 0.1*RMS(ref) = {0.1 * errs[0][2]:.3g}), rel RMS err {errs[0][1]:.3g} (tol 1e-2); "
          f"A/B rel RMS err {errs[1][1]:.3g} / {errs[2][1]:.3g} (tol 1e-4)", flush=True)
    check(all(ok), f"modulate_norm_bwd disagrees at {(R, S, D)}")
    if not timed:
        return None
    host_us(f"modulate_norm_bwd [{R}, {S}, {D}]", adaln.modulate_norm_bwd, (x, do, scale, ns))
    bms, by = bound_ms(3 * R * S * D * 2 + R * D * 2 + D * 4 + 2 * R * D * 4,
                       f32=16.0 * R * S * D)
    return dict(name="modulate_norm_bwd", route="cuda",
                source="orv_tpu_torch/ops/csrc/modulate_norm_bwd.cu",
                replaces="orv_tpu/ops/adaln.py:105", max_abs_err=errs[0][0],
                ms=call_ms("modulate_norm_bwd", adaln.modulate_norm_bwd, (x, do, scale, ns), 50),
                plain_ms=call_ms("modulate_norm_bwd_plain", adaln.modulate_norm_bwd_plain,
                                 (x, do, scale, ns), 10),
                bound_ms=bms, bound_by=by, library_ms=None)


def check_gated_residual_bwd(g, R, S, D, timed: bool):
    """dy exactly (one rounding of one f32 product, as the plain version);
    dgate's f32 sums: max error <= 1e-3 and RMS error <= 1e-4 of RMS(ref)."""
    do, y = (torch.randn(R, S, D, device="cuda", generator=g).bfloat16() for _ in range(2))
    gate = torch.randn(R, 3 * D, device="cuda", generator=g).bfloat16()[:, 2 * D:]
    dy, dgate = adaln.gated_residual_bwd(do, y, gate)
    ref_dy, ref_dgate = adaln.gated_residual_bwd_plain(do, y, gate)
    dy_err, (dg_err, dg_rel, _) = max_err(dy, ref_dy), rms_errors(dgate, ref_dgate)
    print(f"kernel gated_residual_bwd [{R}, {S}, {D}]: dy max_abs_err {dy_err:.3g} (tol 0), "
          f"dgate max_abs_err {dg_err:.3g}, rel RMS err {dg_rel:.3g} (tol 1e-4)", flush=True)
    check(dy_err == 0.0 and rms_agree(dgate, ref_dgate, 1e-3, 1e-4),
          f"gated_residual_bwd disagrees at {(R, S, D)}")
    if not timed:
        return None
    host_us(f"gated_residual_bwd [{R}, {S}, {D}]", adaln.gated_residual_bwd, (do, y, gate))
    bms, by = bound_ms(3 * R * S * D * 2 + R * D * 2 + R * D * 4, f32=3.0 * R * S * D)
    return dict(name="gated_residual_bwd", route="cuda",
                source="orv_tpu_torch/ops/csrc/gated_residual_bwd.cu",
                replaces="orv_tpu/ops/adaln.py:298", max_abs_err=max(dy_err, dg_err),
                ms=call_ms("gated_residual_bwd", adaln.gated_residual_bwd, (do, y, gate), 50),
                plain_ms=call_ms("gated_residual_bwd_plain", adaln.gated_residual_bwd_plain,
                                 (do, y, gate), 10),
                bound_ms=bms, bound_by=by, library_ms=None)


def time_int8_prep(g, prep_k_ms: float) -> None:
    """The W8A8 path's plain-PyTorch int8 work outside the kernels, per
    flagship forward:
    prepare_k_q8 once a layer, and quantize_tokens on the text stream twice a
    layer (attention and FF inputs), on the attention output and on the FF
    hidden state once a layer each."""
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g).bfloat16()
    parts = [("prepare_k_q8 [1,30,8026,64]", prep_k_ms, 30)]
    for what, shape, n in (("text [1,226,1920]", (1, 226, 1920), 60),
                           ("attention out [1,8026,1920]", (1, 8026, 1920), 30),
                           ("FF hidden [1,8026,7680]", (1, 8026, 7680), 30)):
        x = rand(*shape)
        parts.append((f"quantize_tokens {what}",
                      call_ms("quantize_tokens", quantize_tokens, (x,), 10), n))
    total = sum(ms * n for _, ms, n in parts)
    print("int8 prep outside the kernels, per W8A8 forward: " + ", ".join(
        f"{w} {ms:.4f} ms x{n}" for w, ms, n in parts) + f"; total {total:.2f} ms", flush=True)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts():
    return tuple(k.launches for k in KERNELS)


def flagship_inputs(g):
    F, C, H, W = LATENT
    rand = lambda *s, dt=torch.bfloat16: torch.randn(*s, device="cuda", generator=g).to(dt)
    return dict(lat=rand(1, F, C, H, W, dt=torch.float32), img=rand(1, F, C, H, W),
                enc=rand(1, 226, 4096), actions=rand(1, 48, 7),
                depths=rand(1, F, 2 * C, H, W), labels=rand(1, F, 2 * C, H, W))


def agree(got, want, what: str, max_rel: float = 5e-2, mean_rel: float = 5e-3) -> None:
    """max error <= max_rel and mean error <= mean_rel of the reference's
    range. The defaults hold bf16 on the card against f32 on the CPU; the
    bf16 DiT bound of tests/test_torch_port_dit.py is 2e-2 and 3e-3."""
    err = (got.float().cpu() - want.float().cpu()).abs()
    rng = want.float().abs().max().item()
    print(f"{what}: max err {err.max().item():.3g}, mean {err.mean().item():.3g}, range "
          f"{rng:.3g} (tol max {max_rel:g}*range, mean {mean_rel:g}*range)", flush=True)
    check(err.max().item() <= max_rel * rng and err.mean().item() <= mean_rel * rng,
          f"{what} disagrees with its reference")


def tiny_reference_checks() -> None:
    """A 2-layer ControlDiT (batch 2, as CFG runs it), bf16 and W8A8, and a
    small VAE decode, in bf16 on the card (kernels, cuDNN), against the same
    weights in f32 on the CPU (plain versions). The W8A8 model shares the
    bf16 bound: on the CPU its bf16 and f32 runs agree as closely as the
    bf16 model's do (max 7.0e-3 and 8.0e-3 of the range)."""
    cfg = DiTConfig(num_attention_heads=2, attention_head_dim=64, num_layers=2, in_channels=32,
                    out_channels=16, text_embed_dim=32, time_embed_dim=64,
                    modulate_encoder_hidden_states=True, visual_guidance=True)
    gc = torch.Generator().manual_seed(2)
    x, d, lab = (torch.randn(2, 3, 32, 8, 16, generator=gc) for _ in range(3))
    enc, acts = torch.randn(2, 8, 32, generator=gc), torch.randn(2, 8, 7, generator=gc)
    t = torch.tensor([500, 20])
    torch.manual_seed(1)
    sd = ControlDiT(cfg, dtype=torch.float32, device="cpu").state_dict()
    for name, kw, path in (("bf16", {}, BF16_FORWARD),
                           ("W8A8", dict(quant=True, attn_impl="flash_q8"), Q8_FORWARD)):
        weights = quantize_linear_params(sd) if kw else sd
        ref_model = ControlDiT(cfg, dtype=torch.float32, device="cpu", **kw)
        ref_model.load_state_dict(weights)
        model = ControlDiT(cfg, dtype=torch.bfloat16, device="cuda", **kw)
        model.load_state_dict(weights)
        with torch.inference_mode():
            want = ref_model(x, enc, t, actions=acts, depths=d, labels=lab)
            reset_counts()
            got = model(x.cuda(), enc.cuda(), t.cuda(), actions=acts.cuda(), depths=d.cuda(),
                        labels=lab.cuda())
        want_counts = tuple(n * cfg.num_layers // FLAGSHIP.num_layers for n in path)
        check(counts() == want_counts, f"tiny {name} DiT launched {counts()}, not {want_counts}")
        agree(got, want, f"tiny ControlDiT {name} (B=2), card bf16 kernels vs CPU f32 plain")

    vcfg = VAEConfig(block_out_channels=(16, 32, 32, 32), layers_per_block=1, norm_num_groups=8)
    ref_vae = CausalVAE(vcfg, dtype=torch.float32, device="cpu")
    vae = CausalVAE(vcfg, dtype=torch.bfloat16, device="cuda")
    vae.load_state_dict(ref_vae.state_dict())
    z = torch.randn(1, 16, 5, 6, 8, generator=gc)
    agree(decode_chunked(vae, z, chunk_latent_frames=2),
          decode_chunked(ref_vae, z, chunk_latent_frames=2, device="cpu"),
          "small VAE decode_chunked, card bf16 vs CPU f32")


def _to(draws: LossDraws, device) -> LossDraws:
    return LossDraws(**{k: v.to(device) for k, v in vars(draws).items()})


def tiny_train_check() -> None:
    """One train step of a 2-layer recon_action ControlDiT (2 heads of 64,
    6-chunk adaLN, batch 2): bf16 compute on the card (the kernels and
    their backward kernels) against f32 on the CPU (plain versions), from
    the same f32 weights and draws, one row action-CFG masked. Loss and
    grad norm agree to 2e-2 relative; every parameter with a nonzero
    gradient on the CPU gets a nonzero one on the card (no gradient is
    dropped at a kernel's output); then one make_train_step call on each,
    whose loss and grad norm agree to the same bound."""
    cfg = DiTConfig(num_attention_heads=2, attention_head_dim=64, num_layers=2, in_channels=32,
                    out_channels=16, text_embed_dim=32, time_embed_dim=64,
                    modulate_encoder_hidden_states=True, recon_action=True)
    gc_ = torch.Generator().manual_seed(3)
    batch = dict(latents=torch.randn(2, 32, 3, 8, 16, generator=gc_),
                 image_latents=torch.randn(2, 32, 1, 8, 16, generator=gc_),
                 prompt_embeds=torch.randn(2, 8, 32, generator=gc_),
                 actions=0.1 * torch.randn(2, 8, 7, generator=gc_))
    draws = LossDraws.draw(gc_, batch)
    draws.mask_u, draws.drop_u = torch.tensor([0.05, 0.6]), torch.tensor(0.5)
    torch.manual_seed(4)
    ref = ControlDiT(cfg, dtype=torch.float32, device="cpu")
    model = ControlDiT(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(ref.state_dict())
    sched = make_schedule()
    got = {}
    for dev, m in (("cpu", ref), ("cuda", model)):
        b = {k: v.to(dev) for k, v in batch.items()}
        reset_counts()
        loss, _ = diffusion_loss(m, b, sched, _to(draws, dev), recon_action=True)
        loss.backward()
        grads = {n: p.grad for n, p in m.named_parameters()}
        got[dev] = (loss.item(), global_norm([v for v in grads.values() if v is not None]).item(),
                    grads, counts())
    want_counts = train_micro_step_counts(cfg.num_layers)
    check(got["cuda"][3] == want_counts, f"tiny train step launched {got['cuda'][3]}, "
                                         f"not {want_counts}")
    (l_ref, n_ref, g_ref, _), (l_got, n_got, g_got, _) = got["cpu"], got["cuda"]
    dropped = [n for n, v in g_ref.items() if v is not None and v.abs().max() > 0
               and (g_got[n] is None or g_got[n].abs().max() == 0)]
    print(f"tiny train step, card bf16 vs CPU f32: loss {l_got:.6g} vs {l_ref:.6g}, grad norm "
          f"{n_got:.6g} vs {n_ref:.6g} (tol 2e-2 relative); parameters with a gradient on the "
          f"CPU but none on the card: {dropped}", flush=True)
    check(abs(l_got - l_ref) <= 2e-2 * abs(l_ref) and abs(n_got - n_ref) <= 2e-2 * n_ref,
          "tiny train step: loss or grad norm disagrees with the CPU")
    check(not dropped, f"gradients dropped on the card: {dropped}")
    metrics = {}
    for dev, m in (("cpu", ref), ("cuda", model)):
        tx = make_optimizer(make_lr_schedule("constant", 1e-4, warmup_steps=0))
        step = make_train_step(tx, sched, recon_action=True)
        _, metrics[dev] = step(TrainState.create(m, tx), {k: v.to(dev) for k, v in batch.items()},
                               _to(draws, dev))
    (a, b), (c, d) = ((metrics[k]["loss"].item(), metrics[k]["grad_norm"].item())
                      for k in ("cpu", "cuda"))
    print(f"tiny make_train_step: loss {c:.6g} vs {a:.6g}, grad norm {d:.6g} vs {b:.6g}", flush=True)
    check(abs(c - a) <= 2e-2 * abs(a) and abs(d - b) <= 2e-2 * b,
          "tiny make_train_step disagrees with the CPU")


def recipe_batch():
    """One micro-batch of the 2B recipe (B=1): bridgev2 moments, T5 prompt
    embeds and 16 actions, random values on the card from a generator of
    their own (seed 12), so that no check added before them changes them."""
    C, F, H, W = TRAIN_LATENT
    g = torch.Generator(device="cuda").manual_seed(12)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    return dict(latents=rand(1, 2 * C, F, H, W), image_latents=rand(1, 2 * C, 1, H, W),
                prompt_embeds=rand(1, 226, 4096).bfloat16(), actions=0.1 * rand(1, 16, 7))


def train_recipe_2b():
    """The 2B fine-tune recipe at full width (B=1 per micro-step, seeded
    random weights): one warm-up optimizer step, 3 timed ones through
    make_train_step, then one more taken by hand to split a micro-step into
    forward, backward and optimizer. Returns the launch counts of the 3
    timed steps."""
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    model = ControlDiT(RECIPE_2B, dtype=torch.bfloat16, param_dtype=torch.float32)
    params = trainable(model)
    print(f"ControlDiT 2B recipe: {sum(p.numel() for p in params) / 1e9:.3f} B parameters (f32), "
          f"bf16 compute", flush=True)
    batch = recipe_batch()
    tx = make_optimizer(make_lr_schedule(**TRAIN_LR), **TRAIN_OPT)
    sched = make_schedule()
    state = TrainState.create(model, tx)
    step = make_train_step(tx, sched, recon_action=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    watch = [model.transformer_blocks[0].attn1.to_q.weight, model.transformer_blocks[-1].ff.net[2].weight,
             model.proj_out.weight, model.action_recon.mlp[2].weight, model.patch_embed.proj.weight]
    before = [w.detach().clone() for w in watch]
    t0 = time.perf_counter()
    for _ in range(TRAIN_OPT["grad_accum_steps"]):  # warm-up optimizer step
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    print(f"train warm-up optimizer step: {time.perf_counter() - t0:.3f} s, loss "
          f"{m['loss'].item():.5g}", flush=True)

    reset_counts()
    torch.cuda.synchronize()
    step_s, losses, norms = [], [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(TRAIN_OPT["grad_accum_steps"]):
            state, m = step(state, batch, gen)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = counts()
    losses, norms = [x.item() for x in losses], [x.item() for x in norms]
    print(f"train 3 optimizer steps ({TRAIN_OPT['grad_accum_steps']} micro-steps each): s/step "
          f"{', '.join(f'{x:.4f}' for x in step_s)}; loss per micro-step "
          f"{', '.join(f'{x:.5g}' for x in losses)}; grad norm "
          f"{', '.join(f'{x:.5g}' for x in norms)}; launches {launches}", flush=True)
    n_micro = 3 * TRAIN_OPT["grad_accum_steps"]
    check(launches == tuple(n_micro * n for n in TRAIN_MICRO_STEP),
          f"training launch counts {launches} != {n_micro} x {TRAIN_MICRO_STEP}")
    check(all(map(math.isfinite, losses + norms)), "training loss or grad norm is not finite")

    # one more optimizer step by hand, timed in parts with CUDA events
    parts = []
    for _ in range(TRAIN_OPT["grad_accum_steps"]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        draws = LossDraws.draw(gen, batch)
        ev[0].record()
        loss, _ = diffusion_loss(model, batch, sched, draws, recon_action=True)
        ev[1].record()
        loss.backward()
        ev[2].record()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        global_norm(grads)
        tx.update(grads, state.opt_state, params)
        ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train micro-step split (ms): forward {parts[0][0]:.1f} / {parts[1][0]:.1f}, backward "
          f"{parts[0][1]:.1f} / {parts[1][1]:.1f}, grad norm + optimizer: accumulate "
          f"{parts[0][2]:.1f}, apply {parts[1][2]:.1f}; peak memory of the training phase "
          f"{peak:.1f} GiB", flush=True)
    finite = all(bool(torch.isfinite(n)) for n in torch._foreach_norm(params))
    moved = [not torch.equal(b, w) for b, w in zip(before, watch)]
    print(f"train parameters finite: {finite}, watched tensors moved: {moved}", flush=True)
    check(finite and all(moved), "training left non-finite or unmoved parameters")
    return launches


def generate(dit, vae, inp, name: str, forward_counts):
    """4 DPM steps through make_sampler and the chunked decode; checks the
    outputs and the launch counts. Returns (s/step, launch counts)."""
    sampler = make_sampler(dit, make_schedule(), SamplerConfig(num_inference_steps=STEPS))
    gen = torch.Generator(device="cuda").manual_seed(10)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sampler(inp["lat"], inp["img"], inp["enc"], generator=gen, actions=inp["actions"],
                  depths=inp["depths"], labels=inp["labels"])
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    video = decode_latents(lambda z: decode_chunked(vae, z, chunk_latent_frames=6), lat)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counts()
    print(f"generation {name}: {STEPS} DPM steps {sample_s:.3f} s ({sample_s / STEPS:.4f} "
          f"s/step), decode_chunked(6) {decode_s:.3f} s, frames {list(video.shape)}, launches "
          f"{launches}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    check(bool(torch.isfinite(lat).all()), f"{name} sampled latents are not finite")
    check(tuple(video.shape) == (1, 3, 49, 320, 480) and bool(torch.isfinite(video).all()),
          f"{name} decoded frames are not finite or of the wrong shape")
    check(launches == tuple(STEPS * n for n in forward_counts),
          f"{name} generation launch counts {launches}")
    return sample_s / STEPS, launches


def ring_phase(g, dit, inp, x, t, v_resident) -> int:
    """Phase 3b: the ring through LocalRing(SP), every rank a thread on the
    one card. Returns the online kernel's launches in the ring attention run."""
    comm = LocalRing(SP)
    q, k, v = (torch.randn(1, 30, 226 + 7800, 64, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    comm.run(lambda: joint_ring_attention(q, k, v, 226, comm))  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = comm.run(lambda: joint_ring_attention(q, k, v, 226, comm))
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    ring_counts = counts()
    ref, _ = attention.flash_attention(q, k, v)
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    err = max_err(outs[0], ref)
    print(f"joint_ring_attention {list(q.shape)} text 226, static_max=None, {SP} ranks on one "
          f"card: {ring_s * 1e3:.2f} ms, launches {ring_counts}, ranks bitwise equal {same}, "
          f"max_abs_err vs resident online flash_attention {err:.3g} (tol 2e-2)", flush=True)
    want = tuple(SP * 7 if kk is attention.flash_attention_online_kernel else 0 for kk in KERNELS)
    check(ring_counts == want, f"ring attention launched {ring_counts}, not {want}")
    check(same and err <= 2e-2, "ring attention disagrees across ranks or with the resident one")

    dit.set_sp(comm)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = comm.run(lambda: dit(x, inp["enc"], t, actions=inp["actions"],
                                    depths=inp["depths"], labels=inp["labels"]))
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    got = counts()
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    print(f"ControlDiT forward at sp={SP} ({SP} ranks on one card): {fwd_s:.3f} s (first call), "
          f"launches {got} (per rank {SP_FORWARD}), ranks bitwise equal {same}", flush=True)
    check(got == tuple(SP * n for n in SP_FORWARD), f"sp launch counts {got}")
    check(same and all(bool(torch.isfinite(o).all()) for o in outs),
          "the sp ranks' outputs differ or are not finite")
    agree(outs[0], v_resident, f"ControlDiT sp={SP} vs resident forward", 2e-2, 3e-3)

    sampler = make_sampler(dit, make_schedule(), SamplerConfig(num_inference_steps=2))
    run = lambda: sampler(inp["lat"], inp["img"], inp["enc"],
                          generator=torch.Generator(device="cuda").manual_seed(11),
                          actions=inp["actions"], depths=inp["depths"], labels=inp["labels"])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lats = comm.run(run)
    torch.cuda.synchronize()
    sp_step = (time.perf_counter() - t0) / 2
    got = counts()
    dit.set_sp(None)
    t0 = time.perf_counter()
    ref = run()
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) / 2
    same = all(torch.equal(o, lats[0]) for o in lats[1:])
    print(f"make_sampler 2 DPM steps at sp={SP} ({SP} ranks on one card): {sp_step:.4f} s/step; "
          f"resident {step:.4f} s/step; launches {got}; ranks bitwise equal {same}", flush=True)
    check(got == tuple(2 * SP * n for n in SP_FORWARD), f"sp sampler launch counts {got}")
    check(same, "the sp ranks' latents differ")
    agree(lats[0], ref, f"2 DPM steps at sp={SP} vs resident", 2e-2, 3e-3)
    return ring_counts[KERNELS.index(attention.flash_attention_online_kernel)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions are compared
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. build
    _build.library()
    print(f"build: {_build.build_seconds:.1f} s for {len(list(_build.CSRC.glob('*.cu')))} "
          f"sources", flush=True)
    source = None
    for line in _build.build_log.splitlines():  # the Hopper kernels' lines come below
        source = line[3:].strip() if line.startswith("== ") else source
        if source not in HOPPER_SOURCES and re.search(r"registers|spill|^==", line):
            print("  " + line.strip(), flush=True)
    hopper_build_report()

    # 2. every kernel against its plain version
    g = torch.Generator(device="cuda").manual_seed(0)
    check_attention(g, (1, 2, 300), timed=False)
    check_attention_online(g, 2, 300, 300, 1.0, timed=False)
    check_attention_online(g, 2, 226, 1950, 1.0, timed=False)  # the ring's Sq != Skv calls
    check_attention_online(g, 2, 1950, 226, 1.0, timed=False)
    check_attention_online_bwd(g, (1, 2, 300))
    check_modulate_norm(g, 3, 300, 256, timed=False)
    check_gated_residual(g, 3, 300, 64, timed=False)
    check_attention_q8(g, (1, 2, 300), timed=False)
    check_attention_q8(g, (1, 2, 1100), timed=False)  # keys in two 1024-key scale blocks
    check_modulate_norm_q8(g, 3, 300, 256, timed=False)
    q8_record, prep_k_ms = check_attention_q8(g, (1, 30, 8026), timed=True)
    records = [check_attention(g, (1, 30, 8026), timed=True),
               check_modulate_norm(g, 13, 600, 1920, timed=True),
               check_gated_residual(g, 13, 600, 1920, timed=True),
               q8_record,
               check_modulate_norm_q8(g, 13, 600, 1920, timed=True)]
    check_gated_residual(g, 1, 226, 1920, timed=False)  # the text-stream shape
    # the adaLN forwards at the text stream, the training shape (f32 norm
    # params, as under f32 parameters), the 5b family's width and the widest
    for R, S, D, norm_f32 in ((1, 226, 1920, False), (5, 600, 1920, True),
                              (4, 600, 3072, False), (2, 77, 4096, True)):
        check_modulate_norm(g, R, S, D, timed=False, norm_f32=norm_f32)
        check_modulate_norm_q8(g, R, S, D, timed=False, norm_f32=norm_f32)
    time_int8_prep(g, prep_k_ms)
    # the backward kernels: small ragged shapes, then the training shapes
    for shape in ((1, 2, 300), (1, 2, 1100)):
        for with_dlse in (False, True):
            check_attention_bwd(g, shape, with_dlse, timed=False)
    check_attention_bwd(g, (1, 2, 226), True, timed=False, skv=1950)  # the ring's Sq != Skv
    check_attention_bwd(g, (1, 2, 1950), True, timed=False, skv=226)
    check_modulate_norm_bwd(g, 3, 300, 1920, timed=False)
    check_gated_residual_bwd(g, 3, 300, 1920, timed=False)
    check_attention_bwd(g, (1, 30, 3226), True, timed=False)
    bwd_records = check_attention_bwd(g, (1, 30, 3226), False, timed=True)
    records += bwd_records
    records.append(check_modulate_norm_bwd(g, 5, 600, 1920, timed=True))
    records.append(check_gated_residual_bwd(g, 5, 600, 1920, timed=True))
    check_gated_residual_bwd(g, 1, 226, 1920, timed=False)  # the text stream
    # logits past 150 at the flagship shape: q and k scaled by 5 give logits of
    # standard deviation 25, and 2e9 of them
    records.append(check_attention_online(g, 30, 8026, 8026, 5.0, timed=True))
    for r in records:
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {r['library_ms']} ms",
              flush=True)
    by_name = {r["name"]: r for r in records}
    for name, heads, sq, skv, static_max in (("flash_attn_static_max", 30, 8026, 8026, 24.0),
                                             ("flash_attn_online", 30, 8026, 8026, None),
                                             ("flash_attn_static_max", 30, 3226, 3226, 24.0),
                                             ("flash_attn_online", 30, 226, 1950, None),
                                             ("flash_attn_online", 30, 1950, 226, None)):
        if sq == 8026:  # the flagship: the records' times (the online one at logits to 182)
            ms, library_ms = by_name[name]["ms"], by_name[name]["library_ms"]
        else:
            ms, library_ms = time_forward(g, heads, sq, skv, static_max)
        forward_rate(name, heads, sq, skv, ms, library_ms)
    q8_rate(q8_record, 30, 8026)
    bwd_rate(bwd_records, 30, 3226)
    torch.cuda.empty_cache()

    # 3. the small models against the CPU, then the flagship DiT forward
    tiny_reference_checks()
    tiny_train_check()
    torch.cuda.reset_peak_memory_stats()  # from here on: the main path's memory
    torch.manual_seed(0)
    t0 = time.perf_counter()
    dit = ControlDiT(FLAGSHIP, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in dit.parameters())
    print(f"ControlDiT flagship: {n_params / 1e9:.3f} B params, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    inp = flagship_inputs(g)
    x = torch.cat([inp["lat"].bfloat16(), inp["img"]], dim=2)
    t = torch.full((1,), 999, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        v = dit(x, inp["enc"], t, actions=inp["actions"], depths=inp["depths"],
                labels=inp["labels"])
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    got = counts()
    print(f"ControlDiT forward: {fwd_s:.3f} s (first call), out {list(v.shape)}, launches "
          f"in KERNELS order = {got}", flush=True)
    check(tuple(v.shape) == (1, *LATENT) and bool(torch.isfinite(v).all()),
          "flagship DiT output is not finite or of the wrong shape")
    check(got == BF16_FORWARD, f"launch counts {got} != {BF16_FORWARD}")

    # 3b. the ring: attention, then the same DiT at sp=4, on the one card
    ring_online = ring_phase(g, dit, inp, x, t, v)
    torch.cuda.empty_cache()

    # 4. generation through the entry points: bf16, then the same DiT in W8A8
    vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    bf16_step, bf16_launches = generate(dit, vae, inp, "bf16", BF16_FORWARD)
    t0 = time.perf_counter()
    quantize_model_(dit)
    torch.cuda.synchronize()
    print(f"quantize_model_ (in place): {time.perf_counter() - t0:.2f} s", flush=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        v = dit(x, inp["enc"], t, actions=inp["actions"], depths=inp["depths"],
                labels=inp["labels"])
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    got = counts()
    print(f"ControlDiT W8A8 forward: {fwd_s:.3f} s (first call), launches {got}", flush=True)
    check(tuple(v.shape) == (1, *LATENT) and bool(torch.isfinite(v).all()),
          "flagship W8A8 DiT output is not finite or of the wrong shape")
    check(got == Q8_FORWARD, f"W8A8 launch counts {got} != {Q8_FORWARD}")
    q8_step, q8_launches = generate(dit, vae, inp, "W8A8", Q8_FORWARD)
    print(f"s/step side by side: bf16 {bf16_step:.4f}, W8A8 {q8_step:.4f}", flush=True)
    launches = tuple(a + b for a, b in zip(bf16_launches, q8_launches))

    # 5. training at full width, the serving models freed first
    del dit, vae, inp, x, t, v
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_recipe_2b()
    launches = launches[:5] + train_launches[5:9] + (ring_online,)

    # 6. card, kernels line, result line
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    for r, n in zip(records, launches):
        r["launches"] = n
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
