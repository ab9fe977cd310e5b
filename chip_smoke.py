"""Drives the PyTorch/CUDA port (orv_tpu_torch) on one NVIDIA GPU and checks it.

Run from the repository root on the machine with the card:

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no result:
  1. build the CUDA kernels from orv_tpu_torch/ops/csrc (nvcc, sm_90a);
  2. hold each of the five kernels against its plain PyTorch version on the
     card, at the flagship shapes and at small ragged ones, and time kernel,
     plain version and the nearest single PyTorch call; time the W8A8 path's
     int8 prep outside the kernels (prepare_k_q8, quantize_tokens);
  3. a tiny ControlDiT, bf16 and W8A8 (quant=True, attn_impl="flash_q8"), and
     a small VAE decode on the card against the same weights on the CPU
     (plain versions, f32); then one bf16 ControlDiT forward at the flagship
     config (2B: 30 layers x 30 heads x 64, 6-chunk adaLN, visual guidance,
     seeded random weights) with launch counts of exactly 30 / 60 / 120;
  4. generation through the entry points, bf16 then W8A8: make_sampler (4
     DPM steps) and decode_chunked (6 latent frames a chunk) to 49x320x480
     frames. Between the two, the same flagship DiT is quantized in place
     (quantize_model_, no second copy) and one W8A8 forward must launch
     flash_q8 / modulate_norm_q8 / gated_residual = 30 / 60 / 120 and none
     of the bf16 attention and modulate_norm;
  5. the card's name and power limit, the kernels' JSON line (launches: the
     sum over the two generation runs), and last the result line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from orv_tpu_torch.models import CausalVAE, ControlDiT, DiTConfig, VAEConfig, decode_chunked
from orv_tpu_torch.models.layers import quantize_tokens
from orv_tpu_torch.models.quantize import quantize_linear_params, quantize_model_
from orv_tpu_torch.ops import _build, adaln, attention
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
           attention.flash_attention_q8, adaln.modulate_norm_q8)
BF16_FORWARD = (30, 60, 120, 0, 0)  # launches of one flagship forward, in KERNELS order
Q8_FORWARD = (0, 0, 120, 30, 60)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` calls, each after a write of
    64 MB that evicts the 50 MB L2 cache, timed with CUDA events."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


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
    out, lse = attention.flash_attention(q, k, v)
    ref, ref_lse = attention.flash_attention_plain(q, k, v)
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
               ms=cuda_ms(lambda: attention.flash_attention(q, k, v), 10),
               plain_ms=cuda_ms(lambda: attention.flash_attention_plain(q, k, v), 3),
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10))
    return rec


def check_modulate_norm(g, R, S, D, timed: bool):
    x = torch.randn(R, S, D, device="cuda", generator=g).bfloat16()
    # shift/scale as the modulation linear leaves them: row-strided chunks
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, device="cuda", generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    ns = (1 + 0.1 * torch.randn(D, device="cuda", generator=g)).bfloat16()
    nb = (0.1 * torch.randn(D, device="cuda", generator=g)).bfloat16()
    out = adaln.modulate_norm(x, scale, shift, ns, nb)
    ref = adaln.modulate_norm_plain(x, scale, shift, ns, nb)
    err = max_err(out, ref)
    print(f"kernel modulate_norm [{R}, {S}, {D}]: max_abs_err {err:.3g} "
          f"(tol 2e-2 + 1e-2|ref|)", flush=True)
    check(within(out, ref, 2e-2, 1e-2), f"modulate_norm disagrees at {(R, S, D)}")
    if not timed:
        return None
    bms, by = bound_ms(2 * R * S * D * 2 + 2 * R * D * 2 + 2 * D * 2, f32=10.0 * R * S * D)
    return dict(name="modulate_norm", route="cuda", source="orv_tpu_torch/ops/csrc/modulate_norm.cu",
                replaces="orv_tpu/ops/adaln.py:52", max_abs_err=err,
                ms=cuda_ms(lambda: adaln.modulate_norm(x, scale, shift, ns, nb), 50),
                plain_ms=cuda_ms(lambda: adaln.modulate_norm_plain(x, scale, shift, ns, nb), 10),
                bound_ms=bms, bound_by=by, library_ms=None)


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
    bms, by = bound_ms(3 * R * S * D * 2 + R * D * 2, f32=2.0 * R * S * D)
    return dict(name="gated_residual", route="cuda", source="orv_tpu_torch/ops/csrc/gated_residual.cu",
                replaces="orv_tpu/ops/adaln.py:248", max_abs_err=err,
                ms=cuda_ms(lambda: adaln.gated_residual(x, y, gate), 50),
                plain_ms=cuda_ms(lambda: adaln.gated_residual_plain(x, y, gate), 10),
                bound_ms=bms, bound_by=by,
                library_ms=cuda_ms(lambda: torch.addcmul(x, y, gate[:, None]), 50))


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
               ms=cuda_ms(lambda: attention.flash_attention_q8_kernel(q, prep, v, S, scale), 10),
               plain_ms=cuda_ms(lambda: attention.flash_attention_q8_plain(q, k, v), 3),
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10))
    return rec, cuda_ms(lambda: attention.prepare_k_q8(k), 10)


def check_modulate_norm_q8(g, R, S, D, timed: bool):
    x = (2 * torch.randn(R, S, D, device="cuda", generator=g)).bfloat16()
    shift, scale, _ = (0.3 * torch.randn(R, 3 * D, device="cuda", generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    ns = (1 + 0.1 * torch.randn(D, device="cuda", generator=g)).bfloat16()
    nb = (0.1 * torch.randn(D, device="cuda", generator=g)).bfloat16()
    xq, xs = adaln.modulate_norm_q8(x, scale, shift, ns, nb)
    ref_q, ref_s = adaln.modulate_norm_q8_plain(x, scale, shift, ns, nb)
    diff = (xq.int() - ref_q.int()).abs()
    flips, s_err = (diff != 0).float().mean().item(), ((xs - ref_s).abs() / ref_s).max().item()
    print(f"kernel modulate_norm_q8 [{R}, {S}, {D}]: xq max diff {diff.max().item()} (tol 1), "
          f"{flips:.3g} of entries differ (tol 1e-3), xscale rel err {s_err:.3g} (tol 1e-6)",
          flush=True)
    check(diff.max().item() <= 1 and flips <= 1e-3 and s_err <= 1e-6,
          f"modulate_norm_q8 disagrees at {(R, S, D)}")
    if not timed:
        return None
    bms, by = bound_ms(R * S * D * (2 + 1) + R * S * 4 + 2 * R * D * 2 + 2 * D * 2,
                       f32=14.0 * R * S * D)
    return dict(name="modulate_norm_q8", route="cuda",
                source="orv_tpu_torch/ops/csrc/modulate_norm_q8.cu",
                replaces="orv_tpu/ops/adaln.py:190", max_abs_err=float(diff.max().item()),
                ms=cuda_ms(lambda: adaln.modulate_norm_q8(x, scale, shift, ns, nb), 50),
                plain_ms=cuda_ms(lambda: adaln.modulate_norm_q8_plain(x, scale, shift, ns, nb),
                                 10),
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
        parts.append((f"quantize_tokens {what}", cuda_ms(lambda: quantize_tokens(x), 10), n))
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


def agree(got, want, what: str) -> None:
    """bf16 on the card against f32 on the CPU: max error <= 5e-2 and mean
    error <= 5e-3 of the reference's range."""
    err = (got.float().cpu() - want).abs()
    rng = want.abs().max().item()
    print(f"{what}: max err {err.max().item():.3g}, mean {err.mean().item():.3g}, range "
          f"{rng:.3g} (tol max 5e-2*range, mean 5e-3*range)", flush=True)
    check(err.max().item() <= 5e-2 * rng and err.mean().item() <= 5e-3 * rng,
          f"{what} disagrees with the CPU reference")


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    # 2. every kernel against its plain version
    g = torch.Generator(device="cuda").manual_seed(0)
    check_attention(g, (1, 2, 300), timed=False)
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
    time_int8_prep(g, prep_k_ms)
    for r in records:
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {r['library_ms']} ms",
              flush=True)
    torch.cuda.empty_cache()

    # 3. the small models against the CPU, then the flagship DiT forward
    tiny_reference_checks()
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
          f"attention/modulate_norm/gated_residual/flash_q8/modulate_norm_q8 = {got}",
          flush=True)
    check(tuple(v.shape) == (1, *LATENT) and bool(torch.isfinite(v).all()),
          "flagship DiT output is not finite or of the wrong shape")
    check(got == BF16_FORWARD, f"launch counts {got} != {BF16_FORWARD}")

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

    # 5. card, kernels line, result line
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
