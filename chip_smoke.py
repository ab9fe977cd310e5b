"""Drives the PyTorch/CUDA port (orv_tpu_torch) on one NVIDIA GPU and checks it.

Run from the repository root on the machine with the card:

    python3 chip_smoke.py

Phases, in order; any failure raises, exits non-zero and prints no result:
  1. build the CUDA kernels from orv_tpu_torch/ops/csrc (nvcc, sm_90a, one
     process per source, all at once) and print their registers and spills,
     those of the nine Hopper kernels (the bf16 static-max and online and
     the int8 modes of flash_fwd_sm90.cuh, the backward's dq and dk/dv, the
     two adaLN forwards of adaln_fwd_sm90.cuh, the two adaLN backwards of
     adaln_bwd_sm90.cuh) again, by kernel, with any ptxas notice about a
     wgmma pipeline; a spill in any instance or such a notice fails the run;
  2. hold each of the ten kernels against its plain PyTorch version on the
     card, at the flagship or training shapes and at small ragged ones (the
     adaLN forwards also at the text stream's [1,226,1920], the training
     [5,600,1920] with f32 norm params, and rows 3072 and 4096 wide; the
     adaLN backward at [3,300,1920], S 599 and 601 (a row group's last
     12-row tile ragged), [4,600,3072] and [2,77,4096], the gated-residual
     backward at [3,300,1920], S 599 and 601 and the text stream's
     [1,226,1920], both backwards with a second run bitwise equal), and
     time kernel, plain version and the nearest single PyTorch call by
     device time alone (`device_ms`: many calls captured in one CUDA graph,
     their inputs rotating over copies that keep the L2 cold), with the
     host's time per call of the adaLN and gated-residual wrappers and of
     addcmul on lines of their own; the adaLN backward's library time is
     ATen's LayerNorm backward at its R = 1 form [1,3000,1920], timed
     beside the kernel there, the gated-residual backward's text-stream
     time ([1,226,1920]) goes on a line of its own and into its record; the
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
     versions) from the same weights and draws, with visual guidance and
     depth and label moments in the batch: loss and grad norm must agree,
     and every parameter that gets a gradient on the CPU must get a nonzero
     one on the card; the resume round trip of pipelines/train.py:train at
     a tiny config on the card (runs cut before micro-step 2 and 3, each
     resumed from its latest checkpoint to 4, bitwise equal to an unbroken
     run of 4); then one bf16 ControlDiT forward at the
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
  4b. the serving entry points at full width, phase 4's models freed
     first, over a bridgev2 episode written from a numpy seed into a temp
     dir (annotation JSON, [32,13,40,60] moments of a 49-frame clip, the
     empty prompt's [226,4096] embeds, the raw 320x480 frames as mp4 and a
     render.npz of depths and labels), each step with its launch counts
     from zero and a line of its wall, denoise (s/step), encode and decode
     seconds and peak memory: evaluate (pipelines/evaluate.py) on the
     port's base_eval.yaml + eval/eval_traj_image_cond_2b_finetune.yaml at
     49 frames, traj-image-depth-label, 4 DPM steps, a random 2B model
     (build_dit_config, visual guidance) and a random full VAE, in bf16
     (4 x 30 / 60 / 120 launches) and with evaluation.quant=true (4 x
     flash_q8 / modulate_norm_q8 / gated_residual = 30 / 60 / 120, none of
     the bf16 attention or modulate_norm); the clip's latents finite
     [13,16,40,60], its mp4 read back as 49x320x480x3 uint8, manifest.json
     naming it (and a gif beside the first mp4; the later steps write the
     mp4 only); encode_auto of the 49x320x480 clip; evaluate over the raw
     frames (dataset.load_tensors=false: video, first frame, depth and
     labels encoded); the cascaded eval config (17-frame chunks from raw
     pixels, every chunk after the first conditioned on a re-encoded
     generated frame, the stitched mp4 back to 49 frames);
     inference.generate_video at the flagship width from a 320x480 frame
     and 48 actions, twice on the same models (the second call's step
     without the first forward's costs); inference.main in its tiny smoke
     mode over a demo
     folder of 17 png frames;
  4c. the offline path at full width on seeded random weights, phase 4b's
     models freed first: data_process.extract of two 49-frame 320x480
     episodes from a source generator (mp4 + annotation JSON; a render.npz
     of depths and labels beside each); encode_dataset.encode_split on the
     2B recipe's config with the default bf16 VAE, ref_nums 1 and 5 and
     depth and label latents (18 slices of 17 frames: s/slice, s/clip,
     files by kind, peak memory), again (nothing written), then with one
     file deleted (that file only rewritten, every other file's mtime
     unchanged), and the zero empty prompt; T5-v1.1-XXL (24 x 4096, bf16)
     on 226 token ids ([1] + [0] * 225: no tokenizer files are in the
     repository): ms a call, its device time split into GEMMs and the rest,
     peak memory; a 2-layer full-width encoder saved as a sharded folder and
     loaded back through from_pretrained, bitwise equal; a 2-layer narrow
     encoder on the card against the CPU in f32 (`agree`); train on the
     encoded latents (the 2B recipe cut to 4 of 30 layers, 2 micro-steps,
     no validation): launches 2 x train_micro_step_counts(4), finite
     losses; metrics.main with random torchvision- and pytorch-i3d-named
     safetensors folders (non-identity batch norms) over two 49-frame
     gt/pred pairs: PSNR, SSIM, FID and FVD at 16/32/48/49; the feature
     networks' device ms a 32-frame Inception batch and an 8-clip I3D batch
     at 16x224x224 in f32; the card's features against the CPU's on one
     batch each, within 1e-3 of their RMS;
  4d. the data factory at full width, phase 4c's models freed first: two
     seeded episodes of 49 metric depth frames at 320x480 (153,600 points a
     frame) of a table and three boxes 0.25-0.35 m below a camera that
     moves a few millimetres, with per-point labels, objects.txt, instance
     masks and phase 4c's mp4 and annotation JSON; the eight actions
     through prepare_dataset.main in the reference order (reconstruction
     --dense, cameras, align_cameras, caption, caption_post_process,
     labeling, labels_post_process, render at 240x320), each one's seconds,
     every action returning both episodes, launches of hard voxelization
     and the forward rasterizer exactly 2 x 49 (counted in the spawned
     stage workers and sent back), every frame's occupancy non-empty,
     render.npz's semantics uint8 and depths f32 [49,1,240,320] with the
     four object labels and the background present, depths in [0.01, 0.4]
     and the share of pixels with alpha > 0.1 within 0.03 of the share the
     scene's surfaces cover; outlier removal's host seconds and share of
     the reconstruction; the actions again (caption_post_process, then the
     other seven at once) rewrite no file's bytes and launch nothing; the
     factory's kernels against their plain versions on the card (hard and
     dynamic voxelization bitwise on a full frame and 37 points fewer; the
     forward rasterizer on frame 0's gaussians at 240x320 and 237x317 to
     1e-5; the backward on 3000 gaussians at 64x96 and 61x93 and on frame
     0's gaussians at 240x320 with seeded gradients against autograd
     through the plain version, to 1e-4 of each largest gradient (frame
     0's isotropic gaussians at the identity rotation have a zero rotation
     gradient, the plain version's exactly: the kernel's is held to 1e-4 of
     its terms' size, 4 |dL/ds| s), and a second run bitwise equal to the
     first), each with its device time (torch.profiler, after a profiled
     warm-up call: the wrappers read a count back to size their outputs,
     so they cannot be captured in a CUDA graph; the backward at frame 0's
     shape, where the factory launches it, and at 61x93), the plain
     version's and a bytes bound, and a "split" line of the same calls'
     device time by part (the scan, the grouping or binning, the per-tile
     sort, the scatter or blend) and the host's wait in the count read
     that sizes the outputs; the kernels' other entry points on
     episode 0 (dynamic voxelization of its 49 clouds, the depth loss's
     gradient through rasterize on its 49 frames: 49 launches each); last
     encode_split of one slice with depth and label latents from the
     factory's own render.npz (dataset.ori_size the render's 240x320);
  5. training through the entry point, the serving models freed first:
     pipelines/train.py:train on the port's base_train.yaml +
     experiments/traj_image_2b_finetune.yaml (30 layers x 30 heads x 64,
     6-chunk adaLN, f32 parameters and bf16 compute, AdamW with clip 1.0,
     cosine_with_restarts with its 1000-step warmup; transformer.recon_action
     =true passed, as the yaml alone builds no action-recon head), random
     init from the seed (the recipe's THUDM/CogVideoX-2b folder is absent),
     over 9 bridgev2 slices of 17 frames written from a numpy seed into a
     temp dir (moments [32,5,40,60], image moments [32,1,40,60], prompt
     embeds [226,4096], 16 actions), at the recipe's B=4 x accumulation 2:
     4 micro-steps (2 optimizer steps), one checkpoint (at micro-step 4), an
     inline validation at the start and the end (4 DPM steps and a random
     full VAE's decode to an mp4). The temp dir's free space is printed
     first and a shortfall fails the run. Launches must be 4 x
     (30 / 30 / 30 / 60 / 60 / 120 / 119) of flash fwd / dq / dk-dv /
     modulate_norm / its backward / gated_residual / its backward (the last
     block's text-stream output is unused, so autograd skips the backward of
     its last gated residual) plus 2 validations x 4 x (30 / 60 / 120);
     every logged loss and grad norm finite, the parameters moved, one
     checkpoint left, the validation mp4s 17x320x480, and the export
     `checkpoint/` must load strictly through load_pretrained into a
     ControlDiT whose forward equals the trained model's bitwise. It prints
     s per optimizer step (the tracker's s_per_it in metrics.jsonl), the
     validations', checkpoint writes' and export's seconds and bytes
     (TrainTimes wraps the three) and peak memory, then times one more
     optimizer step by hand on the loader's first batch, split into
     forward, backward and optimizer;
  5c. the model surface's training side at full width, phase 5's state
     freed and its checkpoints deleted, each run through
     pipelines/train.py:train with launch counts from zero and a line of
     s per optimizer step (the tracker's s_per_it), peak memory, checkpoint
     and export bytes and seconds: (a) stage 3,
     experiments/traj_image_2b_multiview.yaml on bridgev2_2 (4 episodes of
     9 slices, 3 views of 17 frames, the view count sampled per slice) from
     phase 5's export `checkpoint/` (its MVBlocks seeded, its action-recon
     head carried: transformer.recon_action=true), the 2B DiT with 30
     MVBlocks, remat, only mv_blocks training, the recipe's B=3 x
     accumulation 4, 8 micro-steps, lr warmup 0 (so that 2 updates move
     the MVBlocks), an inline validation first (the batch's views x 5
     latent frames as one view, as JAX validates): launches 8 x (120 / 180 /
     300 / 60 / 60 / 90 / 149) of flash fwd / modulate_norm / gated_residual
     / dq / dk-dv / their backwards (the forwards twice: the recompute) plus
     4 x (60 / 90 / 150); at least one 3-view micro-step; every frozen
     parameter bitwise unchanged and every MVBlock parameter moved but the
     cam_encoders (nothing calls them); the checkpoint's moments all of
     mv_blocks; the export loads strictly into a multiview ControlDiT whose
     3-view forward equals the trained model's bitwise; then a 6-layer
     multiview model's micro-step at B=1 x 3 views without remat, with it and
     with the "dots" policy: loss and MVBlock gradients equal (bitwise, else
     within 1e-6 of the largest gradient), launches as derived; (b) the 5b
     recipe at full width (48 x 64, patch_size_t 2, RoPE, joint final norm)
     cut to 18 of its 42 layers (the card would hold 26 at 20 bytes a
     parameter of f32 parameters, gradients, AdamW's moments and
     accumulator; the checkpoint and the export write 16 bytes a parameter
     to the machine's disk, which takes 45 GiB a call), random
     init, B=1 x accumulation 4, 4 micro-steps, no validation (the sampler
     would take the 5 latent frames unpadded, which fails in both
     packages): launches 4 x (18 / 36 / 72 / 18 / 18 / 36 / 71), then on
     the loader's first batch the loss sees 6 latent frames and 20 actions
     and equals, bitwise, the loss with a given 5-frame mask (the padded
     frame out) and differs from one with a 6-frame all-true mask; (c) the
     1.4b RoPE recipe at full width and depth (28 x 28 x 64, 3-chunk, 1792
     wide), B=4 x accumulation 4, 4 micro-steps with CAME (an inline
     validation first), then 4 with prodigy: launches 4 x (28 / 56 / 56 / 28
     / 28 / 56 / 56) (+ 4 x (28 / 56 / 56)); the largest attention logit
     (`LogitWatch`) of a training forward of the CAME-trained model under
     24; then one applied update each of AdamW, CAME and prodigy over the
     prodigy-trained model's parameters, in device ms; last the
     backward kernels timed at the shapes 5c launched (rows 4-5 at
     [15,30,2478,64] and [1,48,2026,64], rows 7 and 10 at [3,600,3072] and
     [20,600,1792]) beside their bounds, plain versions and SDPA's backward;
  5d. context parallelism, phase 5c's state freed first: SP_RANKS (2)
     rank processes on cuda:0 over gloo (ProcessGroupRing; NCCL refuses two
     ranks on one card, and autograd runs CUDA backward nodes on a thread of
     its own, which LocalRing refuses; the CUDA tensors pass through host
     memory: a correctness harness, not a speed), each importing this
     script (`sp_worker`): joint_ring_attention at [1,30,226+7800,64] under
     grad with static_max=None (row 1) and 24 (row 2), forward and backward
     against the resident flash forward and backward on the card (out atol
     2e-2, dq/dk/dv within the backward's bound `rms_agree`), launches per
     rank 5 forwards, 5 dq and 5 dk/dv (all with dlse), both ranks' results
     bitwise equal, and a planted fault (the flash backward's dlse dropped)
     rejected; pipelines/train.py:train with train.mesh.sp=2 on the 2B
     recipe cut to 8 of 30 layers (17-frame slices, 3000 video tokens, the
     recipe's B=4 x accumulation 2, 2 micro-steps, no validation; rank 0's
     checkpoint save and export counted, not written): launches per rank 2 x
     (40 / 16 / 32 / 0 / 0 / 40 / 40 / 16 / 31), both ranks' parameters,
     moments and batches bitwise equal, only rank 0 writing; rank 0 then
     runs the same train resident on the sp run's batches (the same draws):
     each micro-step's loss within 2^-8 and grad norm within 1e-2 of the
     resident run's (relative), the first moments within 1e-2 RMS;
     evaluate with evaluation.mesh.sp=2 at the flagship (2 DPM steps,
     traj-image-depth-label, latents only): launches per rank 2 x (150 / 60
     / 120), only rank 0's files, the latents within 2e-2 and 3e-3 of their
     range of the resident evaluate's;
  5e. data and model parallelism, phase 5d's state freed first: MESH_RANKS
     (4) rank processes on cuda:0 over gloo, as in phase 5d (`mesh_worker`),
     each logging its kernels' shapes for phase 6b. Rank 0 first runs
     pipelines/train.py:train resident on the 2B recipe cut to 8 of 30
     layers (phase 5d's cut) at full width (30 heads x 64, D 1920; the recipe's B=4 x
     accumulation 2, 2 micro-steps, its action-recon head off as the yaml
     resolves it), and every rank then trains on its batches at dp2 x tp2,
     fsdp2 x pp2 (n_micro 2), pp2 x tp2 and fsdp2 x sp2 (the pipeline's data
     shards given their rows of the resident draws): launches per rank 2 x
     the resident micro-step's (dp2 x tp2), 2 x a micro-step of 12 block
     cells (a pipeline stage runs its 4 layers on each of its 3 ticks) and
     2 x the sp=2 ring's (fsdp2 x sp2); each micro-step's loss within 2^-8
     and grad norm within 1e-2 of the resident run's (relative), the whole
     first moments within 1e-2 RMS; then evaluate at evaluation.mesh dp=2,
     tp=2 (8 layers, 2 DPM steps, a batch of 2 clips of their own split over
     dp) in bf16 and W8A8, 2 x (8 / 16 / 32) and 2 x (32 / 8 / 16) launches
     per rank,
     the latents within 2e-2 (W8A8 4e-2) and 3e-3 of their range of rank
     0's resident evaluate's; each rank's peak memory and the phase's time;
  5f. the grain loader without grain (the card's machine has none), phase
     5e's state freed first: whether huggingface_hub imports there (its
     version, or absent; no Hub call), then data/grain_loader.py's
     make_grain_loader over phase 5's nine slices written again from its
     seed, B=4 over 3 epochs (27 records, 6 batches, the third and fifth
     across epochs) in this process and in 2 spawned workers: both bitwise
     equal and in the order index_shuffle gives; then pipelines/train.py:
     train with train.loader=grain and train.loader_workers=2 on the 2B
     recipe cut to 4 of 30 layers at full width (30 heads x 64, D 1920),
     2 micro-steps, no validation (checkpoint and export counted, not
     written): it must train on the loader's first two batches, bitwise,
     with finite losses and launches 2 x a 4-layer micro-step's; the
     phase's seconds and the seconds until the workers' first record;
  6. the model surface at full width, the training state freed first: rows
     2, 3, 6, 8 and 9 against their plain versions at the surface's shapes
     (the MVBlock's attention [13,30,2478,64] and the 5b's [1,48,6826,64],
     static-max and int8, each timed beside its plain version and SDPA; the
     adaLN forward and gated residual at the 1.4b RoPE model's
     [13,600,1792] and the 5b's [11,600,3072], timed; untimed, the
     multiview DiTBlocks' attention [3,30,8026,64] (static-max and int8),
     their adaLN forwards (bf16 and int8) and gated residual [39,600,1920],
     their text stream's residual [3,226,1920], the MVBlock's
     [3,7800,1920] and the 5b text stream's residual [1,226,3072]); tiny
     multiview (bf16, W8A8) and 1.5-family ControlDiTs on the card against
     the CPU, and a tiny PAB cache check (a block's cached attention fed
     back on its inputs gives the full forward; a cache from other inputs
     must not); then, on seeded random weights
     at B=1, each step with its launch counts from zero, s/step and peak
     memory: (a) evaluate on base_eval.yaml + eval/eval_traj_image_2b_multiview
     .yaml (bridgev2_2, 3 views of a 49-frame episode written from a numpy
     seed: latents [1, 3x13, 32, 40, 60]), the 2B DiT with 30 MVBlocks, 4
     DPM steps, a random full VAE decoding the views' 39 latent frames as
     one 153-frame video (as the JAX package's evaluate does), in bf16
     (4 x 60 / 90 / 150 launches of static-max / modulate_norm /
     gated_residual) and W8A8 (4 x flash_q8 / modulate_norm / gated_residual
     / modulate_norm_q8 = 60 / 30 / 150 / 60: the MVBlocks' adaLN emits no
     int8); (b) evaluate on eval/eval_traj_image_1.4b_scratch.yaml with the
     1.4b RoPE widths passed as transformer.* keys (28 x 28 x 64, 3-chunk,
     1792 wide; 4 x 28 / 56 / 56), then one forward of that model with its
     tables whose largest attention logit (`max_logit`, every layer) must
     stay under the static bound 24; (c) make_sampler on
     experiments/traj_image_5b_finetune.yaml's transformer (48 x 64 over 42
     layers, patch_size_t 2, RoPE, joint final norm, 6-chunk; bf16
     parameters): 2 DPM steps over 22 latent frames at 40 x 60 (the 81-frame
     clip's 21 padded to a multiple of 2, its 80 actions padded by 4 as the
     JAX loss pads them: 11 x 600 + 226 = 6826 joint tokens), no decode (no
     CogVideoX 1.5 VAE config exists), 2 x 42 / 84 / 168 launches, and the
     same logit check; (d) PAB on the flagship, bf16 then quantized in place
     to W8A8: 8 DPM steps with pab_skip=2 (flags T T F F T F F T), then the
     same 8 without, printing both s/step, their ratio and both counts of
     attention launches (a reuse step launches no attention and no norm1
     modulate: 30 / 120 of modulate_norm (or _q8) / gated_residual), in
     turns (PAB, exact, exact, PAB) so that the first calls fall on both;
     the PAB latents must lie 2e-3 to 2.5e-2 of the range from the exact
     sampler's (measured 6.9e-3 bf16, 8.1e-3 W8A8);
  6a. the synthetic PAB quality harness (scripts/pab_quality_synthetic_torch.py)
     on the card at a short budget: its `run` overfits the 4-layer model
     (2 heads of 64, bf16 compute, f32 parameters) for 20 train steps and
     renders 2 clips of 6 DPM steps, exact and PAB (pab_skip 2, window
     0.1-0.85), in both sampler groups: every report field there and
     finite, `safe` the +6 dB rule, launches exactly 20 micro-steps' plus
     the renders' full and reuse forwards'; then an overfit of the same
     budget whose logged loss falls (the second half's mean under the first
     step's), and a PAB sampler with an empty window (pab_start == pab_end)
     bitwise the exact sampler; one line with the phase's seconds;
  6b. every shape at which the DiT layers called a forward kernel (rows 2,
     3, 6, 8, 9) or the kernels' autograd Functions a backward (rows 4-5, 7,
     10) in phases 3 to 6a (`ShapeLog`), held against its plain version
     unless phase 2, 5c or 6 checked it already;
  7. the card's name and power limit, the kernels' JSON line (launches: the
     sum over every main-path run of phases 3 to 6a, the comparisons with
     plain versions left out; every kernel must have run; each record also
     lists its times at phase 6's shapes under "surface_shapes" and at phase
     5c's under "surface_train_shapes"; the factory's four records last, with
     phase 4d's launches), and last
     the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import math
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from orv_tpu_torch.configs import default_config_dir, load_config
from orv_tpu_torch.data import BucketSampler
from orv_tpu_torch.data.grain_loader import index_shuffle, make_grain_loader
from orv_tpu_torch.models import (CausalVAE, ControlDiT, DiTConfig, VAEConfig, decode_chunked,
                                  encode_auto)
from orv_tpu_torch.models.feature_extractors import I3D, ConvBN, InceptionV3Pool3
from orv_tpu_torch.models.layers import quantize_tokens
from orv_tpu_torch.models.quantize import quantize_linear_params, quantize_model_
from orv_tpu_torch.models.text_encoder import T5Config, T5Encoder
from orv_tpu_torch.models.weights import gather_state_dict, write_safetensors
from orv_tpu_torch.ops import _build, adaln, attention
from orv_tpu_torch.ops import gaussian_raster as raster_mod
from orv_tpu_torch.ops import scan as scan_mod
from orv_tpu_torch.ops import voxelize as voxelize_mod
from orv_tpu_torch.ops.ring_attention import joint_ring_attention
from orv_tpu_torch.parallel import (
    LossDraws,
    TrainState,
    diffusion_loss,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from orv_tpu_torch.parallel.sp import SOLO, LocalRing
from orv_tpu_torch.parallel.train_step import global_norm, grad_params, state_tensors
from orv_tpu_torch.pipelines import train as train_mod
from orv_tpu_torch.pipelines import SamplerConfig, data_process, decode_latents, make_sampler
from orv_tpu_torch.pipelines import encode_dataset as encode_mod
from orv_tpu_torch.pipelines import evaluate as evaluate_mod
from orv_tpu_torch.pipelines import inference as inference_mod
from orv_tpu_torch.pipelines import metrics as metrics_mod
from orv_tpu_torch.pipelines.evaluate import evaluate
from orv_tpu_torch.pipelines.inference import generate_video
from orv_tpu_torch.pipelines.train import build_dit_config
from orv_tpu_torch.schedulers import make_schedule
from orv_tpu_torch.utils.checkpoint import TrainCheckpointer, load_pretrained
from orv_tpu_torch.utils.embeddings import prepare_rotary_positional_embeddings
from orv_tpu_torch.utils.video import read_video, write_video

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
TOTAL_LAUNCHES = [0] * len(KERNELS)  # the kernels line's: every main-path run's, summed (`tally`)
CHECKED = set()  # the forward kernels' shapes held against their plain versions, `ShapeLog` keys
BF16_FORWARD = (30, 60, 120, 0, 0, 0, 0, 0, 0, 0)  # launches of one flagship forward, in KERNELS order
Q8_FORWARD = (0, 0, 120, 30, 60, 0, 0, 0, 0, 0)
SP = 4  # ranks of the in-process ring, all on the one card
# launches of one rank's flagship forward at sp=4: each block's joint ring runs
# 7 static-max attentions (video queries: text, local chunk, 3 rotated chunks;
# text queries: text, local chunk)
SP_FORWARD = (7 * 30, 60, 120, 0, 0, 0, 0, 0, 0, 0)


def train_micro_step_counts(num_layers: int, modulate_enc: bool = True, multiview: bool = False,
                            remat: bool = False):
    """Launches of one training micro-step, in KERNELS order. A DiTBlock
    runs one attention, two adaLN forwards (the video stream's) and, 6-chunk
    (`modulate_enc`), four gated residuals (3-chunk: two, the video
    stream's); an MVBlock adds one attention, one adaLN forward and one
    gated residual. Each runs its backward kernel once; under remat
    (`gradient_checkpointing`) the backward recomputes every forward kernel
    of the blocks, so they launch twice. With 6-chunk blocks the last
    block's text-stream output feeds nothing (the head reads the video
    stream only), so autograd never runs the backward of that block's final
    text-stream gated residual."""
    L = num_layers
    attn = L * (2 if multiview else 1)
    mn = L * (3 if multiview else 2)
    gr = L * ((4 if modulate_enc else 2) + (1 if multiview else 0))
    f = 2 if remat else 1
    return (f * attn, f * mn, f * gr, 0, 0, attn, attn, mn, gr - (1 if modulate_enc else 0), 0)


TRAIN_MICRO_STEP = train_micro_step_counts(30)  # one micro-step of the 2B recipe
# the 2B fine-tune recipe: traj_image_2b_finetune.yaml on base_train.yaml, with
# transformer.recon_action=true named (the yaml's runtime block alone builds no
# action-recon head, ROADMAP.md C, "config resolution")
RECIPE_2B = DiTConfig(num_attention_heads=30, attention_head_dim=64, num_layers=30,
                      in_channels=32, out_channels=16, text_embed_dim=4096, time_embed_dim=512,
                      modulate_encoder_hidden_states=True, recon_action=True)
TRAIN_RECIPE = "experiments/traj_image_2b_finetune.yaml"
TRAIN_STEPS = 4  # micro-steps (max_train_steps counts them, as in JAX): 2 optimizer steps
TRAIN_VAL_STEPS = 4  # DPM steps of each inline validation
# the tiny model of the resume round trip: 2 layers x 2 heads x 64, text 8 x 32
TINY_TRAIN = ["transformer.num_attention_heads=2", "transformer.attention_head_dim=64",
              "transformer.num_layers=2", "transformer.text_embed_dim=32",
              "transformer.time_embed_dim=64", "transformer.max_text_seq_length=8",
              "dataset.sample_size=[8, 16]", "dataset.video_size=[64, 128]"]


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


PROFILED = "chip_smoke profiled calls"  # the range profiled_events counts in


def profiled_events(fn, calls, n: int, warmup: int = 2, tries: int = 3) -> dict:
    """{device kernel: us a call}, torch.profiler's device durations over n
    calls rotating over `calls`. Summed over a whole session, the profiler
    missed calls near its start (in the whole smoke, 1 of 5 and 1 of 10
    factory calls, 8 of 10 of dynamic voxelization's 0.002 ms calls): so
    `warmup` calls and 20 ms come first and 20 ms after, only kernels that start
    inside a `record_function` range around the n calls count (2 ms inside
    each end of it: device timestamps may lie a little off the host's), and
    a session in which a kernel's count is not a multiple of n is run again,
    up to `tries` times (a line says so if none is whole)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    best = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(warmup):
                fn(*calls[i % len(calls)])
            torch.cuda.synchronize()
            time.sleep(0.02)
            with record_function(PROFILED):
                time.sleep(0.002)  # device timestamps may lie a little off the host's
                for i in range(n):
                    fn(*calls[i % len(calls)])
                torch.cuda.synchronize()
                time.sleep(0.002)
            time.sleep(0.02)
        events = prof.events()
        window = [e.time_range for e in events
                  if e.name == PROFILED and e.device_type != DeviceType.CUDA]
        check(len(window) == 1, f"torch.profiler recorded {len(window)} ranges {PROFILED!r}")
        t0, t1 = window[0].start, window[0].end
        by, count = {}, {}
        for e in events:
            if (e.device_type != DeviceType.CUDA or e.name == PROFILED
                    or getattr(e, "is_user_annotation", False)
                    or not t0 <= e.time_range.start <= t1):
                continue
            name = re.split(r"[(<]", e.name.replace("(anonymous namespace)::", ""))[0]
            name = name.split("::")[-1].replace("void ", "").strip()[:40]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / n
            count[name] = count.get(name, 0) + 1
        if by and all(c % n == 0 for c in count.values()):
            return by
        if sum(count.values()) > sum(best.get("count", {}).values()):
            best = dict(by=by, count=count)
    print(f"profiler: no whole trace of {n} calls in {tries} sessions (kernel counts "
          f"{best.get('count')}): the times below are short", flush=True)
    check(best.get("by"), "torch.profiler recorded no device time")
    return best["by"]


def profiled_ms(fn, calls, n: int, warmup: int = 2) -> float:
    """Mean device time of a call by torch.profiler (`profiled_events`)."""
    return sum(profiled_events(fn, calls, n, warmup).values()) / 1e3


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


def plain_by_batch(fn, q, k, v, **kwargs):
    """A plain attention over one batch element at a time, concatenated: the
    plain versions hold f32 scores [B, H, S, S] (23 GiB at [3,30,8026])."""
    outs = [fn(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kwargs) for b in range(q.shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def check_attention(g, shape, timed: bool):
    q, k, v = (torch.randn(*shape, 64, device="cuda", generator=g).bfloat16() for _ in range(3))
    out, lse = attention.flash_attention(q, k, v, static_max=24.0)
    ref, ref_lse = plain_by_batch(attention.flash_attention_plain, q, k, v, static_max=24.0)
    CHECKED.add(("flash_attention", tuple(shape), shape[2], 24.0))
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
                  "flash_attn_bwd.cu", "modulate_norm.cu", "modulate_norm_q8.cu",
                  "modulate_norm_bwd.cu", "gated_residual_bwd.cu")
# a kernel's name, and an adaLN instance's count (chunks of 128 columns held
# in registers, or gated_residual_bwd's vectors a thread)
KERNEL_NAME = re.compile(
    r"((?:flash_(?:fwd|bwd)_\w*?|modulate_norm(?:_q8|_bwd)?|gated_residual_bwd)_kernel)"
    r"(?:E|ILi(\d+)E)")
# the instances printed, of those checked: D = 1920 and the widest
SHOWN_HELD = {"gated_residual_bwd_kernel": ("1", "8")}
SHOWN_HELD_ADALN = ("15", "16")  # the adaLN forwards and backward: D = 1920, D = 2048-4096


def hopper_build_report() -> None:
    """The ptxas report of the Hopper kernels: the TMA + wgmma ones (the
    three forwards, each entry file one mode of flash_fwd_sm90.cuh's kernel,
    and the backward's dq and dk/dv kernels), the two bulk-copy adaLN
    forwards (adaln_fwd_sm90.cuh, one instance per held-chunk count) and the
    two bulk-copy backwards (adaln_bwd_sm90.cuh: modulate_norm_bwd one
    instance per held-chunk count, gated_residual_bwd one per count of
    vectors a thread), the instances of SHOWN_HELD printed. Registers and
    spills of each kernel, and any notice that ptxas serialized or fenced a
    wgmma pipeline (C75xx); either of the last two, in any instance, fails
    the run."""
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
            shown = SHOWN_HELD.get(name.group(1) if name else kernel, SHOWN_HELD_ADALN)
            if held is None or held in shown:
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
    CHECKED.add(("modulate_norm", (R, S, D), norm_f32))
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
    CHECKED.add(("gated_residual", (R, S, D)))
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
    ref = plain_by_batch(attention.flash_attention_q8_plain, q, k, v)
    CHECKED.add(("flash_attention_q8", tuple(shape), shape[2]))
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
    CHECKED.add(("modulate_norm_q8", (R, S, D), norm_f32))
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
    """Each error <= max_rel RMS(ref), plus one bf16 rounding of the element
    (2^-8 |ref|) for a bf16 output, and RMS error <= rms_rel RMS(ref). At
    the defaults, the backward kernels' bound: one bf16 rounding of an output
    gives an RMS error of about 1e-3; ignoring dlse gives errors of order
    RMS(ref). The rounding term matters at outliers: at the MVBlock's 2478
    keys a few dv elements reach 0.5-1, where one rounding (0.0039) passes
    0.1 RMS(ref) (0.0033)."""
    _, rel, rms = rms_errors(got, want)
    ulp = 2.0 ** -8 * want.float().abs() if got.dtype == torch.bfloat16 else 0.0
    return bool(((got.float() - want.float()).abs() <= max_rel * rms + ulp).all()) and \
        rel <= rms_rel


def plain_bwd_by_batch(q, k, v, out, lse, do, dlse=None):
    """flash_attention_bwd_plain one batch element at a time, concatenated
    (its f32 scores and probabilities at [9,30,3226] would take 22 GiB)."""
    grads = [attention.flash_attention_bwd_plain(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], out[b:b + 1], lse[b:b + 1], do[b:b + 1],
        dlse=None if dlse is None else dlse[b:b + 1]) for b in range(q.shape[0])]
    return tuple(torch.cat(t) for t in zip(*grads))


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
    want = plain_bwd_by_batch(q, k, v, out, lse, do, dlse)
    again = attention.flash_attention_bwd(q, k, v, out, lse, do, dlse=dlse)
    CHECKED.add(("flash_attention_bwd", tuple(shape), skv))
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
    plain_ms = call_ms("flash_attention_bwd_plain", plain_bwd_by_batch, (q, k, v, out, lse, do),
                       3)
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


def mn_bwd_inputs(g, R, S, D):
    """(x, dout, scale, ns) of the adaLN backward: scale a row-strided bf16
    chunk and ns f32, as in the f32-parameter training model."""
    x = (2 * torch.randn(R, S, D, device="cuda", generator=g) + 0.3).bfloat16()
    do = torch.randn(R, S, D, device="cuda", generator=g).bfloat16()
    _, scale, _ = (0.3 * torch.randn(R, 3 * D, device="cuda", generator=g)).bfloat16(
    ).chunk(3, dim=-1)
    return x, do, scale, 1 + 0.1 * torch.randn(D, device="cuda", generator=g)


def layer_norm_bwd(x, do, w, b, mean, rstd):
    """ATen's LayerNorm backward with weight w, bias b and the saved mean and
    rstd: (dx, dw, db). At R = 1 it is the adaLN backward's function: dx, B
    and A."""
    return torch.ops.aten.native_layer_norm_backward(do, x, [x.shape[-1]], mean, rstd, w, b,
                                                     [True, True, True])


def mn_bwd_library_ms(g, S, D, eps: float = 1e-5):
    """The adaLN backward's yardstick at its R = 1 form [1, S, D]: with w =
    ns * (1 + scale[0]) one [D] vector, ATen's LayerNorm backward returns
    (dx, B, A) from the same bytes (w in x's dtype, bf16: ATen's backward
    takes no f32 weight with bf16 x). Prints its time beside the kernel's at
    the same inputs (device_ms) and how far its outputs lie from the
    kernel's; returns (library ms, kernel ms)."""
    x, do, scale, ns = mn_bwd_inputs(g, 1, S, D)
    w = (ns * (1.0 + scale.float()[0])).to(x.dtype)
    _, mean, rstd = torch.native_layer_norm(x.float(), [D], None, None, eps)
    got = adaln.modulate_norm_bwd(x, do, scale, ns)
    args = (x, do, w, torch.zeros_like(w), mean, rstd)
    lib = layer_norm_bwd(*args)
    errs = [rms_errors(a, b)[1] for a, b in zip((got[0], got[2][0], got[1][0]), lib)]
    lib_ms = call_ms("aten native_layer_norm_backward", layer_norm_bwd, args, 50)
    ms = call_ms("modulate_norm_bwd R = 1", adaln.modulate_norm_bwd, (x, do, scale, ns), 50)
    print(f"library modulate_norm_bwd [1, {S}, {D}] (R = 1: w one vector): aten "
          f"native_layer_norm_backward {lib_ms:.4f} ms, kernel {ms:.4f} ms; rel RMS of the "
          f"kernel's dx / B / A from aten's {errs[0]:.3g} / {errs[1]:.3g} / {errs[2]:.3g}",
          flush=True)
    return lib_ms, ms


def check_modulate_norm_bwd(g, R, S, D, timed: bool):
    """dx against its RMS (`rms_agree`); the f32 row sums A and B, which
    only the summation order separates: max error <= 1e-3 and RMS error
    <= 1e-4 of RMS(ref); a second run gives the same bits (no atomics).
    Timed at the training shape, with the library yardstick at its R = 1
    form (`mn_bwd_library_ms`)."""
    x, do, scale, ns = mn_bwd_inputs(g, R, S, D)
    got = adaln.modulate_norm_bwd(x, do, scale, ns)
    want = adaln.modulate_norm_bwd_plain(x, do, scale, ns)
    again = adaln.modulate_norm_bwd(x, do, scale, ns)
    CHECKED.add(("modulate_norm_bwd", (R, S, D)))
    ok = [rms_agree(got[0], want[0])] + [rms_agree(a, b, 1e-3, 1e-4)
                                          for a, b in zip(got[1:], want[1:])]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [rms_errors(a, b) for a, b in zip(got, want)]
    print(f"kernel modulate_norm_bwd [{R}, {S}, {D}]: dx max_abs_err {errs[0][0]:.3g} "
          f"(tol 0.1*RMS(ref) = {0.1 * errs[0][2]:.3g}), rel RMS err {errs[0][1]:.3g} (tol 1e-2); "
          f"A/B rel RMS err {errs[1][1]:.3g} / {errs[2][1]:.3g} (tol 1e-4); second run bitwise "
          f"equal: {same}", flush=True)
    check(all(ok) and same, f"modulate_norm_bwd disagrees at {(R, S, D)} or differs on a repeat")
    if not timed:
        return None
    host_us(f"modulate_norm_bwd [{R}, {S}, {D}]", adaln.modulate_norm_bwd, (x, do, scale, ns))
    bms, by = bound_ms(3 * R * S * D * 2 + R * D * 2 + D * 4 + 2 * R * D * 4,
                       f32=16.0 * R * S * D)
    lib_ms, r1_ms = mn_bwd_library_ms(g, R * S, D)
    return dict(name="modulate_norm_bwd", route="cuda",
                source="orv_tpu_torch/ops/csrc/modulate_norm_bwd.cu",
                replaces="orv_tpu/ops/adaln.py:105", max_abs_err=errs[0][0],
                ms=call_ms("modulate_norm_bwd", adaln.modulate_norm_bwd, (x, do, scale, ns), 50),
                plain_ms=call_ms("modulate_norm_bwd_plain", adaln.modulate_norm_bwd_plain,
                                 (x, do, scale, ns), 10),
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                library_note=f"aten native_layer_norm_backward at the R = 1 form [1,{R * S},{D}] "
                             f"(w one vector); the kernel there: {r1_ms:.4f} ms")


def check_gated_residual_bwd(g, R, S, D, timed: bool):
    """dy exactly (one rounding of one f32 product, as the plain version);
    dgate's f32 sums: max error <= 1e-3 and RMS error <= 1e-4 of RMS(ref); a
    second run gives the same bits. Timed: a record (the video stream's
    shape), or with `text` its time and bound on a line of their own."""
    do, y = (torch.randn(R, S, D, device="cuda", generator=g).bfloat16() for _ in range(2))
    gate = torch.randn(R, 3 * D, device="cuda", generator=g).bfloat16()[:, 2 * D:]
    dy, dgate = adaln.gated_residual_bwd(do, y, gate)
    ref_dy, ref_dgate = adaln.gated_residual_bwd_plain(do, y, gate)
    again = adaln.gated_residual_bwd(do, y, gate)
    CHECKED.add(("gated_residual_bwd", (R, S, D)))
    same = torch.equal(again[0], dy) and torch.equal(again[1], dgate)
    dy_err, (dg_err, dg_rel, _) = max_err(dy, ref_dy), rms_errors(dgate, ref_dgate)
    print(f"kernel gated_residual_bwd [{R}, {S}, {D}]: dy max_abs_err {dy_err:.3g} (tol 0), "
          f"dgate max_abs_err {dg_err:.3g}, rel RMS err {dg_rel:.3g} (tol 1e-4); second run "
          f"bitwise equal: {same}", flush=True)
    check(dy_err == 0.0 and rms_agree(dgate, ref_dgate, 1e-3, 1e-4) and same,
          f"gated_residual_bwd disagrees at {(R, S, D)} or differs on a repeat")
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


def time_gated_residual_bwd_text(g) -> float:
    """The gated-residual backward at the text stream's [1, 226, 1920] (59
    of its 119 launches a training micro-step): its time and bound on a line
    of their own. Returns the time."""
    R, S, D = 1, 226, 1920
    do, y = (torch.randn(R, S, D, device="cuda", generator=g).bfloat16() for _ in range(2))
    gate = torch.randn(R, 3 * D, device="cuda", generator=g).bfloat16()[:, 2 * D:]
    ms = call_ms("gated_residual_bwd text", adaln.gated_residual_bwd, (do, y, gate), 50)
    bms, by = bound_ms(3 * R * S * D * 2 + R * D * 2 + R * D * 4, f32=3.0 * R * S * D)
    print(f"time gated_residual_bwd text stream [{R}, {S}, {D}]: kernel {ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}), {bms / ms:.1%} of it", flush=True)
    return ms


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
    return LossDraws(**{k: None if v is None else v.to(device) for k, v in vars(draws).items()})


def tiny_train_check() -> None:
    """One train step of a 2-layer recon_action, visual-guidance ControlDiT
    (2 heads of 64, 6-chunk adaLN, batch 2, depth and label moments in the
    batch): bf16 compute on the card (the kernels and their backward
    kernels) against f32 on the CPU (plain versions), from the same f32
    weights and draws, one row action-CFG masked. Loss and grad norm agree
    to 2e-2 relative; every parameter with a nonzero gradient on the CPU
    gets a nonzero one on the card (no gradient is dropped at a kernel's
    output); then one make_train_step call on each, whose loss and grad
    norm agree to the same bound."""
    cfg = DiTConfig(num_attention_heads=2, attention_head_dim=64, num_layers=2, in_channels=32,
                    out_channels=16, text_embed_dim=32, time_embed_dim=64,
                    modulate_encoder_hidden_states=True, recon_action=True, visual_guidance=True)
    gc_ = torch.Generator().manual_seed(3)
    batch = dict(latents=torch.randn(2, 32, 3, 8, 16, generator=gc_),
                 image_latents=torch.randn(2, 32, 1, 8, 16, generator=gc_),
                 prompt_embeds=torch.randn(2, 8, 32, generator=gc_),
                 actions=0.1 * torch.randn(2, 8, 7, generator=gc_),
                 latents_depth=torch.randn(2, 32, 3, 8, 16, generator=gc_),
                 latents_label=torch.randn(2, 32, 3, 8, 16, generator=gc_))
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
    check(model.initial_combine_linear.weight.grad.abs().max() > 0,
          "the depth and label controls gave the combine linear no gradient on the card")
    print(f"tiny train step (depth and label latents), card bf16 vs CPU f32: loss {l_got:.6g} vs {l_ref:.6g}, grad norm "
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


def write_train_data(root: Path, frames: int = 49, slice_frames: int = 17,
                     latent_hw=(40, 60), text=(226, 4096), views: int = 1,
                     episodes: int = 1) -> int:
    """The training configs' on-disk layout for `episodes` bridgev2
    episodes of `frames` frames, from a numpy seed: annotation JSON (states
    for the actions), and for each slice of the train split (one every 4
    frames) and each of `views` views the moments of its `slice_frames`-
    frame clip, [32, F, h, w] video and [32, 1, h, w] image latents (view 0
    unsuffixed, view v as `*_{v}.npz`, the multiview layout); the empty
    prompt's embeds `text`. Returns the number of slices."""
    rng = np.random.default_rng(0)
    emb = root / "embeddings_full" / "train"
    for d in ("latents", "image_latents", "prompt_embeds"):
        (emb / d).mkdir(parents=True)
    (root / "annotations" / "train").mkdir(parents=True)
    F = (slice_frames - 1) // 4 + 1
    starts = range(0, frames - slice_frames + 1, 4)
    for ep in range(episodes):
        eid = f"{ep:05d}"
        ann = dict(episode_id=eid, texts=["put the spoon in the pot"],
                   videos=[{"video_path": f"videos/{eid}.mp4"}],
                   state=rng.uniform(-0.5, 0.5, (frames, 7)).tolist(),
                   continuous_gripper_state=rng.uniform(0, 1, frames).tolist())
        (root / "annotations" / "train" / f"{eid}.json").write_text(json.dumps(ann))
        for start in starts:
            for v in range(views):
                name = f"{eid}_{start:02d}_{slice_frames:02d}{f'_{v}' if v else ''}.npz"
                np.savez(emb / "latents" / name,
                         rng.normal(size=(32, F, *latent_hw)).astype(np.float32))
                np.savez(emb / "image_latents" / name,
                         rng.normal(size=(32, 1, *latent_hw)).astype(np.float32))
    np.savez(emb / "prompt_embeds" / "empty.npz",
             (0.1 * rng.standard_normal(text)).astype(np.float32))
    return episodes * len(starts)


def train_config(root: Path, out: Path, extra=()):
    """The port's base_train.yaml + experiments/traj_image_2b_finetune.yaml
    on bridgev2 at `root`, writing under `out`."""
    return load_config(str(default_config_dir() / "base_train.yaml"),
                       str(default_config_dir() / TRAIN_RECIPE), "bridgev2",
                       overrides=[f"dataset.data_root={root}", "transformer.recon_action=true",
                                  f"train.output_path={out}", "train.output_dir=run", *extra])


class _Cut(Exception):
    pass


def tiny_resume_check(root: Path, device="cuda") -> None:
    """The resume round trip at a tiny config (2 layers x 2 heads x 64, one
    17-frame slice, B=1, accumulation 2, a checkpoint every micro-step):
    runs cut before micro-step 2 (an update boundary) and 3 (mid-
    accumulation), each resumed from its latest checkpoint to 4, end with
    the parameters, moments and counts of an unbroken run of 4, bitwise."""
    write_train_data(root / "data", frames=17, latent_hw=(8, 16), text=(8, 32))
    extra = [*TINY_TRAIN, "transformer.pretrained_name_or_path=null", "train.train_batch_size=1",
             "train.max_train_steps=4", "train.checkpointing_steps=1",
             "train.checkpoints_total_limit=2", "train.lr_warmup_steps=0",
             "train.learning_rate=1e-3", "train.log_every=1"]
    os.environ["NO_INIT_VAL"] = "1"
    try:
        whole = train_mod.train(train_config(root / "data", root / "whole", extra), device=device)
        default = train_mod.seeded_draws(42, device)
        for stop in (2, 3):
            def draws(step, batch, stop=stop):
                if step == stop:
                    raise _Cut
                return default(step, batch)

            cfg = train_config(root / "data", root / f"cut{stop}", extra)
            try:
                train_mod.train(cfg, device=device, draws=draws)
            except _Cut:
                pass
            resumed = train_mod.train(cfg, device=device)
            a, b = whole.model.state_dict(), resumed.model.state_dict()
            same = (all(torch.equal(a[k], b[k]) for k in a)
                    and all(torch.equal(x, y) for g in ("mu", "nu")
                            for x, y in zip(getattr(whole.opt_state, g),
                                            getattr(resumed.opt_state, g)))
                    and (whole.step, whole.opt_state.count) == (resumed.step,
                                                                resumed.opt_state.count) == (4, 2))
            print(f"tiny resume on {device}: cut before micro-step {stop}, resumed to 4: "
                  f"parameters and moments bitwise equal to an unbroken run: {same}", flush=True)
            check(same, f"a run resumed at micro-step {stop} differs from an unbroken one")
    finally:
        os.environ.pop("NO_INIT_VAL", None)


class TrainTimes:
    """Wall seconds (card synchronized) and bytes of what the training entry
    point's tracker does not log: each validation, each checkpoint save and
    the exports. `patch` wraps `run_validation` and `export_pretrained` of
    pipelines/train.py and TrainCheckpointer.save, `restore` puts them back
    and fails if one of them was never called."""

    def __init__(self):
        self.saved = {n: getattr(train_mod, n) for n in ("run_validation", "export_pretrained")}
        self.saved_save = TrainCheckpointer.save
        self.s = {k: [] for k in ("validation", "checkpoint", "export")}
        self.bytes = {"checkpoint": [], "export": []}

    def _timed(self, what, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[what].append(time.perf_counter() - t0)
            return out
        return run

    def patch(self):
        orig, times = self.saved, self

        def export_pretrained(*args):
            times.bytes["export"].append(times._timed("export", orig["export_pretrained"])(*args))
            return times.bytes["export"][-1]

        def save(ckpt, step, state, write=True):
            saved = times._timed("checkpoint", times.saved_save)(ckpt, step, state, write)
            times.bytes["checkpoint"].append(ckpt.last_save_bytes if saved else 0)
            return saved

        train_mod.export_pretrained = export_pretrained
        train_mod.run_validation = self._timed("validation", orig["run_validation"])
        TrainCheckpointer.save = save

    def restore(self):
        for n, fn in self.saved.items():
            setattr(train_mod, n, fn)
        TrainCheckpointer.save = self.saved_save

    def check_called(self, required=("validation", "checkpoint", "export")):
        never = [k for k in required if not self.s[k]]
        check(not never, f"the training entry point never called the wrapped {never}")


def watched(model):
    return [model.transformer_blocks[0].attn1.to_q.weight,
            model.transformer_blocks[-1].ff.net[2].weight, model.proj_out.weight,
            model.action_recon.mlp[2].weight, model.patch_embed.proj.weight]


def train_phase(root: Path) -> None:
    """Phase 5: the 2B fine-tune recipe through pipelines/train.py:train at
    full width (module docstring)."""
    t_phase = time.perf_counter()
    n_params = sum(p.numel() for p in ControlDiT(RECIPE_2B, device="meta").parameters())
    n_5b = sum(p.numel() for p in ControlDiT(FIVE_B_CUT, device="meta").parameters())
    # a checkpoint (f32 parameters and Adam's two moments), then the export: this
    # phase's, or phase 5c's largest, the cut 5b's
    need = 16 * max(n_params, n_5b) + (1 << 30)
    free = shutil.disk_usage(root).free
    print(f"train phase: {free / 2**30:.1f} GiB free in {root}, phases 5 and 5c write up to "
          f"{need / 2**30:.1f} GiB at once", flush=True)
    check(free >= need, f"{root} has {free / 2**30:.1f} GiB free but phases 5 and 5c write up "
                        f"to {need / 2**30:.1f} GiB at once (a checkpoint of parameters and "
                        "moments, then the export): set TMPDIR to a larger disk")
    n_slices = write_train_data(root / "data")
    check(n_slices >= 8, f"{n_slices} training slices written")
    cfg = train_config(root / "data", root / "out", [
        f"train.max_train_steps={TRAIN_STEPS}", "train.checkpointing_steps=4",
        "train.checkpoints_total_limit=1", "train.log_every=1",
        f"train.validation_steps={TRAIN_STEPS}", f"inference.num_inference_steps={TRAIN_VAL_STEPS}"])
    check(build_dit_config(cfg) == RECIPE_2B, f"the recipe builds {build_dit_config(cfg)}")
    bs, accum = int(cfg.train.train_batch_size), int(cfg.train.gradient_accumulation_steps)
    print(f"train: {TRAIN_RECIPE} on base_train.yaml, {n_slices} bridgev2 slices of 17 frames, "
          f"B={bs} x accumulation {accum}, {TRAIN_STEPS} micro-steps, mixed precision "
          f"{cfg.train.mixed_precision}, transformer.recon_action=true passed explicitly (the "
          f"yaml alone builds no action-recon head), pretrained "
          f"{cfg.transformer.pretrained_name_or_path} (absent: random init from seed "
          f"{cfg.seed})", flush=True)
    # the init train makes from the seed, to see the parameters move
    before = [w.detach().clone() for w in watched(train_mod.init_params(cfg, RECIPE_2B))]
    torch.manual_seed(0)
    vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16)  # f32 parameters, as train loads one
    times = TrainTimes()
    times.patch()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        state = train_mod.train(cfg, vae=vae)
    finally:
        times.restore()
    wall = time.perf_counter() - t0
    times.check_called()
    launches, peak = counts(), torch.cuda.max_memory_allocated() / 2**30
    tally(launches)
    run = root / "out" / "run"
    n_val = len(times.s["validation"])
    want = tuple(TRAIN_STEPS * m + n_val * TRAIN_VAL_STEPS * f
                 for m, f in zip(TRAIN_MICRO_STEP, BF16_FORWARD))
    model = state.model
    metrics = [m for m in map(json.loads, (run / "logs" / "metrics.jsonl").read_text().splitlines())
               if "loss" in m]  # the validations' video lines carry no loss
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    micro = [m["s_per_it"] for m in metrics]  # log_every=1: each micro-step's loop iteration
    per_step = [sum(micro[i:i + accum]) for i in range(0, len(micro), accum)]
    print(f"train through the entry point: {wall:.1f} s; s/optimizer step from the tracker's "
          f"s_per_it {', '.join(f'{x:.4f}' for x in per_step)} (micro-steps "
          f"{', '.join(f'{x:.4f}' for x in micro)}; each holds the loader's wait, to_device "
          f"and the draws, and the first after a checkpoint its write); "
          f"validations {', '.join(f'{x:.2f}' for x in times.s['validation'])} s "
          f"({TRAIN_VAL_STEPS} DPM steps, decode and mp4); checkpoint writes "
          f"{', '.join(f'{b / 1e9:.2f} GB in {x:.1f} s' for b, x in zip(times.bytes['checkpoint'], times.s['checkpoint']))}; "
          f"export {times.bytes['export'][0] / 1e9:.2f} GB in {times.s['export'][0]:.1f} s; "
          f"peak memory {peak:.1f} GiB", flush=True)
    print(f"train loss per micro-step {', '.join(f'{x:.5g}' for x in losses)}; grad norm "
          f"{', '.join(f'{x:.5g}' for x in norms)}; launches {launches} = {TRAIN_STEPS} x "
          f"{TRAIN_MICRO_STEP} + {n_val} validations x {TRAIN_VAL_STEPS} x {BF16_FORWARD}",
          flush=True)
    check(launches == want, f"training launch counts {launches} != {want}")
    check(n_val == 2, f"{n_val} validations ran, not the initial one and the last step's")
    check([m["step"] for m in metrics] == list(range(1, TRAIN_STEPS + 1))
          and all(map(math.isfinite, losses + norms)),
          "a logged training step is missing or its loss or grad norm is not finite")
    finite = all(bool(torch.isfinite(n)) for n in torch._foreach_norm(list(model.parameters())))
    moved = [not torch.equal(b, w) for b, w in zip(before, watched(model))]
    print(f"train parameters finite: {finite}, watched tensors moved: {moved}", flush=True)
    check(finite and all(moved), "training left non-finite or unmoved parameters")
    for name in ("step_000000.mp4", f"step_{TRAIN_STEPS:06d}.mp4"):
        clip = read_video(str(run / "validation" / name))
        check(clip.shape == (17, 320, 480, 3), f"validation {name} reads back as {clip.shape}")
    kept = sorted(p.name for p in (run / "checkpoints").iterdir())
    print(f"train checkpoints left after rotation: {kept}", flush=True)
    check(kept == [str(TRAIN_STEPS)], f"checkpoints left: {kept}")

    # the export, strictly through load_pretrained, forwards bitwise as the trained model
    cfg_back, sd = load_pretrained(run / "checkpoint", DiTConfig)
    check(cfg_back == RECIPE_2B, f"the export's config.json gives {cfg_back}")
    back = ControlDiT(cfg_back, dtype=torch.bfloat16, param_dtype=torch.float32)
    back.load_state_dict(sd, strict=True)
    del sd
    dataset = train_mod.build_dataset(cfg)
    loader = train_mod.prefetch_batches(dataset, BucketSampler(dataset, bs, seed=cfg.seed))
    try:
        batch = train_mod.to_device(next(loader), torch.device("cuda"))
    finally:
        loader.close()
    b = {k: v[:1] for k, v in batch.items()}
    x = torch.cat([b["latents"][:, :16], b["image_latents"][:, :16].expand(-1, -1, 5, -1, -1)],
                  dim=1).permute(0, 2, 1, 3, 4)
    t = torch.full((1,), 500, device=x.device)
    with torch.inference_mode():
        outs = [m(x, b["prompt_embeds"], t, actions=b["actions"]) for m in (model, back)]
    same = torch.equal(outs[0], outs[1])
    print(f"train export reloaded strictly through load_pretrained: forward bitwise equal to the "
          f"trained model's: {same}", flush=True)
    check(same, "the exported model's forward differs from the trained model's")
    del back, outs

    # one more optimizer step by hand on that batch, timed in parts with CUDA events
    tx = train_mod.build_optimizer(
        cfg.train, train_mod.total_train_steps(cfg.train, len(dataset), bs), bs)
    params, sched = grad_params(model), make_schedule()
    gen = torch.Generator(device=params[0].device).manual_seed(20)
    parts = []
    for _ in range(accum):
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
    print(f"train phase total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"train micro-step split at B={bs} (ms): forward {parts[0][0]:.1f} / {parts[1][0]:.1f}, "
          f"backward {parts[0][1]:.1f} / {parts[1][1]:.1f}, grad norm + optimizer: accumulate "
          f"{parts[0][2]:.1f}, apply {parts[1][2]:.1f}; peak memory of the training phase "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)


# -- phase 5c: the model surface's training side at full width ---------------------------

MV_RECIPE = "experiments/traj_image_2b_multiview.yaml"
FIVE_B_RECIPE = "experiments/traj_image_5b_finetune.yaml"
ROPE_RECIPE = "experiments/traj_image_1.4b_scratch.yaml"
MV_EPISODES = 4  # of 9 three-view slices: every view-count bucket fills batches of 3
MV_TRAIN_STEPS = 8  # (a): the recipe's B=3 x accumulation 4, 2 updates
FIVE_B_TRAIN_STEPS = 4  # (b): the recipe's B=1 x accumulation 4, 1 update
# (b)'s depth cut: 18 of the 5b's 42 layers, 2.40 B f32 parameters. The card holds
# 20 bytes a parameter (parameters, gradients, AdamW's two moments, the
# accumulator: all 42 layers need 111 GB; 20 layers peaked at 52.7 GiB, 2.6 GiB a
# layer, so 26 would fit), but the run writes 16 bytes a parameter (the
# checkpoint's parameters and moments, then the export) to a disk of which a call
# may fill 45 GiB: 18 layers write 38.4 GB
FIVE_B_LAYERS = 18
ROPE_TRAIN_STEPS = 4  # (c): each optimizer, the base's B=4 x accumulation 4, 1 update
REMAT_LAYERS = 6  # (a)'s remat check: the depth it runs without remat at B=1


def recipe_config(recipe: str, dataset_type: str, data: Path, out: Path, extra=()):
    """The port's base_train.yaml + `recipe` on `dataset_type` at `data`,
    writing under `out`, every micro-step logged."""
    return load_config(str(default_config_dir() / "base_train.yaml"),
                       str(default_config_dir() / recipe), dataset_type,
                       overrides=[f"dataset.data_root={data}", f"train.output_path={out}",
                                  "train.output_dir=run", "train.log_every=1", *extra])


class ViewCounts:
    """Counts the micro-steps pipelines/train.py runs per view count: wraps
    its `make_train_step`, which `train` calls once per view count."""

    def __init__(self):
        self.orig, self.steps = train_mod.make_train_step, {}

    def __enter__(self):
        def make_train_step(*args, num_views: int = 1, **kwargs):
            fn = self.orig(*args, num_views=num_views, **kwargs)

            def step(*a, **k):
                self.steps[num_views] = self.steps.get(num_views, 0) + 1
                return fn(*a, **k)
            return step
        train_mod.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        train_mod.make_train_step = self.orig


def safetensors_names(path: Path):
    """The tensor names of a .safetensors file, from its header alone."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return [k for k in json.loads(f.read(n)) if k != "__metadata__"]


def surface_train_run(name: str, cfg, micro, val_forward=None, vae=None, n_val: int = 0):
    """`train(cfg)` with counts from zero and TrainTimes; checks the launch
    counts (`micro` a micro-step, `val_forward` a validation DPM step, each
    of `n_val` validations running the config's DPM steps) and that every
    logged loss and grad norm is finite; prints the run's line. Returns
    (state, run dir, logged metrics)."""
    steps, accum = int(cfg.train.max_train_steps), int(cfg.train.gradient_accumulation_steps)
    times = TrainTimes()
    times.patch()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        state = train_mod.train(cfg, vae=vae)
    finally:
        times.restore()
    wall = time.perf_counter() - t0
    times.check_called(("validation", "checkpoint", "export") if n_val else
                       ("checkpoint", "export"))
    launches, peak = counts(), torch.cuda.max_memory_allocated() / 2**30
    tally(launches)
    run = Path(cfg.train.output_path) / "run"
    metrics = [m for m in map(json.loads, (run / "logs" / "metrics.jsonl").read_text().splitlines())
               if "loss" in m]
    micro_s = [m["s_per_it"] for m in metrics]
    per_step = [sum(micro_s[i:i + accum]) for i in range(0, len(micro_s), accum)]
    dpm = int(cfg.inference.num_inference_steps)
    want = tuple(steps * m + n_val * dpm * (v if val_forward else 0)
                 for m, v in zip(micro, val_forward or micro))
    print(f"train {name}: {wall:.1f} s; s/optimizer step {', '.join(f'{x:.4f}' for x in per_step)} "
          f"(the tracker's s_per_it summed over {accum} micro-steps: "
          f"{', '.join(f'{x:.4f}' for x in micro_s)}); validations "
          f"{', '.join(f'{x:.2f}' for x in times.s['validation']) or 'none'} s; checkpoint "
          f"{', '.join(f'{b / 1e9:.2f} GB in {x:.1f} s' for b, x in zip(times.bytes['checkpoint'], times.s['checkpoint']))}; "
          f"export {times.bytes['export'][0] / 1e9:.2f} GB in {times.s['export'][0]:.1f} s; "
          f"peak memory {peak:.1f} GiB; launches from zero {launches} = {steps} x {micro}"
          + (f" + {n_val} x {dpm} x {val_forward}" if n_val else ""), flush=True)
    losses, norms = [m["loss"] for m in metrics], [m["grad_norm"] for m in metrics]
    print(f"  {name} loss per micro-step {', '.join(f'{x:.5g}' for x in losses)}; grad norm "
          f"{', '.join(f'{x:.5g}' for x in norms)}", flush=True)
    check(launches == want, f"{name} launch counts {launches} != {want}")
    check(len(times.s["validation"]) == n_val, f"{name}: {len(times.s['validation'])} "
                                               f"validations, not {n_val}")
    check([m["step"] for m in metrics] == list(range(1, steps + 1))
          and all(map(math.isfinite, losses + norms)),
          f"{name}: a logged step is missing or its loss or grad norm is not finite")
    return state, run, metrics


def remat_check(g) -> None:
    """(a)'s remat check: one micro-step's loss and MVBlock gradients of a
    multiview model cut to REMAT_LAYERS (B=1, 3 views of 5 latent frames)
    without remat, with it, and with the "dots" policy, from the same
    weights and draws; equal bitwise, else within 1e-6 of the largest
    gradient (the largest difference printed)."""
    torch.manual_seed(3)
    model = ControlDiT(MULTIVIEW_REMAT, dtype=torch.bfloat16, param_dtype=torch.float32)
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g)
    batch = dict(latents=rand(1, 32, VIEWS * 5, 40, 60), image_latents=rand(1, 32, VIEWS, 40, 60),
                 prompt_embeds=0.1 * rand(1, 226, 4096), actions=0.1 * rand(1, 16, 7))
    draws = LossDraws.draw(g, batch)
    got = {}
    for label, remat, policy in (("none", False, None), ("remat", True, None),
                                 ("dots", True, "dots")):
        model.remat, model.remat_policy = remat, policy
        for p in model.parameters():
            p.grad = None
        reset_counts()
        loss, _ = diffusion_loss(model, batch, make_schedule(), draws, num_views=VIEWS)
        loss.backward()
        got[label] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()
                                      if n.startswith("mv_blocks.") and p.grad is not None},
                      counts())
    (l0, g0, c0) = got["none"]
    scale = max(v.abs().max().item() for v in g0.values())
    for label in ("remat", "dots"):
        lo, gr, co = got[label]
        check(sorted(gr) == sorted(g0), f"remat ({label}) gives other MVBlock parameters a "
                                        "gradient")
        diff = max((gr[n] - g0[n]).abs().max().item() for n in g0)
        same = torch.equal(lo, l0) and diff == 0.0
        print(f"remat check ({REMAT_LAYERS} layers + MVBlocks, B=1 x {VIEWS} views): {label} "
              f"against none: loss {lo.item():.6g} vs {l0.item():.6g}, largest MVBlock gradient "
              f"difference {diff:.3g} of a largest gradient {scale:.3g}, bitwise {same}; launches "
              f"{co} against {c0}", flush=True)
        check(torch.equal(lo, l0) and diff <= 1e-6 * scale,
              f"remat ({label}) changes the loss or the MVBlock gradients")
        want = train_micro_step_counts(REMAT_LAYERS, multiview=True, remat=True)
        check(co == want, f"remat ({label}) launched {co}, not {want}")
    check(c0 == train_micro_step_counts(REMAT_LAYERS, multiview=True),
          f"the micro-step without remat launched {c0}")


def stage3_run(g, root: Path, stage2: Path, vae) -> None:
    """(a): the stage-3 multiview recipe from phase 5's export (module
    docstring)."""
    n = write_train_data(root / "mv", views=VIEWS, episodes=MV_EPISODES)
    # the warmup's first steps have an lr of 0 and 2e-7: a movement check over 2
    # updates needs the lr at once (the recipe keeps its lr, clip and decay)
    # transformer.recon_action=true: the model carries phase 5's action-recon head, as
    # JAX's tree carries a head its model does not call (the recipe's loss does not)
    cfg = recipe_config(MV_RECIPE, "bridgev2_2", root / "mv", root / "mv_out", [
        f"transformer.pretrained_name_or_path={stage2}", "transformer.recon_action=true",
        f"train.max_train_steps={MV_TRAIN_STEPS}", "train.lr_warmup_steps=0",
        f"inference.num_inference_steps={TRAIN_VAL_STEPS}"])
    check(build_dit_config(cfg) == STAGE3, f"the stage-3 recipe builds {build_dit_config(cfg)}")
    bs, accum = int(cfg.train.train_batch_size), int(cfg.train.gradient_accumulation_steps)
    check(cfg.train.gradient_checkpointing and (bs, accum) == (3, 4),
          "the stage-3 recipe lost its remat or its B=3 x accumulation 4")
    print(f"train (a) stage 3: {MV_RECIPE} on base_train.yaml, bridgev2_2, {n} slices of "
          f"{VIEWS} views x 17 frames (view count sampled per slice), B={bs} x accumulation "
          f"{accum}, {MV_TRAIN_STEPS} micro-steps, remat, only mv_blocks train, from phase 5's "
          f"export {stage2} (its MVBlocks seeded), lr warmup 0", flush=True)
    micro = train_micro_step_counts(30, multiview=True, remat=True)
    with ViewCounts() as views:
        state, run, _ = surface_train_run("(a) stage 3", cfg, micro, MV_FORWARD, vae, n_val=1)
    print(f"  (a) micro-steps by view count: {dict(sorted(views.steps.items()))}", flush=True)
    check(views.steps.get(VIEWS, 0) > 0, f"no {VIEWS}-view batch in the stage-3 run")
    clip = read_video(str(run / "validation" / "step_000000.mp4"))
    print(f"  (a) validation clip {list(clip.shape)} (the batch's views x 5 latent frames "
          f"decoded as one video, as the JAX package validates)", flush=True)
    check(clip.shape[0] in [1 + 4 * (v * 5 - 1) for v in range(1, VIEWS + 1)]
          and clip.shape[1:] == (320, 480, 3), f"the stage-3 validation clip {clip.shape}")
    model = state.model
    mask = state.opt_state.mask
    del state

    init = train_mod.init_params(cfg, STAGE3)  # phase 5's export, MVBlocks seeded again
    before, after = dict(init.named_parameters()), dict(model.named_parameters())
    names = list(after)
    frozen = [n for n in names if not n.startswith("mv_blocks.")]
    unchanged = [n for n in frozen if torch.equal(after[n], before[n])]
    still = [n for n in names if n.startswith("mv_blocks.") and torch.equal(after[n], before[n])]
    print(f"  (a) frozen parameters bitwise unchanged: {len(unchanged)} of {len(frozen)}; "
          f"MVBlock parameters unmoved: {len(still)} (the cam_encoders, which nothing calls: "
          f"zero, no gradient, so decay keeps them zero); trainable mask "
          f"{sum(mask)} of {len(mask)}", flush=True)
    check(len(unchanged) == len(frozen), "a frozen parameter moved in stage 3")
    check(sorted(still) == sorted(n for n in names if ".cam_encoder." in n),
          f"MVBlock parameters that did not move: {still[:5]}")
    del init, before, after

    ckpt = run / "checkpoints" / str(MV_TRAIN_STEPS) / TrainCheckpointer.STATE
    tensor_names = safetensors_names(ckpt)
    moments = [k for k in tensor_names if k.startswith(("mu/", "nu/"))]
    print(f"  (a) checkpoint {ckpt.stat().st_size / 1e9:.2f} GB: {len(tensor_names)} tensors, "
          f"{len(moments)} moments, all of mv_blocks: "
          f"{all(k.split('/', 1)[1].startswith('mv_blocks.') for k in moments)}", flush=True)
    check(moments and all(k.split("/", 1)[1].startswith("mv_blocks.") for k in moments),
          "the stage-3 checkpoint holds moments of frozen parameters")

    cfg_back, sd = load_pretrained(run / "checkpoint", DiTConfig)
    check(cfg_back == STAGE3, f"the stage-3 export's config.json gives {cfg_back}")
    back = ControlDiT(cfg_back, dtype=torch.bfloat16, param_dtype=torch.float32)
    back.load_state_dict(sd, strict=True)
    del sd
    rand = lambda *s: torch.randn(*s, device="cuda", generator=g).bfloat16()
    x, enc, acts = rand(1, VIEWS * 5, 32, 40, 60), rand(1, 226, 4096), 0.1 * rand(1, 16, 7)
    t = torch.full((1,), 500, device="cuda")
    with torch.inference_mode():
        outs = [m(x, enc, t, actions=acts, num_views=VIEWS) for m in (model, back)]
    same = torch.equal(outs[0], outs[1])
    print(f"  (a) export reloaded strictly into a multiview ControlDiT: forward on {VIEWS} views "
          f"bitwise equal to the trained model's: {same}", flush=True)
    check(same, "the stage-3 export's forward differs from the trained model's")
    del model, back, outs
    gc.collect()
    torch.cuda.empty_cache()
    remat_check(g)
    shutil.rmtree(root / "mv_out", ignore_errors=True)
    shutil.rmtree(root / "mv", ignore_errors=True)


def five_b_run(g, root: Path) -> None:
    """(b): the 5b recipe at full width, depth cut to FIVE_B_LAYERS."""
    cfg = recipe_config(FIVE_B_RECIPE, "bridgev2", root / "data", root / "5b_out", [
        "transformer.pretrained_name_or_path=null", f"transformer.num_layers={FIVE_B_LAYERS}",
        f"train.max_train_steps={FIVE_B_TRAIN_STEPS}", "train.lr_warmup_steps=0"])
    check(build_dit_config(cfg) == FIVE_B_CUT, f"the 5b recipe builds {build_dit_config(cfg)}")
    bs, accum = int(cfg.train.train_batch_size), int(cfg.train.gradient_accumulation_steps)
    n_params = sum(p.numel() for p in ControlDiT(FIVE_B_CUT, device="meta").parameters())
    n_full = sum(p.numel() for p in ControlDiT(FIVE_B, device="meta").parameters())
    print(f"train (b) 5b: {FIVE_B_RECIPE} at full width (48 x 64, patch_size_t 2, RoPE, joint "
          f"final norm, 6-chunk), depth cut {FIVE_B.num_layers} -> {FIVE_B_LAYERS} layers: "
          f"{n_params / 1e9:.2f} B parameters x 20 bytes (f32 parameters, gradients, AdamW's two "
          f"moments, the accumulator) = {20 * n_params / 1e9:.1f} GB on the card (all "
          f"{FIVE_B.num_layers}: {n_full / 1e9:.2f} B, {20 * n_full / 1e9:.1f} GB), x 16 bytes = "
          f"{16 * n_params / 1e9:.1f} GB of checkpoint and export on the disk, which takes 45 "
          f"GiB a call; B={bs} x accumulation {accum}, "
          f"{FIVE_B_TRAIN_STEPS} micro-steps, random init, no validation (its sampler would take "
          f"the 5 latent frames unpadded, which fails in both packages)", flush=True)
    os.environ["NO_INIT_VAL"] = "1"
    try:
        state, _, _ = surface_train_run("(b) 5b", cfg, train_micro_step_counts(FIVE_B_LAYERS))
    finally:
        os.environ.pop("NO_INIT_VAL", None)
    model = state.model
    del state
    moved = not torch.equal(model.transformer_blocks[0].attn1.to_q.weight,
                            train_mod.init_params(cfg, FIVE_B_CUT).transformer_blocks[0]
                            .attn1.to_q.weight)
    gc.collect()
    # the padding the loss applies, on the loader's first batch: 5 latent frames to 6,
    # 16 actions to 20, the padded frame out of the loss
    dataset = train_mod.build_dataset(cfg)
    loader = train_mod.prefetch_batches(dataset, BucketSampler(dataset, bs, seed=cfg.seed))
    try:
        batch = train_mod.to_device(next(loader), torch.device("cuda"))
    finally:
        loader.close()
    seen = {}
    hook = model.register_forward_pre_hook(
        lambda m, a, k: seen.update(frames=a[0].shape[1], actions=k["actions"].shape[1]),
        with_kwargs=True)
    rope = prepare_rotary_positional_embeddings(320, 480, batch["latents"].shape[2],
                                                patch_size_t=2)
    draws = LossDraws.draw(g, batch, 1000, patch_size_t=2)
    losses = {}
    with torch.no_grad():
        for label, fm in (("default", None), ("5 given", 5), ("6 given", 6)):
            b = dict(batch) if fm is None else dict(
                batch, frame_mask=torch.ones(fm, dtype=torch.bool, device="cuda"))
            losses[label] = diffusion_loss(model, b, make_schedule(), draws, recon_action=True,
                                           image_rotary_emb=rope, patch_size_t=2)[0]
    hook.remove()
    print(f"  (b) parameters moved: {moved}; the loss saw {seen['frames']} latent frames (the "
          f"batch's {batch['latents'].shape[2]}) and {seen['actions']} raw actions (the batch's "
          f"{batch['actions'].shape[1]}); loss {losses['default'].item():.6g}, with a given "
          f"5-frame mask {losses['5 given'].item():.6g} (the padded frame masked: bitwise "
          f"equal), with a 6-frame all-true mask {losses['6 given'].item():.6g}", flush=True)
    check(moved and seen == dict(frames=6, actions=20)
          and torch.equal(losses["default"], losses["5 given"])
          and not torch.equal(losses["default"], losses["6 given"]),
          "the 5b loss did not pad 5 frames to 6 with the padded frame masked out")
    del model
    shutil.rmtree(root / "5b_out", ignore_errors=True)


def optimizer_ms(model, rules=("adamw", "came", "prodigy")) -> None:
    """Device ms of one applied update of each optimizer over `model`'s
    parameters (the same seeded f32 gradients, accumulation 1, clip 1.0):
    CUDA events around `update`, the second of two calls."""
    g = torch.Generator(device="cuda").manual_seed(21)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    grads = [1e-3 * torch.randn(p.shape, device="cuda", generator=g) for p in params]
    ms = {}
    for rule in rules:
        tx = make_optimizer(make_lr_schedule("constant", 1e-5, warmup_steps=0), rule)
        state = tx.init(params, [n for n, _ in named])
        times = []
        for _ in range(2):
            u = [x.clone() for x in grads]
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            tx.update(u, state, params)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms[rule] = times[-1]
        del state, u
        torch.cuda.empty_cache()
    print(f"  (c) one applied update over the 1.4b's {sum(p.numel() for p in params) / 1e9:.2f} B "
          f"parameters (device ms, CUDA events, second call): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()), flush=True)


def rope_run(g, root: Path, vae) -> None:
    """(c): the 1.4b RoPE recipe at full width and depth with CAME, then
    prodigy; the largest attention logit of a training forward; each
    optimizer's update time beside AdamW's."""
    micro = train_micro_step_counts(28, modulate_enc=False)
    for i, rule in enumerate(("came", "prodigy")):
        cfg = recipe_config(ROPE_RECIPE, "bridgev2", root / "data", root / f"rope_{rule}", [
            f"train.optimizer.type={rule}", f"train.max_train_steps={ROPE_TRAIN_STEPS}",
            "train.lr_warmup_steps=0", f"inference.num_inference_steps={TRAIN_VAL_STEPS}"])
        check(build_dit_config(cfg) == ROPE_1_4B, f"the 1.4b recipe builds "
                                                  f"{build_dit_config(cfg)}")
        bs, accum = int(cfg.train.train_batch_size), int(cfg.train.gradient_accumulation_steps)
        print(f"train (c) 1.4b RoPE with {rule}: {ROPE_RECIPE} (28 x 28 x 64, 3-chunk, 1792 "
              f"wide), B={bs} x accumulation {accum}, {ROPE_TRAIN_STEPS} micro-steps, random "
              f"init{', an inline validation first' if not i else ''}", flush=True)
        if i:
            os.environ["NO_INIT_VAL"] = "1"
        try:
            state, _, _ = surface_train_run(f"(c) 1.4b {rule}", cfg, micro,
                                            None if i else ROPE_FORWARD, vae, n_val=1 - i)
        finally:
            os.environ.pop("NO_INIT_VAL", None)
        if rule == "prodigy":
            d = state.opt_state.scalars["estim_lr"].item()
            print(f"  (c) prodigy's d-estimate after one update {d:.6g} (it starts at 1e-6)",
                  flush=True)
            check(math.isfinite(d) and d > 0, "prodigy's d-estimate is not finite")
        model = state.model
        del state
        gc.collect()
        torch.cuda.empty_cache()
        if rule == "came":  # a training forward of the trained model on the loader's batch
            dataset = train_mod.build_dataset(cfg)
            loader = train_mod.prefetch_batches(dataset, BucketSampler(dataset, bs, seed=cfg.seed))
            try:
                batch = train_mod.to_device(next(loader), torch.device("cuda"))
            finally:
                loader.close()
            rope = prepare_rotary_positional_embeddings(320, 480, batch["latents"].shape[2])
            with LogitWatch() as watch:
                diffusion_loss(model, batch, make_schedule(), LossDraws.draw(g, batch),
                               image_rotary_emb=rope)
            logit = max(watch.logits)
            print(f"  (c) largest attention logit of a training forward (grad mode, B={bs}) over "
                  f"its {len(watch.logits)} layers {logit:.2f} (the static bound is 24)",
                  flush=True)
            check(len(watch.logits) == 28 and logit < 24.0,
                  f"a RoPE model's training logits {logit} pass the static bound")
            del batch
        else:
            optimizer_ms(model)
        del model
        shutil.rmtree(root / f"rope_{rule}", ignore_errors=True)


def surface_train_times(g):
    """Rows 4, 5, 7 and 10 timed at the shapes phase 5c launched them at
    (device_ms, bounds, plain and library times): the flash backward at the
    MVBlock's [15, 30, 2478, 64] (B=3 x 5 frames, 3 views x (600 + 226)
    tokens) and the 5b's [1, 48, 2026, 64]; the adaLN and gated-residual
    backwards at the 5b's [3, 600, 3072] and the 1.4b's [20, 600, 1792].
    Returns {kernel name: [records]}."""
    rec = lambda r, shape: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")} | {"shape": shape}
    out = {}
    for shape in ((15, 30, 2478), (1, 48, 2026)):
        for r in check_attention_bwd(g, shape, False, timed=True):
            out.setdefault(r["name"], []).append(rec(r, [*shape, 64]))
        torch.cuda.empty_cache()
    for R, S, D in ((3, 600, 3072), (20, 600, 1792)):
        for fn in (check_modulate_norm_bwd, check_gated_residual_bwd):
            r = fn(g, R, S, D, timed=True)
            out.setdefault(r["name"], []).append(rec(r, [R, S, D]))
    for name, recs in out.items():
        for r in recs:
            print(f"time {name} {r['shape']} (phase 5c): kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"library {r['library_ms']} ms", flush=True)
    return out


def surface_train_phase(g, root: Path, stage2: Path):
    """Phase 5c: the model surface's training side at full width (module
    docstring). Returns the records of rows 4, 5, 7 and 10 at its shapes."""
    t_phase = time.perf_counter()
    torch.manual_seed(0)
    vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16)  # f32 parameters, as train loads one
    stage3_run(g, root, stage2, vae)
    shutil.rmtree(stage2)  # the disk's room goes to (b)'s checkpoint and export
    five_b_run(g, root)
    rope_run(g, root, vae)
    del vae
    gc.collect()
    torch.cuda.empty_cache()
    records = surface_train_times(g)
    print(f"surface train phase total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


# -- phase 5d: context parallelism, the ranks as processes on the one card ----------------
#
# NCCL refuses two ranks on one card and autograd runs CUDA backward nodes on
# a thread of its own (which LocalRing cannot carry), so the sp ranks of this
# phase are SP_RANKS processes on cuda:0 over gloo, their CUDA tensors passing
# through host memory: a correctness harness, not a speed.

SP_RANKS = 2
# the 2B recipe cut to 8 of its 30 layers (0.47 B parameters), so that two
# ranks' training state and activations and rank 0's resident run fit the card
SP_TRAIN_LAYERS = 8
SP_TRAIN_STEPS = 2  # micro-steps: one optimizer step at the recipe's accumulation 2
SP_EVAL_STEPS = 2  # DPM steps of the sp evaluate
SP_RING_TEXT, SP_RING_VIDEO = 226, 7800
# sp train against resident on the card: each micro-step's loss within one bf16
# rounding (2^-8 relative; the ring moves only the merges' roundings), its grad
# norm and the first moments after the one update ((1 - b1) x the two
# micro-steps' mean gradient, RMS error over RMS(ref)) within the backward
# kernels' RMS bound of 1e-2 (`rms_agree`)
SP_LOSS_REL, SP_GRAD_REL = 2.0 ** -8, 1e-2


def sp_attention_calls(n: int) -> int:
    """Flash forwards of one joint ring attention on one rank: the video
    queries against the text, the local chunk and n - 1 rotated chunks, the
    text queries against the text and the local chunk."""
    return n + 3


def sp_train_counts(num_layers: int, n: int):
    """Launches of one sp micro-step on one rank, in KERNELS order: the
    resident micro-step's, with each attention and its dq and dk/dv n + 3
    times (the backwards all with dlse)."""
    c = list(train_micro_step_counts(num_layers))
    for i in (0, 5, 6):
        c[i] *= sp_attention_calls(n)
    return tuple(c)


def _bits(tensors) -> str:
    """sha256 of the tensors' bytes: ranks' results compare bitwise."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy().tobytes())
    return h.hexdigest()


def sp_ring_check(comm, static_max, fault: bool = False) -> dict:
    """joint_ring_attention forward and backward over the ranks at
    [1,30,226+7800,64] against the resident flash forward and backward on
    the card; `fault`: the flash backward's dlse dropped (a planted fault)."""
    g = torch.Generator(device="cuda").manual_seed(21)  # the same inputs on every rank
    T, S = SP_RING_TEXT, SP_RING_VIDEO
    q, k, v, do = (torch.randn(1, 30, T + S, 64, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    orig = attention.flash_attention_bwd
    if fault:
        attention.flash_attention_bwd = lambda *a: orig(*a[:7], None)
    try:
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = joint_ring_attention(*leaves, T, comm, static_max=static_max)
        out.backward(do)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = counts()
    finally:
        attention.flash_attention_bwd = orig
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref, _ = attention.flash_attention(*ref_leaves, static_max=static_max)
    ref.backward(do)
    grads = [x.grad for x in leaves]
    return dict(static_max=static_max, fault=fault, ms=ms, launches=launches,
                out_err=max_err(out, ref),
                grads_agree=all(rms_agree(a, b.grad) for a, b in zip(grads, ref_leaves)),
                grad_rms_rel=[rms_errors(a, b.grad)[1] for a, b in zip(grads, ref_leaves)],
                bits=_bits([out, *grads]))


class SpTrainHooks:
    """Around one run of pipelines/train.py:train (through its module
    names): counts the checkpoint saves and exports and writes none (rank
    0's alone are due), records the bits of each micro-step's batch, and
    with `replay` feeds the run those batches instead of its loader's (the
    two-thread loader's order is not fixed, so a resident run compared with
    an sp run takes the sp run's batches)."""

    def __init__(self, replay=None):
        self.saved = (train_mod.export_pretrained, TrainCheckpointer.save, train_mod.to_device)
        self.calls = {"checkpoint": 0, "export": 0}
        self.bits, self.batches, self.replay = [], [], replay

    def __enter__(self):
        def export_pretrained(*args):
            self.calls["export"] += 1

        def save(ckpt, step, state, write=True):
            state_tensors(state)  # every rank gathers the whole tensors, as the save does
            self.calls["checkpoint"] += int(write)
            return write

        def to_device(batch, device):
            if self.replay is not None:
                batch = self.replay[len(self.batches)]
            arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
            self.batches.append(arrays)
            self.bits.append(_bits(torch.from_numpy(np.ascontiguousarray(arrays[k]))
                                   for k in sorted(arrays)))
            return self.saved[2](batch, device)

        train_mod.export_pretrained, TrainCheckpointer.save = export_pretrained, save
        train_mod.to_device = to_device
        return self

    def __exit__(self, *exc):
        train_mod.export_pretrained, TrainCheckpointer.save, train_mod.to_device = self.saved


def sp_train_run(root: Path, out: str, comm=None, replay=None) -> tuple:
    """pipelines/train.py:train on the 2B recipe cut to SP_TRAIN_LAYERS
    layers, at sp = the ring's size (resident without one); returns
    (state, launches, seconds, hooks, logged metrics)."""
    cfg = train_config(root / "data", root / out, [
        f"transformer.num_layers={SP_TRAIN_LAYERS}",
        f"train.mesh.sp={1 if comm is None else comm.size}",
        f"train.max_train_steps={SP_TRAIN_STEPS}", "train.checkpointing_steps=1000",
        "train.validation_steps=1000", "train.log_every=1", "train.lr_warmup_steps=0"])
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SpTrainHooks(replay) as hooks:
        state = train_mod.train(cfg, comm=comm)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    logs = root / out / "run" / "logs" / "metrics.jsonl"
    metrics = [m for m in map(json.loads, logs.read_text().splitlines()) if "loss" in m] \
        if logs.exists() else []
    return state, counts(), secs, hooks, metrics


def sp_eval_run(root: Path, out: str, comm=None) -> tuple:
    """pipelines/evaluate.py:evaluate at the flagship, SP_EVAL_STEPS DPM
    steps, no VAE (latents only), at sp = the ring's size (resident without
    one); returns (names, launches, seconds)."""
    cfg = load_config(
        str(default_config_dir() / "base_eval.yaml"),
        str(default_config_dir() / "eval" / "eval_traj_image_cond_2b_finetune.yaml"),
        "bridgev2", overrides=[
            f"dataset.data_root={root / 'serving'}", "dataset.sequence_length=48",
            "transformer.pretrained_name_or_path=null", "transformer.visual_guidance=true",
            f"evaluation.num_inference_steps={SP_EVAL_STEPS}", "evaluation.batch_size=1",
            "evaluation.mode=traj-image-depth-label",
            f"evaluation.mesh.sp={1 if comm is None else comm.size}",
            f"evaluation.output_dir={root / out}"])
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = evaluate(cfg, comm=comm)
    torch.cuda.synchronize()
    return names, counts(), time.perf_counter() - t0


def sp_worker(rank: int, world: int, port: int, root: str) -> int:
    """One rank of phase 5d, a process of its own on cuda:0: the bare ring
    under grad (and once with a planted fault), train and evaluate at sp =
    world; rank 0 then runs the same train (on the sp run's batches) and
    evaluate resident and compares. Writes its results to
    root/sp_rank{rank}.json for the parent."""
    from orv_tpu_torch.parallel.sp import ProcessGroupRing

    root = Path(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    os.environ["NO_INIT_VAL"] = "1"  # phase 5 runs the inline validation
    comm = ProcessGroupRing.init_process_group("gloo", f"tcp://localhost:{port}", world, rank,
                                               timeout=300.0)
    t_start = time.perf_counter()
    res = dict(rank=rank, ring=[sp_ring_check(comm, sm) for sm in (None, 24.0)],
               fault=sp_ring_check(comm, 24.0, fault=True))
    state, launches, secs, hooks, metrics = sp_train_run(root, "train_sp", comm)
    params = [p.detach() for p in state.model.parameters()]
    res["train"] = dict(launches=launches, s=secs, writes=hooks.calls, batches=hooks.bits,
                        params=_bits(params),
                        moments=_bits(state.opt_state.mu + state.opt_state.nu), metrics=metrics)
    sp_mu = torch.cat([m.flatten() for m in state.opt_state.mu]) if rank == 0 else None
    del state, params
    names, launches, secs = sp_eval_run(root, "eval_sp", comm)
    res["evaluate"] = dict(names=names, launches=launches, s=secs)
    # the group ends here: rank 0's resident runs must not see a group of 2
    # (evaluate would split its work list over it)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    if rank == 0:  # the same runs resident, to compare with
        state, launches, secs, res_hooks, metrics = sp_train_run(root, "train_res",
                                                                 replay=hooks.batches)
        mu = torch.cat([m.flatten() for m in state.opt_state.mu])
        err, rel, rms = rms_errors(sp_mu, mu)
        res["train_resident"] = dict(launches=launches, s=secs, writes=res_hooks.calls,
                                     batches=res_hooks.bits, metrics=metrics,
                                     moment_rms_rel=rel, moment_max_rel=err / rms)
        del state, mu, sp_mu
        names, launches, secs = sp_eval_run(root, "eval_res")
        res["evaluate_resident"] = dict(names=names, launches=launches, s=secs)
    res["s"] = time.perf_counter() - t_start
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    (root / f"sp_rank{rank}.json").write_text(json.dumps(res))
    return 0


def sp_phase(root: Path) -> None:
    """Phase 5d (module docstring): SP_RANKS rank processes on the card,
    their results checked here."""
    t_phase = time.perf_counter()
    n_slices = write_train_data(root / "data")
    write_serving_data(root / "serving")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = (f"import sys; sys.path.insert(0, {str(Path(__file__).resolve().parent)!r}); "
            "import chip_smoke; sys.exit(chip_smoke.sp_worker(*map(int, sys.argv[1:4]), "
            "sys.argv[4]))")
    logs = [open(root / f"sp_rank{r}.log", "w+") for r in range(SP_RANKS)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(SP_RANKS), str(port),
                               str(root)], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(SP_RANKS)]
    deadline = time.monotonic() + 600.0
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, f in enumerate(logs):
        f.seek(0)
        tail = f.read()[-3000:]
        f.close()
        if procs[r].returncode != 0:
            print(f"sp rank {r} failed (exit {procs[r].returncode}):\n{tail}", flush=True)
    check(all(p.returncode == 0 for p in procs), "an sp rank process failed")
    res = [json.loads((root / f"sp_rank{r}.json").read_text()) for r in range(SP_RANKS)]
    n = SP_RANKS

    # the bare ring under grad
    want = {None: tuple(sp_attention_calls(n) if kk in (attention.flash_attention_online_kernel,
                                                        attention.flash_attention_bwd_dq,
                                                        attention.flash_attention_bwd_dkv)
                        else 0 for kk in KERNELS),
            24.0: tuple(sp_attention_calls(n) if kk in (attention.flash_attention,
                                                        attention.flash_attention_bwd_dq,
                                                        attention.flash_attention_bwd_dkv)
                        else 0 for kk in KERNELS)}
    for i, sm in enumerate((None, 24.0)):
        rings = [r["ring"][i] for r in res]
        launches = [tuple(r["launches"]) for r in rings]
        same = all(r["bits"] == rings[0]["bits"] for r in rings)
        print(f"joint_ring_attention under grad [1,30,{SP_RING_TEXT}+{SP_RING_VIDEO},64], "
              f"static_max={sm}, {n} rank processes on one card over gloo: forward+backward "
              f"{rings[0]['ms']:.1f} ms (rank 0, host clock), launches per rank {launches[0]}, "
              f"ranks bitwise equal {same}, out max_abs_err {rings[0]['out_err']:.3g} (tol 2e-2), "
              f"dq/dk/dv RMS error {', '.join(f'{e:.3g}' for e in rings[0]['grad_rms_rel'])} of "
              f"RMS(ref) (tol 1e-2, max 0.1)", flush=True)
        check(all(l == want[sm] for l in launches), f"ring launches {launches} != {want[sm]}")
        check(same, "the ranks' ring gradients differ")
        check(all(r["out_err"] <= 2e-2 and r["grads_agree"] for r in rings),
              f"the ring under grad (static_max={sm}) disagrees with the resident flash")
        for l in launches:
            tally(l)
    faults = [r["fault"] for r in res]
    print(f"planted fault (the flash backward's dlse dropped): dq/dk/dv RMS error "
          f"{', '.join(f'{e:.3g}' for e in faults[0]['grad_rms_rel'])} of RMS(ref); rejected "
          f"{not any(f['grads_agree'] for f in faults)}", flush=True)
    check(not any(f["grads_agree"] for f in faults), "the ring check let a dropped dlse pass")

    # train at sp
    tr = [r["train"] for r in res]
    ref = res[0]["train_resident"]
    want = tuple(SP_TRAIN_STEPS * c for c in sp_train_counts(SP_TRAIN_LAYERS, n))
    want_res = tuple(SP_TRAIN_STEPS * c for c in train_micro_step_counts(SP_TRAIN_LAYERS))
    losses = [(m["loss"], m["grad_norm"]) for m in tr[0]["metrics"]]
    ref_losses = [(m["loss"], m["grad_norm"]) for m in ref["metrics"]]
    print(f"train at train.mesh.sp={n} ({TRAIN_RECIPE}, {SP_TRAIN_LAYERS} of 30 layers, "
          f"{n_slices} slices, the recipe's B=4 x accumulation 2, {SP_TRAIN_STEPS} micro-steps, "
          f"{n} rank "
          f"processes on one card): {tr[0]['s']:.1f} s (rank 0; resident {ref['s']:.1f} s); "
          f"launches per rank {[tuple(t['launches']) for t in tr]} (want {want}), resident "
          f"{tuple(ref['launches'])}; (loss, grad norm) per micro-step sp {losses}, resident "
          f"{ref_losses}; first moments RMS error {ref['moment_rms_rel']:.3g} of RMS(ref), max "
          f"{ref['moment_max_rel']:.3g}; parameters and moments bitwise equal across ranks "
          f"{len({t['params'] for t in tr}) == 1 and len({t['moments'] for t in tr}) == 1}; "
          f"same batches {len({tuple(t['batches']) for t in tr}) == 1}; writes per rank "
          f"{[t['writes'] for t in tr]}", flush=True)
    check(all(tuple(t["launches"]) == want for t in tr), "sp train launch counts")
    check(tuple(ref["launches"]) == want_res, "resident train launch counts")
    check(len({t["params"] for t in tr}) == 1 and len({t["moments"] for t in tr}) == 1,
          "the sp ranks' parameters or moments differ")
    check(len({tuple(t["batches"]) for t in tr}) == 1 and ref["batches"] == tr[0]["batches"]
          and len(tr[0]["batches"]) == SP_TRAIN_STEPS, "the ranks took different batches")
    check(tr[0]["writes"] == {"checkpoint": 1, "export": 1}
          and all(t["writes"] == {"checkpoint": 0, "export": 0} for t in tr[1:]),
          "only rank 0 may write the checkpoint and the export")
    check(len(losses) == SP_TRAIN_STEPS == len(ref_losses)
          and all(math.isfinite(a) and math.isfinite(b) for a, b in losses), "sp train metrics")
    check(all(abs(a - c) <= SP_LOSS_REL * abs(c) and abs(b - d) <= SP_GRAD_REL * abs(d)
              for (a, b), (c, d) in zip(losses, ref_losses)),
          "sp train's loss or grad norm disagrees with the resident run")
    check(ref["moment_rms_rel"] <= SP_GRAD_REL, "sp train's moments disagree with resident")
    for t in tr:
        tally(t["launches"])
    tally(ref["launches"])

    # evaluate at sp
    ev = [r["evaluate"] for r in res]
    ev_ref = res[0]["evaluate_resident"]
    per_rank = tuple(sp_attention_calls(n) * c if kk is attention.flash_attention else c
                     for kk, c in zip(KERNELS, BF16_FORWARD))
    want = tuple(SP_EVAL_STEPS * c for c in per_rank)
    lat = np.load(root / "eval_sp" / "00000_000_latents.npz")["arr_0"]
    lat_ref = np.load(root / "eval_res" / "00000_000_latents.npz")["arr_0"]
    files = sorted(p.name for p in (root / "eval_sp").iterdir())
    print(f"evaluate at evaluation.mesh.sp={n} (flagship, {SP_EVAL_STEPS} DPM steps, "
          f"traj-image-depth-label, no VAE): {ev[0]['s']:.1f} s (rank 0; resident "
          f"{ev_ref['s']:.1f} s), launches per rank {[tuple(e['launches']) for e in ev]} (want "
          f"{want}), files {files}", flush=True)
    check(all(tuple(e["launches"]) == want for e in ev), "sp evaluate launch counts")
    check(all(e["names"] == ev_ref["names"] for e in ev), "sp evaluate's clips")
    check(files == ["00000_000_latents.npz", "manifest.json", "manifest_0.json"],
          f"sp evaluate wrote {files}")
    check(lat.shape == lat_ref.shape and bool(np.isfinite(lat).all()), "sp evaluate latents")
    agree(torch.from_numpy(lat), torch.from_numpy(lat_ref),
          f"evaluate sp={n} vs resident latents", 2e-2, 3e-3)
    for e in ev:
        tally(e["launches"])
    tally(ev_ref["launches"])
    print(f"sp phase: {time.perf_counter() - t_phase:.1f} s (ranks {res[0]['s']:.1f} and "
          f"{res[1]['s']:.1f} s after their start; peak memory rank 0 "
          f"{res[0]['peak_gib']:.1f} GiB, rank 1 {res[1]['peak_gib']:.1f} GiB)", flush=True)


# -- phase 5e: data and model parallelism, the ranks as processes on the one card ---------
#
# As phase 5d's: gloo between processes on cuda:0, the tensors staged through
# host memory, a correctness harness, not a speed.

MESH_RANKS = 4
# the 2B recipe's width cut to 8 of its 30 layers, as phase 5d cuts it
MESH_TRAIN_LAYERS = 8
MESH_EVAL_LAYERS = 8
MESH_TRAIN = (("dp2 x tp2", dict(dp=2, tp=2)),
              ("fsdp2 x pp2", dict(dp=1, fsdp=2, pp=2, n_micro=2)),
              ("pp2 x tp2", dict(dp=1, pp=2, tp=2)),
              ("fsdp2 x sp2", dict(dp=1, fsdp=2, sp=2)))
MESH_EVAL = (("bf16", False), ("W8A8", True))  # evaluate at dp2 x tp2


def mesh_train_counts(mesh: dict):
    """Launches of one rank's SP_TRAIN_STEPS micro-steps at `mesh`: a
    pipeline stage runs its L/pp layers on each of its n_micro + pp - 1
    ticks, bubbles included; sp rings each attention."""
    L = MESH_TRAIN_LAYERS
    if mesh.get("pp", 1) > 1:
        pp = mesh["pp"]
        c = train_micro_step_counts(L // pp * (mesh.get("n_micro", pp) + pp - 1))
    elif mesh.get("sp", 1) > 1:
        c = sp_train_counts(L, mesh["sp"])
    else:
        c = train_micro_step_counts(L)
    return tuple(SP_TRAIN_STEPS * n for n in c)


def mesh_eval_counts(quant: bool):
    per_layer = [n // 30 for n in (Q8_FORWARD if quant else BF16_FORWARD)]
    return tuple(SP_EVAL_STEPS * MESH_EVAL_LAYERS * n for n in per_layer)


class GlobalDraws:
    """`draws` for pipelines/train.py:train that gives a pipeline's data
    shard its rows of the global batch's draws (the default ones, seeded
    from (seed, step)), so that a pp run with data shards takes the
    resident run's numbers; the global batch is the one `hooks` saw last."""

    def __init__(self, hooks, seed: int = 42):
        self.hooks, self.seeded = hooks, train_mod.seeded_draws(seed, "cuda")

    def __call__(self, step, batch, shard=None):
        if shard is None:
            return self.seeded(step, batch)
        whole = {k: torch.from_numpy(v).cuda() for k, v in self.hooks.batches[-1].items()}
        k = batch["latents"].shape[0]
        return self.seeded(step, whole).rows(slice(shard * k, (shard + 1) * k))


def mesh_train_run(root: Path, out: str, mesh: dict, comm, replay=None) -> dict:
    """pipelines/train.py:train on the 2B recipe cut to MESH_TRAIN_LAYERS
    layers at `mesh` over `comm` (SOLO: resident); returns its launches,
    seconds, writes, metrics (rank 0's), peak memory and the whole first
    moments (flattened, on the host), and the hooks."""
    cfg = train_config(root / "data", root / out, [
        f"transformer.num_layers={MESH_TRAIN_LAYERS}", "transformer.recon_action=false",
        *(f"train.mesh.{k}={v}" for k, v in mesh.items()),
        f"train.max_train_steps={SP_TRAIN_STEPS}", "train.checkpointing_steps=1000",
        "train.validation_steps=1000", "train.log_every=1", "train.lr_warmup_steps=0"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SpTrainHooks(replay) as hooks:
        state = train_mod.train(cfg, comm=comm, draws=GlobalDraws(hooks))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    names = [n for n, _ in state.named_params()]
    mu = dict(zip(names, state.opt_state.mu))
    # every rank gathers the whole moments
    mu = gather_state_dict(mu, state.mesh.placements, state.mesh.mesh, state.mesh.num_layers)
    mu = torch.cat([mu[k].flatten().cpu() for k in sorted(mu)])
    logs = root / out / "run" / "logs" / "metrics.jsonl"
    metrics = [m for m in map(json.loads, logs.read_text().splitlines()) if "loss" in m] \
        if logs.exists() else []
    del state
    return dict(launches=launches, s=secs, writes=dict(hooks.calls), metrics=metrics,
                peak_gib=peak, mu=mu, hooks=hooks)


def mesh_eval_run(root: Path, out: str, quant: bool, comm=None) -> tuple:
    """pipelines/evaluate.py:evaluate at the flagship's width cut to
    MESH_EVAL_LAYERS layers, SP_EVAL_STEPS DPM steps, a batch of the two
    clips, latents only, at evaluation.mesh dp=2, tp=2 over `comm`
    (resident without one); returns (names, launches, seconds, peak GiB)."""
    cfg = load_config(
        str(default_config_dir() / "base_eval.yaml"),
        str(default_config_dir() / "eval" / "eval_traj_image_cond_2b_finetune.yaml"),
        "bridgev2", overrides=[
            f"dataset.data_root={root / 'serving'}", "dataset.sequence_length=48",
            "transformer.pretrained_name_or_path=null", "transformer.visual_guidance=true",
            f"transformer.num_layers={MESH_EVAL_LAYERS}",
            f"evaluation.num_inference_steps={SP_EVAL_STEPS}", "evaluation.batch_size=2",
            "evaluation.mode=traj-image-depth-label", f"evaluation.quant={str(quant).lower()}",
            *(["evaluation.mesh.dp=2", "evaluation.mesh.tp=2"] if comm is not None else []),
            f"evaluation.output_dir={root / out}"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = evaluate(cfg, comm=comm)
    torch.cuda.synchronize()
    return names, counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def mesh_worker(rank: int, world: int, port: int, root: str) -> int:
    """One rank of phase 5e, a process of its own on cuda:0 (module
    docstring). Writes its results to root/mesh_rank{rank}.json."""
    from orv_tpu_torch.parallel.sp import ProcessGroupRing

    root = Path(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    os.environ["NO_INIT_VAL"] = "1"
    comm = ProcessGroupRing.init_process_group("gloo", f"tcp://localhost:{port}", world, rank,
                                               timeout=600.0)
    t_start = time.perf_counter()
    log = ShapeLog().__enter__()
    res = dict(rank=rank, train={}, evaluate={})
    ref = None
    if rank == 0:  # the resident run whose batches every run takes
        ref = mesh_train_run(root, "train_res", {}, SOLO)
        res["train_resident"] = {k: v for k, v in ref.items() if k not in ("mu", "hooks")}
    batches = comm.broadcast(ref["hooks"].batches if rank == 0 else None)
    for name, mesh in MESH_TRAIN:
        run = mesh_train_run(root, f"train_{name.replace(' ', '')}", mesh, comm, batches)
        out = {k: v for k, v in run.items() if k not in ("mu", "hooks")}
        out["batches"] = run["hooks"].bits
        if rank == 0:
            err, rel, rms = rms_errors(run["mu"], ref["mu"])
            out.update(moment_rms_rel=rel, moment_max_rel=err / rms)
        res["train"][name] = out
        del run
    for name, quant in MESH_EVAL:
        names, launches, secs, peak = mesh_eval_run(root, f"eval_{name}", quant, comm)
        res["evaluate"][name] = dict(names=names, launches=launches, s=secs, peak_gib=peak)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    if rank == 0:  # the resident evaluates, once the group is gone (it would split the work)
        for name, quant in MESH_EVAL:
            names, launches, secs, peak = mesh_eval_run(root, f"eval_res_{name}", quant)
            res["evaluate_resident"] = res.get("evaluate_resident", {})
            res["evaluate_resident"][name] = dict(names=names, launches=launches, s=secs)
    log.__exit__()
    res["shapes"] = [list(k) for k in log.keys]
    res["s"] = time.perf_counter() - t_start
    runs = [*res["train"].values(), *res["evaluate"].values(),
            *([res["train_resident"]] if rank == 0 else [])]
    res["peak_gib"] = max(r["peak_gib"] for r in runs)
    (root / f"mesh_rank{rank}.json").write_text(json.dumps(res))
    return 0


def _key(obj):
    """A ShapeLog key back from JSON (its lists were tuples)."""
    return tuple(_key(x) for x in obj) if isinstance(obj, list) else obj


def write_second_clip(root: Path, frames: int = 49) -> None:
    """A second serving episode (00001) beside write_serving_data's, its
    trajectory and its moments (latents, image latents, depth and label)
    drawn from another seed, so that evaluate's batch holds two clips whose
    every conditioning input differs: a rank that took the other's row
    shows."""
    rng = np.random.default_rng(1)
    ann = json.loads((root / "annotations" / "test" / "00000.json").read_text())
    ann.update(episode_id="00001", state=rng.uniform(-0.5, 0.5, (frames, 7)).tolist(),
               continuous_gripper_state=rng.uniform(0, 1, frames).tolist())
    (root / "annotations" / "test" / "00001.json").write_text(json.dumps(ann))
    emb = root / "embeddings_full" / "test"
    F, C, H, W = LATENT
    for kind, f in (("latents", F), ("image_latents", 1), ("depth_latents", F),
                    ("label_latents", F)):
        np.savez(emb / kind / f"00001_00_{frames:02d}.npz",
                 rng.normal(size=(2 * C, f, H, W)).astype(np.float32))


def mesh_phase(root: Path, shape_keys: set) -> None:
    """Phase 5e (module docstring): MESH_RANKS rank processes on the card,
    their results checked here; their kernels' shapes join `shape_keys`."""
    t_phase = time.perf_counter()
    n_slices = write_train_data(root / "data")
    write_serving_data(root / "serving")
    write_second_clip(root / "serving")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    code = (f"import sys; sys.path.insert(0, {str(Path(__file__).resolve().parent)!r}); "
            "import chip_smoke; sys.exit(chip_smoke.mesh_worker(*map(int, sys.argv[1:4]), "
            "sys.argv[4]))")
    logs = [open(root / f"mesh_rank{r}.log", "w+") for r in range(MESH_RANKS)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(MESH_RANKS), str(port),
                               str(root)], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(MESH_RANKS)]
    deadline = time.monotonic() + 600.0
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, f in enumerate(logs):
        f.seek(0)
        tail = f.read()[-3000:]
        f.close()
        if procs[r].returncode != 0:
            print(f"mesh rank {r} failed (exit {procs[r].returncode}):\n{tail}", flush=True)
    check(all(p.returncode == 0 for p in procs), "a mesh rank process failed")
    res = [json.loads((root / f"mesh_rank{r}.json").read_text()) for r in range(MESH_RANKS)]
    for r in res:
        shape_keys.update(_key(k) for k in r["shapes"])

    ref = res[0]["train_resident"]
    want_res = tuple(SP_TRAIN_STEPS * c for c in train_micro_step_counts(MESH_TRAIN_LAYERS))
    ref_losses = [(m["loss"], m["grad_norm"]) for m in ref["metrics"]]
    print(f"train resident ({TRAIN_RECIPE}, {MESH_TRAIN_LAYERS} of 30 layers, {n_slices} "
          f"slices, B=4 x accumulation 2, {SP_TRAIN_STEPS} micro-steps, rank 0): "
          f"{ref['s']:.1f} s, launches {tuple(ref['launches'])} (want {want_res}), (loss, grad "
          f"norm) per micro-step {ref_losses}, peak {ref['peak_gib']:.1f} GiB", flush=True)
    check(tuple(ref["launches"]) == want_res, "resident train launch counts")
    check(len(ref_losses) == SP_TRAIN_STEPS and all(math.isfinite(a) and math.isfinite(b)
                                                    for a, b in ref_losses),
          "resident train metrics")
    tally(ref["launches"])
    for name, mesh in MESH_TRAIN:
        tr = [r["train"][name] for r in res]
        want = mesh_train_counts(mesh)
        losses = [(m["loss"], m["grad_norm"]) for m in tr[0]["metrics"]]
        peaks = ", ".join(f"{t['peak_gib']:.1f}" for t in tr)
        print(f"train at {name} ({MESH_RANKS} rank processes on one card, the resident run's "
              f"batches): {tr[0]['s']:.1f} s (rank 0), launches per rank "
              f"{[tuple(t['launches']) for t in tr]} (want {want}); (loss, grad norm) per "
              f"micro-step {losses}; first moments RMS error {tr[0]['moment_rms_rel']:.3g} of "
              f"RMS(ref), max {tr[0]['moment_max_rel']:.3g}; peak memory per rank "
              f"{peaks} GiB; writes per rank "
              f"{[t['writes'] for t in tr]}", flush=True)
        check(all(tuple(t["launches"]) == want for t in tr), f"{name} train launch counts")
        check(all(t["batches"] == tr[0]["batches"] for t in tr)
              and len(tr[0]["batches"]) == SP_TRAIN_STEPS,
              f"{name}: the ranks took different batches")
        check(tr[0]["writes"] == {"checkpoint": 1, "export": 1}
              and all(t["writes"] == {"checkpoint": 0, "export": 0} for t in tr[1:]),
              f"{name}: only rank 0 may write the checkpoint and the export")
        check(len(losses) == SP_TRAIN_STEPS
              and all(abs(a - c) <= SP_LOSS_REL * abs(c) and abs(b - d) <= SP_GRAD_REL * abs(d)
                      for (a, b), (c, d) in zip(losses, ref_losses)),
              f"{name} train's loss or grad norm disagrees with the resident run")
        check(tr[0]["moment_rms_rel"] <= SP_GRAD_REL, f"{name} train's moments disagree")
        for t in tr:
            tally(t["launches"])

    for name, quant in MESH_EVAL:
        ev = [r["evaluate"][name] for r in res]
        ev_ref = res[0]["evaluate_resident"][name]
        want = mesh_eval_counts(quant)
        files = sorted(p.name for p in (root / f"eval_{name}").iterdir())
        peaks = ", ".join(f"{e['peak_gib']:.1f}" for e in ev)
        print(f"evaluate at evaluation.mesh dp=2, tp=2, {name} ({MESH_EVAL_LAYERS} layers at "
              f"the flagship's width, {SP_EVAL_STEPS} DPM steps, a batch of 2 clips): "
              f"{ev[0]['s']:.1f} s (rank 0; resident {ev_ref['s']:.1f} s), launches per rank "
              f"{[tuple(e['launches']) for e in ev]} (want {want}), peak memory per rank "
              f"{peaks} GiB, files {files}",
              flush=True)
        check(all(tuple(e["launches"]) == want for e in ev), f"{name} mesh evaluate launch counts")
        check(tuple(ev_ref["launches"]) == want, f"{name} resident evaluate launch counts")
        check(all(e["names"] == ev_ref["names"] for e in ev) and len(ev_ref["names"]) == 2,
              f"{name} mesh evaluate's clips")
        check(files == ["00000_000_latents.npz", "00001_000_latents.npz", "manifest.json",
                        "manifest_0.json"], f"{name} mesh evaluate wrote {files}")
        for clip in ("00000_000", "00001_000"):
            lat = np.load(root / f"eval_{name}" / f"{clip}_latents.npz")["arr_0"]
            lat_ref = np.load(root / f"eval_res_{name}" / f"{clip}_latents.npz")["arr_0"]
            check(lat.shape == lat_ref.shape and bool(np.isfinite(lat).all()),
                  f"{name} mesh evaluate latents")
            agree(torch.from_numpy(lat), torch.from_numpy(lat_ref),
                  f"evaluate dp2 x tp2 {name} vs resident latents ({clip})",
                  4e-2 if quant else 2e-2, 3e-3)
        for e in ev:
            tally(e["launches"])
        tally(ev_ref["launches"])
    secs = ", ".join(f"{r['s']:.1f}" for r in res)
    peaks = ", ".join(f"{r['peak_gib']:.1f}" for r in res)
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s (ranks {secs} s after their "
          f"start; peak memory per rank {peaks} GiB)", flush=True)


# -- phase 5f: the grain loader's order, computed without grain -------------------------

GRAIN_BATCH = 4  # the recipe's batch
GRAIN_EPOCHS = 3  # 27 records of 9 slices: 6 batches, the third and fifth across epochs
GRAIN_WORKERS = 2
GRAIN_TRAIN_LAYERS = 4
GRAIN_TRAIN_STEPS = 2  # micro-steps


def grain_phase(root: Path) -> None:
    """Phase 5f (module docstring): data/grain_loader.py on the card's
    machine, which has no grain, then `train` with train.loader=grain."""
    t_phase = time.perf_counter()
    try:
        import huggingface_hub
        hub = f"huggingface_hub {huggingface_hub.__version__} imports"
    except ImportError:
        hub = "huggingface_hub absent"
    print(f"grain phase: {hub} (no Hub call is made); grain "
          f"{'imports' if importlib.util.find_spec('grain') else 'absent'}", flush=True)
    n_slices = write_train_data(root / "data")  # phase 5's nine slices, from its seed
    cfg = train_config(root / "data", root / "out", [
        f"transformer.num_layers={GRAIN_TRAIN_LAYERS}", "train.loader=grain",
        f"train.loader_workers={GRAIN_WORKERS}", f"train.max_train_steps={GRAIN_TRAIN_STEPS}",
        "train.checkpointing_steps=1000", "train.validation_steps=1000", "train.log_every=1",
        "train.lr_warmup_steps=0"])
    seed, bs = int(cfg.get("seed", 42)), int(cfg.train.train_batch_size)
    dataset = train_mod.build_dataset(cfg)
    check(len(dataset) == n_slices == 9 and bs == GRAIN_BATCH,
          f"the grain phase's dataset holds {len(dataset)} slices at batch {bs}")
    runs = {}
    for workers in (0, GRAIN_WORKERS):
        t0 = time.perf_counter()
        loader = make_grain_loader(dataset, bs, seed=seed, num_epochs=GRAIN_EPOCHS,
                                   worker_count=workers)
        runs[workers] = (list(loader), time.perf_counter() - t0, loader.worker_start_s)
    order = [index_shuffle(k, n_slices - 1, (seed + e) % 2**32) for e in range(GRAIN_EPOCHS)
             for k in range(n_slices)]
    want = [(dataset.samples[i]["episode_id"], dataset.samples[i]["start_frame_idx"])
            for i in order[:len(order) // bs * bs]]
    arrays = lambda b: {k: v for k, v in b.items() if isinstance(v, np.ndarray)}
    same = lambda a, b: list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes()
        for k in a)
    for workers, (batches, secs, start_s) in runs.items():
        got = [(m["episode_id"], m["start_frame_idx"]) for b in batches for m in b["metainfos"]]
        print(f"grain loader, {workers} workers: {len(batches)} batches of {bs} over "
              f"{GRAIN_EPOCHS} epochs in {secs:.2f} s"
              + (f" (first record from the workers in {start_s:.2f} s)" if workers else "")
              + f"; slices read, first epoch {order[:n_slices]}", flush=True)
        check(len(batches) == len(order) // bs == 6, f"{len(batches)} grain batches, not 6")
        check(got == want, f"the grain loader with {workers} workers read {got}, not the "
                           f"index_shuffle order {want}")
        check(all(same(arrays(a), arrays(b)) and list(a) == list(b)
                  for a, b in zip(batches, runs[0][0])),
              f"the grain loader's batches with {workers} workers differ from those with 0")
    check(runs[GRAIN_WORKERS][2] is not None and runs[GRAIN_WORKERS][2] > 0,
          "the grain loader's workers reported no time to their first record")

    os.environ["NO_INIT_VAL"] = "1"
    try:
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SpTrainHooks() as hooks:
            state = train_mod.train(cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        os.environ.pop("NO_INIT_VAL", None)
    launches = counts()
    tally(launches)
    want_launches = tuple(GRAIN_TRAIN_STEPS * n
                          for n in train_micro_step_counts(GRAIN_TRAIN_LAYERS))
    logs = root / "out" / "run" / "logs" / "metrics.jsonl"
    losses = [m["loss"] for m in map(json.loads, logs.read_text().splitlines()) if "loss" in m]
    print(f"train with train.loader=grain, {GRAIN_WORKERS} loader workers "
          f"({GRAIN_TRAIN_LAYERS} layers at the 2B recipe's width, B={bs}, "
          f"{GRAIN_TRAIN_STEPS} micro-steps): {secs:.1f} s, losses {losses}, launches "
          f"{launches} (want {want_launches})", flush=True)
    check(state.step == GRAIN_TRAIN_STEPS, f"the grain run stopped at step {state.step}")
    check(len(losses) == GRAIN_TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"the grain run's losses {losses}")
    check(launches == want_launches, f"grain train launch counts {launches} != {want_launches}")
    check(len(hooks.batches) == GRAIN_TRAIN_STEPS
          and all(same(a, arrays(b)) for a, b in zip(hooks.batches, runs[0][0])),
          "train with train.loader=grain did not train on the loader's first batches")
    del state
    print(f"grain phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def generate(dit, vae, inp, name: str, forward_counts):
    """4 DPM steps through make_sampler and the chunked decode; checks the
    outputs and the launch counts. Returns s/step."""
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
    tally(launches)
    print(f"generation {name}: {STEPS} DPM steps {sample_s:.3f} s ({sample_s / STEPS:.4f} "
          f"s/step), decode_chunked(6) {decode_s:.3f} s, frames {list(video.shape)}, launches "
          f"{launches}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    check(bool(torch.isfinite(lat).all()), f"{name} sampled latents are not finite")
    check(tuple(video.shape) == (1, 3, 49, 320, 480) and bool(torch.isfinite(video).all()),
          f"{name} decoded frames are not finite or of the wrong shape")
    check(launches == tuple(STEPS * n for n in forward_counts),
          f"{name} generation launch counts {launches}")
    return sample_s / STEPS


SERVING_STEPS = 4  # DPM steps of every denoise of phase 4b
# the inference entry point's tiny smoke model: 2 layers, 3-chunk adaLN
# (per block 1 attention, 2 modulate_norm on the video stream, 2 gated residuals)
SMOKE_FORWARD = (2, 4, 4, 0, 0, 0, 0, 0, 0, 0)


class StageTimes:
    """Wall seconds (card synchronized) and calls of the entry points' stages:
    the sampler's denoise, the VAE encode and the decode. `patch` wraps the
    names `modules` call (those each has), `restore` puts them back."""

    def __init__(self, modules=(evaluate_mod, inference_mod)):
        self.saved = {(m, n): getattr(m, n) for m in modules
                      for n in ("make_sampler", "encode_auto", "decode_chunked") if hasattr(m, n)}
        self.reset()

    def reset(self):
        self.s = {"sample": 0.0, "encode": 0.0, "decode": 0.0}
        self.calls = {"sample": 0, "encode": 0, "decode": 0}
        self.encode_frames = []

    def _timed(self, what, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.s[what] += time.perf_counter() - t0
            self.calls[what] += 1
            if what == "encode":
                self.encode_frames.append(int(args[1].shape[2]))
            return out
        return run

    def patch(self):
        for (m, n), fn in self.saved.items():
            if n == "make_sampler":
                setattr(m, n, lambda *a, _fn=fn, **k: self._timed("sample", _fn(*a, **k)))
            else:
                setattr(m, n, self._timed(n.split("_")[0], fn))

    def restore(self):
        for (m, n), fn in self.saved.items():
            setattr(m, n, fn)


def write_serving_data(root: Path, frames: int = 49) -> None:
    """The eval configs' on-disk layout for one bridgev2 episode, from a numpy
    seed: annotation JSON; moments of the 49-frame clip (latents, image
    latents, depth and label: [32, 13, 40, 60] f32); the empty prompt's
    embeds [226, 4096]; the raw 320x480 frames as an mp4 and a render.npz of
    depths and semantic labels (the raw-pixel path's inputs)."""
    rng = np.random.default_rng(0)
    emb = root / "embeddings_full" / "test"
    for d in ("latents", "image_latents", "depth_latents", "label_latents", "prompt_embeds"):
        (emb / d).mkdir(parents=True)
    (root / "annotations" / "test").mkdir(parents=True)
    (root / "videos").mkdir()
    ann = dict(episode_id="00000", texts=["put the spoon in the pot"],
               videos=[{"video_path": "videos/00000.mp4"}],
               state=rng.uniform(-0.5, 0.5, (frames, 7)).tolist(),
               continuous_gripper_state=rng.uniform(0, 1, frames).tolist())
    (root / "annotations" / "test" / "00000.json").write_text(json.dumps(ann))
    F, C, H, W = LATENT
    for kind, f in (("latents", F), ("image_latents", 1), ("depth_latents", F),
                    ("label_latents", F)):
        np.savez(emb / kind / f"00000_00_{frames:02d}.npz",
                 rng.normal(size=(2 * C, f, H, W)).astype(np.float32))
    np.savez(emb / "prompt_embeds" / "empty.npz",
             (0.1 * rng.standard_normal((226, 4096))).astype(np.float32))
    t = np.arange(frames)[:, None, None, None]
    yy, xx = np.meshgrid(np.arange(8 * H), np.arange(8 * W), indexing="ij")
    pix = (128 + 60 * np.sin(0.05 * xx[None, :, :, None] + 0.1 * t + np.arange(3))
           + 40 * np.cos(0.07 * yy)[None, :, :, None]
           + rng.normal(0, 4, (frames, 8 * H, 8 * W, 3)))
    written = write_video(str(root / "videos" / "00000.mp4"), np.clip(pix, 0, 255).astype(np.uint8))
    check(written.endswith(".mp4"), f"the raw episode could not be written as mp4 ({written})")
    (root / "00000").mkdir()
    np.savez(root / "00000" / "render.npz",
             depths=rng.uniform(0.0, 0.5, (frames, 1, 8 * H, 8 * W)).astype(np.float32),
             semantics=rng.integers(0, 60, (frames, 1, 8 * H, 8 * W)).astype(np.int32),
             is_labeled=np.ones(1, bool))


def serving_step(name: str, times: StageTimes, run, steps: int = SERVING_STEPS):
    """Run one step of phase 4b (or 6) with counts and stage times from zero;
    print its line (s/step over `steps` DPM steps a denoise), add its counts
    to the kernels line's and return (result, launch counts)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times.reset()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    tally(launches)
    n = max(1, times.calls["sample"]) * steps
    print(f"serving {name}: {wall:.2f} s; denoise {times.s['sample']:.3f} s "
          f"({times.calls['sample']} x {steps} DPM steps, "
          f"{times.s['sample'] / n:.4f} s/step), encode {times.s['encode']:.3f} s "
          f"({times.calls['encode']} calls, frames {times.encode_frames}), decode "
          f"{times.s['decode']:.3f} s ({times.calls['decode']} calls); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches}", flush=True)
    return out, launches


def check_clip(out: Path, name: str, frames: int) -> None:
    """The latents file of a clip is finite [13, 16, 40, 60], its mp4 reads
    back as frames x 320 x 480 x 3 uint8, and manifest.json names it."""
    lat = np.load(out / f"{name}_latents.npz")["arr_0"]
    check(lat.shape == (LATENT[0], LATENT[1], LATENT[2], LATENT[3]) and np.isfinite(lat).all(),
          f"{name} latents {lat.shape} are not finite [13, 16, 40, 60]")
    clip = read_video(str(out / f"{name}.mp4"))
    check(clip.shape == (frames, 320, 480, 3) and clip.dtype == np.uint8,
          f"{name}.mp4 reads back as {clip.shape} {clip.dtype}")
    check(json.loads((out / "manifest.json").read_text()) == [name],
          f"manifest.json does not name {name}")


def serving_phase(root: Path) -> None:
    """Phase 4b: the serving entry points at the flagship width (module
    docstring)."""
    from PIL import Image

    t_phase = time.perf_counter()
    write_serving_data(root / "data")
    times = StageTimes()
    times.patch()
    try:
        torch.manual_seed(0)
        vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16)  # f32 parameters, as evaluate loads
        base = [f"dataset.data_root={root / 'data'}", "dataset.sequence_length=48",
                "transformer.pretrained_name_or_path=null",
                # the eval yamls' `transformer: <<: *runtime` keeps the base's
                # visual_guidance: false there, and that section's value wins
                "transformer.visual_guidance=true",
                f"evaluation.num_inference_steps={SERVING_STEPS}", "evaluation.batch_size=1",
                "evaluation.mode=traj-image-depth-label"]

        def cond_cfg(out, *extra):
            return load_config(str(default_config_dir() / "base_eval.yaml"),
                               str(default_config_dir() / "eval" /
                                   "eval_traj_image_cond_2b_finetune.yaml"), "bridgev2",
                               overrides=base + [f"evaluation.output_dir={root / out}", *extra])

        cfg = cond_cfg("bf16")
        check(build_dit_config(cfg) == FLAGSHIP, f"the eval config builds {build_dit_config(cfg)}")
        _, got = serving_step("evaluate bf16 (traj-image-depth-label, 49 frames, mp4 + gif)",
                              times, lambda: evaluate(cfg, vae=vae))
        check(got == tuple(SERVING_STEPS * n for n in BF16_FORWARD),
              f"evaluate bf16 launch counts {got}")
        check_clip(root / "bf16", "00000_000", 49)
        check((root / "bf16" / "00000_000.gif").exists(), "evaluate wrote no gif beside the mp4")

        # the gif beside each mp4 takes about 9 s of Pillow's quantizing a
        # clip of noise-like frames: the steps below write the mp4 only
        base.append("evaluation.save_gif=false")
        cfg = cond_cfg("q8", "evaluation.quant=true")
        _, got = serving_step("evaluate W8A8 (evaluation.quant=true)", times,
                              lambda: evaluate(cfg, vae=vae))
        check(got == tuple(SERVING_STEPS * n for n in Q8_FORWARD),
              f"evaluate W8A8 launch counts {got}")
        check_clip(root / "q8", "00000_000", 49)

        clip = torch.from_numpy(read_video(str(root / "data" / "videos" / "00000.mp4")))
        clip = clip.permute(3, 0, 1, 2)[None].float().div(127.5).sub(1.0)  # [1, 3, 49, 320, 480]
        moments, _ = serving_step("encode_auto 49x320x480 (chunks of 8 frames)", times,
                                  lambda: encode_auto(vae, clip))
        check(tuple(moments.shape) == (1, 32, 13, 40, 60) and bool(torch.isfinite(moments).all()),
              f"encode_auto gave {tuple(moments.shape)} or non-finite moments")

        cfg = cond_cfg("raw", "dataset.load_tensors=false")
        _, got = serving_step("evaluate raw pixels (load_tensors=false, depth and label)",
                              times, lambda: evaluate(cfg, vae=vae))
        check(times.encode_frames == [49, 1, 49, 49],
              f"the raw path encoded {times.encode_frames} frames, not video, image, depth, label")
        check(got == tuple(SERVING_STEPS * n for n in BF16_FORWARD),
              f"evaluate raw launch counts {got}")
        check_clip(root / "raw", "00000_000", 49)

        cfg = load_config(str(default_config_dir() / "base_eval.yaml"),
                          str(default_config_dir() / "eval" /
                              "eval_traj_image_2b_finetune_cascaded.yaml"), "bridgev2",
                          overrides=[f"dataset.data_root={root / 'data'}",
                                     "transformer.pretrained_name_or_path=null",
                                     f"evaluation.num_inference_steps={SERVING_STEPS}",
                                     "evaluation.save_gif=false",
                                     f"evaluation.output_dir={root / 'cascaded'}"])
        _, got = serving_step("evaluate cascaded (17-frame chunks, raw pixels)", times,
                              lambda: evaluate(cfg, vae=vae))
        with np.load(root / "cascaded" / "00000_cascaded_latents.npz") as f:
            lat, starts = f["arr_0"], f["chunk_starts"].tolist()
        n = len(starts)
        print(f"serving cascaded: {n} chunks starting at frames {starts}, stitched latents "
              f"{list(lat.shape)}", flush=True)
        check(n >= 2 and lat.shape == (5 * n, 16, 40, 60) and np.isfinite(lat).all(),
              f"cascaded latents {lat.shape} over {n} chunks")
        # per chunk: the video and its first frame; per chunk but the last:
        # the generated chaining frame, re-encoded for the next chunk
        check(times.encode_frames == [17, 1, 1] * (n - 1) + [17, 1],
              f"cascaded encodes {times.encode_frames}")
        check(got == tuple(n * SERVING_STEPS * c for c in BF16_FORWARD),
              f"cascaded launch counts {got}")
        video = read_video(str(root / "cascaded" / "00000_cascaded.mp4"))
        check(video.shape == (49, 320, 480, 3), f"the stitched cascade reads back as {video.shape}")
        del vae

        torch.manual_seed(0)
        model = ControlDiT(FLAGSHIP, dtype=torch.bfloat16)
        vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16)
        rng = np.random.default_rng(1)
        ref = rng.uniform(-1, 1, (320, 480, 3)).astype(np.float32)
        actions = (0.3 * rng.standard_normal((48, 7))).astype(np.float32)
        # twice on the same models: the first call pays the new models' first
        # forward, the second shows the steady step with f32 parameters
        for call in ("first", "second"):
            video, got = serving_step(
                f"inference.generate_video (49 frames from a 320x480 frame), {call} call",
                times, lambda: generate_video(model, vae, ref, actions,
                                              np.zeros((226, 4096), np.float32), num_frames=49,
                                              num_inference_steps=SERVING_STEPS))
            check(video.shape == (3, 49, 320, 480) and np.isfinite(video).all(),
                  f"generate_video gave {video.shape}")
            check(got == tuple(SERVING_STEPS * n for n in BF16_FORWARD),
                  f"generate_video launch counts {got}")
        del model, vae

        demo = root / "demo" / "ep0"
        (demo / "rgb").mkdir(parents=True)
        for i in range(17):
            Image.fromarray(rng.integers(0, 256, (320, 480, 3), dtype=np.uint8)).save(
                demo / "rgb" / f"{i:03d}.png")
        (demo / "annotations.json").write_text(json.dumps(dict(
            state=rng.uniform(-0.5, 0.5, (17, 7)).tolist(),
            continuous_gripper_state=rng.uniform(0, 1, 17).tolist())))
        out, got = serving_step("inference.main (tiny smoke model, 17 frames)", times,
                                lambda: inference_mod.main([
                                    "--demo_root", str(root / "demo"), "--output_dir",
                                    str(root / "demo_out"), "--num_inference_steps",
                                    str(SERVING_STEPS)]))
        check(read_video(out).shape == (17, 320, 480, 3), "inference.main's clip")
        check(got == tuple(SERVING_STEPS * n for n in SMOKE_FORWARD),
              f"inference.main launch counts {got}")
    finally:
        times.restore()
    print(f"serving phase total: {time.perf_counter() - t_phase:.1f} s", flush=True)


# -- phase 4c: the offline path (raw episodes -> latents -> train; T5; FID/FVD) -------------

OFFLINE_FRAMES = 49  # frames an episode (two episodes, 320x480)
OFFLINE_LAYERS = 4  # (d): the 2B recipe cut to 4 of its 30 layers, full width
OFFLINE_STEPS = 2  # (d): micro-steps
T5_NARROW = T5Config(d_model=256, d_kv=64, num_heads=4, d_ff=512, num_layers=2)


def conv_flop(model, shape) -> int:
    """Operations of one forward of a conv net on an input of `shape`, two a
    multiply-add of every conv, from the convs' output shapes (the model and
    the input on the meta device: nothing is computed)."""
    total = [0]

    def count(m, _, out):
        total[0] += 2 * m.weight[0].numel() * out.numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    model(torch.empty(shape, device="meta"))
    for h in hooks:
        h.remove()
    return total[0]


def offline_episodes(frames: int = OFFLINE_FRAMES):
    """Two raw single-camera episodes from a numpy seed, as a TFDS source
    yields them: smooth 320x480 frames (codec-friendly), states, gripper,
    actions."""
    rng = np.random.default_rng(4)
    yy, xx = np.meshgrid(np.arange(320), np.arange(480), indexing="ij")
    t = np.arange(frames)[:, None, None, None]
    for i in range(2):
        pix = (128 + 60 * np.sin(0.05 * xx[None, :, :, None] + 0.1 * t + i + np.arange(3))
               + 40 * np.cos(0.07 * yy)[None, :, :, None]
               + rng.normal(0, 4, (frames, 320, 480, 3)))
        yield dict(episode_id=f"{i:05d}", texts=["put the spoon in the pot"],
                   frames={0: np.clip(pix, 0, 255).astype(np.uint8)},
                   state=rng.uniform(-0.5, 0.5, (frames, 7)).tolist(),
                   continuous_gripper_state=rng.uniform(0, 1, frames).tolist(),
                   action=rng.uniform(-1, 1, (frames, 7)).tolist())


def offline_encode(cfg, root: Path, vae) -> None:
    """(b): encode_split with depth and label latents and ref_nums 1 and 5,
    then again (everything skipped), then with one file deleted (that file
    only rewritten); the zero empty prompt."""
    out = root / "data" / "embeddings_full" / "train"
    kw = dict(ref_nums=[1, 5], encode_conds=True)
    torch.cuda.reset_peak_memory_stats()
    times = StageTimes((encode_mod,))
    times.patch()
    t0 = time.perf_counter()
    try:
        written = encode_mod.encode_split(cfg, vae, "train", **kw)
    finally:
        times.restore()
    wall = time.perf_counter() - t0
    kinds = {}
    for p in map(Path, written):
        kind = p.parent.name + ("_ref5" if p.stem.endswith("_ref5") else "")
        kinds[kind] = kinds.get(kind, 0) + 1
    n_slices = kinds.get("latents", 0)
    clips = max(times.calls["encode"], 1)
    print(f"offline encode_split (bf16 VAE, ref_nums 1 and 5, depth and label): {wall:.2f} s for "
          f"{n_slices} slices, {wall / max(n_slices, 1):.3f} s/slice; {times.calls['encode']} "
          f"clips "
          f"({sum(times.encode_frames)} frames) encoded in {times.s['encode']:.2f} s, "
          f"{times.s['encode'] / clips:.3f} s/clip; files {dict(sorted(kinds.items()))}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    check(n_slices == 18 and all(kinds.get(k) == 18 for k in
                                ("image_latents", "image_latents_ref5", "depth_latents",
                                 "label_latents")), f"encode_split wrote {kinds}")
    for kind, frames in (("latents", 5), ("image_latents", 1), ("depth_latents", 5),
                         ("label_latents", 5)):
        m = np.load(out / kind / "00001_32_17_0.npz")["arr_0"]
        check(m.shape == (32, frames, 40, 60) and np.isfinite(m).all(),
              f"{kind} moments {m.shape} not finite [32, {frames}, 40, 60]")
    ref5 = np.load(out / "image_latents" / "00001_32_17_ref5.npz")["arr_0"]
    check(ref5.shape == (32, 2, 40, 60), f"ref5 moments {ref5.shape}")
    again = encode_mod.encode_split(cfg, vae, "train", **kw)
    print(f"offline encode_split again: {len(again)} files written (all skipped)", flush=True)
    check(again == [], f"a second encode_split wrote {again}")
    gone = out / "label_latents" / "00000_16_17_0.npz"
    old = np.load(gone)["arr_0"]
    gone.unlink()
    mtimes = {p: p.stat().st_mtime_ns for p in out.rglob("*.npz")}
    third = encode_mod.encode_split(cfg, vae, "train", **kw)
    same = {p: p.stat().st_mtime_ns for p in mtimes} == mtimes
    new = np.load(gone)["arr_0"]
    print(f"offline encode_split after deleting {gone.name}: wrote "
          f"{[Path(p).name for p in third]}, "
          f"other files untouched: {same}, rewritten file bitwise equal: "
          f"{np.array_equal(new, old)} (max diff {np.abs(new - old).max():.3g})", flush=True)
    check(third == [str(gone)] and same, "the backfill rewrote more or less than the deleted file")
    encode_mod.encode_empty_prompt(cfg, out)
    emb = np.load(out / "prompt_embeds" / "empty.npz")["arr_0"]
    check(emb.shape == (226, 4096) and not emb.any(), "the zero empty prompt")


def offline_t5(root: Path) -> None:
    """(c): T5-v1.1-XXL at full width on random weights, a 2-layer full-width
    encoder's sharded folder round trip, a 2-layer narrow encoder against the
    CPU in f32."""
    import importlib.util

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("transformers", "tokenizers", "sentencepiece")}
    # no T5 tokenizer files are in the repository, so no route can tokenize
    # here: the empty prompt's ids are T5's </s> (1) then the pad (0)
    ids = torch.tensor([[1] + [0] * 225], device="cuda")
    print(f"offline T5 tokenizer packages installed: {have}; no tokenizer files in the "
          f"repository, so the empty prompt's ids are [1] + [0] * 225", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    t0 = time.perf_counter()
    t5 = T5Encoder(T5Config(), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in t5.parameters())
    build = time.perf_counter() - t0
    with torch.inference_mode():
        out = t5(ids)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            out = t5(ids)
        ev[1].record()
        torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / 10
    flop = 2 * (n - t5.shared.weight.numel()) * ids.shape[1]
    print(f"offline T5-v1.1-XXL (24 x 4096, 64 heads x 64, d_ff 10240, bf16, random): "
          f"{n / 1e9:.3f} B parameters built in {build:.1f} s; {ms:.2f} ms a call on 226 tokens "
          f"({flop / 1e12:.2f} TFLOP of projections, {flop / ms / 1e9:.1f} TFLOP/s; bound "
          f"{flop / PEAK_BF16_FLOPS * 1e3:.2f} ms); out {list(out.shape)} {out.dtype}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    check(tuple(out.shape) == (1, 226, 4096) and out.dtype == torch.float32
          and bool(torch.isfinite(out).all()), "the XXL encoder's output")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t5(ids)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # cuBLAS's Hopper GEMMs are named nvjet_*, its older and batched ones *gemm* / xmma
    gemm = [e for e in kernels if re.search(r"nvjet|gemm|xmma|cutlass|cublas", e.name, re.I)]
    us = lambda evs: sum(e.time_range.elapsed_us() for e in evs)
    print(f"offline T5-XXL one call by torch.profiler: {len(kernels)} kernels, "
          f"{us(kernels) / 1e3:.2f} "
          f"ms of device time: GEMMs {len(gemm)} / {us(gemm) / 1e3:.2f} ms, the rest "
          f"{len(kernels) - len(gemm)} / {(us(kernels) - us(gemm)) / 1e3:.2f} ms", flush=True)
    del t5, out
    gc.collect()
    torch.cuda.empty_cache()

    t5 = T5Encoder(dataclasses.replace(T5Config(), num_layers=2), dtype=torch.bfloat16)
    folder = root / "t5_2layer"
    t0 = time.perf_counter()
    files = t5.save_pretrained(folder, max_shard_bytes=512 << 20)
    back = T5Encoder.from_pretrained(folder, dtype=torch.bfloat16)
    with torch.inference_mode():
        same = torch.equal(back(ids), t5(ids))
    size = sum((folder / f).stat().st_size for f in files)
    print(f"offline T5 2-layer full-width folder: {len(files)} shards, {size / 1e9:.2f} GB, "
          f"saved and loaded in {time.perf_counter() - t0:.1f} s; output bitwise equal: {same}",
          flush=True)
    check(len(files) > 1 and same, "the sharded T5 folder did not round-trip")
    del t5, back
    shutil.rmtree(folder)

    torch.manual_seed(1)
    card = T5Encoder(T5_NARROW, dtype=torch.bfloat16)
    cpu = T5Encoder(T5_NARROW, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.float().cpu() for k, v in card.state_dict().items()})
    narrow_ids = torch.randint(2, T5_NARROW.vocab_size, (2, 226),
                               generator=torch.Generator().manual_seed(2))
    narrow_ids[0, 150:] = 0  # trailing pads, attended as in the reference
    with torch.inference_mode():
        agree(card(narrow_ids.cuda()), cpu(narrow_ids), "offline T5 2-layer narrow bf16 card vs "
              "f32 CPU")
    del card, cpu


def write_feature_weights(root: Path):
    """Random InceptionV3 (torchvision names) and I3D (pytorch-i3d names)
    state dicts with non-identity batch norms, as safetensors folders."""
    g = torch.Generator().manual_seed(5)
    out = []
    for name, model, conv in (("inception", InceptionV3Pool3(device="meta"), "conv"),
                              ("i3d", I3D(device="meta"), "conv3d")):
        sd = {}
        for key, m in model.named_modules():
            if isinstance(m, ConvBN):
                w = m.conv.weight
                sd[f"{key}.{conv}.weight"] = torch.randn(w.shape, generator=g) * math.sqrt(
                    2.0 / w[0].numel())
                c = w.shape[0]
                sd[f"{key}.bn.weight"] = 0.5 + torch.rand(c, generator=g)
                sd[f"{key}.bn.bias"] = 0.1 * torch.randn(c, generator=g)
                sd[f"{key}.bn.running_mean"] = 0.1 * torch.randn(c, generator=g)
                sd[f"{key}.bn.running_var"] = 0.5 + torch.rand(c, generator=g)
        if name == "i3d":
            sd["logits.conv3d.weight"] = 0.05 * torch.randn(model.logits.weight.shape, generator=g)
            sd["logits.conv3d.bias"] = 0.1 * torch.randn(400, generator=g)
        (root / name).mkdir(parents=True)
        write_safetensors(root / name / "model.safetensors", sd)
        out.append(root / name)
    return out


def offline_metrics(root: Path) -> None:
    """(e): metrics.main with FID and FVD over two 49-frame gt/pred pairs, the
    feature networks' times, and the card's features against the CPU's."""
    from orv_tpu_torch.models import feature_extractors as fe

    inc, i3d = write_feature_weights(root / "weights")
    rng = np.random.default_rng(6)
    for d in ("gt", "pred"):
        (root / d).mkdir()
    for i in range(2):
        clip = read_video(str(root / "data" / "videos" / f"{i:05d}.mp4"))
        write_video(str(root / "gt" / f"{i:05d}.mp4"), clip)
        noisy = np.clip(clip.astype(np.int16) + rng.integers(-20, 21, clip.shape), 0, 255)
        write_video(str(root / "pred" / f"{i:05d}.mp4"), noisy.astype(np.uint8))
    t0 = time.perf_counter()
    summary = metrics_mod.main(["--gt_dir", str(root / "gt"), "--pred_dir", str(root / "pred"),
                                "--output_csv", str(root / "metrics.csv"),
                                "--inception_weights", str(inc), "--i3d_weights", str(i3d)])
    wall = time.perf_counter() - t0
    print(f"offline metrics.main (2 pairs of 49 frames, FID and FVD): {wall:.1f} s; "
          + ", ".join(f"{k} {v:.6g}" for k, v in summary.items() if k != "name"), flush=True)
    check([k for k in summary if k.startswith("fvd_")] == ["fvd_16", "fvd_32", "fvd_48", "fvd_49"]
          and all(math.isfinite(v) for k, v in summary.items() if k != "name"),
          f"metrics.main's summary {summary}")

    sd = fe.load_torch_state_dict(inc)
    model = fe._load(fe.InceptionV3Pool3(), sd, fe.convert_inception_state_dict)
    x = torch.rand(32, 3, 299, 299, device="cuda", generator=torch.Generator("cuda").manual_seed(7))
    with torch.inference_mode():
        inc_ms = call_ms("inception 32 frames", model, (x * 2 - 1,), n=10)
    del model, x
    model = fe._load(fe.I3D(), fe.load_torch_state_dict(i3d), fe.convert_i3d_state_dict)
    x = torch.rand(8, 3, 16, 224, 224, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(8))
    with torch.inference_mode():
        i3d_ms = call_ms("i3d 8 clips", model, (x * 2 - 1,), n=5)
    del model, x
    inc_flop = conv_flop(fe.InceptionV3Pool3(device="meta"), (32, 3, 299, 299))
    i3d_flop = conv_flop(fe.I3D(device="meta"), (8, 3, 16, 224, 224))
    print(f"offline feature networks (f32, TF32 off): InceptionV3 pool3 {inc_ms:.2f} ms a 32-frame "
          f"batch at 299x299 ({inc_flop / 32e9:.3f} GFLOP a frame, {inc_flop / inc_ms / 1e9:.1f} "
          f"TFLOP/s; f32 bound {inc_flop / PEAK_F32_FLOPS * 1e3:.2f} ms), I3D {i3d_ms:.2f} ms an "
          f"8-clip batch at 16x224x224 ({i3d_flop / 8e9:.3f} GFLOP a clip, "
          f"{i3d_flop / i3d_ms / 1e9:.1f} TFLOP/s; f32 bound "
          f"{i3d_flop / PEAK_F32_FLOPS * 1e3:.2f} ms)", flush=True)

    frames = read_video(str(root / "gt" / "00000.mp4")).astype(np.float32) / 255.0
    for what, make, batch in (
            ("InceptionV3 pool3, 8 frames", fe.inception_pool3_features, frames[:8]),
            ("I3D, one 16-frame clip", fe.i3d_features,
             metrics_mod.center_crop_resize(frames[:16])[None])):
        card, ref = (make(str(inc if "Incep" in what else i3d), device=d)(batch)
                     for d in ("cuda", "cpu"))
        err = np.abs(card - ref).max() / np.sqrt(np.mean(ref ** 2))
        print(f"offline features card vs CPU f32 ({what}): max error {err:.3g} of the RMS "
              f"(tol 1e-3)", flush=True)
        check(err <= 1e-3, f"the card's {what} features disagree with the CPU's")


def offline_phase(root: Path) -> None:
    """Phase 4c: raw episodes -> latents -> train, the T5 encoder and FID/FVD
    (module docstring)."""
    t_phase = time.perf_counter()
    written = data_process.extract(offline_episodes(), str(root / "data"), split="train",
                                   num_workers=2)
    rng = np.random.default_rng(5)
    for i in range(2):
        (root / "data" / f"{i:05d}").mkdir()
        np.savez(root / "data" / f"{i:05d}" / "render.npz",
                 depths=rng.uniform(0.0, 0.5, (OFFLINE_FRAMES, 1, 320, 480)).astype(np.float32),
                 semantics=rng.integers(0, 60, (OFFLINE_FRAMES, 1, 320, 480)).astype(np.int32),
                 is_labeled=np.ones(1, bool))
    print(f"offline extract: {len(written)} episodes of {OFFLINE_FRAMES} frames at 320x480 "
          f"(mp4 + annotation JSON) and their render.npz in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    check(len(written) == 2, f"extract wrote {written}")

    cfg = train_config(root / "data", root / "out", [
        f"transformer.num_layers={OFFLINE_LAYERS}", f"train.max_train_steps={OFFLINE_STEPS}",
        "train.checkpointing_steps=1000", "train.log_every=1", "train.validation_steps=1000"])
    torch.manual_seed(0)
    vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16)  # f32 parameters, as main() loads one
    offline_encode(cfg, root, vae)
    del vae
    offline_t5(root)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    old = os.environ.get("NO_INIT_VAL")
    os.environ["NO_INIT_VAL"] = "1"
    reset_counts()
    t0 = time.perf_counter()
    try:
        state = train_mod.train(cfg)
    finally:
        if old is None:
            os.environ.pop("NO_INIT_VAL")
        else:
            os.environ["NO_INIT_VAL"] = old
    wall = time.perf_counter() - t0
    launches = counts()
    tally(launches)
    want = tuple(OFFLINE_STEPS * c for c in train_micro_step_counts(OFFLINE_LAYERS))
    logs = [m for m in map(json.loads, (root / "out" / "run" / "logs" / "metrics.jsonl")
                           .read_text().splitlines()) if "loss" in m]
    print(f"offline train on the encoded latents (2B recipe cut to {OFFLINE_LAYERS} of 30 layers, "
          f"B={cfg.train.train_batch_size} x {cfg.train.gradient_accumulation_steps}, "
          f"{OFFLINE_STEPS} micro-steps): {wall:.1f} s with the final checkpoint and export; "
          f"losses {[round(m['loss'], 5) for m in logs]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {launches} = "
          f"{OFFLINE_STEPS} x {train_micro_step_counts(OFFLINE_LAYERS)}", flush=True)
    check(launches == want, f"offline train launch counts {launches} != {want}")
    check(state.step == OFFLINE_STEPS and len(logs) == OFFLINE_STEPS
          and all(math.isfinite(m["loss"]) for m in logs), "offline train's steps or losses")
    del state
    shutil.rmtree(root / "out")
    gc.collect()
    torch.cuda.empty_cache()

    offline_metrics(root)
    print(f"offline phase total: {time.perf_counter() - t_phase:.1f} s", flush=True)


# -- phase 4d: the data factory (depth episodes -> occupancy -> condition maps) ----------

def raster_scene(n: int, H: int, W: int, seed: int):
    """A seeded scene for the rasterizer checks: (settings, arrays) of n
    anisotropic, rotated gaussians (unnormalized quaternions) before a
    pinhole camera at H x W: a tenth behind the near plane (view depth under
    0.2), some off screen, and a twentieth large ones past the frustum
    clamp (1.3 tan-fov) that still reach the image."""
    from orv_tpu_torch.ops.gaussian_raster import view_settings

    rng = np.random.default_rng(seed)
    f = 0.9 * W
    z = rng.uniform(0.25, 3.0, n)
    z[: n // 10] = rng.uniform(0.05, 0.19, n // 10)
    u = rng.uniform(-0.7, 0.7, n)
    v = rng.uniform(-0.7, 0.7, n) * H / W
    scales = rng.uniform(0.004, 0.04, (n, 3)) * z[:, None]
    big = slice(n // 10, n // 10 + n // 20)
    u[big] = rng.choice([-1, 1], len(u[big])) * rng.uniform(0.75, 0.9, len(u[big]))
    scales[big] = rng.uniform(0.15, 0.3, (len(u[big]), 3)) * z[big, None]
    cam = np.stack([u * z, v * z, z, np.ones(n)], 1)
    a = 0.3
    c2w = np.array([[math.cos(a), 0, math.sin(a), 0.05], [0, 1, 0, -0.02],
                    [-math.sin(a), 0, math.cos(a), 0.1], [0, 0, 0, 1]])
    K = np.array([[f, 0, W / 2 + 1.5], [0, 1.05 * f, H / 2 - 2.5], [0, 0, 1]])
    settings = view_settings(c2w, K, (H, W), bg_color=(0.1, 0.2, 0.3))
    arrays = dict(means3d=(cam @ c2w.T)[:, :3], colors=rng.uniform(0, 1, (n, 3)),
                  opacities=rng.uniform(0.1, 1.0, n), scales=scales,
                  rotations=rng.normal(size=(n, 4)), features=rng.uniform(0, 1, (n, 12)))
    return settings, {k: x.astype(np.float32) for k, x in arrays.items()}


FACTORY_FRAMES = 49  # frames an episode, at data_process's 320x480
FACTORY_HW = (320, 480)
FACTORY_K = np.array([[450.0, 0.0, 240.0], [0.0, 450.0, 160.0], [0.0, 0.0, 1.0]])
FACTORY_RENDER = (240, 320)  # run_render's default image shape
# the scene, in the occupancy workspace [-0.2, 0.2]^2 x [0, 0.4] (1 mm voxels):
# (label, x0, x1, y0, y1, top z) of a table and three boxes; the camera looks
# straight down from 0.40 m, so every surface lies 0.25-0.35 m in front of it
# (the rasterizer culls under 0.2 m, the render clamps depth to 0.4 m); the
# floor, 0.7 m away, lies outside the workspace and renders as background
FACTORY_SURFACES = ((1, -0.15, 0.15, -0.10, 0.10, 0.05), (2, -0.09, -0.03, 0.00, 0.05, 0.13),
                    (3, -0.01, 0.04, -0.04, 0.01, 0.10), (4, -0.14, -0.10, 0.06, 0.10, 0.15))
FACTORY_OBJECTS = {1: "table", 2: "red box", 3: "blue box", 4: "green box"}
FACTORY_KERNELS = (voxelize_mod.hard_voxelize, voxelize_mod.dynamic_voxelize,
                   raster_mod.rasterize, raster_mod.rasterize_backward)
FACTORY_LAUNCHES = [0] * len(FACTORY_KERNELS)  # the kernels line's, summed over 4d's main path
FACTORY_ACTIONS = (("reconstruction", "--dense"), ("cameras",), ("align_cameras",), ("caption",),
                   ("caption_post_process",), ("labeling",), ("labels_post_process",),
                   ("render",))


def factory_pose(f: int, ep: int) -> np.ndarray:
    """cam -> world of frame f: looking down (x right, y and z flipped) from
    0.40 m, moving a few millimetres and turning 0.02 rad about the vertical."""
    a = 2 * math.pi * f / FACTORY_FRAMES + ep
    yaw = 0.02 * math.sin(a)
    c, s = math.cos(yaw), math.sin(yaw)
    pose = np.eye(4)
    pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag([1.0, -1.0, -1.0])
    pose[:3, 3] = [0.004 * math.sin(a), 0.003 * math.cos(a), 0.40]
    return pose


def factory_cast(pose: np.ndarray, K: np.ndarray, hw, shift: float = 0.0):
    """(depth [H,W] f32 along the view axis, label [H,W]) of the scene seen
    through (pose, K): the nearest horizontal surface each pixel's ray meets
    (0 where it meets the floor); boxes shifted by `shift` in x."""
    H, W = hw
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], -1)
    dw = d @ pose[:3, :3].T  # world direction per unit view depth (z component -1)
    depth = np.full((H, W), pose[2, 3] + 0.30)  # the floor at z = -0.30
    label = np.zeros((H, W), np.int64)
    for lab, x0, x1, y0, y1, top in FACTORY_SURFACES:
        dx = shift if lab > 1 else 0.0
        t = pose[2, 3] - top
        x = pose[0, 3] + t * dw[..., 0]
        y = pose[1, 3] + t * dw[..., 1]
        hit = (x >= x0 + dx) & (x <= x1 + dx) & (y >= y0) & (y <= y1) & (t < depth)
        depth[hit], label[hit] = t, lab
    return depth.astype(np.float32), label


def write_factory_episodes(root: Path) -> list:
    """Two seeded depth episodes under root (data_process's layout: the mp4s
    and annotation JSONs of phase 4c's generator, and per episode depth/,
    intrinsics.json, poses.npy, per-point labels/, objects.txt and masks/).
    Returns each episode's share of the render's pixels that the
    workspace's surfaces cover, seen from its first pose (the alpha > 0.1
    share its render must come near)."""
    data_process.extract(offline_episodes(FACTORY_FRAMES), str(root), split="train",
                         num_workers=2)
    rng = np.random.default_rng(11)
    names = sorted(FACTORY_OBJECTS.values())  # the objects_file backend's (sorted) order
    shares = []
    for ep in range(2):
        d = root / f"{ep:05d}"
        for sub in ("depth", "labels", "masks"):
            (d / sub).mkdir(parents=True)
        (d / "intrinsics.json").write_text(json.dumps({"K": FACTORY_K.tolist()}))
        (d / "objects.txt").write_text("\n".join(FACTORY_OBJECTS.values()) + "\n")
        poses = np.stack([factory_pose(f, ep) for f in range(FACTORY_FRAMES)])
        np.save(d / "poses.npy", poses)
        for f in range(FACTORY_FRAMES):
            depth, label = factory_cast(poses[f], FACTORY_K, FACTORY_HW, shift=0.01 * ep)
            depth += rng.normal(0, 2e-4, depth.shape).astype(np.float32)
            np.save(d / "depth" / f"{f:05d}.npy", depth)
            np.save(d / "labels" / f"{f:05d}.npy", label.reshape(-1))
            ids = {v: k for k, v in FACTORY_OBJECTS.items()}
            np.save(d / "masks" / f"frame_{f:04d}.npy", np.stack([label == ids[n] for n in names]))
        _, label = factory_cast(poses[0], FACTORY_K, FACTORY_RENDER, shift=0.01 * ep)
        shares.append(float((label > 0).mean()))
    return shares


# f32 operations of one blended (pixel, splat) pair in the kernels' code
# (csrc/gaussian_raster.cu): forward_kernel's blend (the power 11, the
# tests 4, alpha 2, the weight 1, colour 6, 12 features 24, depth 2, T 2),
# backward_kernel's (the power, tests and alpha 16, T before and the weight
# 3, the payload 31, the payload gradients 16, d alpha 8, the clamp test 2,
# the local gradients 21, the carried payload 2) and its sum over the
# pixels (22 values added); an expf counted as 8 (its MUFU.EX2 issues at
# 1/8 of the f32 rate). The preprocess, the slot sums and the geometry
# chain (a few hundred a gaussian) are left out.
RASTER_FWD_PAIR_OPS = 52 + 8
RASTER_BWD_PAIR_OPS = 121 + 8
# the kernels of gaussian_raster.cu whose ptxas lines phase 4d prints
RASTER_KERNEL = re.compile(r"((?:forward|backward|backward_sum)_kernel)(ILb([01])E)?")


def raster_build_report() -> None:
    """The rasterizer's blend kernels by ptxas (registers, static shared
    memory, spills) and the backward's residency on this card (blocks a
    multiprocessor, dynamic shared memory)."""
    source, kernel = None, None
    for line in _build.build_log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif source == "gaussian_raster.cu" and "entry function" in line:
            m = RASTER_KERNEL.search(line)
            kernel = None if m is None else m.group(1) + (
                "" if m.group(3) is None else f"<{'true' if m.group(3) == '1' else 'false'}>")
        elif source == "gaussian_raster.cu" and kernel and re.search(r"registers|spill", line):
            print(f"ptxas gaussian_raster.cu {kernel}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
    if not _build.build_log:
        print("ptxas gaussian_raster.cu: no build log (the library was built before)", flush=True)
    for feats in (True, False):
        blocks, smem = raster_mod.backward_occupancy(feats)
        print(f"occupancy backward_kernel<{str(feats).lower()}>: {blocks} blocks of 256 threads "
              f"a multiprocessor, {smem} bytes of dynamic shared memory a block", flush=True)
        check(blocks >= 2, f"the raster backward holds {blocks} block(s) a multiprocessor")


def check_raster_state(s, t, grads, got, what: str) -> dict:
    """The forward under autograd: its outputs the no-grad forward's bits;
    its saved state (each pixel's final T and last blended splat) against
    `forward_state_plain` (T to 1e-6, the last splat equal off the pixels
    whose running T passes within 1e-5 of 1e-4); autograd's backward from
    it bitwise equal to the standalone backward's `got`. Returns the plain
    state (its pairs count the bound's operations)."""
    names = ("means3d", "colors", "opacities", "scales", "rotations", "features")
    leaves = [t[k].clone().requires_grad_(True) for k in names]
    out = raster_mod.rasterize(s, *leaves)
    with torch.no_grad():
        bare = raster_mod.rasterize(s, *(t[k] for k in names))
    same_out = all(torch.equal(a.detach(), b) for a, b in zip(out, bare))
    state = out[0].grad_fn.state
    want = raster_mod.forward_state_plain(s, t["means3d"], t["opacities"], t["scales"],
                                          t["rotations"])
    t_err = max_err(state["T"], want["T"])
    off = ~want["marginal"]
    moved = int((state["last"] != want["last"]).sum())
    moved_off = int((state["last"] != want["last"])[off].sum())
    color, feature, _, depth, alpha = out
    loss = ((color * grads["grad_color"]).sum() + (depth * grads["grad_depth"]).sum()
            + (alpha * grads["grad_alpha"]).sum() + (feature * grads["grad_feature"]).sum())
    auto = dict(zip(names, torch.autograd.grad(loss, leaves)))
    bitwise = all(torch.equal(auto[k], got[k]) for k in names)
    print(f"kernel gaussian_raster state, {what}: the forward's outputs under autograd bitwise "
          f"equal to no-grad {same_out}; final T max_abs_err {t_err:.3g} (tol 1e-6); last "
          f"splat differs on {moved} pixels, {moved_off} off the {int(want['marginal'].sum())} "
          f"marginal ones (tol 0); {int(want['pairs'].sum())} blended pairs, "
          f"{int(want['clamped'].sum())} at the 0.99 clamp, {int((want['T'] < 1e-4).sum())} "
          f"pixels stopped; autograd's backward bitwise equal to the standalone {bitwise}",
          flush=True)
    check(same_out and t_err <= 1e-6 and moved_off == 0 and bitwise,
          f"the rasterizer's saved state or its autograd backward at {what}")
    return want


def factory_kernel_checks(g, data: Path, t0: float):
    """The factory's kernels against their plain versions on the card, on the
    factory's own data: voxelization bitwise (hard, at points_to_voxels'
    limits, and dynamic) on one full frame and at a ragged count; the
    forward rasterizer on frame 0's gaussians at the render's size and at a
    ragged one; the backward on a 3000-gaussian scene at 64 x 96 and 61 x 93
    and on frame 0's gaussians at the render's size, against autograd
    through the plain version, and its second run against its first,
    bitwise. Then device times a frame beside the plain versions' and a
    bytes bound, each call's split by part. Returns the records."""
    from orv_tpu_torch.pipelines import prepare_dataset as pd

    ep = data / "00000"
    pts = pd.depth_unproject_backend(str(ep))["points"][0]
    labels = np.load(ep / "labels" / "00000.npy")
    # row-major, as points_to_voxels hands it over (the unprojected points are column-major)
    cloud = torch.tensor(np.concatenate([pts, labels[:, None].astype(np.float32)], 1),
                         device="cuda").contiguous()
    vox_args = (pd.VOXEL_SIZE, pd.POINT_CLOUD_RANGE)
    for n in (len(cloud), len(cloud) - 37):
        c = cloud[:n].contiguous()
        got = voxelize_mod.voxelization(c, *vox_args, max_points=16, max_voxels=2_000_000)
        want = voxelize_mod.voxelization_plain(c, *vox_args, 16, 2_000_000)
        same = all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want))
        dyn = torch.equal(voxelize_mod.voxelization(c, *vox_args, max_points=-1),
                          voxelize_mod.voxelization_plain(c, *vox_args, max_points=-1))
        print(f"kernel voxelize on {n} points: {len(got[1])} voxels, hard bitwise equal "
              f"{same}, dynamic bitwise equal {dyn}", flush=True)
        check(same and dyn, f"voxelization disagrees with its plain version at {n} points")
    M = len(got[1])

    occ = np.load(ep / "occupancy.npz")
    n0 = int(occ["frame_sizes"][0])
    gauss = pd.occupancy_to_gaussians(occ["coors"][:n0], occ["labels"][:n0], device="cuda")
    centers, feat, rot, scales, opac = gauss
    rgb = torch.zeros_like(centers)
    pose0 = np.load(ep / "poses.npy")[0]
    for hw in (FACTORY_RENDER, (237, 317)):
        settings = raster_mod.view_settings(pose0, FACTORY_K, hw)
        args = (centers, rgb, opac, scales, rot, feat)
        got = raster_mod.rasterize(settings, *args)
        want = raster_mod.rasterize_plain(settings, *args)
        err = max(max_err(a, b) for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]))
        print(f"kernel gaussian_raster forward, {n0} gaussians at {hw[0]}x{hw[1]}: radii bitwise "
              f"{torch.equal(got[2], want[2])}, max_abs_err {err:.3g} (tol 1e-5)", flush=True)
        check(torch.equal(got[2], want[2]) and err <= 1e-5,
              f"the rasterizer disagrees with its plain version at {hw}")
    fwd_err = err
    settings = raster_mod.view_settings(pose0, FACTORY_K, FACTORY_RENDER)
    args = (centers, rgb, opac, scales, rot, feat)
    lengths = raster_mod._bin(settings, centers, scales, rot, opac)["ranges"].diff(1)[:, 0]
    print(f"binning frame 0 at {FACTORY_RENDER[0]}x{FACTORY_RENDER[1]}: {int(lengths.sum())} keys "
          f"over {len(lengths)} tiles, {float(lengths.float().mean()):.1f} a tile, the longest "
          f"{int(lengths.max())} (the shared-memory sort holds {raster_mod.TILE_SORT_CAP})",
          flush=True)
    raster_build_report()

    bwd_errs = []
    pairs = {}
    frame_scene = (settings, dict(means3d=centers, colors=rgb, opacities=opac, scales=scales,
                                  rotations=rot, features=feat))
    bwd_calls = {}
    for hw in ((64, 96), (61, 93), FACTORY_RENDER):
        if hw == FACTORY_RENDER:
            s_bwd, t = frame_scene
            what = f"frame 0's {n0} gaussians"
        else:
            s_bwd, arr = raster_scene(3000, *hw, seed=hw[1])
            t = {k: torch.tensor(v, device="cuda") for k, v in arr.items()}
            what = "3000 gaussians"
        grads = dict(grad_color=torch.randn(3, *hw, generator=g, device="cuda"),
                     grad_depth=torch.randn(*hw, generator=g, device="cuda"),
                     grad_alpha=torch.randn(*hw, generator=g, device="cuda"),
                     grad_feature=torch.randn(12, *hw, generator=g, device="cuda"))
        bargs = (t["means3d"], t["colors"], t["opacities"], t["scales"], t["rotations"])
        got = raster_mod.rasterize_backward(s_bwd, *bargs, features=t["features"], **grads)
        want = raster_mod.rasterize_backward_plain(s_bwd, *bargs, features=t["features"],
                                                   **grads)
        rel = {k: max_err(got[k], want[k]) / max(want[k].abs().max().item(), 1e-30) for k in want}
        note = ""
        if hw == FACTORY_RENDER:
            # the factory's gaussians are isotropic at the identity rotation: their rotation
            # gradient is zero, the plain version's exactly; the kernel's, rounding, is held to
            # 1e-4 of the size of its terms, 4 |dL/ds| s (|dL/dq| ~ 2 |dL/dR| ~ 4 |dL/dM| s)
            scale = 4 * (want["scales"].abs().amax(1) * t["scales"].abs().amax(1)).max().item()
            rel["rotations"] = got["rotations"].abs().max().item() / scale
            note = (f" (rotations: the plain version's largest "
                    f"{want['rotations'].abs().max():.3g}, the kernel's against 4 |dL/ds| s = "
                    f"{scale:.3g})")
        again = raster_mod.rasterize_backward(s_bwd, *bargs, features=t["features"], **grads)
        bitwise = all(torch.equal(got[k], again[k]) for k in got)
        print(f"kernel gaussian_raster backward, {what} at {hw[0]}x{hw[1]}: error of "
              f"the largest gradient {', '.join(f'{k} {v:.3g}' for k, v in rel.items())} (tol "
              f"1e-4){note}; a second run bitwise equal: {bitwise}", flush=True)
        check(max(rel.values()) <= 1e-4, f"the raster backward disagrees at {hw}")
        check(bitwise, f"the raster backward's second run at {hw} differs in its bits")
        pairs[hw] = int(check_raster_state(s_bwd, t, grads, got, f"{what} at {hw[0]}x{hw[1]}")
                        ["pairs"].sum())
        bwd_errs.append(max(rel.values()))
        bwd_calls[hw] = (s_bwd, *bargs, grads["grad_color"], grads["grad_depth"],
                         grads["grad_alpha"], t["features"], grads["grad_feature"])

    print(f"factory kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)
    # device times a frame, beside the plain versions' and a bytes bound
    hard = lambda c: voxelize_mod.voxelization(c, *vox_args, max_points=16, max_voxels=2_000_000)
    records = []
    vox_bytes = cloud.numel() * 4 + M * (16 * 4 * 4 + 3 * 4 + 4)
    dyn_bytes = cloud.numel() * 4 + len(cloud) * 3 * 4
    n_g = len(centers)
    fwd_bytes = n_g * (3 + 3 + 1 + 3 + 4 + 12) * 4 + 17 * math.prod(FACTORY_RENDER) * 4 + n_g * 4
    # the gaussians read and their gradients written, the 17 gradient planes read
    bwd_bytes = lambda n, hw: n * (3 + 3 + 1 + 3 + 4 + 12) * 4 * 2 + 17 * math.prod(hw) * 4
    # the blend's operations: frame 0's blended (pixel, splat) pairs
    fwd_ops = pairs[FACTORY_RENDER] * RASTER_FWD_PAIR_OPS
    bwd_ops = lambda hw: pairs[hw] * RASTER_BWD_PAIR_OPS
    for name, src, line, fn, plain, call, nbytes_, ops, err, host in (
            ("voxelize_hard", "voxelize.cu", "orv_tpu/ops/native/voxelize.cpp:94", hard,
             lambda c: voxelize_mod.voxelization_plain(c, *vox_args, 16, 2_000_000), (cloud,),
             vox_bytes, 0, 0.0, "hard_voxelize"),
            ("voxelize_dynamic", "voxelize.cu", "orv_tpu/ops/native/voxelize.cpp:59",
             lambda c: voxelize_mod.voxelization(c, *vox_args, max_points=-1),
             lambda c: voxelize_mod.voxelization_plain(c, *vox_args, max_points=-1), (cloud,),
             dyn_bytes, 0, 0.0, None),
            ("gaussian_raster_fwd", "gaussian_raster.cu",
             "orv_tpu/ops/native/gaussian_raster.cpp:205",
             lambda *a: raster_mod.rasterize(settings, *a),
             lambda *a: raster_mod.rasterize_plain(settings, *a), args, fwd_bytes, fwd_ops,
             fwd_err, "rasterize"),
            ("gaussian_raster_bwd", "gaussian_raster.cu",
             "orv_tpu/ops/native/gaussian_raster.cpp:264",
             raster_mod.rasterize_backward, raster_mod.rasterize_backward_plain,
             bwd_calls[FACTORY_RENDER], bwd_bytes(n_g, FACTORY_RENDER), bwd_ops(FACTORY_RENDER),
             max(bwd_errs), "rasterize")):
        waits = list(_build.host_waits.get(host, [0, 0.0]))
        kernels = profiled_events(fn, [call], 10)
        ms = sum(kernels.values()) / 1e3
        print(f"split {name}: " + factory_split(kernels, host, waits), flush=True)
        # thousands of small kernels a call: one call, no warm-up (a lost first
        # kernel is noise there, and the profiler's own work grows with the kernels)
        plain_ms = profiled_ms(plain, [call], 1, warmup=0)
        bound, by = bound_ms(nbytes_, f32=ops)
        records.append(dict(name=name, route="cuda", source=f"orv_tpu_torch/ops/csrc/{src}",
                            replaces=line, launches=0, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None))
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}: {nbytes_} bytes at 3.35 TB/s, {ops} f32 operations at 67 TFLOP/s), "
              f"library none (device time by torch.profiler)", flush=True)
    # the device-wide scan alone, at a frame's points (the grouping scans its head flags)
    flags = (torch.arange(len(cloud), device="cuda") % 3 == 0).int()
    got, total = scan_mod.exclusive_scan(flags)
    want, want_total = scan_mod.exclusive_scan_plain(flags)
    check(torch.equal(got, want) and torch.equal(total, want_total),
          "the device-wide scan disagrees with torch.cumsum")
    ms = profiled_ms(scan_mod.exclusive_scan, [(flags,)], 10)
    lib = profiled_ms(lambda x: torch.cumsum(x, 0, dtype=torch.int32), [(flags,)], 10)
    print(f"time exclusive_scan of {len(flags)} int32: kernel {ms:.4f} ms "
          f"({scan_mod.scan_blocks(len(flags))} blocks, bitwise equal to torch.cumsum), "
          f"torch.cumsum {lib:.4f} ms, bound "
          f"{bound_ms(len(flags) * 4 * 2)[0]:.4f} ms (bytes)", flush=True)
    # the backward at the small scene's shape too (3000 gaussians, 61x93)
    hw = (61, 93)
    waits = list(_build.host_waits.get("rasterize", [0, 0.0]))
    split = profiled_events(raster_mod.rasterize_backward, [bwd_calls[hw]], 10)
    ms = sum(split.values()) / 1e3
    bound, by = bound_ms(bwd_bytes(3000, hw), f32=bwd_ops(hw))
    records[-1].update(small_shape=[3000, *hw], small_ms=ms, small_bound_ms=bound)
    print(f"split gaussian_raster_bwd at 3000 gaussians, {hw[0]}x{hw[1]}: "
          + factory_split(split, "rasterize", waits), flush=True)
    print(f"time gaussian_raster_bwd at 3000 gaussians, {hw[0]}x{hw[1]}: kernel {ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}) (device time by torch.profiler)", flush=True)
    return records


@contextlib.contextmanager
def spawned_workers_skip_this_script():
    """While open, the factory's spawned stage workers do not re-run this
    script as __mp_main__ (multiprocessing re-runs the parent's main file
    when it has one): they start as the workers of `python -m
    orv_tpu_torch.pipelines.prepare_dataset` do, importing the factory alone
    (torch only where a stage runs on the device; torch's import takes 7 s
    on the card's machine), not this script's models and pipelines."""
    main = sys.modules["__main__"]
    path = main.__dict__.pop("__file__", None)
    try:
        yield
    finally:
        if path is not None:
            main.__file__ = path


# the factory kernels' parts, by kernel name, for the split lines
FACTORY_PARTS = (("cells", ("voxel_cells_kernel",)),
                 ("scan", ("scan_reduce_kernel", "scan_apply_kernel")),
                 ("grouping", ("voxel_insert_kernel", "voxel_fill_kernel")),
                 ("scatter", ("voxel_scatter_kernel",)),
                 ("preprocess", ("preprocess_kernel",)),
                 ("binning", ("tile_fill_kernel",)),
                 ("per-tile sort", ("tile_sort_kernel",)),
                 ("blend", ("forward_kernel",)),  # in a backward: its state
                 ("backward pass", ("backward_kernel",)),
                 ("backward sums", ("backward_sum_kernel", "backward_geom_kernel")))


def factory_split(by: dict, host, waits) -> str:
    """A call's device time by part (`profiled_events`' {kernel: us}:
    FACTORY_PARTS, memsets and any other kernel by name), and the host's
    wait in the wrapper's count read since `waits` (`_build.host_waits[host]`
    before the calls)."""
    by = dict(by)
    total = sum(by.values())
    parts = []
    for part, names in FACTORY_PARTS:
        got = {k: by.pop(k) for k in names if k in by}
        if got:
            inner = ", ".join(f"{k} {v / 1e3:.4f}" for k, v in got.items())
            parts.append(f"{part} {sum(got.values()) / 1e3:.4f} ({inner})")
    parts += [f"{k} {v / 1e3:.4f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])]
    line = f"{total / 1e3:.4f} ms a call: " + ", ".join(parts)
    if host:
        got = _build.host_waits.get(host, [0, 0.0])
        reads, secs = got[0] - waits[0], got[1] - waits[1]
        line += (f"; the host waits {secs / max(reads, 1) * 1e6:.1f} us a call in its count "
                 f"read ({reads} reads)")
    return line


def factory_counts():
    return tuple(k.launches for k in FACTORY_KERNELS)


def factory_tree(root: Path):
    """{path: (mtime_ns, bytes)} of every file under root."""
    return {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in root.rglob("*") if p.is_file()}


def factory_phase(root: Path) -> list:
    """Phase 4d: the data factory at full width (module docstring). Returns
    the factory kernels' records for the kernels line."""
    from orv_tpu_torch.pipelines import prepare_dataset as pd

    t_phase = time.perf_counter()
    data = root / "data"
    t0 = time.perf_counter()
    shares_want = write_factory_episodes(data)
    print(f"factory episodes: 2 x {FACTORY_FRAMES} depth frames at {FACTORY_HW[0]}x"
          f"{FACTORY_HW[1]} (+ mp4, annotation JSON, labels, masks) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k in FACTORY_KERNELS:
        k.launches = 0
    pd.stats.clear()
    torch.cuda.reset_peak_memory_stats()
    wall = {}
    for action, *flags in FACTORY_ACTIONS:
        t0 = time.perf_counter()
        with spawned_workers_skip_this_script():
            done = pd.main(["--action", action, "--data_root", str(data), *flags])
        wall[action] = time.perf_counter() - t0
        n_done = len(done)
        print(f"factory {action}: {wall[action]:.2f} s, "
              + (f"{n_done} captions clustered" if isinstance(done, dict)
                 else f"episodes {[Path(e).name for e in done]}"), flush=True)
        check(n_done == 4 if isinstance(done, dict) else n_done == 2,
              f"factory action {action} returned {done}: a worker failed on an episode")
    launches = factory_counts()
    recon = wall["reconstruction"]
    st = dict(pd.stats)
    print(f"factory launches (hard voxelize / dynamic / raster forward / backward) {launches}; "
          f"reconstruction {recon:.2f} s of which outlier removal (host, cKDTree) "
          f"{st.get('outlier_removal_s', 0):.2f} s ({st.get('outlier_removal_s', 0) / recon:.1%}), "
          f"TSDF {st.get('tsdf_fuse_s', 0):.2f} s, voxelize + vote "
          f"{st.get('voxelize_s', 0):.2f} s; render {st.get('render_s', 0):.2f} s in its worker; "
          f"workers' peak device memory {st.get('worker_peak_bytes', 0) / 2**30:.2f} GiB",
          flush=True)
    check(launches[0] == 2 * FACTORY_FRAMES and launches[2] == 2 * FACTORY_FRAMES,
          f"the factory launched {launches}, not {2 * FACTORY_FRAMES} voxelizations and renders")
    frame_points, frame_gauss = [], []
    for ep, share_want in zip(("00000", "00001"), shares_want):
        occ = np.load(data / ep / "occupancy.npz")
        sizes = occ["frame_sizes"]
        check(len(sizes) == FACTORY_FRAMES and (sizes > 0).all() and sizes.sum() == len(occ["coors"]),
              f"episode {ep}'s occupancy frames {sizes}")
        frame_gauss += list(sizes)
        frame_points.append(len(np.load(data / ep / "dense_surface.npz")["points"]))
        r = np.load(data / ep / "render.npz")
        sem, dep = r["semantics"], r["depths"]
        shape = (FACTORY_FRAMES, 1, *FACTORY_RENDER)
        check(sem.dtype == np.uint8 and dep.dtype == np.float32 and sem.shape == shape
              and dep.shape == shape, f"render.npz {sem.dtype} {sem.shape}, {dep.dtype} {dep.shape}")
        present = set(np.unique(sem).tolist())
        share = float((sem != pd.NUM_SEMANTIC_CHANNELS - 1).mean())
        print(f"factory render {ep}: labels present {sorted(present)}, depths in "
              f"[{dep.min():.4f}, {dep.max():.4f}], alpha > 0.1 on {share:.4f} of the pixels "
              f"(the scene's surfaces cover {share_want:.4f} from the first pose)", flush=True)
        check(set(FACTORY_OBJECTS) | {pd.NUM_SEMANTIC_CHANNELS - 1} <= present,
              f"render {ep} lacks an object label or the background: {sorted(present)}")
        check(dep.min() >= 0.01 and dep.max() <= 0.4 and abs(share - share_want) <= 0.03,
              f"render {ep}: depths or the covered share off")
    n_pts = [len(p) for p in pd.depth_unproject_backend(str(data / "00000"))["points"][:1]]
    print(f"factory sizes: {n_pts[0]} points a frame unprojected (+ {frame_points} TSDF surface "
          f"points an episode), gaussians a frame {min(frame_gauss)}-{max(frame_gauss)} "
          f"(mean {np.mean(frame_gauss):.0f})", flush=True)
    check(launches[1] == 0 and launches[3] == 0, f"the factory launched {launches}")
    tally_factory(launches)

    # again: caption_post_process first (it rewrites the vocabulary that
    # labeling reads), then the other seven at once in threads (each spawns
    # its workers; a worker's start is mostly its 7 s import of torch)
    before = factory_tree(data)
    t0 = time.perf_counter()
    pd.main(["--action", "caption_post_process", "--data_root", str(data)])
    again = [(a, *f) for a, *f in FACTORY_ACTIONS if a != "caption_post_process"]
    with spawned_workers_skip_this_script(), ThreadPoolExecutor(len(again)) as pool:
        runs = [pool.submit(pd.main, ["--action", a, "--data_root", str(data), *f])
                for a, *f in again]
        again_done = [r.result() for r in runs]
    check(all(len(d) == 2 for d in again_done), f"the second run's episodes {again_done}")
    after = factory_tree(data)
    rewritten = sorted(str(p.relative_to(data)) for p in after if after[p][0] != before.get(p, (0,))[0])
    same_bytes = {p: v[1] for p, v in after.items()} == {p: v[1] for p, v in before.items()}
    print(f"factory actions again: {time.perf_counter() - t0:.1f} s; files rewritten "
          f"{rewritten} (caption_post_process re-clusters by design), every file's bytes "
          f"unchanged: {same_bytes}", flush=True)
    check(same_bytes and set(rewritten) <= {"captions/labels.txt", "captions/all_captions.jsonl"},
          "a second run of the actions wrote something")
    check(factory_counts() == launches, "a second run of the actions launched a kernel")

    g = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    records = factory_kernel_checks(g, data, t0)
    print(f"factory kernel checks and times: {time.perf_counter() - t0:.1f} s", flush=True)

    # the kernels' other entry points, as a user of the ops calls them:
    # dynamic voxelization of every frame's cloud and the rasterizer's
    # gradient by autograd, on episode 0's data
    t0 = time.perf_counter()
    for k in FACTORY_KERNELS:
        k.launches = 0
    ep = data / "00000"
    clouds = pd.depth_unproject_backend(str(ep))["points"]
    for c in clouds:
        coors = voxelize_mod.voxelization(torch.tensor(c, device="cuda"), pd.VOXEL_SIZE,
                                          pd.POINT_CLOUD_RANGE, max_points=-1)
        check(coors.shape == (len(c), 3), "dynamic voxelization's shape")
    occ = dict(np.load(ep / "occupancy.npz"))
    pose0 = np.load(ep / "poses.npy")[0]
    settings = raster_mod.view_settings(pose0, FACTORY_K, FACTORY_RENDER)
    target = torch.tensor(np.load(ep / "render.npz")["depths"][:, 0], device="cuda")
    off = 0
    norms = []
    for f, n in enumerate(occ["frame_sizes"]):
        centers, feat, rot, scales, opac = pd.occupancy_to_gaussians(
            occ["coors"][off:off + n], occ["labels"][off:off + n], device="cuda")
        off += n
        means = centers.clone().requires_grad_(True)
        _, _, _, depth, alpha = raster_mod.rasterize(settings, means, torch.zeros_like(centers),
                                                     opac, scales, rot, feat)
        # the render's own depth moved 2%: a loss with a gradient
        loss = (depth / alpha.clamp(min=1e-6) - 1.02 * target[f]).square().mul(alpha > 0.1).mean()
        (grad,) = torch.autograd.grad(loss, means)
        norms.append(grad.norm().item())
    other = factory_counts()
    print(f"factory entry points (dynamic voxelization of {len(clouds)} clouds, the depth loss's "
          f"gradient through rasterize on {len(norms)} frames): {time.perf_counter() - t0:.1f} s, "
          f"launches {other}; gradient "
          f"norms {min(norms):.4g}-{max(norms):.4g}, all finite "
          f"{all(math.isfinite(x) for x in norms)}", flush=True)
    check(other == (0, FACTORY_FRAMES, FACTORY_FRAMES, FACTORY_FRAMES)
          and all(math.isfinite(x) and x > 0 for x in norms),
          f"the entry points' launches {other} or gradients {norms}")
    tally_factory(other)

    # encode_split on one episode, its depth and label latents from render.npz
    cfg = train_config(data, root / "out", [f"dataset.ori_size=[{FACTORY_RENDER[0]}, "
                                            f"{FACTORY_RENDER[1]}]"])
    torch.manual_seed(0)
    t0 = time.perf_counter()
    vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16)
    print(f"factory VAE built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    written = encode_mod.encode_split(cfg, vae, "train", max_samples=1, ref_nums=[1],
                                      encode_conds=True)
    out = data / "embeddings_full" / "train"
    kinds = sorted(Path(p).parent.name for p in written)
    print(f"factory encode_split (one slice, the factory's render.npz): {time.perf_counter() - t0:.1f}"
          f" s; wrote {kinds}", flush=True)
    check(kinds == ["depth_latents", "image_latents", "label_latents", "latents"],
          f"encode_split wrote {kinds}")
    for p in written:
        m = np.load(p)["arr_0"]
        check(m.shape[0] == 32 and np.isfinite(m).all(), f"{p}: moments {m.shape} not finite")
    del vae
    print(f"factory phase: {time.perf_counter() - t_phase:.1f} s; peak memory of this process "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return records


def tally_factory(launches) -> None:
    for i, n in enumerate(launches):
        FACTORY_LAUNCHES[i] += n


# -- phase 6: the model surface at full width -----------------------------------------

SURFACE_STEPS = 4  # DPM steps of (a) and (b)
SURFACE_5B_STEPS = 2
PAB_STEPS, PAB_SKIP = 8, 2  # (d): flags T T F F T F F T
VIEWS = 3
# launches of one forward, in KERNELS order: each MVBlock adds one attention, one
# modulate_norm (its adaLN never emits int8) and one gated residual to a DiTBlock's
MV_FORWARD = (60, 90, 150, 0, 0, 0, 0, 0, 0, 0)
MV_Q8_FORWARD = (0, 30, 150, 60, 60, 0, 0, 0, 0, 0)
ROPE_FORWARD = (28, 56, 56, 0, 0, 0, 0, 0, 0, 0)  # 3-chunk: 2 modulates, 2 residuals a block
FIVE_B_FORWARD = (42, 84, 168, 0, 0, 0, 0, 0, 0, 0)
# a PAB reuse step: no attention, norm1 computes its gates only (no modulate)
PAB_REUSE = (0, 30, 120, 0, 0, 0, 0, 0, 0, 0)
PAB_Q8_REUSE = (0, 0, 120, 0, 30, 0, 0, 0, 0, 0)
# the 1.4b scratch RoPE model (transformer/base_1.4b_480_320_rope.yaml), its widths
# passed explicitly (ROADMAP.md C, "config resolution")
ROPE_KEYS = ["transformer.num_attention_heads=28", "transformer.attention_head_dim=64",
             "transformer.num_layers=28", "transformer.use_rotary_positional_embeddings=true",
             "transformer.modulate_encoder_hidden_states=false"]
ROPE_1_4B = DiTConfig(num_attention_heads=28, attention_head_dim=64, num_layers=28,
                      in_channels=32, out_channels=16, text_embed_dim=4096, time_embed_dim=512,
                      sample_width=60, sample_height=40, sample_frames=17,
                      use_rotary_positional_embeddings=True)
FIVE_B = DiTConfig(num_attention_heads=48, attention_head_dim=64, num_layers=42, in_channels=32,
                   out_channels=16, text_embed_dim=4096, time_embed_dim=512, patch_size_t=2,
                   use_rotary_positional_embeddings=True, modulate_encoder_hidden_states=True,
                   joint_final_norm=True)
MULTIVIEW_2B = DiTConfig(num_attention_heads=30, attention_head_dim=64, num_layers=30,
                         in_channels=32, out_channels=16, text_embed_dim=4096,
                         time_embed_dim=512, modulate_encoder_hidden_states=True,
                         multiview=True)
# phase 5c's models (their constants above): stage 3 with phase 5's action-recon head
STAGE3 = dataclasses.replace(MULTIVIEW_2B, recon_action=True)
MULTIVIEW_REMAT = dataclasses.replace(MULTIVIEW_2B, num_layers=REMAT_LAYERS)
FIVE_B_CUT = dataclasses.replace(FIVE_B, num_layers=FIVE_B_LAYERS)


def tally(launches) -> None:
    """Add a main-path run's launch counts to the kernels line's."""
    for i, n in enumerate(launches):
        TOTAL_LAUNCHES[i] += n


def surface_kernel_checks(g):
    """Rows 2, 3, 6, 8 and 9 against their plain versions at the surface's
    shapes: the MVBlock's attention [13, 30, 2478, 64] (13 frames x (3 views x
    600 + 3 x 226 text)) and the 5b's [1, 48, 6826, 64] (11 x 600 + 226), the
    adaLN kernels at the 1.4b RoPE model's [13, 600, 1792] and the 5b's
    [11, 600, 3072]; untimed, the multiview DiTBlocks' (B = 3 views) attention
    [3, 30, 8026, 64], adaLN forwards and residual [39, 600, 1920] and text
    residual [3, 226, 1920], the MVBlock's adaLN and residual [3, 7800, 1920]
    and the 5b text stream's residual [1, 226, 3072]. Returns {kernel name:
    [records of the timed shapes]}."""
    rec = lambda r, shape: {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")} | {"shape": shape}
    out = {}
    for shape in ((13, 30, 2478), (1, 48, 6826)):
        r = check_attention(g, shape, timed=True)
        out.setdefault(r["name"], []).append(rec(r, [*shape, 64]))
        r, _ = check_attention_q8(g, shape, timed=True)
        out.setdefault(r["name"], []).append(rec(r, [*shape, 64]))
        torch.cuda.empty_cache()
    for R, S, D in ((13, 600, 1792), (11, 600, 3072)):
        for fn in (check_modulate_norm, check_gated_residual):
            r = fn(g, R, S, D, timed=True)
            out.setdefault(r["name"], []).append(rec(r, [R, S, D]))
    check_attention(g, (VIEWS, 30, 8026), timed=False)
    check_attention_q8(g, (VIEWS, 30, 8026), timed=False)
    torch.cuda.empty_cache()
    for R, S in ((VIEWS, 13 * 600), (VIEWS * 13, 600)):
        check_modulate_norm(g, R, S, 1920, timed=False)
        check_gated_residual(g, R, S, 1920, timed=False)
    check_modulate_norm_q8(g, VIEWS * 13, 600, 1920, timed=False)
    check_gated_residual(g, VIEWS, 226, 1920, timed=False)
    check_gated_residual(g, 1, 226, 3072, timed=False)
    for name, recs in out.items():
        for r in recs:
            print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                  f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
                  f"{r['library_ms']} ms", flush=True)
    return out


def tiny_surface_checks() -> None:
    """Tiny multiview (V = 2, bf16 and W8A8) and 1.5-family (patch_size_t 2,
    RoPE, joint final norm) ControlDiTs in bf16 on the card against the same
    weights in f32 on the CPU, at the bound of tiny_reference_checks."""
    from orv_tpu_torch.utils.embeddings import prepare_rotary_positional_embeddings

    base = dict(num_attention_heads=2, attention_head_dim=64, num_layers=2, in_channels=32,
                out_channels=16, text_embed_dim=32, time_embed_dim=64,
                modulate_encoder_hidden_states=True)
    gc_ = torch.Generator().manual_seed(3)
    for name, extra, frames, views, quant in (
            ("multiview bf16", dict(multiview=True), 3, 2, False),
            ("multiview W8A8", dict(multiview=True), 3, 2, True),
            ("5b-style (patch_size_t 2, RoPE, joint final norm)",
             dict(patch_size_t=2, use_rotary_positional_embeddings=True, joint_final_norm=True),
             4, 1, False)):
        cfg = DiTConfig(**base, **extra)
        torch.manual_seed(4)
        sd = ControlDiT(cfg, dtype=torch.float32, device="cpu").state_dict()
        for k in sd:  # the random init zeroes the MVBlocks' proj_out
            if k.startswith("mv_blocks.") and ".proj_out." in k:
                sd[k] = 0.05 * torch.randn(sd[k].shape, generator=gc_)
        kw = dict(quant=True, attn_impl="flash_q8") if quant else {}
        weights = quantize_linear_params(sd) if quant else sd
        x = torch.randn(2, views * frames, 32, 8, 16, generator=gc_)
        enc, t = torch.randn(2, 8, 32, generator=gc_), torch.tensor([500, 20])
        acts = torch.randn(2, 4 * frames - 1, 7, generator=gc_)
        rope = None
        if cfg.use_rotary_positional_embeddings:
            rope = prepare_rotary_positional_embeddings(64, 128, frames, patch_size_t=2,
                                                        device="cpu")
        outs = []
        for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
            model = ControlDiT(cfg, dtype=dt, device=dev, **kw)
            model.load_state_dict(weights, strict=True)
            to = lambda a: None if a is None else a.to(dev)
            with torch.inference_mode():
                outs.append(model(to(x), to(enc), to(t), actions=to(acts), num_views=views,
                                  image_rotary_emb=None if rope is None else tuple(map(to, rope))))
        agree(outs[1], outs[0], f"tiny ControlDiT {name}, card bf16 kernels vs CPU f32 plain")


def tiny_pab_cache_check() -> None:
    """PAB's attention cache on the card, bf16 and W8A8, on a tiny RoPE model
    whose weights are all perturbed (0.05 noise: the gates let attention
    through). The cache a full forward collects, fed back on the same inputs
    after a forward on others, must give the full forward's output (mean
    error at most 0.05 of a stale cache's, max 1e-2 of the range) with no
    attention launched; a cache from other inputs must move the output (mean
    2e-3 of the range or more; measured on the CPU 1.2e-2); and the reuse
    forward agrees with the CPU's in f32."""
    from orv_tpu_torch.utils.embeddings import prepare_rotary_positional_embeddings

    cfg = DiTConfig(num_attention_heads=2, attention_head_dim=64, num_layers=2, in_channels=32,
                    out_channels=16, text_embed_dim=32, time_embed_dim=64,
                    modulate_encoder_hidden_states=True, use_rotary_positional_embeddings=True)
    gc_ = torch.Generator().manual_seed(6)
    torch.manual_seed(7)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gc_)
          for k, v in ControlDiT(cfg, dtype=torch.float32, device="cpu").state_dict().items()}
    xa, xb = (torch.randn(1, 3, 32, 8, 16, generator=gc_) for _ in range(2))
    enc, acts = torch.randn(1, 8, 32, generator=gc_), torch.randn(1, 11, 7, generator=gc_)
    rope = prepare_rotary_positional_embeddings(64, 128, 3, device="cpu")
    for name, kw in (("bf16", {}), ("W8A8", dict(quant=True, attn_impl="flash_q8"))):
        weights = quantize_linear_params(sd) if kw else sd
        outs = {}
        for dev, dt in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
            model = ControlDiT(cfg, dtype=dt, device=dev, **kw)
            model.load_state_dict(weights, strict=True)
            run = lambda x, t, **k: model(
                x.to(dev), enc.to(dev), torch.tensor([t], device=dev), actions=acts.to(dev),
                image_rotary_emb=tuple(a.to(dev) for a in rope), **k)
            with torch.inference_mode():
                full, cache = run(xa, 500, collect_attn=True)
                _, other = run(xb, 999, collect_attn=True)
                reset_counts()
                reuse = run(xa, 500, attn_cache=cache)
                got = counts()
                stale = run(xa, 500, attn_cache=other)
            outs[dev] = full, reuse, stale
        full, reuse, stale = (o.float().cpu() for o in outs["cuda"])
        rng = full.abs().max().item()
        e_reuse, e_stale = (reuse - full).abs(), (stale - full).abs()
        print(f"tiny PAB cache {name} on the card: the cache fed back, max err "
              f"{e_reuse.max().item() / rng:.3g} and mean {e_reuse.mean().item() / rng:.3g} of the "
              f"range; a stale cache, mean {e_stale.mean().item() / rng:.3g}; attention launches "
              f"of the reuse forward {got[0] + got[3]}", flush=True)
        check(got[0] + got[3] == 0, f"a PAB reuse forward launched attention: {got}")
        check(e_reuse.max().item() <= 1e-2 * rng
              and e_reuse.mean().item() <= 0.05 * e_stale.mean().item()
              and e_stale.mean().item() >= 2e-3 * rng,
              f"the {name} PAB cache fed back does not give the full forward, or a stale one does")
        agree(outs["cuda"][1], outs["cpu"][1], f"tiny PAB reuse forward {name}, card bf16 "
              f"kernels vs CPU f32 plain")


def write_surface_data(root: Path, frames: int = 49) -> None:
    """One bridgev2 episode of VIEWS views from a numpy seed, in the eval
    configs' layout: annotation JSON, per view v the moments of the 49-frame
    clip [32, 13, 40, 60] and of its first frame (`*_{v}.npz`; the
    single-view dataset reads view 0), the empty prompt's embeds
    [226, 4096]."""
    rng = np.random.default_rng(5)
    emb = root / "embeddings_full" / "test"
    for d in ("latents", "image_latents", "prompt_embeds"):
        (emb / d).mkdir(parents=True)
    (root / "annotations" / "test").mkdir(parents=True)
    ann = dict(episode_id="00000", texts=["stack the blocks"],
               state=rng.uniform(-0.5, 0.5, (frames, 7)).tolist(),
               continuous_gripper_state=rng.uniform(0, 1, frames).tolist())
    (root / "annotations" / "test" / "00000.json").write_text(json.dumps(ann))
    F, C, H, W = LATENT
    for v in range(VIEWS):
        for kind, f in (("latents", F), ("image_latents", 1)):
            np.savez(emb / kind / f"00000_00_{frames:02d}_{v}.npz",
                     rng.normal(size=(2 * C, f, H, W)).astype(np.float32))
    np.savez(emb / "prompt_embeds" / "empty.npz",
             (0.1 * rng.standard_normal((226, 4096))).astype(np.float32))


class LogitWatch:
    """Records the largest attention logit (`max_logit`) of every static-max
    attention the DiT layers launch while it is on: RoPE rotates the
    qk-normed q and k, which keeps their norms, so the static bound of 24
    should hold; this checks it on the card."""

    def __init__(self):
        from orv_tpu_torch.models import layers

        self.layers, self.real, self.logits = layers, layers.flash_attention, []

    def __enter__(self):
        def watched(q, k, v, static_max=None):
            with torch.no_grad():
                self.logits.append(max_logit(q, k))
            return self.real(q, k, v, static_max=static_max)
        self.layers.flash_attention = watched
        return self

    def __exit__(self, *exc):
        self.layers.flash_attention = self.real


class ShapeLog:
    """Records, while it is on, the shape of every call the DiT layers make
    to a forward kernel (`models/layers.py` binds the five wrappers by
    name), of every flash backward (`ops/attention.py:flash_attention_bwd`,
    which the Function looks up by name) and of every adaLN backward (the
    Functions' `backward`, wrapped on the class: the kernels' wrappers count
    their launches under their module names, which must stay as they are),
    keyed as `CHECKED` is: attention by [B, H, Sq], Skv and its static
    bound; the adaLN forwards by [R, S, D] and whether the norm params are
    f32; the gated residual, and the adaLN backwards, by [R, S, D] (their
    output gradient's shape); the flash backward by [B, H, Sq] and Skv."""

    NAMES = ("flash_attention", "flash_attention_q8", "modulate_norm", "modulate_norm_q8",
             "gated_residual")
    BWD = {adaln._ModulateNorm: "modulate_norm_bwd", adaln._GatedResidual: "gated_residual_bwd"}

    def __init__(self):
        from orv_tpu_torch.models import layers

        self.keys = set()
        self.real = {(layers, n): getattr(layers, n) for n in self.NAMES}
        self.real[attention, "flash_attention_bwd"] = attention.flash_attention_bwd
        self.real_bwd = {cls: cls.backward for cls in self.BWD}

    @staticmethod
    def key(name, args, kwargs):
        x = args[0]
        if name == "flash_attention":
            return name, tuple(x.shape[:3]), args[1].shape[2], kwargs.get("static_max")
        if name in ("flash_attention_q8", "flash_attention_bwd"):
            return name, tuple(x.shape[:3]), args[1].shape[2]
        if name == "gated_residual":
            return name, tuple(x.shape)
        return name, tuple(x.shape), args[3].dtype == torch.float32

    def __enter__(self):
        def logged(name, real):
            def run(*args, **kwargs):
                self.keys.add(self.key(name, args, kwargs))
                return real(*args, **kwargs)
            return run

        def logged_bwd(name, real):
            def backward(ctx, dout):  # ctx.saved_tensors may be read once only (remat)
                self.keys.add((name, tuple(dout.shape)))
                return real(ctx, dout)
            return staticmethod(backward)
        for (m, n), real in self.real.items():
            setattr(m, n, logged(n, real))
        for cls, real in self.real_bwd.items():
            cls.backward = logged_bwd(self.BWD[cls], real)
        return self

    def __exit__(self, *exc):
        for (m, n), real in self.real.items():
            setattr(m, n, real)
        for cls, real in self.real_bwd.items():
            cls.backward = staticmethod(real)


def check_logged_shapes(g, keys) -> None:
    """Phase 6b: each kernel, forward and backward, against its plain
    version at every shape of `keys` (a ShapeLog's) that phase 2, 5c or 6
    did not check."""
    todo = sorted(keys - CHECKED, key=str)
    print(f"main-path shapes: {len(keys)} (kernel, shape) pairs logged, {len(keys) - len(todo)} "
          f"checked in phase 2, 5c or 6, {len(todo)} checked now", flush=True)
    for key in todo:
        name, shape = key[0], key[1]
        if name == "flash_attention":
            check(key[2:] == (shape[2], 24.0), f"no plain-version check for {key}")
            check_attention(g, shape, timed=False)
        elif name == "flash_attention_bwd":
            check_attention_bwd(g, shape, False, timed=False, skv=key[2])
        elif name == "modulate_norm_bwd":
            check_modulate_norm_bwd(g, *shape, timed=False)
        elif name == "gated_residual_bwd":
            check_gated_residual_bwd(g, *shape, timed=False)
        elif name == "flash_attention_q8":
            check(key[2] == shape[2], f"no plain-version check for {key}")
            check_attention_q8(g, shape, timed=False)
        elif name == "gated_residual":
            check_gated_residual(g, *shape, timed=False)
        else:
            fn = check_modulate_norm if name == "modulate_norm" else check_modulate_norm_q8
            fn(g, *shape, timed=False, norm_f32=key[2])
        torch.cuda.empty_cache()
    check(keys <= CHECKED, f"main-path shapes left unchecked: {sorted(keys - CHECKED, key=str)}")


def surface_phase(g, root: Path):
    """Phase 6: the model surface at full width (module docstring). Returns
    the records of rows 2, 3, 6 and 9 at its shapes."""
    t_phase = time.perf_counter()
    new_shapes = surface_kernel_checks(g)
    gc.collect()
    torch.cuda.empty_cache()
    tiny_surface_checks()
    tiny_pab_cache_check()
    write_surface_data(root / "data")
    F, C, H, W = LATENT
    times = StageTimes()
    built = {}  # the model evaluate builds last, for the logit check
    real_build = evaluate_mod.build_serving_model

    def keep_model(*args, **kwargs):
        built["model"] = real_build(*args, **kwargs)
        return built["model"]

    evaluate_mod.build_serving_model = keep_model
    times.patch()
    try:
        torch.manual_seed(0)
        vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16)  # f32 parameters, as evaluate loads

        def eval_cfg(name, dataset_type, out, *extra):
            return load_config(str(default_config_dir() / "base_eval.yaml"),
                               str(default_config_dir() / "eval" / name), dataset_type,
                               overrides=[f"dataset.data_root={root / 'data'}",
                                          "dataset.sequence_length=48",
                                          "transformer.pretrained_name_or_path=null",
                                          f"evaluation.num_inference_steps={SURFACE_STEPS}",
                                          "evaluation.batch_size=1", "evaluation.save_gif=false",
                                          f"evaluation.output_dir={root / out}", *extra])

        # (a) multiview serving: 3 views stacked on the frame axis, 30 MVBlocks
        for label, extra, per_step in (("bf16", (), MV_FORWARD),
                                       ("W8A8", ("evaluation.quant=true",), MV_Q8_FORWARD)):
            cfg = eval_cfg("eval_traj_image_2b_multiview.yaml", "bridgev2_2", f"mv_{label}",
                           *extra)
            check(build_dit_config(cfg) == MULTIVIEW_2B,
                  f"the multiview eval config builds {build_dit_config(cfg)}")
            _, got = serving_step(
                f"evaluate multiview {label} ({VIEWS} views x 49 frames, latents "
                f"[1, {VIEWS}x{F}, {C}, {H}, {W}], 30 DiTBlocks + 30 MVBlocks, MVBlock attention "
                f"[{F}, 30, {VIEWS * (600 + 226)}, 64])", times, lambda: evaluate(cfg, vae=vae),
                SURFACE_STEPS)
            check(got == tuple(SURFACE_STEPS * n for n in per_step),
                  f"multiview {label} launch counts {got}, not {SURFACE_STEPS} x {per_step}")
            lat = np.load(root / f"mv_{label}" / "00000_000_latents.npz")["arr_0"]
            clip = read_video(str(root / f"mv_{label}" / "00000_000.mp4"))
            print(f"  multiview {label}: latents {list(lat.shape)}, clip {list(clip.shape)} (the "
                  f"views' {VIEWS * F} latent frames decoded as one video, as the JAX package's "
                  f"evaluate does)", flush=True)
            check(lat.shape == (VIEWS * F, C, H, W) and np.isfinite(lat).all(),
                  f"multiview {label} latents {lat.shape}")
            check(clip.shape == (1 + 4 * (VIEWS * F - 1), 320, 480, 3),
                  f"multiview {label} clip {clip.shape}")
        built.clear()

        # (b) the 1.4b RoPE model (28 x 28 x 64, 3-chunk adaLN, 1792 wide)
        cfg = eval_cfg("eval_traj_image_1.4b_scratch.yaml", "bridgev2", "rope", *ROPE_KEYS)
        check(build_dit_config(cfg) == ROPE_1_4B, f"the RoPE eval config builds "
                                                  f"{build_dit_config(cfg)}")
        _, got = serving_step("evaluate 1.4b RoPE (28 x 28 x 64, 3-chunk, 49 frames)", times,
                              lambda: evaluate(cfg, vae=vae), SURFACE_STEPS)
        check(got == tuple(SURFACE_STEPS * n for n in ROPE_FORWARD),
              f"RoPE launch counts {got}, not {SURFACE_STEPS} x {ROPE_FORWARD}")
        lat = np.load(root / "rope" / "00000_000_latents.npz")["arr_0"]
        check(lat.shape == (F, C, H, W) and np.isfinite(lat).all(), f"RoPE latents {lat.shape}")
        check(read_video(str(root / "rope" / "00000_000.mp4")).shape == (49, 320, 480, 3),
              "the RoPE clip")
        model = built.pop("model")
        rope = evaluate_mod.rotary_tables(model.config, F, H, W, "cuda")
        x = torch.randn(1, F, 2 * C, H, W, device="cuda", generator=g).bfloat16()
        with LogitWatch() as watch, torch.inference_mode():
            model(x, torch.zeros(1, 226, 4096, device="cuda"), torch.full((1,), 999, device="cuda"),
                  actions=torch.zeros(1, 48, 7, device="cuda"), image_rotary_emb=rope)
        print(f"  RoPE 1.4b: largest attention logit over its {len(watch.logits)} layers "
              f"{max(watch.logits):.2f} (the static bound is 24)", flush=True)
        check(len(watch.logits) == 28 and max(watch.logits) < 24.0,
              f"a RoPE model's logits {max(watch.logits)} pass the static bound")
        del model, vae
    finally:
        times.restore()
        evaluate_mod.build_serving_model = real_build
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the 5b family: 48 x 64 over 42 layers, patch_size_t 2, RoPE, joint final norm,
    # 22 latent frames (the 81-frame clip's 21, padded to a multiple of 2 as the loss pads)
    cfg = load_config(str(default_config_dir() / "base_train.yaml"),
                      str(default_config_dir() / "experiments" / "traj_image_5b_finetune.yaml"),
                      "bridgev2", overrides=["transformer.pretrained_name_or_path=null"])
    check(build_dit_config(cfg) == FIVE_B, f"the 5b recipe builds {build_dit_config(cfg)}")
    torch.cuda.reset_peak_memory_stats()
    torch.manual_seed(0)
    t0 = time.perf_counter()
    model = ControlDiT(FIVE_B, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"ControlDiT 5b: {n_params / 1e9:.3f} B params, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    F5 = 22
    rand = lambda *s, dt=torch.bfloat16: torch.randn(*s, device="cuda", generator=g).to(dt)
    actions = torch.cat([rand(1, 80, 7), torch.zeros(1, 4, 7, device="cuda").bfloat16()], 1)
    rope = evaluate_mod.rotary_tables(FIVE_B, F5, H, W, "cuda")
    sampler = make_sampler(model, make_schedule(), SamplerConfig(
        num_inference_steps=SURFACE_5B_STEPS))
    lat0, img, enc = rand(1, F5, C, H, W, dt=torch.float32), rand(1, F5, C, H, W), rand(1, 226, 4096)
    run = lambda: sampler(lat0, img, enc, generator=torch.Generator("cuda").manual_seed(12),
                          actions=actions, image_rotary_emb=rope)
    run()  # the first call's costs
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = run()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / SURFACE_5B_STEPS
    got = counts()
    tally(got)
    print(f"surface 5b make_sampler: {SURFACE_5B_STEPS} DPM steps over [1, {F5}, {C}, {H}, {W}] "
          f"({F5 // 2 * 600 + 226} joint tokens), second call {step_s:.4f} s/step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {got}", flush=True)
    check(got == tuple(SURFACE_5B_STEPS * n for n in FIVE_B_FORWARD),
          f"5b launch counts {got}, not {SURFACE_5B_STEPS} x {FIVE_B_FORWARD}")
    check(tuple(lat.shape) == (1, F5, C, H, W) and bool(torch.isfinite(lat).all()),
          "the 5b latents are not finite or of the wrong shape")
    x = torch.cat([lat0.bfloat16(), img], dim=2)
    with LogitWatch() as watch, torch.inference_mode():
        model(x, enc, torch.full((1,), 999, device="cuda"), actions=actions,
              image_rotary_emb=rope)
    print(f"  5b: largest attention logit over its {len(watch.logits)} layers "
          f"{max(watch.logits):.2f} (the static bound is 24)", flush=True)
    check(len(watch.logits) == 42 and max(watch.logits) < 24.0,
          f"the 5b model's logits {max(watch.logits)} pass the static bound")
    del model, sampler, x, lat
    gc.collect()
    torch.cuda.empty_cache()

    # (d) PAB on the flagship, bf16 then W8A8: 8 DPM steps with pab_skip=2, then without
    from orv_tpu_torch.pipelines.sample import pab_full_flags

    flags = pab_full_flags(PAB_STEPS, PAB_SKIP, 0.1, 0.85)
    n_full = int(flags.sum())
    print(f"surface PAB: flags {''.join('T' if f else 'F' for f in flags)}", flush=True)
    torch.manual_seed(0)
    dit = ControlDiT(FLAGSHIP, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    inp = flagship_inputs(g)
    pab_s = {}
    for label, full_counts, reuse_counts in (("bf16", BF16_FORWARD, PAB_REUSE),
                                             ("W8A8", Q8_FORWARD, PAB_Q8_REUSE)):
        if label == "W8A8":
            quantize_model_(dit)
        outs = {}
        # in turns, PAB, exact, exact, PAB: the model's first calls (new blocks
        # after quantize_model_ too) fall on both sides alike
        for skip in (PAB_SKIP, 0, 0, PAB_SKIP):
            sampler = make_sampler(dit, make_schedule(), SamplerConfig(
                num_inference_steps=PAB_STEPS, pab_skip=skip))
            run = lambda: sampler(inp["lat"], inp["img"], inp["enc"],
                                  generator=torch.Generator("cuda").manual_seed(13),
                                  actions=inp["actions"], depths=inp["depths"],
                                  labels=inp["labels"])
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[skip] = run()
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / PAB_STEPS
            got = counts()
            tally(got)
            pab_s.setdefault((label, skip), []).append(step_s)
            att = got[0] + got[3]
            print(f"surface PAB {label} pab_skip={skip}: {PAB_STEPS} DPM steps {step_s:.4f} "
                  f"s/step, attention launches {att}, launches {got}, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
            n_reuse = PAB_STEPS - n_full if skip else 0
            want = tuple((PAB_STEPS - n_reuse) * f + n_reuse * r
                         for f, r in zip(full_counts, reuse_counts))
            check(got == want, f"PAB {label} pab_skip={skip} launch counts {got}, not {want}")
            check(bool(torch.isfinite(outs[skip]).all()), f"PAB {label} latents not finite")
        rel = ((outs[PAB_SKIP] - outs[0]).abs().max() / outs[0].abs().max()).item()
        with_pab, without = (sum(pab_s[label, k]) / 2 for k in (PAB_SKIP, 0))
        print(f"surface PAB {label}: s/step with PAB {with_pab:.4f}, without {without:.4f} (means "
              f"of the two turns), ratio {with_pab / without:.3f}; PAB latents from the exact "
              f"sampler's: max abs difference {rel:.3g} of the range (bound 2e-3 to 2.5e-2)",
              flush=True)
        check(2e-3 <= rel <= 2.5e-2, f"PAB {label} latents {rel:.3g} of the range from the exact "
                                     f"sampler's, outside 2e-3 to 2.5e-2")
    del dit, inp, outs
    print(f"surface phase total: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return new_shapes


# -- phase 6a: the synthetic PAB quality harness on the card ---------------------------

# a short budget of scripts/pab_quality_synthetic_torch.py: train steps, DPM steps, clips,
# and its one cell (pab_skip, window)
HARNESS_STEPS, HARNESS_SAMPLE_STEPS, HARNESS_CLIPS = 20, 6, 2
HARNESS_SKIP, HARNESS_WINDOW = 2, (0.1, 0.85)


def load_script(name: str):
    """A module of scripts/ beside this file, loaded from its path."""
    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pab_quality_phase() -> None:
    """Phase 6a: the synthetic PAB quality harness's `run` on the card at a
    short budget, its one cell in both sampler groups: every report field
    there and finite, the launches of rows 2, 4-7, 9 and 10 exactly the
    overfit's micro-steps plus the renders' full and reuse forwards, the
    overfit's logged loss falling; then, on the model that `run` trained, a
    PAB sampler with an empty window (pab_start == pab_end) bitwise the
    exact one."""
    from orv_tpu_torch.pipelines.sample import pab_full_flags

    t_phase = time.perf_counter()
    harness = load_script("pab_quality_synthetic_torch")
    cuda = torch.device("cuda")
    cfg, _ = harness.model_setup(cuda)
    built = []  # what `run`'s one overfit returns: (model, clip, img_lat, enc, losses)
    build = harness.build_overfit_model
    harness.build_overfit_model = lambda *a, **k: built.append(build(*a, **k)) or built[-1]
    reset_counts()
    report = harness.run(HARNESS_STEPS, HARNESS_SAMPLE_STEPS, HARNESS_CLIPS,
                         skips=(HARNESS_SKIP,), windows=(HARNESS_WINDOW,), device=cuda)
    torch.cuda.synchronize()
    got = counts()
    tally(got)
    L = cfg.num_layers
    n_full = int(pab_full_flags(HARNESS_SAMPLE_STEPS, HARNESS_SKIP, *HARNESS_WINDOW).sum())
    full = HARNESS_SAMPLE_STEPS + n_full  # forwards a clip a group: the exact render's, PAB's
    reuse = HARNESS_SAMPLE_STEPS - n_full
    forward = tuple(2 * HARNESS_CLIPS * (full * f + reuse * r) * L // FLAGSHIP.num_layers
                    for f, r in zip(BF16_FORWARD, PAB_REUSE))
    want = tuple(HARNESS_STEPS * n + f for n, f in zip(train_micro_step_counts(L), forward))
    print(f"pab quality harness: launches {got} (want {want})", flush=True)
    check(got == want, f"pab quality harness launch counts {got}, not {want}")
    check((report["device"], report["compute_dtype"], report["attention_head_dim"])
          == ("cuda", "bfloat16", 64) and bool(report["card"]),
          f"pab quality harness report names {report['device']}, {report['compute_dtype']}, "
          f"{report['attention_head_dim']}, {report['card']}")
    numbers = [report["final_train_loss"], report["recon_psnr_exact"]]
    for group in ("stochastic_dpm", "deterministic"):
        numbers.append(report[group]["recon_psnr_exact"])
        (cell,) = report[group]["cells"]
        check(cell["pab_skip"] == HARNESS_SKIP and cell["window"] == list(HARNESS_WINDOW)
              and cell["safe"] == (cell["pab_vs_exact_psnr"]
                                   >= report[group]["recon_psnr_exact"] + 6.0),
              f"pab quality harness cell {cell}")
        numbers += [cell[k] for k in ("recon_psnr_pab", "pab_vs_exact_psnr", "frechet_rp")]
    check(all(math.isfinite(x) for x in numbers), f"pab quality harness report {report}")

    (model, _, img_lat, enc, losses), = built
    late = float(np.mean(losses[len(losses) // 2:]))
    check(late < losses[0], f"the overfit's loss does not fall: {losses}")
    exact, empty = (harness.render(model, make_schedule(), SamplerConfig(
        num_inference_steps=HARNESS_SAMPLE_STEPS, **kw), img_lat, enc, 1)[0]
        for kw in ({}, dict(pab_skip=HARNESS_SKIP, pab_start=0.5, pab_end=0.5)))
    check(np.array_equal(exact, empty), "a PAB sampler with an empty window differs from the "
                                        "exact sampler on the card")
    print(f"pab quality harness ({HARNESS_STEPS} train steps, {HARNESS_SAMPLE_STEPS} DPM steps, "
          f"{HARNESS_CLIPS} clips, bf16, heads of 64): final loss "
          f"{report['final_train_loss']:.4f}, overfit loss {losses[0]:.4f} -> mean {late:.4f} "
          f"over the second half; deterministic recon PSNR "
          f"{report['deterministic']['recon_psnr_exact']:.2f} dB, PAB vs exact "
          f"{report['deterministic']['cells'][0]['pab_vs_exact_psnr']:.2f} dB; empty window "
          f"bitwise the exact sampler; phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def ring_phase(g, dit, inp, x, t, v_resident) -> None:
    """Phase 3b: the ring through LocalRing(SP), every rank a thread on the
    one card."""
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
    tally(ring_counts)
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
    tally(got)
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
    tally(got)
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
    # the adaLN backwards: a row group's last tile ragged (12- and 8-row
    # tiles at S 599 and 601), the 5b family's width and the widest, then
    # the training shapes
    for R, S, D in ((3, 300, 1920), (5, 599, 1920), (5, 601, 1920), (4, 600, 3072),
                    (2, 77, 4096)):
        check_modulate_norm_bwd(g, R, S, D, timed=False)
    for R, S, D in ((3, 300, 1920), (5, 599, 1920), (5, 601, 1920), (1, 226, 1920)):
        check_gated_residual_bwd(g, R, S, D, timed=False)
    check_attention_bwd(g, (1, 30, 3226), True, timed=False)
    bwd_records = check_attention_bwd(g, (1, 30, 3226), False, timed=True)
    records += bwd_records
    records.append(check_modulate_norm_bwd(g, 5, 600, 1920, timed=True))
    records.append(check_gated_residual_bwd(g, 5, 600, 1920, timed=True))
    records[-1]["text_ms"] = time_gated_residual_bwd_text(g)
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
    resume_root = Path(tempfile.mkdtemp(prefix="orv_resume_"))
    try:
        tiny_resume_check(resume_root)
    finally:
        shutil.rmtree(resume_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()  # from here on: the main path's memory
    shape_log = ShapeLog().__enter__()  # and its kernels' shapes, up to phase 6b
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
    tally(got)
    print(f"ControlDiT forward: {fwd_s:.3f} s (first call), out {list(v.shape)}, launches "
          f"in KERNELS order = {got}", flush=True)
    check(tuple(v.shape) == (1, *LATENT) and bool(torch.isfinite(v).all()),
          "flagship DiT output is not finite or of the wrong shape")
    check(got == BF16_FORWARD, f"launch counts {got} != {BF16_FORWARD}")

    # 3b. the ring: attention, then the same DiT at sp=4, on the one card
    ring_phase(g, dit, inp, x, t, v)
    torch.cuda.empty_cache()

    # 4. generation through the entry points: bf16, then the same DiT in W8A8
    vae = CausalVAE(VAEConfig(), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    bf16_step = generate(dit, vae, inp, "bf16", BF16_FORWARD)
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
    tally(got)
    print(f"ControlDiT W8A8 forward: {fwd_s:.3f} s (first call), launches {got}", flush=True)
    check(tuple(v.shape) == (1, *LATENT) and bool(torch.isfinite(v).all()),
          "flagship W8A8 DiT output is not finite or of the wrong shape")
    check(got == Q8_FORWARD, f"W8A8 launch counts {got} != {Q8_FORWARD}")
    q8_step = generate(dit, vae, inp, "W8A8", Q8_FORWARD)
    print(f"s/step side by side: bf16 {bf16_step:.4f}, W8A8 {q8_step:.4f}", flush=True)

    # 4b. the serving entry points at full width, phase 4's models freed first
    del dit, vae, inp, x, t, v
    serving_root = Path(tempfile.mkdtemp(prefix="orv_serving_"))
    try:
        serving_phase(serving_root)
    finally:
        shutil.rmtree(serving_root, ignore_errors=True)

    # 4c. the offline path: raw episodes -> latents -> train, T5, FID/FVD
    gc.collect()
    torch.cuda.empty_cache()
    offline_root = Path(tempfile.mkdtemp(prefix="orv_offline_"))
    try:
        offline_phase(offline_root)
    finally:
        shutil.rmtree(offline_root, ignore_errors=True)

    # 4d. the data factory: depth episodes -> occupancy -> condition maps -> latents
    gc.collect()
    torch.cuda.empty_cache()
    factory_root = Path(tempfile.mkdtemp(prefix="orv_factory_"))
    try:
        factory_records = factory_phase(factory_root)
    finally:
        shutil.rmtree(factory_root, ignore_errors=True)

    # 5. training through the entry point at full width, the serving models freed first;
    # 5c. the model surface's training side, phase 5's state freed, from its export
    gc.collect()
    torch.cuda.empty_cache()
    train_root = Path(tempfile.mkdtemp(prefix="orv_train_"))
    try:
        train_phase(train_root)
        shutil.rmtree(train_root / "out" / "run" / "checkpoints")
        gc.collect()
        torch.cuda.empty_cache()
        train_shapes = surface_train_phase(g, train_root, train_root / "out" / "run" / "checkpoint")
    finally:
        shutil.rmtree(train_root, ignore_errors=True)

    # 5d. context parallelism: the ring under grad, train and evaluate at sp=2, the
    # ranks as processes on the one card
    gc.collect()
    torch.cuda.empty_cache()
    sp_root = Path(tempfile.mkdtemp(prefix="orv_sp_"))
    try:
        sp_phase(sp_root)
    finally:
        shutil.rmtree(sp_root, ignore_errors=True)

    # 5e. data and model parallelism: train at dp2 x tp2, fsdp2 x pp2, pp2 x tp2 and
    # fsdp2 x sp2, evaluate at dp2 x tp2, the ranks as processes on the one card
    gc.collect()
    torch.cuda.empty_cache()
    mesh_root = Path(tempfile.mkdtemp(prefix="orv_mesh_"))
    try:
        mesh_phase(mesh_root, shape_log.keys)
    finally:
        shutil.rmtree(mesh_root, ignore_errors=True)

    # 5f. the grain loader's order without grain, with workers, and train through it
    gc.collect()
    torch.cuda.empty_cache()
    grain_root = Path(tempfile.mkdtemp(prefix="orv_grain_"))
    try:
        grain_phase(grain_root)
    finally:
        shutil.rmtree(grain_root, ignore_errors=True)

    # 6. the model surface at full width, the training state freed first
    gc.collect()
    torch.cuda.empty_cache()
    surface_root = Path(tempfile.mkdtemp(prefix="orv_surface_"))
    try:
        surface_shapes = surface_phase(g, surface_root)
    finally:
        shutil.rmtree(surface_root, ignore_errors=True)

    # 6a. the synthetic PAB quality harness at a short budget
    gc.collect()
    torch.cuda.empty_cache()
    pab_quality_phase()
    launches = tuple(TOTAL_LAUNCHES)

    # 6b. every forward kernel against its plain version at the main path's shapes
    shape_log.__exit__()
    gc.collect()
    torch.cuda.empty_cache()
    check_logged_shapes(g, shape_log.keys)
    check(all(launches), f"a kernel was never launched on the main path: {launches}")

    # 7. card, kernels line, result line
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    for r, n in zip(records, launches):
        r["launches"] = n
        r["surface_shapes"] = surface_shapes.get(r["name"], [])
        r["surface_train_shapes"] = train_shapes.get(r["name"], [])
    for r, n in zip(factory_records, FACTORY_LAUNCHES):
        r["launches"] = n
    check(all(FACTORY_LAUNCHES), f"a factory kernel was never launched: {FACTORY_LAUNCHES}")
    print(json.dumps({"kernels": records + factory_records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
