"""orv_tpu_torch — the PyTorch/CUDA port of orv_tpu for one NVIDIA H100.

Mirrors `orv_tpu`'s layout and public names; imports `torch`, never `jax`
or `orv_tpu`. Every Pallas kernel on the ported path is a hand-written CUDA
kernel for Hopper (`ops/csrc/`), built at first use; each has a plain
PyTorch version beside it that the CPU path and the tests use.

  ops        — kernels + plain versions (flash attention forward and backward,
               adaLN and gated residual forward and backward)
  utils      — device policy, embeddings
  schedulers — DDIM / DPM-solver++ steps
  models     — ControlDiT, causal VAE (decode side), weight bridge
  pipelines  — the sampler
  parallel   — the training step (diffusion loss; AdamW, CAME, prodigy; make_train_step)

Entry points (`ControlDiT`, `CausalVAE`, `make_sampler`, `decode_chunked`,
`make_train_step`) run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
