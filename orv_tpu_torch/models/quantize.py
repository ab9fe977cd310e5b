"""Post-training int8 quantization of the DiT's block linears (W8A8).

Counterpart of `orv_tpu/models/quantize.py`. Inside every transformer block
the attention projections (`attn1.to_q`, `attn1.to_k`, `attn1.to_v`,
`attn1.to_out.0`) and both feed-forward matmuls (`ff.net.0.proj`,
`ff.net.2`) become int8 weights with one scale per output channel, and so
do a multiview model's MVBlock attention projections (the JAX package's
rule goes by layer name); everything else (embeddings, adaLN modulation,
the MVBlock's `proj_out`, the output norm and projection) stays as it is. Activations are quantized per token at
run time by `Int8Dense` (models/layers.py).

State-dict names: the float `<layer>.weight` [out, in] of each of those
layers is replaced by
  `<layer>.weight_q8`    int8 [out, in]
  `<layer>.weight_scale` f32 [out], max(max|w[o, :]|, 1e-8) / 127,
with `weight_q8 = round_half_even(w / weight_scale[:, None])`, computed from
the weight in f32 exactly as the JAX package computes it (clamp, then
divide). `<layer>.bias` is kept in its dtype. A JAX tree quantized by
`orv_tpu.models.quantize.quantize_linear_params` carries over to the same
names through `models/weights.py:dit_params_from_jax`.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

# the quantized layers, relative to a transformer block
QUANT_LAYER_NAMES = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0",
                     "ff.net.0.proj", "ff.net.2")
_QUANT_WEIGHT = re.compile(r"(^|\.)(" + "|".join(map(re.escape, QUANT_LAYER_NAMES))
                           + r")\.weight$")


def quantize_linear_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ControlDiT (or DiTBlock) state dict -> the state dict its
    `quant=True` counterpart loads: the block linears of QUANT_LAYER_NAMES
    quantized, every other entry passed through."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if _QUANT_WEIGHT.search(key):
            w = value.float()
            scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
            stem = key[: -len("weight")]
            out[stem + "weight_q8"] = torch.round(w / scale[:, None]).to(torch.int8)
            out[stem + "weight_scale"] = scale
        else:
            out[key] = value
    return out


@torch.no_grad()
def quantize_model_(model):
    """Turn a bf16 `ControlDiT` into its W8A8 counterpart in place (the
    model `ControlDiT(quant=True, attn_impl="flash_q8")` loading
    `quantize_linear_params` of its state dict), block by block: only one
    block's weights are held twice at any time. Returns the model."""
    stacks = [(model.transformer_blocks, model.make_block)]
    if hasattr(model, "mv_blocks"):
        stacks.append((model.mv_blocks, model.make_mv_block))
    for blocks, make in stacks:
        for i in model.layers:  # a pipeline stage holds some layers only
            old = blocks[i]
            new = make(True, next(old.parameters()).device)
            new.load_state_dict(quantize_linear_params(old.state_dict()), strict=True)
            blocks[i] = new
    model.quant, model.attn_impl = True, "flash_q8"
    return model
