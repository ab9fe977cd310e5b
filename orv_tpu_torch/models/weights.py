"""Weight bridge: the JAX package's parameter trees -> the port's state dicts.

The port's module names follow the diffusers CogVideoX keys, so these
functions emit exactly the keys a real checkpoint carries (for the DiT, the
keys `orv_tpu.models.weights.export_dit_state_dict` emits). Inputs are the
JAX trees as nested dicts of numpy arrays (`jax.device_get(params)`); the
port imports nothing of the JAX package.

Conventions:
  flax Dense kernel [in, out]         -> torch Linear weight [out, in]
  Int8Dense kernel_q8 [in, out] int8  -> `weight_q8` [out, in] int8, and
    kernel_scale [out] f32            -> `weight_scale` [out] (a tree from
                                         orv_tpu's quantize_linear_params)
  patch-embed kernel [(c p p), D]     -> conv weight [D, C, p, p]
  conv kernel [kt, kh, kw, I, O]      -> torch Conv3d weight [O, I, kt, kh, kw]
  (1, 3, 3) upsample conv kernel      -> torch Conv2d weight [O, I, 3, 3]
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _lin(sd, key, p, bias: bool = True):
    if "kernel_q8" in p:  # a block linear of a quantized tree (models/quantize.py)
        sd[f"{key}.weight_q8"] = _tensor(np.asarray(p["kernel_q8"]).T)
        sd[f"{key}.weight_scale"] = _tensor(p["kernel_scale"])
    else:
        sd[f"{key}.weight"] = _tensor(np.asarray(p["kernel"]).T)
    if bias:
        sd[f"{key}.bias"] = _tensor(p["bias"])


def _adaln(sd, key, p):
    sd[f"{key}.linear.weight"] = _tensor(np.asarray(p["linear_kernel"]).T)
    sd[f"{key}.linear.bias"] = _tensor(p["linear_bias"])
    sd[f"{key}.norm.weight"] = _tensor(p["norm_scale"])
    sd[f"{key}.norm.bias"] = _tensor(p["norm_bias"])


def dit_params_from_jax(params: Dict[str, Any], config) -> Dict[str, torch.Tensor]:
    """ControlDiT param tree (`{'params': ...}` or its inner dict, with the
    scanned blocks stacked along a leading layer axis under
    `blocks/block`) -> the port's ControlDiT state dict. A quantized tree
    (stacked `kernel_q8` [L, in, out] int8 and `kernel_scale` [L, out] f32)
    gives the state dict of `ControlDiT(quant=True)`."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    kernel = np.asarray(p["patch_embed"]["proj"]["kernel"])  # [(c p p), D]
    ps = config.patch_size
    D = kernel.shape[1]
    sd["patch_embed.proj.weight"] = _tensor(kernel.T.reshape(D, -1, ps, ps))
    if "bias" in p["patch_embed"]["proj"]:
        sd["patch_embed.proj.bias"] = _tensor(p["patch_embed"]["proj"]["bias"])
    _lin(sd, "patch_embed.text_proj", p["patch_embed"]["text_proj"])
    _lin(sd, "time_embedding.linear_1", p["time_embedding"]["linear_1"])
    _lin(sd, "time_embedding.linear_2", p["time_embedding"]["linear_2"])

    stacked = p["blocks"]["block"]
    for i in range(config.num_layers):
        blk = _index(stacked, i)
        key = f"transformer_blocks.{i}"
        _adaln(sd, f"{key}.norm1", blk["norm1"])
        _adaln(sd, f"{key}.norm2", blk["norm2"])
        attn = blk["attn1"]
        for name in ("to_q", "to_k", "to_v"):
            _lin(sd, f"{key}.attn1.{name}", attn[name])
        _lin(sd, f"{key}.attn1.to_out.0", attn["to_out"])
        for qk in ("norm_q", "norm_k"):
            sd[f"{key}.attn1.{qk}.weight"] = _tensor(attn[qk]["scale"])
            sd[f"{key}.attn1.{qk}.bias"] = _tensor(attn[qk]["bias"])
        _lin(sd, f"{key}.ff.net.0.proj", blk["ff"]["net_0_proj"])
        _lin(sd, f"{key}.ff.net.2", blk["ff"]["net_2"])

    sd["norm_final.weight"] = _tensor(p["norm_final"]["scale"])
    sd["norm_final.bias"] = _tensor(p["norm_final"]["bias"])
    sd["norm_out.linear.weight"] = _tensor(np.asarray(p["norm_out"]["linear_kernel"]).T)
    sd["norm_out.linear.bias"] = _tensor(p["norm_out"]["linear_bias"])
    sd["norm_out.norm.weight"] = _tensor(p["norm_out"]["norm_scale"])
    sd["norm_out.norm.bias"] = _tensor(p["norm_out"]["norm_bias"])
    _lin(sd, "proj_out", p["proj_out"])

    ae = p["action_embed"]
    _lin(sd, "action_embed.mlp.0", ae["fc1"])
    _lin(sd, "action_embed.mlp.3", ae["fc2"])
    sd["action_embed.mask_embed.weight"] = _tensor(np.asarray(ae["mask_embed"])[None])
    if "action_recon" in p:
        _lin(sd, "action_recon.mlp.0", p["action_recon"]["fc1"])
        _lin(sd, "action_recon.mlp.2", p["action_recon"]["fc2"])
    if "initial_combine_linear" in p:
        _lin(sd, "initial_combine_linear", p["initial_combine_linear"])
    return sd


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _conv3d(sd, key, p):
    """CausalConv3d {'conv': {kernel [kt,kh,kw,I,O], bias}} -> `key.conv.*`."""
    sd[f"{key}.conv.weight"] = _tensor(np.transpose(np.asarray(p["conv"]["kernel"]),
                                                    (4, 3, 0, 1, 2)))
    sd[f"{key}.conv.bias"] = _tensor(p["conv"]["bias"])


def _spatial_norm(sd, key, p):
    sd[f"{key}.norm_layer.weight"] = _tensor(p["norm_layer"]["scale"])
    sd[f"{key}.norm_layer.bias"] = _tensor(p["norm_layer"]["bias"])
    _conv3d(sd, f"{key}.conv_y", p["conv_y"])
    _conv3d(sd, f"{key}.conv_b", p["conv_b"])


def _resnet(sd, key, p):
    _spatial_norm(sd, f"{key}.norm1", p["norm1"])
    _conv3d(sd, f"{key}.conv1", p["conv1"])
    _spatial_norm(sd, f"{key}.norm2", p["norm2"])
    _conv3d(sd, f"{key}.conv2", p["conv2"])
    if "conv_shortcut" in p:
        _conv3d(sd, f"{key}.conv_shortcut", p["conv_shortcut"])


def vae_params_from_jax(params: Dict[str, Any], config) -> Dict[str, torch.Tensor]:
    """CausalVAE param tree (`{'params': {'decoder': ...}}` or its inner
    dict) -> the port's CausalVAE state dict (decoder side)."""
    p = params.get("params", params)["decoder"]
    sd: Dict[str, torch.Tensor] = {}
    _conv3d(sd, "decoder.conv_in", p["conv_in"])
    for j in range(2):
        _resnet(sd, f"decoder.mid_block.resnets.{j}", p[f"mid_res_{j}"])
    nb = len(config.block_out_channels)
    for i in range(nb):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", p[f"up_{i}_res_{j}"])
        if i < nb - 1:
            up = p[f"up_{i}_upsample"]["conv"]
            sd[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"] = _tensor(
                np.transpose(np.asarray(up["kernel"])[0], (3, 2, 0, 1)))
            sd[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"] = _tensor(up["bias"])
    _spatial_norm(sd, "decoder.norm_out", p["norm_out"])
    _conv3d(sd, "decoder.conv_out", p["conv_out"])
    return sd
