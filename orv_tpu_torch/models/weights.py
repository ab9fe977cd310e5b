"""Weight bridge: the JAX package's parameter trees -> the port's state dicts,
and the reader and writer of diffusers model folders (safetensors).

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
  patch-embed kernel [(c p p), D]     -> conv weight [D, C, p, p]; with
                                         patch_size_t (CogVideoX 1.5) the
                                         linear weight [D, (c pt p p)]
  stacked `blocks/mv_block/*`          -> `mv_blocks.{i}.*` (cam_encoder_kernel
                                         [12, D] -> cam_encoder.weight [D, 12])
  conv kernel [kt, kh, kw, I, O]      -> torch Conv3d weight [O, I, kt, kh, kw]
  (1, 3, 3) up/downsample conv kernel -> torch Conv2d weight [O, I, 3, 3]
  feature-network kernel [*k, I, O]   -> Conv2d/Conv3d weight [O, I, *k]
  T5 Dense kernel [in, out]           -> Linear weight [out, in]; its
                                         embeddings keep their layout
  Fuser / FloatGroupNorm /            -> Linear [out, in], Conv2d [O, I, 3, 3]
    ConditioningEmbedding trees          from HWIO, GroupNorm `scale` ->
                                         `weight` (`aux_params_from_jax`)

Under a mesh (`parallel/mesh.py`) `shard_state_dict` cuts a whole state
(the port's, or a JAX tree's through `dit_params_from_jax`) to one rank's
part, its pp stage's layers and its tp and fsdp pieces, and
`gather_state_dict` gathers the ranks' parts back into whole tensors (for
checkpoints and the export), every rank taking part.

A diffusers folder (`config.json` plus `diffusion_pytorch_model.safetensors`,
or shards listed in `diffusion_pytorch_model.safetensors.index.json`) reads
through `load_diffusers_folder`, with the port's own safetensors reader:
the port's modules carry the diffusers key names, so the state dict loads
with `load_state_dict(strict=True)`. `write_safetensors` and
`export_diffusers_folder` write such folders, tensor by tensor;
`dit_state_dict_from_diffusers` applies the JAX package's init surgery
(`orv_tpu/models/weights.py:convert_dit_state_dict`) to a diffusers state
dict: the T2V -> I2V zero-padding of the patch embed's input channels, the
multiview blocks seeded from the main blocks (`ensure_mv_blocks`), and the
optional keys checked against the config's model.
"""

from __future__ import annotations

import dataclasses
import json
import re
import struct
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Tuple

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

    kernel = np.asarray(p["patch_embed"]["proj"]["kernel"])  # [(c [pt] p p), D]
    ps = config.patch_size
    D = kernel.shape[1]
    if config.patch_size_t is None:  # the conv of CogVideoX 1.0
        sd["patch_embed.proj.weight"] = _tensor(kernel.T.reshape(D, -1, ps, ps))
    else:  # the linear of CogVideoX 1.5
        sd["patch_embed.proj.weight"] = _tensor(kernel.T)
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
        _attn(sd, f"{key}.attn1", blk["attn1"])
        _lin(sd, f"{key}.ff.net.0.proj", blk["ff"]["net_0_proj"])
        _lin(sd, f"{key}.ff.net.2", blk["ff"]["net_2"])
        if "mv_block" in p["blocks"]:
            mv = _index(p["blocks"]["mv_block"], i)
            key = f"mv_blocks.{i}"
            _adaln(sd, f"{key}.norm1", mv["norm1"])
            _attn(sd, f"{key}.attn1", mv["attn1"])
            _lin(sd, f"{key}.proj_out", mv["proj_out"])
            sd[f"{key}.cam_encoder.weight"] = _tensor(np.asarray(mv["cam_encoder_kernel"]).T)
            sd[f"{key}.cam_encoder.bias"] = _tensor(mv["cam_encoder_bias"])

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


def _attn(sd, key, attn):
    for name in ("to_q", "to_k", "to_v"):
        _lin(sd, f"{key}.{name}", attn[name])
    _lin(sd, f"{key}.to_out.0", attn["to_out"])
    for qk in ("norm_q", "norm_k"):
        sd[f"{key}.{qk}.weight"] = _tensor(attn[qk]["scale"])
        sd[f"{key}.{qk}.bias"] = _tensor(attn[qk]["bias"])


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


def _conv2d(sd, key, p):
    """A (1, 3, 3) conv {'conv': {kernel [1,3,3,I,O], bias}} -> torch Conv2d."""
    sd[f"{key}.conv.weight"] = _tensor(np.transpose(np.asarray(p["conv"]["kernel"])[0],
                                                    (3, 2, 0, 1)))
    sd[f"{key}.conv.bias"] = _tensor(p["conv"]["bias"])


def _group_norm(sd, key, p):
    sd[f"{key}.weight"] = _tensor(p["scale"])
    sd[f"{key}.bias"] = _tensor(p["bias"])


def _resnet(sd, key, p):
    norm = _spatial_norm if "norm_layer" in p["norm1"] else _group_norm
    norm(sd, f"{key}.norm1", p["norm1"])
    _conv3d(sd, f"{key}.conv1", p["conv1"])
    norm(sd, f"{key}.norm2", p["norm2"])
    _conv3d(sd, f"{key}.conv2", p["conv2"])
    if "conv_shortcut" in p:
        _conv3d(sd, f"{key}.conv_shortcut", p["conv_shortcut"])


def vae_params_from_jax(params: Dict[str, Any], config) -> Dict[str, torch.Tensor]:
    """CausalVAE param tree (`{'params': {'encoder': ..., 'decoder': ...}}`
    or its inner dict) -> the port's CausalVAE state dict."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    nb = len(config.block_out_channels)
    e = p["encoder"]
    _conv3d(sd, "encoder.conv_in", e["conv_in"])
    for i in range(nb):
        for j in range(config.layers_per_block):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", e[f"down_{i}_res_{j}"])
        if i < nb - 1:
            _conv2d(sd, f"encoder.down_blocks.{i}.downsamplers.0", e[f"down_{i}_downsample"])
    for j in range(2):
        _resnet(sd, f"encoder.mid_block.resnets.{j}", e[f"mid_res_{j}"])
    _group_norm(sd, "encoder.norm_out", e["norm_out"])
    _conv3d(sd, "encoder.conv_out", e["conv_out"])

    d = p["decoder"]
    _conv3d(sd, "decoder.conv_in", d["conv_in"])
    for j in range(2):
        _resnet(sd, f"decoder.mid_block.resnets.{j}", d[f"mid_res_{j}"])
    for i in range(nb):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", d[f"up_{i}_res_{j}"])
        if i < nb - 1:
            _conv2d(sd, f"decoder.up_blocks.{i}.upsamplers.0", d[f"up_{i}_upsample"])
    _spatial_norm(sd, "decoder.norm_out", d["norm_out"])
    _conv3d(sd, "decoder.conv_out", d["conv_out"])
    return sd


# ---------------------------------------------------------------------------
# diffusers folders
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


_TORCH_ST = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def aux_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The param tree (`{'params': ...}` or its inner dict) of one of the
    modules off the main path, `Fuser`, `FloatGroupNorm` or
    `ConditioningEmbedding` (orv_tpu/models/layers.py:799-876), -> the port
    module's state dict: flax Dense kernels [in, out] -> Linear weights
    [out, in], Conv kernels HWIO -> Conv2d weights OIHW, GroupNorm `scale`
    -> `weight`; ConditioningEmbedding's `block_{j}` -> `blocks.{j}`."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                key = f"blocks.{name[6:]}" if name.startswith("block_") else name
                walk(value, f"{prefix}{key}.")
                continue
            a = np.asarray(value)
            if name == "kernel":
                sd[f"{prefix}weight"] = _tensor(a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1)))
            else:
                sd[f"{prefix}{'weight' if name == 'scale' else name}"] = _tensor(a)

    walk(p, "")
    return sd


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor}. The format: a
    little-endian u64 header length, a JSON header {name: {dtype, shape,
    data_offsets [begin, end)}} (offsets from the end of the header), then
    the raw little-endian buffers."""
    return dict(iter_safetensors(path))


def iter_safetensors(path) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) pairs of one .safetensors file in file order, one
    tensor read at a time."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        header.pop("__metadata__", None)
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
            if len(buf) != end - begin:
                raise ValueError(f"{path}: tensor {name} runs past the end of the file")
            arr = np.frombuffer(buf, dtype=np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
            t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=False))
            if info["dtype"] == "BF16":
                t = t.view(torch.bfloat16)
            yield name, t.reshape(info["shape"])


def write_safetensors(path, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write `tensors` (on any device) as one .safetensors file, in sorted
    name order, one tensor on the host at a time: a state of many GB never
    sits whole in host memory. The header's metadata is diffusers' own
    `{"format": "pt"}`. Returns the bytes written."""
    names = sorted(tensors)
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _TORCH_ST:
            raise ValueError(f"tensor {name} has dtype {t.dtype}, which safetensors lacks")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _TORCH_ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(blob) + offset


def export_diffusers_folder(folder, state_dict: Mapping[str, torch.Tensor], config) -> int:
    """A diffusers transformer folder: config.json with the keys
    `orv_tpu.models.weights.export_torch_pretrained` writes (the config's
    fields but action_dim and joint_final_norm, plus the reference's
    constants) and `diffusion_pytorch_model.safetensors`. Returns the
    weights' bytes."""
    out = Path(folder)
    out.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.asdict(config)
    cfg.pop("action_dim", None)
    cfg.pop("joint_final_norm", None)
    cfg.update({
        "_class_name": "CogVideoXTransformer3DModelTraj",
        "ofs_embed_dim": None,
        "dropout": 0.0,
        "activation_fn": "gelu-approximate",
        "timestep_activation_fn": "silu",
        "norm_elementwise_affine": True,
        "num_control_blocks": 12,
    })
    (out / "config.json").write_text(json.dumps(cfg, indent=2))
    return write_safetensors(out / "diffusion_pytorch_model.safetensors", state_dict)


def dit_state_dict_from_diffusers(sd: Mapping[str, torch.Tensor], config,
                                  from_t2v: bool = False) -> Dict[str, torch.Tensor]:
    """A diffusers CogVideoX transformer state dict -> the state dict of the
    port's `ControlDiT(config)`, with the JAX package's init surgery
    (`convert_dit_state_dict`): with `from_t2v`, a conv patch embed whose
    input channels are half of `config.in_channels` gets zero-initialized
    extra channels (T2V -> I2V, 16 -> 32; a CogVideoX 1.5 linear patch embed
    passes as it is); `mv_blocks.*` are kept for a multiview config and
    dropped for any other, as the JAX package drops them, and a multiview
    config without them gets them seeded (`ensure_mv_blocks`). The optional
    keys must match the model: `patch_embed.proj.bias` exactly where
    `config.patch_bias`, and `norm_out.norm.*`, which the model always has.
    Any other mismatch raises by name in `load_state_dict(strict=True)`."""
    sd = dict(sd)
    if not config.multiview:
        sd = {k: v for k, v in sd.items() if not k.startswith("mv_blocks.")}
    w = sd["patch_embed.proj.weight"]
    if from_t2v and w.dim() == 4 and 2 * w.shape[1] == config.in_channels:
        sd["patch_embed.proj.weight"] = torch.cat([w, torch.zeros_like(w)], dim=1)
    if ("patch_embed.proj.bias" in sd) != bool(config.patch_bias):
        raise ValueError(f"patch_embed.proj.bias is {'' if config.patch_bias else 'not '}in "
                         f"the model (patch_bias={config.patch_bias}) but "
                         f"{'not ' if config.patch_bias else ''}in the state dict")
    lacking = [k for k in ("norm_out.norm.weight", "norm_out.norm.bias") if k not in sd]
    if lacking:
        raise ValueError(f"the state dict lacks {lacking}: the output AdaLayerNorm without an "
                         "elementwise affine is not a model either package builds")
    return ensure_mv_blocks(sd, config)


def ensure_mv_blocks(sd: Mapping[str, torch.Tensor], config) -> Dict[str, torch.Tensor]:
    """The JAX package's stage-3 surgery (`orv_tpu/models/weights.py:
    ensure_mv_blocks`) on a state dict: a multiview config whose weights
    hold no `mv_blocks.*` gets them, each block's `norm1` and `attn1`
    copied from `transformer_blocks.{i}`, and `proj_out` and the unused
    `cam_encoder` zero, in the dtype of the block's `to_q` weight, so that
    the cross-view path is an identity at step 0. Any other state dict is
    returned as it is."""
    sd = dict(sd)
    if not config.multiview or any(k.startswith("mv_blocks.") for k in sd):
        return sd
    D = config.inner_dim
    for i in range(config.num_layers):
        src, dst = f"transformer_blocks.{i}.", f"mv_blocks.{i}."
        for k in [k for k in sd if k.startswith((src + "norm1.", src + "attn1."))]:
            sd[dst + k[len(src):]] = sd[k].clone()
        like = sd[src + "attn1.to_q.weight"]
        zeros = lambda *shape: torch.zeros(shape, dtype=like.dtype, device=like.device)
        sd[dst + "proj_out.weight"] = zeros(D, D)
        sd[dst + "proj_out.bias"] = zeros(D)
        sd[dst + "cam_encoder.weight"] = zeros(D, 12)
        sd[dst + "cam_encoder.bias"] = zeros(D)
    return sd


def weight_files(folder: Path, stem: str):
    """The shards that `{stem}.safetensors.index.json` lists, else
    `{stem}.safetensors`, else []."""
    index = folder / f"{stem}.safetensors.index.json"
    if index.exists():
        return sorted({folder / v for v in json.loads(index.read_text())["weight_map"].values()})
    return [folder / f"{stem}.safetensors"] if (folder / f"{stem}.safetensors").exists() else []


def load_diffusers_folder(folder) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """A diffusers model folder -> (its config.json as a dict, its state
    dict as CPU tensors). Reads the shards an
    `diffusion_pytorch_model.safetensors.index.json` lists, else
    `diffusion_pytorch_model.safetensors`, else every `*.safetensors`."""
    folder = Path(folder)
    cfg_path = folder / "config.json"
    config = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    files = weight_files(folder, "diffusion_pytorch_model") or sorted(folder.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors weights in {folder}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return config, sd


# ---------------------------------------------------------------------------
# the offline models: T5 encoder, InceptionV3, I3D
# ---------------------------------------------------------------------------

def t5_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """transformers' `FlaxT5EncoderModel.params` (`{'shared': {'embedding'},
    'encoder': {'block': {'0': {'layer': {...}}}, 'final_layer_norm'}}`, or
    that under 'params') -> the port's `T5Encoder` state dict: Dense
    kernels [in, out] become Linear weights [out, in]; embeddings (the
    token table [vocab, d], the relative bias [buckets, heads]) and norm
    weights keep their layout."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {"shared.weight": _tensor(p["shared"]["embedding"])}
    enc = p["encoder"]
    for i, blk in sorted(enc["block"].items(), key=lambda kv: int(kv[0])):
        key = f"encoder.block.{i}.layer"
        attn, ff = blk["layer"]["0"], blk["layer"]["1"]
        for name in ("q", "k", "v", "o"):
            sd[f"{key}.0.SelfAttention.{name}.weight"] = _tensor(
                np.asarray(attn["SelfAttention"][name]["kernel"]).T)
        if "relative_attention_bias" in attn["SelfAttention"]:
            sd[f"{key}.0.SelfAttention.relative_attention_bias.weight"] = _tensor(
                attn["SelfAttention"]["relative_attention_bias"]["embedding"])
        for j, sub in ((0, attn), (1, ff)):
            sd[f"{key}.{j}.layer_norm.weight"] = _tensor(sub["layer_norm"]["weight"])
        for name, lin in ff["DenseReluDense"].items():
            sd[f"{key}.1.DenseReluDense.{name}.weight"] = _tensor(np.asarray(lin["kernel"]).T)
    sd["encoder.final_layer_norm.weight"] = _tensor(enc["final_layer_norm"]["weight"])
    return sd


def t5_state_dict_from_hf(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A transformers T5 (encoder) state dict -> the port's `T5Encoder`
    state dict. The names are the same; the encoder's token table, which
    transformers ties to `shared` and may save under
    `encoder.embed_tokens.weight` as well or instead, becomes `shared.weight`
    (both present must be equal). Decoder keys, which a full T5 holds, are
    left in, so that a strict load names them."""
    sd = dict(sd)
    tied = sd.pop("encoder.embed_tokens.weight", None)
    if tied is not None:
        if "shared.weight" in sd and not torch.equal(sd["shared.weight"], tied):
            raise ValueError("encoder.embed_tokens.weight differs from shared.weight, which it "
                             "is tied to")
        sd.setdefault("shared.weight", tied)
    return sd


def _conv_tree(tree: Dict[str, Any], prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    """Flax conv leaves -> torch: a `kernel` [*k, I, O] becomes `weight`
    [O, I, *k]; a `bias` stays."""
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if name == "kernel":
            k = np.asarray(sub)
            sd[f"{prefix}weight"] = _tensor(np.transpose(k, (k.ndim - 1, k.ndim - 2,
                                                             *range(k.ndim - 2))))
        elif name == "bias":
            sd[key] = _tensor(sub)
        else:
            _conv_tree(sub, f"{key}.", sd)


def feature_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """`InceptionV3Pool3` or `I3D` params of the JAX package (BN folded:
    `Mixed_5b/branch1x1/conv/{kernel,bias}`, `logits/{kernel,bias}`) -> the
    port's state dict of the same model."""
    sd: Dict[str, torch.Tensor] = {}
    _conv_tree(params.get("params", params), "", sd)
    return sd


inception_params_from_jax = i3d_params_from_jax = feature_params_from_jax


# ---------------------------------------------------------------------------
# a mesh rank's part of a state, and the whole state back
# ---------------------------------------------------------------------------

_LAYER_NAME = re.compile(r"^((?:.*/)?(?:transformer_blocks|mv_blocks))\.(\d+)\.(.+)$")


def placement_splits(pl, axes) -> Dict[int, Tuple[str, ...]]:
    """{torch dim: the mesh axes splitting it, outermost first} of a
    placement, over `axes`."""
    out: Dict[int, Tuple[str, ...]] = {}
    if "tp" in axes and pl.tp_dim is not None:
        out[pl.tp_dim] = ("tp",)
    if "fsdp" in axes and pl.fsdp_dim is not None:
        out[pl.fsdp_dim] = out.get(pl.fsdp_dim, ()) + ("fsdp",)
    return out


def shard_tensor(t: torch.Tensor, splits: Dict[int, Tuple[str, ...]], mesh) -> torch.Tensor:
    """This rank's piece of the whole tensor `t`: each split dim cut in the
    order of its axes (a dim split by tp and then fsdp holds tp's pieces,
    each cut in fsdp pieces)."""
    for dim, axes in splits.items():
        for a in axes:
            n = mesh.shape[a]
            k = t.shape[dim] // n
            t = t.narrow(dim, mesh.coords[a] * k, k)
    return t


def gather_tensor(t: torch.Tensor, splits: Dict[int, Tuple[str, ...]], mesh) -> torch.Tensor:
    """The inverse of `shard_tensor`, a collective of the ranks of each
    split axis: the innermost axis is gathered first."""
    for dim, axes in splits.items():
        for a in reversed(axes):
            t = mesh.comm_of((a,)).all_gather_seq(t.contiguous(), dim)
    return t


def shard_state_dict(whole: Mapping[str, torch.Tensor], placements: Mapping[str, Any], mesh,
                     axes=("pp", "tp", "fsdp")) -> Dict[str, torch.Tensor]:
    """This rank's part of a whole state dict: the entries of `placements`
    (a rank model's `mesh.Placement`s, by the entry's name; a name may carry
    a group prefix such as "mu/"), those of a block layer only where the
    rank's pp stage holds that layer, each cut over `axes` (copies)."""
    return {name: shard_tensor(whole[name], placement_splits(pl, axes), mesh).clone()
            for name, pl in placements.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], placements: Mapping[str, Any], mesh,
                      num_layers: int) -> Dict[str, torch.Tensor]:
    """The whole tensors of the ranks' parts `local` (names as in
    `shard_state_dict`), on every rank: each tensor gathered over fsdp and
    tp within its stage, then each block tensor's layers over pp (every
    stage stacks its layers of a name and the stacks are gathered in stage
    order). Every rank of the mesh must call it with the same names."""
    whole: Dict[str, torch.Tensor] = {}
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    for name, t in local.items():
        t = gather_tensor(t, placement_splits(placements[name], ("tp", "fsdp")), mesh)
        m = _LAYER_NAME.match(name)
        if m and mesh.shape["pp"] > 1:
            stacks.setdefault(f"{m.group(1)}.*.{m.group(3)}", {})[int(m.group(2))] = t
        else:
            whole[name] = t
    for key in sorted(stacks):
        layers = stacks[key]
        stacked = mesh.pp.all_gather_seq(torch.stack([layers[i] for i in sorted(layers)]), 0)
        stem, rest = key.split(".*.")
        for i in range(num_layers):
            whole[f"{stem}.{i}.{rest}"] = stacked[i]
    return whole
