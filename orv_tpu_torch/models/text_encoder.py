"""T5-v1.1 prompt encoder, in plain PyTorch.

Counterpart of `orv_tpu/models/text_encoder.py`, which wraps transformers'
`FlaxT5EncoderModel`. The port has no JAX, so the encoder is written here
with no transformers import, and follows the Flax module's arithmetic:

  * `shared` token embedding;
  * pre-norm blocks: T5's RMS LayerNorm (no mean, no bias, the variance in
    f32, the output in f32 as Flax's f32 weight gives it), self-attention,
    then the feed-forward, each added to the residual stream;
  * self-attention with no 1/sqrt(d) scale on the logits, plus a
    bidirectional relative-position bias (log-spaced buckets up to
    `relative_attention_max_distance`) that the first block computes once
    and every block adds;
  * gated-GELU feed-forward (`gelu_new`, the tanh form), or ReLU for
    `feed_forward_proj="relu"`;
  * a final RMS norm.

`encode_prompts` passes no attention mask, as the JAX package does: pad
tokens are attended (CogVideoX trains on the raw padded encoder states).

Module names are transformers' (`shared.weight`,
`encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight`,
`encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight`,
`encoder.block.{i}.layer.{0,1}.layer_norm.weight`,
`encoder.block.{i}.layer.1.DenseReluDense.{wi_0,wi_1,wo}.weight`,
`encoder.final_layer_norm.weight`), so a local transformers folder
(`config.json` and `model.safetensors` or shards listed in
`model.safetensors.index.json`) loads strictly through `from_pretrained`.

CogVideoX's encoder is T5-v1.1-XXL (`DEFAULT_T5`): 24 layers, d_model
4096, 64 heads x 64, d_ff 10240, vocabulary 32128, 32 buckets, max distance
128; about 4.76 B parameters, 9.5 GB in bf16.
"""

from __future__ import annotations

import dataclasses
import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from orv_tpu_torch.models.weights import (iter_safetensors, t5_state_dict_from_hf, weight_files,
                                          write_safetensors)
from orv_tpu_torch.utils.device import DeviceLike, check_module_device, resolve_device

DEFAULT_T5 = "google/t5-v1_1-xxl"  # CogVideoX text encoder


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The encoder's fields of a transformers T5 `config.json`; the defaults
    are T5-v1.1-XXL's."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"

    @classmethod
    def from_dict(cls, d: Dict) -> "T5Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")

    @property
    def act(self) -> str:
        """transformers' `dense_act_fn`: "gated-gelu" means `gelu_new` (the
        tanh form)."""
        if self.feed_forward_proj == "gated-gelu":
            return "gelu_new"
        act = self.feed_forward_proj.split("-")[-1]
        if act not in ("gelu", "relu"):
            raise ValueError(f"feed_forward_proj {self.feed_forward_proj!r}: only (gated-)gelu "
                             "and (gated-)relu are supported")
        return act


_ACT = {"gelu_new": lambda h: F.gelu(h, approximate="tanh"), "gelu": F.gelu, "relu": F.relu}


class T5LayerNorm(nn.Module):
    """RMS norm: x / sqrt(mean(x^2) + eps) * weight, in f32 (the weight is
    kept in f32 whatever the model's dtype, as Flax keeps it)."""

    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=torch.float32))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        return self.weight.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 buckets of key - query positions (transformers'
    `_relative_position_bucket`): half the buckets for each sign; of those,
    half exact, half log-spaced up to `max_distance`. The log is taken in
    f32, as JAX takes it."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    rp = relative_position.abs()
    max_exact = num_buckets // 2
    scale = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    large = max_exact + (torch.log(rp.float() / max_exact) / scale
                         * (num_buckets - max_exact))
    large = large.clamp(max=num_buckets - 1)
    return buckets + torch.where(rp < max_exact, rp.float(), large).long()


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, dtype, device=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q = nn.Linear(cfg.d_model, inner, **kw)
        self.k = nn.Linear(cfg.d_model, inner, **kw)
        self.v = nn.Linear(cfg.d_model, inner, **kw)
        self.o = nn.Linear(inner, cfg.d_model, **kw)
        self.cfg = cfg
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads, device=device, dtype=dtype)

    def compute_bias(self, length: int) -> torch.Tensor:
        """[1, heads, length, length] bias of the bucketed key - query offsets.
        The buckets are computed on the CPU on every device: offsets 16, 32
        and 64 land on whole buckets in exact arithmetic (max distance 128),
        where another library's f32 log may fall an ulp short."""
        pos = torch.arange(length)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.cfg.relative_attention_num_buckets,
                                           self.cfg.relative_attention_max_distance)
        weight = self.relative_attention_bias.weight
        return F.embedding(buckets.to(weight.device), weight).permute(2, 0, 1)[None]

    def forward(self, x, bias):
        B, S, _ = x.shape
        dtype = self.q.weight.dtype
        x = x.to(dtype)
        heads = lambda t: t.view(B, S, self.cfg.num_heads, self.cfg.d_kv).transpose(1, 2)
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2))  # T5: no 1/sqrt(d)
        w = torch.softmax(scores.float() + bias.float(), dim=-1).to(dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(B, S, -1)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, dtype, device=None):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias, dtype, device)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, device)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias).to(x.dtype)


class T5DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        if cfg.is_gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **kw)
        self.gated = cfg.is_gated
        self.act = _ACT[cfg.act]

    def forward(self, x):
        x = x.to(self.wo.weight.dtype)
        h = self.act(self.wi_0(x)) * self.wi_1(x) if self.gated else self.act(self.wi(x))
        return self.wo(h)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device=None):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg, dtype, device)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, device)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x)).to(x.dtype)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool, dtype, device=None):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias, dtype, device),
                                    T5LayerFF(cfg, dtype, device)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, dtype, device=None):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0, dtype, device)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, device)


class T5Encoder(nn.Module):
    """input_ids [B, S] int -> last hidden state [B, S, d_model] f32.

    Linear and embedding weights live on `device` (CUDA unless
    `device="cpu"`) in `dtype`, which is also the compute dtype; the norms'
    weights and outputs are f32. Random init is transformers' (normal with
    T5's per-matrix scales, from the torch generator's state)."""

    def __init__(self, config: T5Config = T5Config(), dtype=torch.bfloat16,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model, device=device, dtype=dtype)
        self.encoder = T5Stack(config, dtype, device)
        self._init_weights()

    @torch.no_grad()
    def _init_weights(self):
        c = self.config
        inner = c.num_heads * c.d_kv
        self.shared.weight.normal_(0.0, 1.0)
        for blk in self.encoder.block:
            a = blk.layer[0].SelfAttention
            a.q.weight.normal_(0.0, (inner * c.d_kv) ** -0.5)
            for lin in (a.k, a.v, a.o):
                lin.weight.normal_(0.0, inner ** -0.5)
            if hasattr(a, "relative_attention_bias"):
                a.relative_attention_bias.weight.normal_(0.0, inner ** -0.5)
            ff = blk.layer[1].DenseReluDense
            for lin in ((ff.wi_0, ff.wi_1) if ff.gated else (ff.wi,)):
                lin.weight.normal_(0.0, c.d_model ** -0.5)
            ff.wo.weight.normal_(0.0, c.d_ff ** -0.5)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids.to(self.shared.weight.device))
        bias = self.encoder.block[0].layer[0].SelfAttention.compute_bias(x.shape[1])
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)

    @classmethod
    def from_pretrained(cls, model_path, dtype=torch.bfloat16,
                        device: DeviceLike = None) -> "T5Encoder":
        """A local transformers T5 folder -> T5Encoder. Every weight the
        model holds must be in the folder and nothing else may be: a
        missing or unexpected key raises by name."""
        folder = Path(model_path)
        config = T5Config.from_dict(json.loads((folder / "config.json").read_text()))
        model = cls(config, dtype=dtype, device=device)
        sd = t5_state_dict_from_hf(read_weights(folder))
        model.load_state_dict(sd, strict=True)
        return model

    def save_pretrained(self, folder, max_shard_bytes: int = 5 * 2**30) -> List[str]:
        """config.json and the weights as transformers names them: one
        `model.safetensors`, or shards `model-0000i-of-0000n.safetensors`
        of at most `max_shard_bytes` each (a tensor larger than that gets a
        shard of its own) listed in `model.safetensors.index.json`. Returns
        the weight files written."""
        out = Path(folder)
        out.mkdir(parents=True, exist_ok=True)
        cfg = dataclasses.asdict(self.config)
        cfg.update(model_type="t5", architectures=["T5EncoderModel"],
                   dense_act_fn=self.config.act,
                   is_gated_act=self.config.is_gated)
        (out / "config.json").write_text(json.dumps(cfg, indent=2))
        sd = self.state_dict()
        shards: List[Dict[str, torch.Tensor]] = [{}]
        size = 0
        for name in sorted(sd):
            t = sd[name]
            n = t.numel() * t.element_size()
            if shards[-1] and size + n > max_shard_bytes:
                shards.append({})
                size = 0
            shards[-1][name] = t
            size += n
        if len(shards) == 1:
            write_safetensors(out / "model.safetensors", shards[0])
            return ["model.safetensors"]
        files = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
        for f, shard in zip(files, shards):
            write_safetensors(out / f, shard)
        index = {"metadata": {"total_size": sum(t.numel() * t.element_size()
                                                for t in sd.values())},
                 "weight_map": {name: f for f, shard in zip(files, shards) for name in shard}}
        (out / "model.safetensors.index.json").write_text(json.dumps(index, indent=2))
        return files


def read_weights(folder) -> Dict[str, torch.Tensor]:
    """The tensors of a transformers folder: the shards that
    `model.safetensors.index.json` lists, else `model.safetensors`."""
    files = weight_files(Path(folder), "model")
    if not files:
        raise FileNotFoundError(f"{folder} holds no model.safetensors and no "
                                "model.safetensors.index.json")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(iter_safetensors(f))
    return sd


def t5_available(model_path: Optional[str] = None) -> bool:
    """True only for a local path (nothing is downloaded)."""
    return bool(model_path) and Path(str(model_path)).exists()


class Tokenizer:
    """T5 tokenization padded and truncated to `max_length`: transformers'
    `AutoTokenizer` where it imports (as the JAX package tokenizes), else
    the `tokenizers` package over the folder's `tokenizer.json`."""

    def __init__(self, model_path):
        self.folder = Path(model_path)
        try:
            from transformers import AutoTokenizer
        except ImportError:
            AutoTokenizer = None
        if AutoTokenizer is not None:
            self.hf = AutoTokenizer.from_pretrained(str(self.folder))
            self.fast = None
            return
        try:
            from tokenizers import Tokenizer as FastTokenizer
        except ImportError as e:
            raise RuntimeError("T5 tokenization needs transformers or tokenizers; neither "
                               "imports") from e
        path = self.folder / "tokenizer.json"
        if not path.exists():
            raise RuntimeError(f"T5 tokenization without transformers needs {path}, which is "
                               "missing")
        self.hf = None
        self.fast = FastTokenizer.from_file(str(path))

    def __call__(self, prompts: List[str], max_length: int) -> np.ndarray:
        """-> input ids [B, max_length] int64 (special tokens added)."""
        if self.hf is not None:
            return np.asarray(self.hf(prompts, padding="max_length", max_length=max_length,
                                      truncation=True, add_special_tokens=True,
                                      return_tensors="np")["input_ids"], np.int64)
        pad_id = self.fast.token_to_id("<pad>")
        self.fast.enable_truncation(max_length)
        self.fast.enable_padding(length=max_length, pad_id=0 if pad_id is None else pad_id,
                                 pad_token="<pad>")
        return np.asarray([e.ids for e in self.fast.encode_batch(prompts)], np.int64)


@lru_cache(maxsize=1)
def _load(model_path: str, device: torch.device):
    """(tokenizer, bf16 encoder) of a folder; the last one only is kept (an
    XXL encoder takes 9.5 GB)."""
    return (Tokenizer(model_path),
            T5Encoder.from_pretrained(model_path, dtype=torch.bfloat16, device=device))


@torch.inference_mode()
def encode_prompts(prompts: List[str], max_sequence_length: int = 226,
                   model_path: Optional[str] = None, device: DeviceLike = None) -> np.ndarray:
    """-> [B, max_sequence_length, d_model] f32: pad and truncate to 226,
    no attention mask (the raw padded encoder states)."""
    if not t5_available(model_path):
        raise RuntimeError(
            "T5 weights unavailable; pass model_path to a local checkpoint "
            "or use pre-encoded prompt embeddings"
        )
    device = resolve_device(device)
    tokenizer, model = _load(str(model_path), device)
    check_module_device(model, device, "encode_prompts: the T5 encoder")
    ids = torch.from_numpy(tokenizer(prompts, max_sequence_length)).to(device)
    return model(ids).float().cpu().numpy()
