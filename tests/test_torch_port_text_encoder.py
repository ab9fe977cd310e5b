"""The port's T5 prompt encoder (`models/text_encoder.py`) against
transformers' `FlaxT5EncoderModel`, which the JAX package wraps, on the CPU.

A tiny T5-v1.1 config built here (vocabulary 64, d_model 32, 4 heads x 8,
d_ff 64, 2 layers, 32 buckets with a max distance of 16, so that 40 tokens
reach the log buckets and their clamp); Flax's random init goes through
`t5_params_from_jax`, a transformers folder through `from_pretrained`.

Tolerances, against the reference output's RMS:
  * f32: max error <= 1e-4 (only the order of sums differs);
  * bf16 against Flax's bf16 run: max error <= 5e-2 and RMS error <= 1e-2.
    Both round the residual stream, the projections and the attention
    weights to bf16 at the same points (8 bits of mantissa, an ulp is 2^-8 =
    3.9e-3 of a value); what differs is where each sums and whether the
    scores and bias are added before or after their bf16 rounding (and, at
    this test's head dim 8, Flax's q * sqrt(8) / sqrt(8), two roundings), so
    a few ulps of the stream's largest elements, which reach 3-4x its RMS
    (measured 3.5e-2 and 6.8e-3);
  * the zero empty-prompt file and the token ids: bitwise.
"""

import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orv_tpu.models import text_encoder as jte
from orv_tpu.pipelines import encode_dataset as jenc
from orv_tpu_torch.models import text_encoder as tte
from orv_tpu_torch.models.weights import t5_params_from_jax, write_safetensors
from orv_tpu_torch.pipelines import encode_dataset as tenc
from test_torch_port_isolation import no_persistent_jax_cache  # noqa: F401 (autouse)


def _rel(got, want):
    """(max error, RMS error) over the reference's RMS."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(got - want)
    return err.max() / rms, np.sqrt(np.mean(err ** 2)) / rms


# -- the T5 encoder ------------------------------------------------------------

T5 = dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2,
          relative_attention_num_buckets=32, relative_attention_max_distance=16,
          dropout_rate=0.0, layer_norm_epsilon=1e-6)


def _flax_t5(feed_forward_proj="gated-gelu", dtype=jnp.float32, seed=0):
    from transformers import FlaxT5EncoderModel, T5Config

    cfg = T5Config(feed_forward_proj=feed_forward_proj, **T5)
    return FlaxT5EncoderModel(cfg, seed=seed, dtype=dtype), cfg


def _ids(batch=2, length=40, pads=(10, 3)):
    """Token ids 2..63 with trailing pads (id 0): pads are attended, as in JAX."""
    rng = np.random.default_rng(7)
    ids = rng.integers(2, 64, (batch, length))
    for b, n in enumerate(pads[:batch]):
        ids[b, length - n:] = 0
    return ids


def _port_t5(flax_model, cfg, dtype=torch.float32):
    model = tte.T5Encoder(tte.T5Config.from_dict(cfg.to_dict()), dtype=dtype, device="cpu")
    model.load_state_dict(t5_params_from_jax(jax.device_get(flax_model.params)), strict=True)
    return model


@pytest.mark.parametrize("proj", ["gated-gelu", "relu"])
def test_t5_encoder_matches_flax_in_f32(proj):
    """40 tokens pass the narrow max distance (16), so the log buckets and
    their clamp are reached; the pads are attended."""
    jm, cfg = _flax_t5(proj)
    ids = _ids()
    want = np.asarray(jm(input_ids=ids).last_hidden_state)
    got = _port_t5(jm, cfg)(torch.tensor(ids)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 40, 32)
    assert _rel(got, want)[0] <= 1e-4


def test_t5_relative_buckets_match_flax():
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    rp = np.arange(-300, 301)[None, :]
    for nb, md in ((32, 16), (32, 128), (8, 20)):
        want = np.asarray(FlaxT5Attention._relative_position_bucket(
            jnp.asarray(rp), bidirectional=True, num_buckets=nb, max_distance=md))
        got = tte.relative_position_bucket(torch.tensor(rp), nb, md).numpy()
        np.testing.assert_array_equal(got, want)


def test_t5_encoder_matches_flax_in_bf16():
    jm, cfg = _flax_t5(dtype=jnp.bfloat16)
    ids = _ids()
    want = np.asarray(jm(input_ids=ids).last_hidden_state, np.float32)
    got = _port_t5(jm, cfg, torch.bfloat16)(torch.tensor(ids)).detach()
    assert got.dtype == torch.float32  # the final norm's output, as Flax's
    mx, rms = _rel(got.numpy(), want)
    assert mx <= 5e-2 and rms <= 1e-2, (mx, rms)


def _t5_folder(tmp_path):
    """A transformers T5 folder holding both packages' weights: Flax's
    msgpack (JAX reads it) and the torch model's safetensors that
    transformers writes from it (the port reads those), plus a fast
    tokenizer over a word-level vocabulary."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast, T5EncoderModel
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    jm, cfg = _flax_t5()
    folder = tmp_path / "t5"
    jm.save_pretrained(str(folder))
    pt = load_flax_weights_in_pytorch_model(T5EncoderModel(cfg), jm.params)
    pt.save_pretrained(str(folder), safe_serialization=True)
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: 3 + i for i, w in enumerate("pick the cube put spoon in pot a red".split())})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(str(folder))
    return jm, cfg, folder


PROMPTS = ["pick the red cube", "", "put the spoon in the pot " * 10]


def test_t5_folder_loads_and_encodes_as_jax(tmp_path, monkeypatch):
    """transformers' own safetensors names load strictly; `encode_prompts`
    (tokenize, pad and truncate to 24, bf16 encoder) against JAX's on the
    same folder; the `tokenizers` route gives the same ids as
    `AutoTokenizer`."""
    jm, cfg, folder = _t5_folder(tmp_path)
    ids = _ids()
    model = tte.T5Encoder.from_pretrained(folder, dtype=torch.float32, device="cpu")
    want = np.asarray(jm(input_ids=ids).last_hidden_state)
    assert _rel(model(torch.tensor(ids)).detach().numpy(), want)[0] <= 1e-4

    jte._load.cache_clear()
    want = jte.encode_prompts(PROMPTS, 24, model_path=str(folder))
    got = tte.encode_prompts(PROMPTS, 24, model_path=str(folder), device="cpu")
    assert got.shape == want.shape == (3, 24, 32) and got.dtype == np.float32
    mx, rms = _rel(got, want)
    assert mx <= 5e-2 and rms <= 1e-2, (mx, rms)

    auto = tte.Tokenizer(folder)(PROMPTS, 24)
    monkeypatch.setitem(sys.modules, "transformers", None)  # `import transformers` fails
    fast = tte.Tokenizer(folder)
    assert fast.hf is None
    np.testing.assert_array_equal(fast(PROMPTS, 24), auto)
    assert auto[1].tolist() == [1] + [0] * 23  # the empty prompt: </s>, then pads


def test_t5_refusals(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="T5 weights unavailable"):
        tte.encode_prompts([""], model_path=None, device="cpu")
    with pytest.raises(RuntimeError, match="T5 weights unavailable"):
        tte.encode_prompts([""], model_path=str(tmp_path / "absent"), device="cpu")
    model = tte.T5Encoder(tte.T5Config(**{k: v for k, v in T5.items() if k != "dropout_rate"}),
                          dtype=torch.float32, device="cpu")
    folder = tmp_path / "saved"
    files = model.save_pretrained(folder, max_shard_bytes=20_000)
    assert len(files) > 1 and (folder / "model.safetensors.index.json").exists()
    back = tte.T5Encoder.from_pretrained(folder, dtype=torch.float32, device="cpu")
    ids = torch.tensor(_ids())
    assert torch.equal(back(ids), model(ids))
    sd = dict(model.state_dict())
    # transformers' tied name is taken as `shared`
    sd["encoder.embed_tokens.weight"] = sd.pop("shared.weight")
    shutil.rmtree(folder)
    model.save_pretrained(folder)
    write_safetensors(folder / "model.safetensors", sd)
    assert torch.equal(tte.T5Encoder.from_pretrained(folder, dtype=torch.float32,
                                                     device="cpu")(ids), model(ids))
    for name, change in (("final_layer_norm", lambda d: d.pop("encoder.final_layer_norm.weight")),
                         ("decoder.extra", lambda d: d.update({"decoder.extra":
                                                               torch.zeros(1)}))):
        bad = dict(model.state_dict())
        change(bad)
        write_safetensors(folder / "model.safetensors", bad)
        with pytest.raises(RuntimeError, match=name):
            tte.T5Encoder.from_pretrained(folder, dtype=torch.float32, device="cpu")
    (folder / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        tte.T5Encoder.from_pretrained(folder, dtype=torch.float32, device="cpu")
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(RuntimeError, match="transformers or tokenizers"):
        tte.Tokenizer(folder)


def _prompt_cfg(mod, text_encoder_path=None):
    d = {"dataset": {"data_root": "unused"},
         "transformer": {"max_text_seq_length": 24, "text_embed_dim": 32}}
    if text_encoder_path:
        d["text_encoder_path"] = str(text_encoder_path)
    return mod.Config(d)


def test_empty_prompt_embedding_matches_jax(tmp_path):
    """Without a T5 folder both write zeros [max_text_seq_length,
    text_embed_dim], bitwise the same file; with one, the encoder's output."""
    from orv_tpu import configs as jconfigs
    from orv_tpu_torch import configs as tconfigs

    jenc.encode_empty_prompt(_prompt_cfg(jconfigs), tmp_path / "jax")
    tenc.encode_empty_prompt(_prompt_cfg(tconfigs), tmp_path / "port", device="cpu")
    j = np.load(tmp_path / "jax" / "prompt_embeds" / "empty.npz")["arr_0"]
    t = np.load(tmp_path / "port" / "prompt_embeds" / "empty.npz")["arr_0"]
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape == (24, 32)
    np.testing.assert_array_equal(t, j)
    assert not t.any()

    _, _, folder = _t5_folder(tmp_path)
    jte._load.cache_clear()
    jenc.encode_empty_prompt(_prompt_cfg(jconfigs, folder), tmp_path / "jax")
    tenc.encode_empty_prompt(_prompt_cfg(tconfigs, folder), tmp_path / "port", device="cpu")
    j = np.load(tmp_path / "jax" / "prompt_embeds" / "empty.npz")["arr_0"]
    t = np.load(tmp_path / "port" / "prompt_embeds" / "empty.npz")["arr_0"]
    assert t.shape == j.shape == (24, 32) and np.abs(j).max() > 0.1
    mx, rms = _rel(t, j)
    assert mx <= 5e-2 and rms <= 1e-2, (mx, rms)
