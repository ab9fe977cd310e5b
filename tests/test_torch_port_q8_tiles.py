"""What the int8-QK^T kernel assumes of its input, held on the CPU.

`orv_tpu_torch/ops/csrc/flash_attn_q8.cu` walks the keys in 128-key tiles
and looks up one k scale per tile, so it relies on two facts of
`prepare_k_q8`'s output for every key count Skv:
  * block_k is a multiple of 128 (no tile straddles two scale blocks), and
    it is the JAX package's own block choice (`_pick_block(Skv, 1024, 128)`);
  * the rows of k8 from Skv on are zero padding (the kernel still masks
    them: exp(0 - 24) is not 0).
The wrapper refuses a `block_k` that breaks the first fact before any launch.
"""

import numpy as np
import pytest
import torch

from orv_tpu.ops.attention import _pick_block as jax_pick_block
from orv_tpu_torch.ops import _build, attention

# around the 128-key tiles and the 1024-key scale blocks, up to 4100
_SKV = (1, 2, 63, 64, 127, 128, 129, 255, 256, 257, 383, 384, 385, 895, 896, 897, 1000, 1023,
        1024, 1025, 1100, 2047, 2048, 2049, 3071, 3072, 3073, 4095, 4096, 4097, 4100)


def test_q8_block_choice_is_a_multiple_of_128_for_every_skv():
    for skv in range(1, 4101):
        block = attention._pick_block(skv)
        assert block % 128 == 0 and block == jax_pick_block(skv, 1024, 128), skv
        nk = -(-skv // block)
        assert (nk - 1) * block < skv <= nk * block, skv


@pytest.mark.parametrize("skv", _SKV)
def test_prepare_k_q8_tiles_and_zero_padding(skv):
    rng = np.random.default_rng(skv)
    k = torch.tensor(rng.standard_normal((1, 2, skv, 64)) + 0.5, dtype=torch.bfloat16)
    k8, sk_r, block_k = attention.prepare_k_q8(k)
    nk = -(-skv // block_k)
    assert block_k % 128 == 0 and block_k == jax_pick_block(skv, 1024, 128)
    assert k8.dtype == torch.int8 and tuple(k8.shape) == (1, 2, nk * block_k, 64)
    assert sk_r.dtype == torch.float32 and tuple(sk_r.shape) == (2, nk)
    assert not k8[:, :, skv:].any()
    # every block holds at least one real key, and its scale comes from them
    # (one value per block reaches +-127); one key alone smooths to zero
    blocks = k8.reshape(2, nk, block_k, 64).abs().amax(dim=(2, 3))
    assert bool((blocks == (127 if skv > 1 else 0)).all())


def _k_prep(B, H, skv, block_k):
    nk = -(-skv // block_k)
    return (torch.zeros(B, H, nk * block_k, 64, dtype=torch.int8),
            torch.ones(B * H, nk, dtype=torch.float32), block_k)


@pytest.mark.parametrize("block_k", [0, 64, 192, 1000])
def test_flash_attention_q8_kernel_refuses_block_k_off_the_tile(block_k, monkeypatch):
    """A block_k that is not a positive multiple of 128 raises before the
    library is built or a kernel launched."""
    def no_launch(*args):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(_build, "kernel", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)
    q = v = torch.zeros(1, 2, 300, 64, dtype=torch.bfloat16)
    k_prep = _k_prep(1, 2, 300, max(block_k, 64))[:2] + (block_k,)
    with pytest.raises(ValueError, match="multiple of 128"):
        attention.flash_attention_q8_kernel(q, k_prep, v, 300, 0.125)


def test_flash_attention_q8_kernel_refuses_a_foreign_k_prep_and_the_cpu(monkeypatch):
    """A k_prep of another key count, or tensors on the CPU, raise before any
    launch: the CPU path is `flash_attention_q8`, which runs the plain version."""
    def no_launch(*args):
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(_build, "kernel", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)
    q = v = torch.zeros(1, 2, 300, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="prepare_k_q8"):
        attention.flash_attention_q8_kernel(q, _k_prep(1, 2, 1100, 1024), v, 300, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_q8_kernel(q, _k_prep(1, 2, 300, 384), v, 300, 0.125)
    before = attention.flash_attention_q8.launches
    out = attention.flash_attention_q8(q, q, v)
    assert out.shape == q.shape and attention.flash_attention_q8.launches == before
