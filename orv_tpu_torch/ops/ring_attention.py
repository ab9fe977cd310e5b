"""Ring (sequence-parallel) attention over a communicator's ranks.

Counterpart of `orv_tpu/ops/ring_attention.py`. The JAX package shards the
token axis over the `sp` mesh axis inside a `shard_map`; here the same body
runs on every rank of a communicator (`parallel/sp.py`: `LocalRing` for
ranks as threads of one process, `ProcessGroupRing` for one process per
rank). Each rank keeps its query chunk resident while the K/V chunks rotate
one hop at a time (`sp.rotate`, the ppermute to rank + 1), and partial
results merge exactly in f32 with logsumexp weights. Every per-chunk call
goes through `attention_with_lse`, so on CUDA it launches the online kernel
(`static_max=None`) or the static-max one.

The public functions take the full [B, H, S, D] tensors that every rank
holds (as a replicated activation is held on every rank), attend with the
calling rank's chunk, and return the full result on every rank, the video
chunks all-gathered in rank order: what the JAX `shard_map` returns.

They are differentiable in q, k and v through the collectives of
`parallel/sp.py`, which carry `shard_map`'s transpose rules: the inputs'
cotangents are summed over the ranks and the output's divided by their
number, the rotation's backward rotates back, the text merge's max carries
no gradient. Under grad every per-chunk call still goes through
`attention_with_lse`, so on CUDA the merge's lse cotangent reaches the
flash backward kernels as dlse, as JAX's `_bwd_impl(..., dlse)` takes it.
Every rank ends a backward with the same gradients, bit for bit. On CUDA
the ranks must then be processes (`ProcessGroupRing`): `LocalRing` refuses
a backward there (`parallel/sp.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from orv_tpu_torch.ops.attention import attention_with_lse
from orv_tpu_torch.parallel import sp


def _lse_combine(out_a, lse_a, out_b, lse_b):
    """Merge two partial attention results (f32 out, f32 lse) exactly
    (ring_attention.py:56)."""
    lse = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse)[..., None]
    w_b = torch.exp(lse_b - lse)[..., None]
    return out_a * w_a + out_b * w_b, lse


def _attend(q, k, v, scale, impl, static_max):
    """`attention_with_lse`, out in f32."""
    out, lse = attention_with_lse(q, k, v, scale, impl, static_max)
    return out.float(), lse


def _ring_body(q_blk, k_blk, v_blk, comm, scale: float, impl: str, static_max=None):
    """This rank's queries against every rank's K/V chunk
    (ring_attention.py:30-53): the local chunk, then size - 1 rotations."""
    out, lse = _attend(q_blk, k_blk, v_blk, scale, impl, static_max)
    k_cur, v_cur = k_blk, v_blk
    for _ in range(comm.size - 1):
        k_cur, v_cur = sp.rotate(comm, [k_cur, v_cur])
        out_i, lse_i = _attend(q_blk, k_cur, v_cur, scale, impl, static_max)
        out, lse = _lse_combine(out, lse, out_i, lse_i)
    return out.to(q_blk.dtype)


def _joint_ring_body(q_t, k_t, v_t, q_v, k_v, v_v, comm, scale: float, impl: str,
                     static_max=None):
    """Text tokens replicated, video tokens in one chunk per rank
    (ring_attention.py:64-111). Video queries attend the text K/V, the local
    chunk, then size - 1 rotated chunks; text queries attend the text K/V and
    the local chunk, and the ranks' partials merge in probability space:
    a max-all-reduce of the lse (it only steadies the exponentials, so it
    carries no gradient), then sum-all-reduces of exp(lse - m) * out and of
    exp(lse - m)."""
    out_a, lse_a = _attend(q_v, k_t, v_t, scale, impl, static_max)
    out_b, lse_b = _attend(q_v, k_v, v_v, scale, impl, static_max)
    out_vid, lse_vid = _lse_combine(out_a, lse_a, out_b, lse_b)
    k_cur, v_cur = k_v, v_v
    for _ in range(comm.size - 1):
        k_cur, v_cur = sp.rotate(comm, [k_cur, v_cur])
        out_i, lse_i = _attend(q_v, k_cur, v_cur, scale, impl, static_max)
        out_vid, lse_vid = _lse_combine(out_vid, lse_vid, out_i, lse_i)

    out_tt, lse_tt = _attend(q_t, k_t, v_t, scale, impl, static_max)
    out_tv, lse_tv = _attend(q_t, k_v, v_v, scale, impl, static_max)
    m = torch.maximum(sp.all_reduce_max(comm, lse_tv), lse_tt.detach())
    num = (sp.all_reduce_sum(comm, torch.exp(lse_tv - m)[..., None] * out_tv)
           + torch.exp(lse_tt - m)[..., None] * out_tt)
    den = sp.all_reduce_sum(comm, torch.exp(lse_tv - m)) + torch.exp(lse_tt - m)
    out_txt = num / den[..., None]
    return out_txt.to(q_t.dtype), out_vid.to(q_v.dtype)


def _chunk(x: torch.Tensor, start: int, comm) -> torch.Tensor:
    """This rank's chunk of the token range [start, S) of x [B, H, S, D],
    contiguous (the kernels take contiguous operands; a chunk is copied
    once, not at every call)."""
    n = (x.shape[2] - start) // comm.size
    lo = start + comm.rank * n
    return x[:, :, lo:lo + n].contiguous()


def _check_call(n_tokens: int, comm, what: str) -> None:
    """Raise on tokens that do not split over the ranks."""
    if n_tokens % comm.size:
        raise ValueError(f"{what}: {n_tokens} tokens do not split over {comm.size} ranks")


def joint_ring_attention(q, k, v, text_len: int, comm, scale: Optional[float] = None,
                         impl: str = "auto", static_max: Optional[float] = None
                         ) -> torch.Tensor:
    """Exact joint [text | video] attention over [B, H, T+S, D] with the
    video range split over `comm`'s ranks and the text range replicated
    (ring_attention.py:114). S must divide by `comm.size`. Call it on every
    rank with the same q, k, v; each returns the full [B, H, T+S, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_call(q.shape[2] - text_len, comm, "joint_ring_attention")
    q, k, v = (sp.replicated_input(comm, x) for x in (q, k, v))
    text = lambda x: x[:, :, :text_len].contiguous()
    out_t, out_v = _joint_ring_body(text(q), text(k), text(v), _chunk(q, text_len, comm),
                                    _chunk(k, text_len, comm), _chunk(v, text_len, comm),
                                    comm, float(scale), impl, static_max)
    out = torch.cat([out_t, sp.all_gather(comm, out_v, dim=2)], dim=2)
    return sp.replicated_output(comm, out)


def ring_attention(q, k, v, comm, scale: Optional[float] = None, impl: str = "auto",
                   static_max: Optional[float] = None) -> torch.Tensor:
    """Exact attention over [B, H, S, D] with S split over `comm`'s ranks
    (ring_attention.py:157); bidirectional, as the DiT's attention is. S
    must divide by `comm.size`. Call it on every rank with the same q, k, v;
    each returns the full [B, H, S, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_call(q.shape[2], comm, "ring_attention")
    q, k, v = (sp.replicated_input(comm, x) for x in (q, k, v))
    out = _ring_body(_chunk(q, 0, comm), _chunk(k, 0, comm), _chunk(v, 0, comm), comm,
                     float(scale), impl, static_max)
    return sp.replicated_output(comm, sp.all_gather(comm, out, dim=2))
