"""Pipeline-parallel training: the DiT block stack split into `pp` stages.

Counterpart of `orv_tpu/parallel/pp.py`, tick for tick. Each pp rank holds
L/pp consecutive blocks (`ControlDiT(layers=...)`, `parallel/fsdp.py`), and
its batch (a data shard's) is split into M = `n_micro` microbatches (default
pp). The GPipe schedule runs T = M + pp - 1 ticks: on every tick every
stage runs its blocks on one microbatch, bubbles included (stage s takes
microbatch clamp(t - s, 0, M - 1)); the first stage takes its input from
the embeddings, the others what the stage before handed on; then one pp
rotation hands every stage's output to the next, and the first stage takes
zeros in place of what the last one sends (JAX's ppermute leaves it out).
The last stage writes each finished microbatch, and a masked sum over pp
gives every stage the output, so every rank runs the head and the loss.

The masks are 0/1 tensors (`torch.where` on a 0-d bool), never Python
branches on the rank: every rank records the same graph and makes the same
collectives in the same order, forward and backward, which autograd then
replays in reverse, as the sequence ring does (`ops/ring_attention.py`).
The collectives carry `shard_map`'s transpose rules (`parallel/sp.py`):
the embeddings (the first stage's input, the time and action embeddings
every stage's blocks read) enter the pipeline as replicated inputs, whose
cotangents are summed over the stages; the final masked sum is
`sum_partials`. The embeddings and the head run whole on every stage, as in
JAX (under 1% of the flops).

`make_pp_train_step` is `make_train_step`'s pipeline counterpart: the same
loss and optimizer; each (dp, fsdp) shard takes its own rows and its own
draws (the caller's, as JAX folds its key with the linearized (dp, fsdp)
index: `pipelines/train.py` passes the shard index to `draws`), and the
loss is the mean of the shards' losses (`diffusion_loss(data_mean=
"shards")`). So at dp = fsdp = 1 the step is the resident one, and with
data shards the image-dropout draw is per shard, as in JAX. Under fsdp each
stage's blocks are gathered from their shards inside the stage (`Zero`).
Remat recomputes each block cell, collectives included. The enc tokens'
output is collected (one more masked sum) only under `joint_final_norm`,
as in JAX; the port's head does not read them.

Refused with JAX's messages: sp under pp, pp x tp with fsdp > 1, a layer
count pp does not divide, a batch n_micro does not divide, and a multiview
batch whose samples n_micro does not divide. Skipping the bubble ticks'
work is left to later (ROADMAP.md B).
"""

from __future__ import annotations

from typing import Optional

import torch

from orv_tpu_torch.parallel.sp import replicated_input, rotate, sum_partials
from orv_tpu_torch.parallel.train_step import make_train_step


def check_pp_mesh(shape, num_layers: int) -> None:
    """JAX's refusals of a pp mesh (orv_tpu/parallel/pp.py:268-290)."""
    pp, fsdp, tp = shape["pp"], shape.get("fsdp", 1), shape.get("tp", 1)
    if shape.get("sp", 1) != 1:
        raise ValueError(
            "pp composes with dp, fsdp and tp (sp=1); got mesh "
            f"{dict(shape)}. For long sequences use train.mesh.sp "
            "(composes with dp/fsdp, not pp)")
    if tp > 1 and fsdp > 1:
        raise ValueError(
            "pp x tp requires fsdp=1 (the ('tp','fsdp')-stacked kernel "
            f"dim cannot cross the shard_map boundary); got mesh "
            f"{dict(shape)}. Use dp x pp x tp, or dp x fsdp x pp")
    if num_layers % pp != 0:
        raise ValueError(f"num_layers={num_layers} not divisible by pp={pp}")


class PipelineApply:
    """A stage model's training call (the model's signature) whose block
    stack runs as the pipeline over `pp` (module docstring). `model` holds
    this stage's blocks."""

    def __init__(self, model, pp, n_micro: int):
        self.model, self.pp, self.n_micro = model, pp, n_micro

    def __call__(self, hidden_states, encoder_hidden_states, timestep, actions=None,
                 depths=None, labels=None, deterministic: bool = True, action_mask_u=None,
                 image_rotary_emb=None, num_views: int = 1):
        m = self.model
        if num_views > 1 and hidden_states.shape[0] % self.n_micro != 0:
            raise ValueError("multiview pp needs n_micro to divide the sample batch so views "
                             "stay in one microbatch")
        e = m.embed(hidden_states, encoder_hidden_states, timestep, actions, depths, labels,
                    None, deterministic, action_mask_u, num_views)
        collect_enc = m.config.joint_final_norm
        hidden, enc = _pipeline(m, self.pp, e, image_rotary_emb, self.n_micro, collect_enc)
        out = m.head(hidden, e, enc)
        return out if deterministic else (out, e.is_action_mask, e.actions_recon)


def _pipeline(model, pp, e, rope, n_micro: int, collect_enc: bool):
    """The GPipe ticks over `pp` (module docstring): returns the blocks'
    video tokens on every stage, and their text tokens with `collect_enc`
    (else None)."""
    M, P, p = n_micro, pp.size, pp.rank
    B = e.hidden.shape[0]
    if B % M != 0:
        raise ValueError(f"pipeline batch {B} not divisible by n_micro={M}")
    mb = B // M
    split = lambda a: None if a is None else replicated_input(pp, a).reshape(M, mb,
                                                                             *a.shape[1:])
    h_in, e_in, t_in, a_in = split(e.hidden), split(e.enc), split(e.temb), split(e.action_emb)
    dev = e.hidden.device
    first = torch.tensor(p == 0, device=dev)
    is_last = torch.tensor(p == P - 1, device=dev)
    cur_h = torch.zeros_like(h_in[0])
    cur_e = torch.zeros_like(e_in[0])
    out_h = [torch.zeros_like(h_in[0]) for _ in range(M)]
    out_e = [torch.zeros_like(e_in[0]) for _ in range(M)] if collect_enc else None
    for t in range(M + P - 1):
        i = min(max(t - p, 0), M - 1)  # this stage's microbatch on this tick
        in_h = torch.where(first, h_in[i], cur_h)
        in_e = torch.where(first, e_in[i], cur_e)
        y_h, y_e, _ = model.run_blocks(in_h, in_e, t_in[i], None if a_in is None else a_in[i],
                                       rope, None, e.num_views, e.num_frames, model.layers)
        write = is_last & torch.tensor(0 <= t - p < M, device=dev)
        out_h[i] = torch.where(write, y_h, out_h[i])
        if collect_enc:
            out_e[i] = torch.where(write, y_e, out_e[i])
        if P > 1:  # hand on to the next stage; the first takes zeros
            y_h, y_e = rotate(pp, [y_h, y_e], 1)
            cur_h = torch.where(first, torch.zeros_like(y_h), y_h)
            cur_e = torch.where(first, torch.zeros_like(y_e), y_e)
    hidden = torch.stack(out_h).reshape(B, *e.hidden.shape[1:])
    hidden = sum_partials(pp, torch.where(is_last, hidden, torch.zeros_like(hidden)))
    if not collect_enc:
        return hidden, None
    enc = torch.stack(out_e).reshape(B, *e.enc.shape[1:])
    return hidden, sum_partials(pp, torch.where(is_last, enc, torch.zeros_like(enc)))


def make_pp_apply(model, pp, n_micro: Optional[int] = None) -> PipelineApply:
    """The stage model `model`'s call with its blocks run as a pipeline over
    the communicator `pp` (n_micro microbatches, default pp's size); under
    remat (`model.remat`) each block cell recomputes in the backward."""
    return PipelineApply(model, pp, int(n_micro or pp.size))


def make_pp_train_step(tx, schedule, mesh, num_layers: int, n_micro: Optional[int] = None,
                       **loss_kwargs):
    """Pipeline-parallel counterpart of `make_train_step` (module docstring):
    `step(state, batch, draws)` on this data shard's rows and draws, for a
    state whose model is this rank's stage (`parallel/fsdp.py:build_rank_model`
    on `mesh`)."""
    check_pp_mesh(mesh.shape, num_layers)
    n = int(n_micro or mesh.shape["pp"])
    return make_train_step(tx, schedule, model_fn=lambda state: make_pp_apply(
        state.model, mesh.pp, n), data_mean="shards", **loss_kwargs)
