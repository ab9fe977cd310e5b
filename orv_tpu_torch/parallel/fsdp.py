"""A rank's part of the DiT under a mesh: its tp and pp copy, its fsdp shards.

Counterpart of what the JAX package leaves to GSPMD once `param_shardings`
(`orv_tpu/parallel/mesh.py:108-180`) has placed the parameters. Here each
rank builds its own model:

* `build_rank_model`: the whole model's state dict (a seeded init, a
  diffusers folder, or a JAX tree through `models/weights.py`) cut to this
  rank: its pp stage's block layers, its tp columns of the split layers
  (`models/layers.py`), and, under fsdp, its fsdp shards (`Zero`). Each
  tensor's `mesh.Placement` says where its part comes from; the plan is
  the JAX package's, leaf by leaf (`mesh.param_shardings`).
* `Zero` is ZeRO-3 over the fsdp axis: a parameter the plan shards is held
  as this rank's shard (the training leaf that the optimizer, its moments
  and the EMA follow), and the module keeps an empty placeholder. Around
  each unit's use (a block cell, the embeddings "pre", the head "post":
  `ControlDiT._unit`) one all-gather of the unit's flattened shards
  rebuilds its tensors, whose gradients one reduce-scatter (in rank order)
  returns to the shards. Under remat the gather runs again in the
  backward; without it, autograd holds the gathered tensors until the
  backward (prefetch and early release are not done: ROADMAP.md B).
* `MeshLayout` carries what the step and the optimizer need to reduce
  over the mesh: each leaf's placement, which rank counts it in a global
  sum (one replica of each replicated tensor), and the communicators.
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from orv_tpu_torch.parallel.mesh import (Mesh, MeshConfig, Placement, make_mesh,
                                         param_shardings, placement, stage_layers)
from orv_tpu_torch.parallel.sp import _check_backward

_LAYER = re.compile(r"^(?:transformer_blocks|mv_blocks)\.(\d+)\.")
_POST = ("norm_final.", "norm_out.", "proj_out.")


def unit_of(name: str):
    """The unit a parameter is gathered with: its block layer, "post" for
    the head's, "pre" for the rest."""
    m = _LAYER.match(name)
    if m:
        return int(m.group(1))
    return "post" if name.startswith(_POST) else "pre"


def _piece(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    k = t.shape[dim] // n
    return t.narrow(dim, index * k, k)


class _GatherUnit(torch.autograd.Function):
    """The unit's shards -> its whole tensors: one all-gather of the
    flattened shards; the backward one reduce-scatter of the flattened
    gradient pieces."""

    @staticmethod
    def forward(ctx, comm, dims, *shards):
        ctx.comm, ctx.dims = comm, dims
        ctx.shapes = [s.shape for s in shards]
        ctx.like = shards[0]
        n = comm.size
        flat = torch.cat([s.reshape(-1) for s in shards])
        parts = comm.all_gather_seq(flat, 0).view(n, -1)
        outs, off = [], 0
        for d, s in zip(dims, shards):
            k = s.numel()
            pieces = parts[:, off:off + k].reshape(n, *s.shape)
            outs.append(torch.cat(pieces.unbind(0), dim=d))
            off += k
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.comm.size
        cols = []
        for d, shape, g in zip(ctx.dims, ctx.shapes, grads):
            if g is None:
                cols.append(ctx.like.new_zeros(n, shape.numel()))
                continue
            cols.append(torch.stack(g.chunk(n, dim=d)).reshape(n, -1))
        mine = ctx.comm.reduce_scatter_sum(torch.cat(cols, dim=1), 0).reshape(-1)
        out, off = [], 0
        for shape in ctx.shapes:
            out.append(mine[off:off + shape.numel()].reshape(shape))
            off += shape.numel()
        return (None, None, *out)


class _Slot:
    __slots__ = ("name", "module", "attr", "shard", "dim")

    def __init__(self, name, module, attr, shard, dim):
        self.name, self.module, self.attr, self.shard, self.dim = name, module, attr, shard, dim


class Zero:
    """ZeRO-3 shards of `model`'s parameters over `comm` (module
    docstring). `dims[name]`: the torch dim of the rank's (tp-split) tensor
    that fsdp splits; parameters without one stay whole in the module.
    Sets `model.zero`."""

    def __init__(self, model: nn.Module, comm, dims: Dict[str, int]):
        self.comm = comm
        self.units: Dict[object, List[_Slot]] = {}
        self.shards: Dict[str, nn.Parameter] = {}
        for name, p in list(model.named_parameters()):
            d = dims.get(name)
            if d is None or comm.size == 1:
                continue
            *path, attr = name.split(".")
            module = model.get_submodule(".".join(path))
            shard = nn.Parameter(_piece(p.detach(), d, comm.rank, comm.size).clone(),
                                 requires_grad=p.requires_grad)
            p.data = p.data.new_empty(0)  # the whole tensor exists only while gathered
            self.units.setdefault(unit_of(name), []).append(_Slot(name, module, attr, shard, d))
            self.shards[name] = shard
        model.zero = self

    @contextlib.contextmanager
    def gathered(self, key):
        slots = self.units.get(key)
        if not slots:
            yield
            return
        shards = [s.shard for s in slots]
        _check_backward(self.comm, shards, "fsdp gather")
        whole = _GatherUnit.apply(self.comm, tuple(s.dim for s in slots), *shards)
        for s, w in zip(slots, whole):
            s.module.__dict__[s.attr] = w  # found before the placeholder in _parameters
        try:
            yield
        finally:
            for s in slots:
                s.module.__dict__.pop(s.attr, None)


def named_leaves(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(name, training leaf) of every parameter that requires grad, in the
    model's order: the fsdp shard where `model.zero` holds one, else the
    parameter."""
    zero = getattr(model, "zero", None)
    shards = {} if zero is None else zero.shards
    return [(n, shards.get(n, p)) for n, p in model.named_parameters() if p.requires_grad]


class MeshLayout:
    """The placements of a rank model's tensors on `mesh` (module
    docstring). `whole_shapes`: the whole model's shape of every state
    dict entry; `placements`: each entry's `Placement`."""

    def __init__(self, mesh: Mesh, placements: Dict[str, Placement],
                 whole_shapes: Dict[str, Tuple[int, ...]], num_layers: int):
        self.mesh, self.placements = mesh, placements
        self.whole_shapes, self.num_layers = whole_shapes, num_layers

    @classmethod
    def whole(cls, shapes: Dict[str, Sequence[int]], mesh: Optional[Mesh] = None,
              num_layers: int = 0) -> "MeshLayout":
        """The layout of tensors `shapes` (name: shape) that every rank of
        `mesh` (default: one rank) holds whole, as under dp or sp alone or
        on one device: every placement trivial, every gather an identity."""
        mesh = mesh if mesh is not None else make_mesh(MeshConfig(dp=1))
        return cls(mesh, {n: Placement(layer=_layer_of(n)) for n in shapes},
                   {n: tuple(s) for n, s in shapes.items()}, num_layers)

    @property
    def split(self) -> bool:
        """Whether a rank holds parts of the model (fsdp, tp or pp above 1)
        rather than all of it."""
        return any(self.mesh.shape[a] > 1 for a in ("fsdp", "tp", "pp"))

    def replicated_axes(self, name: str) -> Tuple[str, ...]:
        pl = self.placements[name]
        axes = ["dp", "sp"]
        if pl.fsdp_dim is None:
            axes.append("fsdp")
        if pl.tp_dim is None:
            axes.append("tp")
        if pl.layer is None:
            axes.append("pp")
        return tuple(axes)

    def owned(self, name: str) -> bool:
        """Whether this rank counts `name` in a global sum: it holds the
        replica at index 0 of every axis the tensor is replicated over."""
        return all(self.mesh.coords[a] == 0 for a in self.replicated_axes(name))

    def global_sum(self, values: torch.Tensor) -> torch.Tensor:
        """A 0-d or 1-d f32 of per-rank partial sums, summed over every rank."""
        return self.mesh.comm.all_reduce_sum(values)

    def reduce_grads(self, names: Sequence[str], grads: List[torch.Tensor]) -> None:
        """Sum, in place, each leaf's gradient over the data axes (dp,
        fsdp): an fsdp shard's over dp (its gather's backward summed it over
        fsdp already), every other leaf's over (dp, fsdp). tp, pp and sp
        replicas hold their whole gradient already."""
        mesh = self.mesh
        groups: Dict[Tuple[str, ...], List[int]] = {}
        for i, n in enumerate(names):
            axes = ("dp",) if self.placements[n].fsdp_dim is not None else ("dp", "fsdp")
            groups.setdefault(axes, []).append(i)
        for axes in (("dp",), ("dp", "fsdp")):
            idx = groups.get(axes)
            comm = mesh.comm_of(axes)
            if not idx or comm.size == 1:
                continue
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            flat = comm.all_reduce_sum(flat)
            off = 0
            for i in idx:
                k = grads[i].numel()
                grads[i].copy_(flat[off:off + k].view_as(grads[i]))
                off += k


def build_rank_model(make_model: Callable[..., nn.Module], whole: Dict[str, torch.Tensor],
                     mesh: Mesh, num_layers: int, shard_fsdp: bool = True):
    """This rank's model and its `MeshLayout` (module docstring).
    `make_model(tp=..., layers=...)` builds the rank's model (empty weights
    are fine); `whole` is the whole model's state dict, whose parts the
    rank copies in. `shard_fsdp=False` leaves the fsdp axis to the caller
    (the model then holds its tp and pp part whole)."""
    from orv_tpu_torch.models.weights import shard_state_dict

    pp = mesh.shape["pp"]
    layers = stage_layers(num_layers, pp, mesh.coords["pp"]) if pp > 1 else None
    model = make_model(tp=mesh.tp if mesh.shape["tp"] > 1 else None, layers=layers)
    own = model.state_dict()
    whole_shapes = {k: tuple(v.shape) for k, v in whole.items()}
    params = {n for n, _ in model.named_parameters()}
    specs = param_shardings({n: whole_shapes[n] for n in own if n in params}, mesh.shape,
                            num_layers)
    placements: Dict[str, Placement] = {}
    for name, local in own.items():
        shape = whole_shapes[name]
        tp_dims = [d for d, (a, b) in enumerate(zip(shape, local.shape)) if a != b]
        spec = specs.get(name, ())
        pl = placement(name, shape, spec, bool(tp_dims)) if spec else \
            Placement(tp_dims[0] if tp_dims else None, None, _layer_of(name))
        if tp_dims and pl.tp_dim != tp_dims[0]:  # a split layer outside the JAX plan's
            pl = Placement(tp_dims[0], pl.fsdp_dim, pl.layer)
        if pl.fsdp_dim is not None:
            k = local.shape[pl.fsdp_dim] if pl.fsdp_dim >= 0 else 0
            if name not in params or k % mesh.shape["fsdp"] or k < mesh.shape["fsdp"]:
                pl = Placement(pl.tp_dim, None, pl.layer)
        placements[name] = pl
    model.load_state_dict(shard_state_dict({n: whole[n] for n in own}, placements, mesh,
                                           axes=("tp",)), strict=True)
    if shard_fsdp and mesh.shape["fsdp"] > 1:
        Zero(model, mesh.fsdp, {n: pl.fsdp_dim for n, pl in placements.items()
                                if pl.fsdp_dim is not None})
    return model, MeshLayout(mesh, placements, whole_shapes, num_layers)


def _layer_of(name: str) -> Optional[int]:
    m = _LAYER.match(name)
    return int(m.group(1)) if m else None
