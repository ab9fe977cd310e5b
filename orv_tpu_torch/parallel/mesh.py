"""The device mesh and its sharding rules, over torch.distributed.

Counterpart of `orv_tpu/parallel/mesh.py`. The JAX package lays its devices
out as a `jax.sharding.Mesh` with axes (dp, fsdp, pp, tp, sp) and lets
GSPMD place the collectives. Here a mesh is a communicator of every rank
(`parallel/sp.py`: `LocalRing`, or `ProcessGroupRing` over a
`torch.distributed` group) split into one communicator per axis, and the
collectives are written out where the JAX package leaves them to XLA
(`models/layers.py` for tp, `parallel/fsdp.py` for fsdp, `parallel/pp.py`
for pp, `parallel/train_step.py` for the data axes):

    dp    data parallel: each rank takes its rows of the global batch, and
          the gradients are summed over the ranks;
    fsdp  ZeRO-3: parameters, optimizer state and EMA held as shards, each
          block's parameters gathered for its forward, their gradients
          reduce-scattered; the batch shards over (dp, fsdp);
    pp    the block stack split over pp stages (GPipe);
    tp    Megatron tensor parallelism: the attention's heads and the
          feed-forward's hidden columns split over the ranks;
    sp    the sequence ring of the joint attention (`ops/ring_attention.py`).

Ranks lie row-major over (dp, fsdp, pp, tp, sp), as
`np.asarray(devices).reshape(dp, fsdp, pp, tp, sp)` lays the JAX devices:
rank = (((dp * F + fsdp) * P + pp) * T + tp) * S + sp.

`param_shardings` is the JAX package's rule (`_spec_for`), applied to each
of the port's parameters at the name and shape of its JAX leaf (blocks
stacked [L, ...] under `blocks/block` and `blocks/mv_block`, Dense kernels
[in, out]), so the plan is held against JAX's `param_shardings` leaf by
leaf. `placement` turns a leaf's plan into the torch dims of the port's
tensor that a rank's copy splits.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Dict, Optional, Sequence, Tuple

from orv_tpu_torch.parallel.sp import SOLO, ProcessGroupRing

AXES = ("dp", "fsdp", "pp", "tp", "sp")


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, timeout: float = 600.0):
    """The communicator of every rank, or None for a single process.
    Already initialised: the ring over the default group. With
    `init_method` (an explicit address, "tcp://localhost:29500"): start the
    group there (NCCL where every rank has a card of its own, else gloo),
    and raise if that fails, naming the address: every process going on
    alone would repeat or corrupt the work. Else the environment of
    `torchrun` (`ProcessGroupRing.from_env`); None without one."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return ProcessGroupRing()
    if init_method:
        backend = "nccl" if torch.cuda.device_count() >= (world_size or 1) else "gloo"
        try:
            return ProcessGroupRing.init_process_group(backend, init_method, world_size, rank,
                                                       timeout)
        except Exception as e:
            raise RuntimeError(
                f"distributed bring-up failed (init_method {init_method!r}, "
                f"world_size={world_size}, rank={rank}): {e}") from e
    return ProcessGroupRing.from_env(timeout)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1: every rank the other axes leave
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        dp = self.dp
        if dp == -1:
            dp = n_devices // (self.fsdp * self.tp * self.pp * self.sp)
        if dp * self.fsdp * self.tp * self.pp * self.sp != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.fsdp}x{self.pp}x{self.tp}x{self.sp} != "
                f"{n_devices} devices"
            )
        return MeshConfig(dp=dp, fsdp=self.fsdp, tp=self.tp, pp=self.pp, sp=self.sp)


class Mesh:
    """A resolved mesh over the ranks `members` of the communicator `comm`
    (None: one rank; `members` None: every rank of `comm`, else the ranks
    it names, in mesh order). `shape[axis]`, `coords[axis]` (this rank's
    index on each axis), and `comm_of(axes)`: the communicator of the ranks
    that differ from this one only on `axes`, in rank order (the rank order
    of a group over several axes is row-major in `AXES` order). Every rank
    of `comm` builds the same mesh and so asks `comm` for the same groups in
    the same order (`ProcessGroupRing.split`), a rank outside `members`
    too: it is not `inside` and holds no coordinates, and every communicator
    it gets is a group of its own."""

    def __init__(self, config: MeshConfig, comm=None, members: Optional[Sequence[int]] = None):
        self.parent = comm if comm is not None else SOLO
        everyone = tuple(range(self.parent.size))
        self.members = everyone if members is None else tuple(members)
        self.config = config.resolve(len(self.members))
        self.shape = {a: getattr(self.config, a) for a in AXES}
        # the mesh's own communicator: the parent, or its group of the members
        self.comm = self.parent if self.members == everyone else self.parent.split([self.members])
        self.inside = self.parent.rank in self.members
        self.coords = {}
        if self.inside:
            r = self.members.index(self.parent.rank)
            for a in reversed(AXES):
                self.coords[a] = r % self.shape[a]
                r //= self.shape[a]
        self._comms: Dict[Tuple[str, ...], object] = {}
        # the groups every rank builds, in this order: one per axis and the data axes
        for axes in (("dp",), ("fsdp",), ("pp",), ("tp",), ("sp",), ("dp", "fsdp")):
            self.comm_of(axes)

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def rank(self) -> int:
        return self.comm.rank

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in AXES:
            r = r * self.shape[a] + coords[a]
        return r

    def comm_of(self, axes: Sequence[str]):
        axes = tuple(a for a in AXES if a in axes)
        if axes not in self._comms:
            if all(self.shape[a] == 1 for a in axes):
                self._comms[axes] = SOLO
            else:
                fixed = [a for a in AXES if a not in axes]
                groups = []
                for outer in itertools.product(*(range(self.shape[a]) for a in fixed)):
                    base = dict(zip(fixed, outer))
                    groups.append(tuple(
                        self.members[self.rank_of({**base, **dict(zip(axes, inner))})]
                        for inner in itertools.product(*(range(self.shape[a]) for a in axes))))
                # a group of every member is the mesh's own communicator
                whole = len(groups) == 1 and groups[0] == self.members
                self._comms[axes] = self.comm if whole else self.parent.split(groups)
        return self._comms[axes]

    @property
    def data(self):
        """The communicator of the batch axes (dp, fsdp)."""
        return self.comm_of(("dp", "fsdp"))

    @property
    def data_size(self) -> int:
        return self.shape["dp"] * self.shape["fsdp"]

    @property
    def data_index(self) -> int:
        """This rank's linearized (dp, fsdp) index: its shard of the batch."""
        return self.coords["dp"] * self.shape["fsdp"] + self.coords["fsdp"]

    def __getattr__(self, axis: str):
        """`mesh.tp` etc.: the communicator of one axis."""
        if axis in AXES:
            return self.comm_of((axis,))
        raise AttributeError(axis)


def make_mesh(config: MeshConfig = MeshConfig(), comm=None,
              members: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of `config` over `comm`'s ranks, or over its ranks `members`
    (`dp=-1` takes the rest); call it on every rank of `comm`."""
    return Mesh(config, comm, members)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of `batch` rows: the batch shards
    over the combined (dp, fsdp) axes, in (dp, fsdp) index order."""
    n = mesh.data_size
    if batch % n:
        raise ValueError(f"global batch {batch} not divisible by dp x fsdp = {n}")
    k = batch // n
    return slice(mesh.data_index * k, (mesh.data_index + 1) * k)


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

_TP_SHARD_OUT = ("to_q", "to_k", "to_v", "net_0_proj")  # column parallel
_TP_SHARD_IN = ("to_out", "net_2")  # row parallel


def _spec_for(names: Sequence[str], shape: Tuple[int, ...], mesh_shape: Dict[str, int]):
    """The JAX package's PartitionSpec of one leaf (orv_tpu/parallel/mesh.py
    `_spec_for`), as a tuple of None, an axis name or a tuple of names:
    tp on the column-parallel kernels' out dim and the row-parallel ones'
    in dim; fsdp on the largest free axis it divides (the output head's
    kernel on its in dim; stacked block kernels on their out dim, stacking
    on tp, except under sp); pp on the stacked blocks' layer axis."""
    tp_size = mesh_shape.get("tp", 1)
    fsdp_size = mesh_shape.get("fsdp", 1)
    pp_size = mesh_shape.get("pp", 1)
    spec = [None] * len(shape)
    start = 1 if "blocks" in names and len(shape) > 1 else 0
    if pp_size > 1 and start == 1 and shape[0] % pp_size == 0:
        spec[0] = "pp"
    if tp_size > 1 and "kernel" in names and len(shape) >= 2:
        parent = names[-2] if len(names) >= 2 else ""
        if any(t in parent for t in _TP_SHARD_OUT) and shape[-1] % tp_size == 0:
            spec[-1] = "tp"
        elif any(t in parent for t in _TP_SHARD_IN) and shape[-2] % tp_size == 0:
            spec[-2] = "tp"
    if fsdp_size > 1:
        sp_active = mesh_shape.get("sp", 1) > 1
        scanned_kernel = (start == 1 and "kernel" in names and len(shape) >= 3
                          and not sp_active)
        if "proj_out" in names and "kernel" in names and len(shape) >= 2:
            order = [len(shape) - 2]
        elif scanned_kernel:
            order = [len(shape) - 1, len(shape) - 2]
        else:
            order = sorted(range(start, len(shape)), key=lambda i: -shape[i])
        for i in order:
            if spec[i] is None and shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
                spec[i] = "fsdp"
                break
            if (scanned_kernel and spec[i] == "tp" and i == len(shape) - 1
                    and shape[i] % (tp_size * fsdp_size) == 0):
                spec[i] = ("tp", "fsdp")
                break
    return tuple(spec)


_BLOCK = re.compile(r"^(transformer_blocks|mv_blocks)\.(\d+)\.(.+)$")
_LEAF_NAMES = {  # the port's module path -> the JAX leaf's path within its parent
    "to_out.0": "to_out", "ff.net.0.proj": "ff.net_0_proj", "ff.net.2": "ff.net_2",
    "action_embed.mlp.0": "action_embed.fc1", "action_embed.mlp.3": "action_embed.fc2",
    "action_recon.mlp.0": "action_recon.fc1", "action_recon.mlp.2": "action_recon.fc2",
}


def jax_leaf(name: str, shape: Sequence[int], num_layers: int):
    """(path names, shape) of the JAX leaf that holds the port's parameter
    `name` of torch shape `shape` (a block's leaf stacked over
    `num_layers`)."""
    m = _BLOCK.match(name)
    stem = m.group(3) if m else name
    for port, jax in _LEAF_NAMES.items():
        stem = stem.replace(port, jax)
    parts = stem.split(".")
    leaf = parts[-1]
    owner = parts[:-1]
    if leaf == "weight" and owner and owner[-1] in ("norm", "norm_q", "norm_k", "norm_final"):
        leaf = "scale"
    if owner and owner[-1] == "norm" and len(owner) >= 2 and owner[-2].startswith("norm"):
        owner, leaf = owner[:-1], f"norm_{'scale' if leaf == 'scale' else leaf}"
    elif owner and owner[-1] == "linear" and len(owner) >= 2 and owner[-2].startswith("norm"):
        owner, leaf = owner[:-1], f"linear_{'kernel' if leaf == 'weight' else leaf}"
    elif owner and owner[-1] == "cam_encoder":
        owner, leaf = owner[:-1], f"cam_encoder_{'kernel' if leaf == 'weight' else leaf}"
    elif owner and owner[-1] == "mask_embed":
        owner, leaf = owner[:-1], "mask_embed"
    elif leaf == "weight":
        leaf = "kernel"
    names = ["params"]
    if m:
        names += ["blocks", "block" if m.group(1) == "transformer_blocks" else "mv_block"]
    names += owner + [leaf]
    jshape = _jax_shape(name, tuple(shape))
    if m:
        jshape = (num_layers, *jshape)
    return tuple(names), jshape


def _jax_shape(name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if name.endswith("mask_embed.weight"):
        return shape[1:]
    if len(shape) == 4:  # conv patch embed [D, C, p, p] -> [(c p p), D]
        return (shape[1] * shape[2] * shape[3], shape[0])
    if len(shape) == 2:
        return shape[::-1]
    return shape


def torch_dim(name: str, torch_ndim: int, jax_dim: int, stacked: bool) -> int:
    """The torch dim of the port's tensor that holds the JAX leaf's dim
    `jax_dim` (the layer axis of a stacked leaf has none: -1)."""
    if stacked:
        if jax_dim == 0:
            return -1
        jax_dim -= 1
    if name.endswith("mask_embed.weight"):
        return 1
    if torch_ndim == 4:  # [(c p p), D]: dim 0 is C's (c-major), dim 1 is D
        return 1 if jax_dim == 0 else 0
    if torch_ndim == 2:
        return 1 - jax_dim
    return jax_dim


def param_shardings(named_shapes: Dict[str, Sequence[int]], mesh_shape: Dict[str, int],
                    num_layers: int) -> Dict[str, tuple]:
    """{port parameter name: the JAX package's spec of its leaf}, the spec
    in the JAX leaf's layout (`jax_leaf`)."""
    out = {}
    for name, shape in named_shapes.items():
        names, jshape = jax_leaf(name, shape, num_layers)
        out[name] = _spec_for(names, jshape, mesh_shape)
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank's copy of one port tensor comes from: `tp_dim` and
    `fsdp_dim`, the torch dims split over tp and fsdp (fsdp splits the
    tp-split tensor further, so that a dim split both ways holds tp's
    pieces in order, each cut in fsdp pieces: JAX's ('tp', 'fsdp')), and
    `layer`, the block layer of a stacked leaf (None for the rest). A rank
    holds a block's tensors only if its pp stage holds that layer."""

    tp_dim: Optional[int] = None
    fsdp_dim: Optional[int] = None
    layer: Optional[int] = None


def placement(name: str, shape: Sequence[int], spec: tuple, tp_applied: bool) -> Placement:
    """The Placement of the port's parameter `name` (whole torch shape
    `shape`) under its JAX spec. `tp_applied`: whether the rank's module
    splits this tensor over tp (the port keeps an attention whole on every
    rank where tp does not divide its heads, and a feed-forward where it
    does not divide its hidden width: `models/layers.py`)."""
    m = _BLOCK.match(name)
    stacked = m is not None
    tp_dim = fsdp_dim = None
    for jd, axes in enumerate(spec):
        axes = axes if isinstance(axes, tuple) else (axes,)
        d = torch_dim(name, len(shape), jd, stacked)
        if "tp" in axes and tp_applied:
            tp_dim = d
        if "fsdp" in axes:
            fsdp_dim = d
    return Placement(tp_dim, fsdp_dim, int(m.group(2)) if stacked else None)


def stage_layers(num_layers: int, pp: int, stage: int) -> range:
    """The block layers pp stage `stage` holds: L/pp consecutive ones."""
    n = num_layers // pp
    return range(stage * n, (stage + 1) * n)
