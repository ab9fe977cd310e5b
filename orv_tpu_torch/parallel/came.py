"""CAME (Confidence-guided Adaptive Memory Efficient, arXiv 2307.02047), the
inner rule of `parallel/train_step.py:Optimizer` for `optimizer: came`.

Counterpart of `orv_tpu/parallel/came.py`, the same algorithm per leaf, in
float32:

    u   = g^2 + eps1                       (second-moment target)
    R   = b2*R + (1-b2)*mean(u, -1);  C = b2*C + (1-b2)*mean(u, -2)
    u   = g * rsqrt(R/mean(R,-1)) x rsqrt(C)        (factored rms approx)
    u   = u / max(1, rms(u)/clip_threshold)
    m   = b1*m + (1-b1)*u
    res = (u - m)^2 + eps2                 (instability)
    Rr  = b3*Rr + (1-b3)*mean(res, -1); Cr = b3*Cr + (1-b3)*mean(res, -2)
    out = m * rsqrt(Rr/mean(Rr,-1)) x rsqrt(Cr)
    p  -= lr * (out + weight_decay * p)    (decoupled decay)

A leaf with two or more axes keeps factored row and column moments over its
LAST TWO axes, and its rms is over the whole leaf; a 1-D leaf keeps a full
second moment and skips the confidence step. So the leaves must be the JAX
package's, and the port's parameters are not: JAX scans the DiT blocks, so
each block parameter is one leaf stacked [L, ...] over the layers (a block's
bias [L, D] is factored across layers), a flax Dense kernel is [in, out]
where a torch Linear weight is [out, in], and the 1.0 family's patch embed
is a Dense kernel [(c p p), D] where the port keeps a conv weight
[D, C, p, p]. `leaf_plan` groups the port's parameters into the JAX tree's
leaves: the same-named tensors of `transformer_blocks.{i}` (JAX
`blocks/block`) and of `mv_blocks.{i}` (`blocks/mv_block`) stack in layer
order, and each tensor takes JAX's layout (`to_jax`). The state lives in
that layout, one entry per leaf, keyed by the port's name with `*` for the
layer.

Under a mesh (`parallel/fsdp.py:MeshLayout`) a rank holds a piece of each
leaf: its pp stage's layers of a stacked leaf and its tp and fsdp pieces.
The factored row and column means, the normalising mean of `_approx_sq_grad`
and the rms run over the whole leaf (came.py:101-104), so each is a local
sum added over the communicator of the mesh axes that split the axis (or,
for the rms, the leaf) it reduces, then divided by the whole count. The
elementwise rest needs nothing. `state_splits` gives each state tensor's
split axes, for the checkpoint's gather.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

import torch

_BLOCK = re.compile(r"^(transformer_blocks|mv_blocks)\.(\d+)\.(.+)$")


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX tree: `key` (the port's name, `*` for a stacked
    layer index), the indices of its port tensors in the rule's parameter
    list (in layer order; one for a leaf that is not stacked), and its shape
    in JAX's layout."""

    key: str
    members: Tuple[int, ...]
    stacked: bool
    shape: Tuple[int, ...]
    first: int = 0  # the first layer of a stacked leaf (a pp stage's)


def to_jax(name: str, t: torch.Tensor) -> torch.Tensor:
    """A port tensor in the layout of its JAX leaf (a view where it can be):
    Linear weights [out, in] -> kernels [in, out], the conv patch embed
    [D, C, p, p] -> [(c p p), D], the action mask embedding [1, H] -> [H]."""
    if name.endswith("mask_embed.weight"):
        return t.reshape(-1)
    if t.dim() == 4:
        return t.reshape(t.shape[0], -1).t()
    if t.dim() == 2:
        return t.t()
    return t


def from_jax(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of `to_jax`, into a port tensor of `shape`."""
    if len(shape) == 4:
        return t.t().reshape(shape)
    if name.endswith("mask_embed.weight"):
        return t.reshape(shape)
    if t.dim() == 2:
        return t.t()
    return t


def leaf_plan(names: Sequence[str], shapes: Sequence[Sequence[int]]) -> List[Leaf]:
    """The JAX tree's leaves over the port's parameters `names` (module
    docstring). Raises if a block parameter is missing from a layer."""
    groups: Dict[str, List[Tuple[int, int]]] = {}
    for i, name in enumerate(names):
        m = _BLOCK.match(name)
        key = f"{m.group(1)}.*.{m.group(3)}" if m else name
        groups.setdefault(key, []).append((int(m.group(2)) if m else 0, i))
    plan = []
    for key, members in groups.items():
        stacked = "*" in key
        members.sort()
        first = members[0][0]
        if stacked and [layer for layer, _ in members] != list(range(first,
                                                                    first + len(members))):
            raise ValueError(f"{key}: layers {[layer for layer, _ in members]} are not "
                             "consecutive")
        idx = tuple(i for _, i in members)
        shape = tuple(to_jax(names[idx[0]], torch.empty(shapes[idx[0]], device="meta")).shape)
        plan.append(Leaf(key, idx, stacked, (len(idx), *shape) if stacked else shape, first))
    return plan


def jax_dim(name: str, torch_ndim: int, dim: int, stacked: bool) -> int:
    """The dim of the JAX leaf that holds dim `dim` of the port's tensor
    (`to_jax`'s layouts)."""
    if name.endswith("mask_embed.weight"):
        jd = 0
    elif torch_ndim in (2, 4):
        jd = 1 if dim == 0 else 0
    else:
        jd = dim
    return jd + 1 if stacked else jd


def leaf_axes(names, plan: List[Leaf], mesh) -> Dict[str, Tuple[Tuple[str, ...], ...]]:
    """{leaf key: for each dim of the JAX leaf, the mesh axes that split it
    (outermost first)}: a stacked leaf's layer axis over pp, the tp and fsdp
    dims of its members' placements (`mesh`: a MeshLayout)."""
    out = {}
    for leaf in plan:
        name = names[leaf.members[0]]
        pl = mesh.placements[name]
        axes = [[] for _ in leaf.shape]
        if leaf.stacked and mesh.mesh.shape["pp"] > 1:
            axes[0].append("pp")
        ndim = len(mesh.whole_shapes[name])
        for a, d in (("tp", pl.tp_dim), ("fsdp", pl.fsdp_dim)):
            if d is not None:
                axes[jax_dim(name, ndim, d, leaf.stacked)].append(a)
        out[leaf.key] = tuple(tuple(a) for a in axes)
    return out


def state_splits(layout, group: str, key: str) -> Dict[int, Tuple[str, ...]]:
    """The split axes of CAME's state tensor `group`/`key` under a mesh
    (for the checkpoint's gather): `m` and `sq` the leaf's, `row` and
    `res_row` without its last dim, `col` and `res_col` without the one
    before it."""
    axes = layout[2][key]
    n = len(axes)
    if group in ("row", "res_row"):
        dims = list(range(n - 1))
    elif group in ("col", "res_col"):
        dims = list(range(n - 2)) + [n - 1]
    else:
        dims = list(range(n))
    return {i: axes[d] for i, d in enumerate(dims) if axes[d]}


def _approx_sq_grad(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Rank-1 rsqrt reconstruction of a second moment (Adafactor eq. 4)."""
    r = torch.rsqrt(row / row.mean(dim=-1, keepdim=True))
    return r[..., None] * torch.rsqrt(col)[..., None, :]


class Came:
    """The CAME rule on the trainable parameters, leaf by leaf of the JAX
    tree (module docstring). Its state per leaf, in JAX's layout: `m` (full
    shape), `row` and `col` (the factored E[g^2]), `sq` (a 1-D leaf's full
    E[g^2]), `res_row` and `res_col` (the factored instability); a field the
    leaf's branch does not use has no entry."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, b3: float = 0.9999,
                 eps1: float = 1e-30, eps2: float = 1e-16, clip_threshold: float = 1.0,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.b3 = b1, b2, b3
        self.eps1, self.eps2 = eps1, eps2
        self.clip_threshold, self.wd = clip_threshold, weight_decay

    def init(self, params, names, mesh):
        plan = leaf_plan(names, [p.shape for p in params])
        tensors: Dict[str, Dict[str, torch.Tensor]] = {
            k: {} for k in ("m", "row", "col", "sq", "res_row", "res_col")}
        for leaf in plan:
            kw = dict(dtype=torch.float32, device=params[leaf.members[0]].device)
            shape = leaf.shape
            tensors["m"][leaf.key] = torch.zeros(shape, **kw)
            if len(shape) >= 2:
                for k, s in (("row", shape[:-1]), ("col", shape[:-2] + shape[-1:])):
                    tensors[k][leaf.key] = torch.zeros(s, **kw)
                    tensors["res_" + k][leaf.key] = torch.zeros(s, **kw)
            else:
                tensors["sq"][leaf.key] = torch.zeros(shape, **kw)
        axes = leaf_axes(names, plan, mesh)
        comms = {}  # every rank asks for the same groups in the same order
        for leaf in plan:
            ax = axes[leaf.key]
            dims = [mesh.mesh.comm_of(a) for a in ax]
            whole = mesh.mesh.comm_of(tuple(x for a in ax for x in a))
            comms[leaf.key] = None if whole.size == 1 else (dims, whole)
        return tensors, {}, (list(names), plan, axes, comms)

    def _jax_leaf(self, names, tensors, leaf: Leaf) -> torch.Tensor:
        parts = [to_jax(names[i], tensors[i]).float() for i in leaf.members]
        return torch.stack(parts) if leaf.stacked else parts[0]

    def apply(self, u: List[torch.Tensor], params: List[torch.Tensor], state,
              lr: float) -> None:
        names, plan, _, comms = state.layout
        s = state.tensors
        b1, b2, b3 = self.b1, self.b2, self.b3
        for leaf in plan:
            key = leaf.key
            dim_comms, all_comm = comms[key] or (None, None)

            def mean(x, dim=None):
                """x's mean over `dim` (None: all of x) of the whole leaf."""
                if dim_comms is None:
                    return x.mean() if dim is None else x.mean(dim=dim)
                if dim is None:
                    return all_comm.all_reduce_sum(x.sum()) / (x.numel() * all_comm.size)
                c = dim_comms[dim % len(dim_comms)]
                return c.all_reduce_sum(x.sum(dim=dim)) / (x.shape[dim] * c.size)

            def approx(row, col):
                # row's last axis is the leaf's axis -2
                if dim_comms is None:
                    return _approx_sq_grad(row, col)
                c = dim_comms[-2]
                norm = c.all_reduce_sum(row.sum(dim=-1, keepdim=True)) / (row.shape[-1] * c.size)
                return torch.rsqrt(row / norm)[..., None] * torch.rsqrt(col)[..., None, :]

            g = self._jax_leaf(names, u, leaf)
            u2 = g * g + self.eps1
            factored = g.dim() >= 2
            if factored:
                row = s["row"][key].mul_(b2).add_((1 - b2) * mean(u2, -1))
                col = s["col"][key].mul_(b2).add_((1 - b2) * mean(u2, -2))
                upd = g * approx(row, col)
            else:
                sq = s["sq"][key].mul_(b2).add_((1 - b2) * u2)
                upd = g * torch.rsqrt(sq)
            del u2, g
            rms = mean(upd.square()).sqrt()
            upd = upd / torch.clamp_min(rms / self.clip_threshold, 1.0)
            m = s["m"][key].mul_(b1).add_((1 - b1) * upd)
            if factored:
                res = (upd - m).square_().add_(self.eps2)
                res_row = s["res_row"][key].mul_(b3).add_((1 - b3) * mean(res, -1))
                res_col = s["res_col"][key].mul_(b3).add_((1 - b3) * mean(res, -2))
                del res
                out = m * approx(res_row, res_col)
            else:
                out = m
            del upd
            if self.wd:
                out = out + self.wd * self._jax_leaf(names, params, leaf)
            out = out * -lr
            for j, i in enumerate(leaf.members):
                part = out[j] if leaf.stacked else out
                params[i].add_(from_jax(names[i], part, params[i].shape))
