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
        if stacked and [layer for layer, _ in members] != list(range(len(members))):
            raise ValueError(f"{key}: layers {[layer for layer, _ in members]} are not 0..L-1")
        idx = tuple(i for _, i in members)
        shape = tuple(to_jax(names[idx[0]], torch.empty(shapes[idx[0]], device="meta")).shape)
        plan.append(Leaf(key, idx, stacked, (len(idx), *shape) if stacked else shape))
    return plan


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

    def init(self, params, names):
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
        return tensors, {}, (list(names), plan)

    def _jax_leaf(self, names, tensors, leaf: Leaf) -> torch.Tensor:
        parts = [to_jax(names[i], tensors[i]).float() for i in leaf.members]
        return torch.stack(parts) if leaf.stacked else parts[0]

    def apply(self, u: List[torch.Tensor], params: List[torch.Tensor], state,
              lr: float) -> None:
        names, plan = state.layout
        s = state.tensors
        b1, b2, b3 = self.b1, self.b2, self.b3
        for leaf in plan:
            key = leaf.key
            g = self._jax_leaf(names, u, leaf)
            u2 = g * g + self.eps1
            factored = g.dim() >= 2
            if factored:
                row = s["row"][key].mul_(b2).add_((1 - b2) * u2.mean(dim=-1))
                col = s["col"][key].mul_(b2).add_((1 - b2) * u2.mean(dim=-2))
                upd = g * _approx_sq_grad(row, col)
            else:
                sq = s["sq"][key].mul_(b2).add_((1 - b2) * u2)
                upd = g * torch.rsqrt(sq)
            del u2, g
            rms = upd.square().mean().sqrt()
            upd = upd / torch.clamp_min(rms / self.clip_threshold, 1.0)
            m = s["m"][key].mul_(b1).add_((1 - b1) * upd)
            if factored:
                res = (upd - m).square_().add_(self.eps2)
                res_row = s["res_row"][key].mul_(b3).add_((1 - b3) * res.mean(dim=-1))
                res_col = s["res_col"][key].mul_(b3).add_((1 - b3) * res.mean(dim=-2))
                del res
                out = m * _approx_sq_grad(res_row, res_col)
            else:
                out = m
            del upd
            if self.wd:
                out = out + self.wd * self._jax_leaf(names, params, leaf)
            out = out * -lr
            for j, i in enumerate(leaf.members):
                part = out[j] if leaf.stacked else out
                params[i].add_(from_jax(names[i], part, params[i].shape))
