"""Prodigy (Mishchenko and Defazio, arXiv 2306.06101), the inner rule of
`parallel/train_step.py:Optimizer` for `optimizer: prodigy`.

The port's own copy of `optax.contrib.prodigy` (optax 0.2.6) as the JAX
package calls it (`orv_tpu/parallel/train_step.py:98-114`): learning_rate
1.0 (the lr schedule is not used), betas (beta1, beta2), beta3 = sqrt(beta2)
for the d-estimate, eps, AdamW-style decay and safeguard_warmup from the
yaml, estim_lr0 1e-6. Per trainable parameter it keeps exp_avg, exp_avg_sq,
grad_sum and params0 (the parameter at init); the d-estimate `estim_lr` and
`numerator_weighted` are 0-d f32 tensors summed over every leaf, so the
leaves' order and layout do not matter. The scalar arithmetic runs in f32 on
the device, as JAX runs it, and never waits for the host:

    bc    = sqrt(1 - b2^k) / (1 - b1^k)          (k: this update's count)
    dlr   = d * bc;  dg = d * g
    num  += vdot(g, p0 - p)                      (over every leaf)
    m     = b1*m + (1-b1)*dg;  v = b2*v + (1-b2)*dg^2
    s     = b3*s + (dlr, or d with safeguard_warmup) * dg / d0
    nw    = b3*nw + (d / d0) * dlr * num
    d'    = max(d, nw / sum|s|)
    p    += -wd*dlr*p - dlr*m / (sqrt(v) + d'*eps)

Under a mesh (`parallel/fsdp.py:MeshLayout`) the numerator and `sum|s|`
are global sums: each rank adds the leaves it counts (`MeshLayout.owned`:
one replica of each) and the partial sums are added over every rank, so
every rank takes the same d-estimate.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


class Prodigy:
    """The prodigy rule (module docstring)."""

    def __init__(self, betas: Tuple[float, float] = (0.9, 0.999), beta3: Optional[float] = None,
                 eps: float = 1e-8, estim_lr0: float = 1e-6, estim_lr_coef: float = 1.0,
                 weight_decay: float = 0.0, safeguard_warmup: bool = False):
        self.b1, self.b2 = betas
        self.b3 = self.b2 ** 0.5 if beta3 is None else beta3
        self.eps, self.d0, self.coef = eps, estim_lr0, estim_lr_coef
        self.wd, self.safeguard_warmup = weight_decay, safeguard_warmup

    def init(self, params, names, mesh):
        zeros = lambda: {n: torch.zeros_like(p) for n, p in zip(names, params)}
        tensors = {"exp_avg": zeros(), "exp_avg_sq": zeros(), "grad_sum": zeros(),
                   "params0": {n: p.detach().clone() for n, p in zip(names, params)}}
        device = params[0].device if params else None
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return tensors, {"estim_lr": f32(self.d0), "numerator_weighted": f32(0.0)}, None

    def apply(self, u: List[torch.Tensor], params: List[torch.Tensor], state,
              lr: float) -> None:
        """`lr` is not used (learning_rate 1.0, as the JAX package passes it)."""
        t = state.tensors
        leaves = list(zip(u, params, *(t[k].values() for k in ("exp_avg", "exp_avg_sq",
                                                               "grad_sum", "params0"))))
        d = state.scalars["estim_lr"]
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=d.device)
        mesh = state.mesh
        counted = [mesh.owned(n) for n in t["exp_avg"]]
        k = f32(float(state.count))
        bc = (1 - f32(self.b2) ** k) ** 0.5 / (1 - f32(self.b1) ** k)
        dlr = d * bc
        num = f32(0.0)
        for (g, p, _, _, _, p0), c in zip(leaves, counted):
            if c:
                num = num + torch.dot(g.reshape(-1), (p0 - p).reshape(-1))
        denom = f32(0.0)
        s_lr = d if self.safeguard_warmup else dlr
        for (g, _, m, v, s, _), c in zip(leaves, counted):
            dg = g.mul_(d)  # the clipped mean gradients are the rule's to overwrite
            m.mul_(self.b1).add_((1 - self.b1) * dg)
            v.mul_(self.b2).add_((1 - self.b2) * dg * dg)
            s.mul_(self.b3).add_(s_lr * dg / self.d0)
            if c:
                denom = denom + s.abs().sum()
        num, denom = mesh.global_sum(torch.stack([num, denom])).unbind(0)
        nw = self.b3 * state.scalars["numerator_weighted"] + (d / self.d0) * dlr * num
        d_new = torch.maximum(d, self.coef * nw / denom)
        for _, p, m, v, _, _ in leaves:
            step = dlr * m / (v.sqrt() + d_new * self.eps)
            if self.wd:
                step = -self.wd * dlr * p - step
                p.add_(step)
            else:
                p.sub_(step)
        state.scalars["estim_lr"], state.scalars["numerator_weighted"] = d_new, nw
