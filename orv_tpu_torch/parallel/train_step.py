"""Training step: v-prediction diffusion loss + action recon; AdamW, CAME, prodigy.

Counterpart of `orv_tpu/parallel/train_step.py` on one GPU. The loss
replicates the JAX package's (and so the reference train loop's):

  latents   = sample(moments) * vae_scaling_factor
  x_t       = add_noise(latents, eps, t)
  model_in  = concat([x_t, image_latents], channel)     (image-CFG dropout 5%)
  v_pred    = model(model_in, ...)
  x0_pred   = sqrt(abar)*x_t - sqrt(1-abar)*v_pred
  loss      = mean_b[ mean_tokens( w_t * (x0_pred - latents)^2 [frame_mask] ) ]
              + 0.4*rot + 5*pos + 1*grip action-recon losses over ~action_mask

Random draws are kept apart from the arithmetic: `LossDraws` holds every
random number one loss evaluation takes (the JAX package splits its rng
seven ways for the same draws, train_step.py:259), `LossDraws.draw` makes
them on the device from a `torch.Generator`, and `diffusion_loss` takes
them as an argument, so a test can hand both packages the same numbers.

The loss takes the rest of the model surface as the JAX package's does:
`num_views` for a multiview model's per-view latents, `image_rotary_emb`
for a RoPE model's tables, and `patch_size_t` for the 1.5 family's frame
padding (zeros at the end to a multiple of pt, the actions by 4 raw frames a
padded latent frame, the padded tail out of `frame_mask`).

The optimizer follows optax, not torch's defaults: `make_optimizer` builds
`MultiSteps(chain(multi_transform({train: chain(clip_by_global_norm,
rule), freeze: set_to_zero}), params_ema), k)` as one in-place `Optimizer`
whose rule is Adam(W), CAME (`parallel/came.py`) or prodigy
(`parallel/prodigy.py`): the lr of applied update k is `schedule(k)` counted
from 0; the clip scales by max_norm/norm only when norm >= max_norm, with no
epsilon, over the trainable parameters only; accumulation keeps the running
mean of the k micro-gradients and updates on the k-th; a
`trainable_predicate` freezes the parameters it rejects, which still take
gradients (the logged grad norm covers them) but never move, and the EMA
covers every parameter. JAX's arrays are immutable; here the parameters,
the rule's state and the accumulator are updated in place to save memory.

`state_tensors` / `load_state_tensors` flatten a `TrainState` (the
parameters, the rule's tensors and scalars, the accumulator and the EMA)
into named tensors and scalars and back, for `utils/checkpoint.py`.

Every state carries its parameters' `parallel/fsdp.py:MeshLayout`
(`TrainState.mesh`): on one device, and under dp or sp alone, the
trivial one of a model held whole (`MeshLayout.whole`), whose gathers are
identities. Under sequence parallelism (`ControlDiT(sp=...)`,
`pipelines/train.py`'s `train.mesh.sp`) the ring's collectives give every
rank the same gradients, bit for bit, so the clip, the grad norm, the EMA
and the update agree.

On a mesh (`parallel/mesh.py`, `parallel/fsdp.py`) the step computes the
single-device step's function,
as the JAX package's `make_train_step(mesh=...)` does under GSPMD
(orv_tpu/parallel/train_step.py:348-395): every rank holds the global
batch and the global batch's `LossDraws` (the whole-batch image-dropout
uniform one value for all) and takes its rows of both (`batch_sharding`);
the loss is the global batch's, its per-row terms gathered over the data
axes (dp, fsdp) in rank order (`diffusion_loss(data=...)`); each leaf's
gradient is summed over those axes (`MeshLayout.reduce_grads`), fsdp's
shards by their gather's reduce-scatter; tp, pp and sp replicas hold
their whole gradients already. The global norms (the clip's over the
trainable leaves, the logged `grad_norm` over all) sum each tensor's
squares once, on the rank that holds its replica 0 of every axis it is
replicated over, over every rank; CAME's factored means and rms and
prodigy's d-estimate sums reduce over the axes that split their leaves.
AdamW and the EMA are elementwise and need nothing. A state's checkpoint
form gathers every shard back into whole tensors under the resident
names (`state_tensors`), so a run saved at one mesh resumes at another.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from orv_tpu_torch.parallel.came import Came, state_splits
from orv_tpu_torch.parallel.fsdp import MeshLayout, named_leaves
from orv_tpu_torch.parallel.mesh import batch_sharding
from orv_tpu_torch.parallel.prodigy import Prodigy
from orv_tpu_torch.parallel.sp import all_gather, replicated_output
from orv_tpu_torch.pipelines.sample import sample_from_moments
from orv_tpu_torch.schedulers.scheduling import (
    DiffusionSchedule,
    add_noise,
    loss_weights,
    pred_x0_from_v,
)


# ---------------------------------------------------------------------------
# Learning-rate schedules
# ---------------------------------------------------------------------------

def make_lr_schedule(
    name: str = "cosine_with_restarts",
    learning_rate: float = 2e-4,
    warmup_steps: int = 1000,
    total_steps: int = 20000,
    num_cycles: int = 1,
    power: float = 1.0,
) -> Callable[[int], float]:
    """HF-diffusers-compatible LR schedules as optax builds them: a linear
    warmup from 0 over `warmup_steps`, then the named decay over
    `total_steps - warmup_steps`, counted from the end of the warmup."""
    lr = learning_rate
    warm = max(1, warmup_steps)
    decay_steps = max(1, total_steps - warmup_steps)
    if name == "constant":
        def main(n):
            return lr
    elif name == "linear":
        def main(n):
            return lr * (1.0 - min(max(n, 0), decay_steps) / decay_steps)
    elif name == "cosine":
        def main(n):
            return lr * 0.5 * (1.0 + math.cos(math.pi * min(n, decay_steps) / decay_steps))
    elif name == "cosine_with_restarts":
        # HF get_cosine_with_hard_restarts_schedule_with_warmup: restarts at
        # cycle boundaries, exactly 0 at and after the end
        def main(n):
            progress = n / decay_steps
            if progress >= 1.0:
                return 0.0
            return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((num_cycles * progress) % 1.0))))
    elif name == "polynomial":
        def main(n):
            return lr * (1.0 - min(max(n, 0), decay_steps) / decay_steps) ** power
    else:
        raise ValueError(f"unknown lr scheduler {name}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * min(max(step, 0), warm) / warm
        return main(step - warmup_steps)

    return schedule


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptState:
    """The optimizer's state: `count` applied updates (the schedule's step);
    the inner rule's tensors as named groups (`tensors[group][leaf]`: Adam's
    mu and nu, CAME's m, row, col, sq, res_row, res_col, prodigy's exp_avg,
    exp_avg_sq, grad_sum, params0; a field a leaf does not use has no entry)
    and its 0-d f32 `scalars`; `mask`, which of the step's parameters train
    (the others are frozen); the MultiSteps position and the running mean of
    the trainable parameters' micro-gradients; the optional EMA of every
    parameter. `layout` is what the rule derived from the parameters' names
    at init (CAME's leaf plan), not part of a checkpoint."""

    count: int
    tensors: Dict[str, Dict[str, torch.Tensor]]
    mask: List[bool]
    scalars: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None
    ema: Optional[List[torch.Tensor]] = None
    layout: Any = None
    mesh: Any = None  # the parameters' `parallel/fsdp.py:MeshLayout`
    names: Optional[List[str]] = None  # the step's parameter names, in order

    @property
    def mu(self) -> List[torch.Tensor]:
        """Adam's first moments, in the trainable parameters' order."""
        return list(self.tensors["mu"].values())

    @property
    def nu(self) -> List[torch.Tensor]:
        """Adam's second moments, in the trainable parameters' order."""
        return list(self.tensors["nu"].values())


def global_norm(tensors: Sequence[torch.Tensor], names: Optional[Sequence[str]] = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), f32.
    Over the ranks of a mesh of more than one (`mesh`, a MeshLayout, and
    the tensors' `names`): each rank's tensors that it counts
    (`MeshLayout.owned`), summed over every rank."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if mesh is None or mesh.mesh.size == 1:
        return torch.linalg.vector_norm(torch.stack(norms))
    owned = torch.tensor([mesh.owned(n) for n in names], device=norms[0].device)
    sq = (torch.stack(norms).square() * owned).sum()
    return mesh.global_sum(sq).sqrt()


def _chunks(n: int, size: int = 32):
    """Slices of range(n), `size` at a time: a rule's foreach temporaries stay
    a few tensors' size."""
    return (slice(i, min(i + size, n)) for i in range(0, n, size))


class Adam:
    """optax.adamw's update (adam: weight_decay 0) on the trainable leaves:
    moments mu and nu per leaf, bias-corrected, eps outside the square root,
    decoupled decay lr*wd*p."""

    def __init__(self, beta1: float, beta2: float, epsilon: float, weight_decay: float):
        self.b1, self.b2, self.eps, self.wd = beta1, beta2, epsilon, weight_decay

    def init(self, params, names, mesh):
        return {"mu": {n: torch.zeros_like(p) for n, p in zip(names, params)},
                "nu": {n: torch.zeros_like(p) for n, p in zip(names, params)}}, {}, None

    def apply(self, u: List[torch.Tensor], params: List[torch.Tensor], state: OptState,
              lr: float) -> None:
        """Update `params` in place by the clipped mean gradients `u` (owned:
        they may be overwritten); `state.count` is this update's, from 1."""
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        mus, nus = state.mu, state.nu
        for sl in _chunks(len(params)):
            p, g, mu, nu = params[sl], u[sl], mus[sl], nus[sl]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            step = torch._foreach_div(mu, bc1)
            torch._foreach_div_(step, denom)
            del denom
            if self.wd:
                torch._foreach_add_(step, p, alpha=self.wd)
            torch._foreach_add_(p, step, alpha=-lr)


class Optimizer:
    """optax.MultiSteps(chain(multi_transform({"train": chain(
    clip_by_global_norm(max_grad_norm), rule), "freeze": set_to_zero()}),
    params_ema), k) applied in place, as the JAX package's `make_optimizer`
    builds it: `update` changes the parameters on every k-th call.

    With a `trainable_predicate(name)`, the parameters it rejects are frozen:
    they still take gradients (the step's `grad_norm` is over every
    parameter, as JAX logs it), but the rule, its state and the clip's norm
    cover the trainable ones only, and the frozen ones never move (no decay
    either). The running mean of the micro-gradients is kept for the
    trainable parameters only: MultiSteps accumulates every leaf, but a
    frozen leaf's mean reaches nothing but `set_to_zero`. The EMA comes
    after the multi_transform and covers every parameter."""

    def __init__(self, schedule: Callable[[int], float], rule, max_grad_norm: float,
                 grad_accum_steps: int = 1, ema_decay: Optional[float] = None,
                 trainable_predicate: Optional[Callable[[str], bool]] = None):
        self.schedule, self.rule = schedule, rule
        self.max_grad_norm = max_grad_norm
        self.k = grad_accum_steps
        self.ema_decay = ema_decay
        self.trainable_predicate = trainable_predicate

    def init(self, params: Sequence[torch.Tensor],
             names: Optional[Sequence[str]] = None, mesh=None) -> OptState:
        """The state for `params` (every parameter the step differentiates),
        named by `names` (the model's parameter names; without them the
        parameters are named by position and none is frozen). `mesh`: the
        parameters' MeshLayout (default: held whole on one rank)."""
        params = list(params)
        if names is None:
            if self.trainable_predicate is not None:
                raise ValueError("a trainable_predicate needs the parameters' names")
            names = [str(i) for i in range(len(params))]
        if mesh is None:
            mesh = MeshLayout.whole({n: p.shape for n, p in zip(names, params)})
        pred = self.trainable_predicate
        mask = [True if pred is None else bool(pred(n)) for n in names]
        train = [(n, p) for n, p, m in zip(names, params, mask) if m]
        tensors, scalars, layout = self.rule.init([p for _, p in train], [n for n, _ in train],
                                                  mesh)
        ema = None if self.ema_decay is None else [p.detach().clone() for p in params]
        return OptState(count=0, tensors=tensors, mask=mask, scalars=scalars, ema=ema,
                        layout=layout, mesh=mesh, names=list(names))

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> None:
        """Take `grads` (owned from here on: they may be updated in place)."""
        grads = [g for g, m in zip(grads, state.mask) if m]
        if state.mini_step == 0:
            state.acc = grads  # acc + (g - acc) / 1 with acc = 0
        else:  # optax's running mean of the micro-gradients
            for i, g in enumerate(grads):
                state.acc[i].add_((g - state.acc[i]) / (state.mini_step + 1))
        if state.mini_step < self.k - 1:
            state.mini_step += 1
            return
        u, params = state.acc, list(params)
        state.acc, state.mini_step = None, 0

        # clip_by_global_norm over the trainable leaves: t / norm * max_norm
        # when norm >= max_norm
        norm = global_norm(u, [n for n, m in zip(state.names or [], state.mask) if m],
                           state.mesh)
        trigger = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(u, torch.where(trigger, one, norm))
        torch._foreach_mul_(u, torch.where(trigger, one, one * self.max_grad_norm))

        lr = self.schedule(state.count)
        state.count += 1
        self.rule.apply(u, [p for p, m in zip(params, state.mask) if m], state, lr)
        del u
        if state.ema is not None:
            for sl in _chunks(len(params)):
                torch._foreach_mul_(state.ema[sl], self.ema_decay)
                torch._foreach_add_(state.ema[sl], params[sl], alpha=1.0 - self.ema_decay)


def make_optimizer(
    learning_rate_schedule: Callable[[int], float],
    optimizer: str = "adamw",
    beta1: float = 0.9,
    beta2: float = 0.95,
    epsilon: float = 1e-8,
    weight_decay: float = 1e-3,
    max_grad_norm: float = 1.0,
    grad_accum_steps: int = 1,
    trainable_predicate: Optional[Callable[[str], bool]] = None,
    beta3: float = 0.98,
    prodigy_safeguard_warmup: bool = False,
    prodigy_decouple: bool = False,
    prodigy_use_bias_correction: bool = False,
    ema_decay: Optional[float] = None,
) -> Optimizer:
    """The JAX package's `make_optimizer`, its arguments in its order:
    "adam" (no decay), "adamw", "came" (`parallel/came.py`: eps 1e-30 and
    1e-16, betas (beta1, beta2, beta3), decoupled decay; `epsilon` unused)
    or "prodigy" (`parallel/prodigy.py`, optax.contrib.prodigy with
    learning_rate 1.0: the schedule is not used; betas (beta1, beta2), eps,
    decay, safeguard_warmup). `trainable_predicate(name)` takes a parameter
    name of the port's model (`mv_blocks.3.attn1.to_q.weight`) and freezes
    the parameters it rejects (`Optimizer`)."""
    if optimizer in ("adam", "adamw"):
        rule = Adam(beta1, beta2, epsilon, weight_decay if optimizer == "adamw" else 0.0)
    elif optimizer == "prodigy":
        if prodigy_decouple or prodigy_use_bias_correction:
            raise ValueError(
                "prodigy_decouple / prodigy_use_bias_correction are not supported by the "
                "optax prodigy implementation (reference defaults are false — leave them "
                "unset)")
        rule = Prodigy(betas=(beta1, beta2), eps=epsilon, weight_decay=weight_decay,
                       safeguard_warmup=prodigy_safeguard_warmup)
    elif optimizer == "came":
        rule = Came(beta1, beta2, beta3, weight_decay=weight_decay)
    else:
        raise ValueError(f"unsupported optimizer {optimizer} (adam/adamw/prodigy/came); the "
                         "reference's bnb-8bit/torchao-4bit variants are not ported")
    return Optimizer(learning_rate_schedule, rule, max_grad_norm, grad_accum_steps,
                     None if ema_decay is None else float(ema_decay), trainable_predicate)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LossDraws:
    """Every random number of one `diffusion_loss` evaluation."""

    lat_noise: torch.Tensor  # [B, C, F, H, W] to sample the video latents' moments
    img_noise: torch.Tensor  # [B, C, F_img, H, W] to sample the image latents' moments
    noise: torch.Tensor  # [B, F, C, H, W] diffusion noise (F padded as the loss pads it)
    t: torch.Tensor  # [B] int64 timesteps
    drop_u: torch.Tensor  # [] uniform of the whole-batch image-CFG dropout
    mask_u: torch.Tensor  # [B] uniforms of the action-CFG mask
    # [B, C, F, H, W] to sample the depth and label moments; None when the
    # batch has no such key (JAX: r_cond and fold_in(r_cond, 1))
    depth_noise: Optional[torch.Tensor] = None
    label_noise: Optional[torch.Tensor] = None

    def rows(self, sl: slice) -> "LossDraws":
        """The draws of the batch's rows `sl` (a mesh rank's): every per-row
        field sliced, the whole-batch dropout uniform kept."""
        cut = lambda x: None if x is None else x[sl]
        return LossDraws(lat_noise=cut(self.lat_noise), img_noise=cut(self.img_noise),
                         noise=cut(self.noise), t=cut(self.t), drop_u=self.drop_u,
                         mask_u=cut(self.mask_u), depth_noise=cut(self.depth_noise),
                         label_noise=cut(self.label_noise))

    @classmethod
    def draw(cls, generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
             num_train_timesteps: int = 1000, patch_size_t: Optional[int] = None) -> "LossDraws":
        """Fresh draws for `batch` on its device. With `patch_size_t`, the
        diffusion noise covers the frames the loss pads to a multiple of it."""
        lat, img = batch["latents"], batch["image_latents"]
        B, C2, F, H, W = lat.shape
        kw = dict(generator=generator, device=lat.device)
        F_noise = F + (-F % patch_size_t if patch_size_t else 0)

        def moment_noise(key):
            m = batch.get(key)
            return None if m is None else torch.randn(B, m.shape[1] // 2, *m.shape[2:], **kw)

        return cls(lat_noise=torch.randn(B, C2 // 2, F, H, W, **kw),
                   img_noise=torch.randn(B, img.shape[1] // 2, *img.shape[2:], **kw),
                   noise=torch.randn(B, F_noise, C2 // 2, H, W, **kw),
                   t=torch.randint(0, num_train_timesteps, (B,), **kw),
                   drop_u=torch.rand((), **kw), mask_u=torch.rand(B, **kw),
                   depth_noise=moment_noise("latents_depth"),
                   label_noise=moment_noise("latents_label"))


@dataclasses.dataclass
class EvalDraws:
    """Every random number of one denoise through the serving entry points:
    a batch of `pipelines/evaluate.py:evaluate`, a chunk of its cascaded
    rollout, or `pipelines/inference.py:generate_video`. A noise the call
    does not need is None."""

    noise: torch.Tensor  # [B, F, C, H, W] initial latents
    image_noise: Optional[torch.Tensor] = None  # [B, C, F_img, H, W] samples the image moments
    depth_noise: Optional[torch.Tensor] = None  # [B, C, F, H, W] samples the depth moments
    label_noise: Optional[torch.Tensor] = None  # [B, C, F, H, W] samples the label moments
    generator: Optional[torch.Generator] = None  # feeds the stochastic DPM steps

    @classmethod
    def draw(cls, generator: torch.Generator, noise_shape, image_shape=None, depth_shape=None,
             label_shape=None) -> "EvalDraws":
        """Fresh standard normals of the given shapes from `generator`, on its
        device, which then also feeds the sampler."""
        def randn(shape):
            return None if shape is None else torch.randn(tuple(shape), generator=generator,
                                                          device=generator.device)

        return cls(noise=randn(noise_shape), image_noise=randn(image_shape),
                   depth_noise=randn(depth_shape), label_noise=randn(label_shape),
                   generator=generator)


def _smooth_l1(x, y):
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def compute_action_loss(actions, recon, mask, weights=(0.4, 5.0, 1.0), rows=None):
    """rot = 1 - mean cos(delta euler); pos and grip smooth-L1, grip through
    a sigmoid; each a mean over the batch entries `mask` selects (those whose
    actions were not CFG-masked). Returns the three weighted terms. `rows`
    (a mesh rank's): gathers each per-row term over the data axes before
    the batch mean, so the terms are the global batch's."""
    rows = rows or (lambda x: x)
    mask_f = rows(mask.float())
    denom = mask_f.sum().clamp_min(1.0)
    actions, recon = actions.float(), recon.float()

    def masked_mean(x):
        per_b = rows(x.mean(dim=tuple(range(1, x.dim()))))
        return (per_b * mask_f).sum() / denom

    rot = 1.0 - masked_mean(torch.cos(recon[..., 3:6] - actions[..., 3:6]))
    pos = masked_mean(_smooth_l1(recon[..., :3], actions[..., :3]))
    grip = masked_mean(_smooth_l1(torch.sigmoid(recon[..., -1]), actions[..., -1]))
    return weights[0] * rot, weights[1] * pos, weights[2] * grip


def diffusion_loss(
    model: torch.nn.Module,
    batch: Dict[str, torch.Tensor],
    schedule: DiffusionSchedule,
    draws: LossDraws,
    vae_scaling_factor: float = 1.15258426,
    noised_image_dropout: float = 0.05,
    recon_action: bool = False,
    num_views: int = 1,
    image_rotary_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    patch_size_t: Optional[int] = None,
    data=None,
    data_mean: str = "rows",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One loss evaluation of the ControlDiT `model`. batch keys ([B, ...],
    the reference collate's layouts): 'latents' (moments [B, 2C, F, H, W];
    a multiview batch stacks its `num_views` views on F), 'image_latents'
    (moments, F_img frames), 'prompt_embeds', optional 'actions' [B, F_raw, 7],
    'frame_mask' [F] and the visual-control moments 'latents_depth' /
    'latents_label' [B, 2C, F, H, W], each sampled with its `draws` noise,
    scaled and duplicated to 2C channels as the model's `depths` / `labels`.
    `image_rotary_emb`: a RoPE model's (cos, sin) tables for one view.
    `patch_size_t` (the 1.5 family): a frame count it does not divide is
    zero-padded at the end to a multiple of it, the actions by 4 raw frames
    a padded latent frame and the control latents alike, and the padded
    tail leaves the loss through `frame_mask` (merged with the batch's);
    single-view only, as in the JAX package. Returns (loss, metrics); the
    metrics are detached.

    `data`: the communicator of a mesh's data axes (dp, fsdp), whose ranks
    each pass their rows of the batch and of the draws. With `data_mean`
    "rows" the loss is the global batch's, every per-row term gathered in
    rank order (the resident mesh step's); with "shards", the mean of the
    ranks' own losses (the pipeline step's pmean). Either way every rank
    returns the same loss, a replicated output: its cotangent is divided
    over the ranks (`parallel/sp.py`), so each rank's gradients are its
    rows' share, to be summed over the data axes."""
    multi = data is not None and data.size > 1
    rows = (lambda x: all_gather(data, x.reshape(-1), 0)) if multi and data_mean == "rows" \
        else None
    lat = sample_from_moments(batch["latents"], noise=draws.lat_noise) * vae_scaling_factor
    lat = lat.permute(0, 2, 1, 3, 4)  # [B, F, C, H, W]
    img = sample_from_moments(batch["image_latents"], noise=draws.img_noise) * vae_scaling_factor
    img = img.permute(0, 2, 1, 3, 4)
    actions, frame_mask = batch.get("actions"), batch.get("frame_mask")
    pad_frames = 0
    if patch_size_t and lat.shape[1] % patch_size_t:
        if num_views > 1:
            raise ValueError("patch_size_t frame padding is single-view only "
                             "(matches the reference train loop)")
        pad_frames = patch_size_t - lat.shape[1] % patch_size_t
        lat = torch.cat([lat, lat.new_zeros((lat.shape[0], pad_frames, *lat.shape[2:]))], dim=1)
        if actions is not None:
            actions = torch.cat([actions, actions.new_zeros(
                (actions.shape[0], pad_frames * 4, actions.shape[2]))], dim=1)
        fm = torch.ones(lat.shape[1], dtype=torch.bool, device=lat.device)
        fm[-pad_frames:] = False
        frame_mask = fm if frame_mask is None else torch.cat(
            [frame_mask.bool(), fm[frame_mask.shape[0]:]])
    B, F = lat.shape[:2]
    img = torch.cat([img, img.new_zeros((B, F - img.shape[1], *img.shape[2:]))], dim=1)
    # image-CFG dropout of the whole batch, as the reference's python-level rand
    img = torch.where(draws.drop_u < noised_image_dropout, torch.zeros_like(img), img)

    noisy = add_noise(schedule, lat, draws.noise, draws.t)
    model_in = torch.cat([noisy, img], dim=2)  # [B, F, 2C, H, W]

    def control(key, noise):
        if batch.get(key) is None:
            return None
        if noise is None:
            raise ValueError(f"batch[{key!r}] needs its moment noise in the draws")
        c = sample_from_moments(batch[key], noise=noise) * vae_scaling_factor
        c = c.permute(0, 2, 1, 3, 4)
        if pad_frames and c.shape[1] < F:
            c = torch.cat([c, c.new_zeros((c.shape[0], F - c.shape[1], *c.shape[2:]))], dim=1)
        return torch.cat([c, c], dim=2)

    v_pred, is_action_mask, actions_recon = model(
        model_in, batch["prompt_embeds"], draws.t, actions=actions,
        depths=control("latents_depth", draws.depth_noise),
        labels=control("latents_label", draws.label_noise),
        deterministic=False, action_mask_u=draws.mask_u, image_rotary_emb=image_rotary_emb,
        num_views=num_views)

    x0_pred = pred_x0_from_v(schedule, v_pred.float(), noisy, draws.t)
    w = loss_weights(schedule, draws.t).reshape(B, *([1] * (lat.dim() - 1)))
    sq = w * (x0_pred - lat) ** 2
    if frame_mask is not None:
        fm = frame_mask.reshape(1, -1, 1, 1, 1).float()
        per_b = (sq * fm).reshape(B, -1).sum(1) / (fm.sum() * sq[0].numel() / F)
    else:
        per_b = sq.reshape(B, -1).mean(1)
    loss = (per_b if rows is None else rows(per_b)).mean()

    terms = {"diffusion_loss": loss}
    if recon_action and actions is not None and actions_recon is not None:
        rot, pos, grip = compute_action_loss(actions, actions_recon, ~is_action_mask,
                                             rows=rows)
        loss = loss + rot + pos + grip
        terms.update(rot_loss=rot, pos_loss=pos, grip_loss=grip)
    terms["loss"] = loss
    if multi and data_mean == "shards":
        names = list(terms)
        stacked = all_gather(data, torch.stack([terms[k] for k in names])[None], 0)
        terms = dict(zip(names, stacked.mean(0).unbind(0)))
    loss = replicated_output(data, terms["loss"]) if multi else terms["loss"]
    return loss, {k: v.detach() for k, v in terms.items()}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The JAX package's TrainState(step, params, opt_state); the
    parameters live in `model` and are updated in place. `mesh` is the
    model's MeshLayout (default: the model held whole on one rank) and the
    step's parameters are the rank's leaves (`parallel/fsdp.py:named_leaves`:
    its fsdp shards where it holds them)."""

    step: int
    model: torch.nn.Module
    opt_state: OptState
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = MeshLayout.whole({k: v.shape for k, v in self.model.state_dict().items()})

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Optimizer, mesh=None) -> "TrainState":
        state = cls(step=0, model=model, opt_state=None, mesh=mesh)
        names, params = zip(*state.named_params())
        state.opt_state = tx.init(params, names, state.mesh)
        return state

    def named_params(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, training leaf) of every parameter the step differentiates
        (`parallel/fsdp.py:named_leaves`)."""
        return named_leaves(self.model)


def named_grad_params(model: torch.nn.Module) -> List[Tuple[str, torch.nn.Parameter]]:
    """(name, parameter) of every parameter the step differentiates (those
    that require grad), in `model.named_parameters()` order; the frozen
    ones of a `trainable_predicate` are among them."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def grad_params(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters of `named_grad_params`."""
    return [p for _, p in named_grad_params(model)]


def batch_rows(batch: Dict[str, torch.Tensor], sl: slice) -> Dict[str, torch.Tensor]:
    """The rows `sl` of every per-row entry of `batch` (all but the
    frame mask, which is per frame)."""
    return {k: v if k == "frame_mask" else v[sl] for k, v in batch.items()}


def make_train_step(tx: Optimizer, schedule: DiffusionSchedule, model_fn=None, data_mean=None,
                    **loss_kwargs):
    """The training step: `step(state, batch, rng) -> (state, metrics)`.

    One call is one micro-step: the loss and the gradients of every
    parameter, then `tx.update` (which applies on every `grad_accum_steps`-th
    call). `rng` is a `torch.Generator` to draw the step's `LossDraws` from,
    or the draws themselves. A parameter that gets no gradient takes a zero
    one, as in JAX. metrics: the loss terms and `grad_norm`, the global norm
    of this micro-step's gradients over every parameter (frozen ones too, as
    JAX logs it), all detached device scalars. `loss_kwargs` go to
    `diffusion_loss`.

    The state's mesh (`TrainState.mesh`) decides the rows (module
    docstring): `batch` and the draws are the global batch's, and the rank
    takes its rows; with `data_mean="shards"` (`parallel/pp.py`) they are
    the rank's own already. `model_fn(state)` gives the callable the loss
    runs (default: the state's model)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             rng: Union[torch.Generator, LossDraws, None]):
        named = state.named_params()
        names, params = [n for n, _ in named], [p for _, p in named]
        draws = rng if isinstance(rng, LossDraws) else LossDraws.draw(
            rng, batch, schedule.num_train_timesteps, loss_kwargs.get("patch_size_t"))
        layout = state.mesh
        kw = dict(loss_kwargs, data=layout.mesh.data, data_mean=data_mean or "rows")
        if data_mean != "shards":
            sl = batch_sharding(layout.mesh, draws.t.shape[0])
            batch, draws = batch_rows(batch, sl), draws.rows(sl)
        for p in params:
            p.grad = None
        model = state.model if model_fn is None else model_fn(state)
        loss, metrics = diffusion_loss(model, batch, schedule, draws, **kw)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        layout.reduce_grads(names, grads)
        metrics["grad_norm"] = global_norm(grads, names, layout)
        tx.update(grads, state.opt_state, params)
        state.step += 1
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# Flat form of a TrainState (the checkpoint's)
# ---------------------------------------------------------------------------

def _places(state: TrainState):
    """{checkpoint name: (the rank's tensor, the placement of the parameter
    it follows)} for the model's state dict and every parameter-named
    optimizer tensor, and {name: (tensor, JAX-layout splits)} for the
    rule's per-leaf tensors (CAME's) and its scalars."""
    layout = state.mesh
    o = state.opt_state
    leaves = dict(state.named_params())
    own = state.model.state_dict()
    places = {f"params/{k}": (leaves.get(k, v), layout.placements[k]) for k, v in own.items()}
    names = [n for n, _ in state.named_params()]
    trained = [n for n, m in zip(names, o.mask) if m]
    for group, ns, values in (("acc", trained, o.acc), ("ema", names, o.ema)):
        if values is not None:
            places.update({f"{group}/{n}": (v, layout.placements[n]) for n, v in zip(ns, values)})
    per_leaf = {}
    for group, ts in o.tensors.items():
        for key, v in ts.items():
            if o.layout is None:  # the tensors follow their parameters (Adam's, prodigy's)
                places[f"{group}/{key}"] = (v, layout.placements[key])
            else:  # CAME's, in the layout of the JAX tree's leaves
                per_leaf[f"{group}/{key}"] = (v, state_splits(o.layout, group, key))
    per_leaf.update({f"scalar/{k}": (v, {}) for k, v in o.scalars.items()})
    return places, per_leaf


def state_tensors(state: TrainState) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """`state` -> ({name: tensor}, scalars): the whole tensors under the
    resident names, gathered from the mesh's ranks (every rank must call
    it; held whole, no copies are made). Names are "params/<key>" for every
    entry of the model's state dict, "<group>/<leaf>" for the optimizer
    rule's tensors (Adam's mu and nu by parameter name, CAME's fields by
    leaf, prodigy's by parameter name; a frozen parameter has none),
    "acc/<parameter>" for the trainable parameters' accumulator between the
    micro-steps of an accumulation, "ema/<parameter>" for every parameter's
    EMA with `ema_decay`, and "scalar/<name>" for the rule's 0-d tensors
    (prodigy's estim_lr and numerator_weighted); the scalars returned are
    step, count and mini_step."""
    from orv_tpu_torch.models.weights import gather_state_dict, gather_tensor

    o = state.opt_state
    scalars = dict(step=int(state.step), count=int(o.count), mini_step=int(o.mini_step))
    layout = state.mesh
    places, per_leaf = _places(state)
    with torch.no_grad():
        whole = gather_state_dict({k: t.detach() for k, (t, _) in places.items()},
                                  {k: pl for k, (_, pl) in places.items()}, layout.mesh,
                                  layout.num_layers)
        for k, (t, splits) in per_leaf.items():
            whole[k] = gather_tensor(t.detach(), splits, layout.mesh)
    return whole, scalars


def load_state_tensors(state: TrainState, items: Iterable[Tuple[str, torch.Tensor]],
                       scalars: Dict[str, int]) -> TrainState:
    """The inverse of `state_tensors`, in place: copy every (name, whole
    tensor) of `items` (an iterable, so a reader can stream them) into
    `state`'s tensors, each rank its part, and set its scalars. The
    accumulator is rebuilt when `mini_step` > 0. Raises on a name `state`
    has no place for (a block layer another pp stage holds is passed
    over), a shape that differs or a name missing from `items`."""
    from orv_tpu_torch.models.weights import placement_splits, shard_tensor

    o = state.opt_state
    mini_step = int(scalars["mini_step"])
    trained = [p for (_, p), m in zip(state.named_params(), o.mask) if m]
    o.acc = [torch.empty_like(p) for p in trained] if mini_step else None
    layout = state.mesh
    places, per_leaf = _places(state)
    dest = {k: (t, placement_splits(pl, ("tp", "fsdp"))) for k, (t, pl) in places.items()}
    dest.update(per_leaf)
    seen = set()
    with torch.no_grad():
        for name, value in items:
            if name not in dest:
                if _held_elsewhere(name, layout):
                    continue
                raise KeyError(f"checkpoint tensor {name!r} has no place in this train state "
                               "(another model, optimizer or trainable set, or an EMA the "
                               "optimizer does not keep)")
            t, splits = dest[name]
            whole = list(t.shape)
            for d, axes in splits.items():
                whole[d] *= math.prod(layout.mesh.shape[a] for a in axes)
            if tuple(value.shape) != tuple(whole):
                raise ValueError(f"checkpoint tensor {name!r} is {tuple(value.shape)}, the "
                                 f"state's {tuple(whole)}")
            t.copy_(shard_tensor(value.to(t.device), splits, layout.mesh))
            seen.add(name)
    missing = sorted(set(dest) - seen)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensor(s) of this train state: "
                       f"{missing[:5]}")
    state.step, o.count, o.mini_step = int(scalars["step"]), int(scalars["count"]), mini_step
    return state


def _held_elsewhere(name: str, layout) -> bool:
    """Whether checkpoint tensor `name` belongs to a block layer another pp
    stage holds."""
    import re

    m = re.search(r"(?:transformer_blocks|mv_blocks)\.(\d+)\.", name)
    if m is None or layout.mesh.shape["pp"] == 1:
        return False
    return not any(pl.layer == int(m.group(1)) for pl in layout.placements.values())
