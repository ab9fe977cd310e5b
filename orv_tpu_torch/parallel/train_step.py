"""Training step: v-prediction diffusion loss + action recon, AdamW.

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

The optimizer follows optax, not torch's defaults: `make_optimizer` builds
`MultiSteps(chain(clip_by_global_norm, adamw) [+ params EMA])` as one
in-place `AdamW`: the lr of applied update k is `schedule(k)` counted from
0; the clip scales by max_norm/norm only when norm >= max_norm, with no
epsilon; accumulation keeps the running mean of the k micro-gradients and
updates on the k-th; eps is added outside the square root and the decay
lr*wd*p applies to every parameter. JAX's arrays are immutable; here the
parameters, moments and accumulator are updated in place to save memory.

`state_tensors` / `load_state_tensors` flatten a `TrainState` (the
parameters, the moments, the accumulator and the EMA) into named tensors
and scalars and back, for `utils/checkpoint.py`.

Not ported: the mesh (sharding; ROADMAP.md A7, A8), CAME and prodigy and
`trainable_predicate` (A4), and the training side of the model surface
(A11): `diffusion_loss` refuses a RoPE, `patch_size_t` or multiview model by
name, since it lacks their rotary tables, frame padding and views.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

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
    """AdamW state: `count` applied updates (the schedule's step), the two
    moments, the MultiSteps position and running-mean accumulator, and the
    optional EMA of the parameters."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None
    ema: Optional[List[torch.Tensor]] = None


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _chunks(n: int, size: int = 32):
    return (slice(i, min(i + size, n)) for i in range(0, n, size))


class AdamW:
    """optax.MultiSteps(chain(clip_by_global_norm(max_grad_norm),
    adamw(schedule, b1, b2, eps, weight_decay)) [+ params_ema], k) applied
    in place: `update` changes the parameters on every k-th call."""

    def __init__(self, schedule: Callable[[int], float], beta1: float, beta2: float,
                 epsilon: float, weight_decay: float, max_grad_norm: float,
                 grad_accum_steps: int = 1, ema_decay: Optional[float] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.wd = beta1, beta2, epsilon, weight_decay
        self.max_grad_norm = max_grad_norm
        self.k = grad_accum_steps
        self.ema_decay = ema_decay

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        ema = None if self.ema_decay is None else [p.detach().clone() for p in params]
        return OptState(count=0, mu=[torch.zeros_like(p) for p in params],
                        nu=[torch.zeros_like(p) for p in params], ema=ema)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> None:
        """Take `grads` (owned from here on: they may be updated in place)."""
        if state.mini_step == 0:
            state.acc = list(grads)  # acc + (g - acc) / 1 with acc = 0
        else:  # optax's running mean of the micro-gradients
            for i, g in enumerate(grads):
                state.acc[i].add_((g - state.acc[i]) / (state.mini_step + 1))
        if state.mini_step < self.k - 1:
            state.mini_step += 1
            return
        u, params = state.acc, list(params)
        state.acc, state.mini_step = None, 0

        # clip_by_global_norm: t / norm * max_norm when norm >= max_norm
        norm = global_norm(u)
        trigger = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(u, torch.where(trigger, one, norm))
        torch._foreach_mul_(u, torch.where(trigger, one, one * self.max_grad_norm))

        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        for sl in _chunks(len(params)):  # bounds the temporaries to a few tensors' size
            p, g, mu, nu = params[sl], u[sl], state.mu[sl], state.nu[sl]
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
            if state.ema is not None:
                torch._foreach_mul_(state.ema[sl], self.ema_decay)
                torch._foreach_add_(state.ema[sl], p, alpha=1.0 - self.ema_decay)


def make_optimizer(
    learning_rate_schedule: Callable[[int], float],
    optimizer: str = "adamw",
    beta1: float = 0.9,
    beta2: float = 0.95,
    epsilon: float = 1e-8,
    weight_decay: float = 1e-3,
    max_grad_norm: float = 1.0,
    grad_accum_steps: int = 1,
    ema_decay: Optional[float] = None,
) -> AdamW:
    """The JAX package's `make_optimizer` for "adam" (no decay) and "adamw".
    CAME and prodigy are not ported yet."""
    if optimizer not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported (adam/adamw only)")
    return AdamW(learning_rate_schedule, beta1, beta2, epsilon,
                 weight_decay if optimizer == "adamw" else 0.0, max_grad_norm,
                 grad_accum_steps, None if ema_decay is None else float(ema_decay))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LossDraws:
    """Every random number of one `diffusion_loss` evaluation."""

    lat_noise: torch.Tensor  # [B, C, F, H, W] to sample the video latents' moments
    img_noise: torch.Tensor  # [B, C, F_img, H, W] to sample the image latents' moments
    noise: torch.Tensor  # [B, F, C, H, W] diffusion noise
    t: torch.Tensor  # [B] int64 timesteps
    drop_u: torch.Tensor  # [] uniform of the whole-batch image-CFG dropout
    mask_u: torch.Tensor  # [B] uniforms of the action-CFG mask
    # [B, C, F, H, W] to sample the depth and label moments; None when the
    # batch has no such key (JAX: r_cond and fold_in(r_cond, 1))
    depth_noise: Optional[torch.Tensor] = None
    label_noise: Optional[torch.Tensor] = None

    @classmethod
    def draw(cls, generator: Optional[torch.Generator], batch: Dict[str, torch.Tensor],
             num_train_timesteps: int = 1000) -> "LossDraws":
        """Fresh draws for `batch` on its device."""
        lat, img = batch["latents"], batch["image_latents"]
        B, C2, F, H, W = lat.shape
        kw = dict(generator=generator, device=lat.device)

        def moment_noise(key):
            m = batch.get(key)
            return None if m is None else torch.randn(B, m.shape[1] // 2, *m.shape[2:], **kw)

        return cls(lat_noise=torch.randn(B, C2 // 2, F, H, W, **kw),
                   img_noise=torch.randn(B, img.shape[1] // 2, *img.shape[2:], **kw),
                   noise=torch.randn(B, F, C2 // 2, H, W, **kw),
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


def compute_action_loss(actions, recon, mask, weights=(0.4, 5.0, 1.0)):
    """rot = 1 - mean cos(delta euler); pos and grip smooth-L1, grip through
    a sigmoid; each a mean over the batch entries `mask` selects (those whose
    actions were not CFG-masked). Returns the three weighted terms."""
    mask_f = mask.float()
    denom = mask_f.sum().clamp_min(1.0)
    actions, recon = actions.float(), recon.float()

    def masked_mean(x):
        per_b = x.mean(dim=tuple(range(1, x.dim())))
        return (per_b * mask_f).sum() / denom

    rot = 1.0 - masked_mean(torch.cos(recon[..., 3:6] - actions[..., 3:6]))
    pos = masked_mean(_smooth_l1(recon[..., :3], actions[..., :3]))
    grip = masked_mean(_smooth_l1(torch.sigmoid(recon[..., -1]), actions[..., -1]))
    return weights[0] * rot, weights[1] * pos, weights[2] * grip


def refuse_model_surface(dit_cfg, who: str) -> None:
    """Raise by name on a model whose training the port lacks (ROADMAP.md
    A11): a RoPE model's loss needs the rotary tables, a `patch_size_t`
    model's the frame padding, a multiview model's the per-view latents."""
    for name, on in (("use_rotary_positional_embeddings", dit_cfg.use_rotary_positional_embeddings),
                     ("patch_size_t", dit_cfg.patch_size_t is not None),
                     ("multiview", dit_cfg.multiview)):
        if on:
            raise NotImplementedError(
                f"{who}: training a model with {name} is not ported yet (ROADMAP.md A11); "
                "its serving path is")


def diffusion_loss(
    model: torch.nn.Module,
    batch: Dict[str, torch.Tensor],
    schedule: DiffusionSchedule,
    draws: LossDraws,
    vae_scaling_factor: float = 1.15258426,
    noised_image_dropout: float = 0.05,
    recon_action: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One loss evaluation of the ControlDiT `model`. batch keys ([B, ...],
    the reference collate's layouts): 'latents' (moments [B, 2C, F, H, W]),
    'image_latents' (moments, F_img frames), 'prompt_embeds', optional
    'actions' [B, F_raw, 7], 'frame_mask' [F] and the visual-control moments
    'latents_depth' / 'latents_label' [B, 2C, F, H, W], each sampled with
    its `draws` noise, scaled and duplicated to 2C channels as the model's
    `depths` / `labels`. Returns (loss, metrics); the metrics are detached.
    Refuses RoPE, `patch_size_t` and multiview models (ROADMAP.md A11)."""
    refuse_model_surface(model.config, "diffusion_loss")
    lat = sample_from_moments(batch["latents"], noise=draws.lat_noise) * vae_scaling_factor
    lat = lat.permute(0, 2, 1, 3, 4)  # [B, F, C, H, W]
    img = sample_from_moments(batch["image_latents"], noise=draws.img_noise) * vae_scaling_factor
    img = img.permute(0, 2, 1, 3, 4)
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
        return torch.cat([c, c], dim=2)

    actions = batch.get("actions")
    v_pred, is_action_mask, actions_recon = model(
        model_in, batch["prompt_embeds"], draws.t, actions=actions,
        depths=control("latents_depth", draws.depth_noise),
        labels=control("latents_label", draws.label_noise),
        deterministic=False, action_mask_u=draws.mask_u)

    x0_pred = pred_x0_from_v(schedule, v_pred.float(), noisy, draws.t)
    w = loss_weights(schedule, draws.t).reshape(B, *([1] * (lat.dim() - 1)))
    sq = w * (x0_pred - lat) ** 2
    frame_mask = batch.get("frame_mask")
    if frame_mask is not None:
        fm = frame_mask.reshape(1, -1, 1, 1, 1).float()
        per_b = (sq * fm).reshape(B, -1).sum(1) / (fm.sum() * sq[0].numel() / F)
    else:
        per_b = sq.reshape(B, -1).mean(1)
    loss = per_b.mean()

    metrics = {"diffusion_loss": loss.detach()}
    if recon_action and actions is not None and actions_recon is not None:
        rot, pos, grip = compute_action_loss(actions, actions_recon, ~is_action_mask)
        loss = loss + rot + pos + grip
        metrics.update(rot_loss=rot.detach(), pos_loss=pos.detach(), grip_loss=grip.detach())
    metrics["loss"] = loss.detach()
    return loss, metrics


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The JAX package's TrainState(step, params, opt_state); the
    parameters live in `model` and are updated in place."""

    step: int
    model: torch.nn.Module
    opt_state: OptState

    @classmethod
    def create(cls, model: torch.nn.Module, tx: AdamW) -> "TrainState":
        return cls(step=0, model=model, opt_state=tx.init(trainable(model)))


def trainable(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters the optimizer updates, in `model.parameters()` order."""
    return [p for p in model.parameters() if p.requires_grad]


def make_train_step(tx: AdamW, schedule: DiffusionSchedule, **loss_kwargs):
    """The training step: `step(state, batch, rng) -> (state, metrics)`.

    One call is one micro-step: the loss and its gradients, then `tx.update`
    (which applies on every `grad_accum_steps`-th call). `rng` is a
    `torch.Generator` to draw the step's `LossDraws` from, or the draws
    themselves. A parameter that gets no gradient takes a zero one, as in
    JAX. metrics: the loss terms and `grad_norm`, the global norm of this
    micro-step's gradients, all detached device scalars."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             rng: Union[torch.Generator, LossDraws, None]):
        params = trainable(state.model)
        draws = rng if isinstance(rng, LossDraws) else LossDraws.draw(
            rng, batch, schedule.num_train_timesteps)
        for p in params:
            p.grad = None
        loss, metrics = diffusion_loss(state.model, batch, schedule, draws, **loss_kwargs)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        metrics["grad_norm"] = global_norm(grads)
        tx.update(grads, state.opt_state, params)
        state.step += 1
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# Flat form of a TrainState (the checkpoint's)
# ---------------------------------------------------------------------------

_OPT_GROUPS = ("mu", "nu", "acc", "ema")


def state_tensors(state: TrainState) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """`state` -> ({name: tensor}, scalars), no copies made. Names are
    "params/<key>" for every entry of the model's state dict and
    "<group>/<parameter>" for the optimizer's lists (group mu, nu, acc
    between the micro-steps of an accumulation, ema with `ema_decay`);
    scalars are step, count and mini_step."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    o = state.opt_state
    tensors = {f"params/{k}": v.detach() for k, v in state.model.state_dict().items()}
    for group in _OPT_GROUPS:
        values = getattr(o, group)
        if values is not None:
            tensors.update({f"{group}/{n}": v.detach() for n, v in zip(names, values)})
    return tensors, dict(step=int(state.step), count=int(o.count), mini_step=int(o.mini_step))


def load_state_tensors(state: TrainState, items, scalars: Dict[str, int]) -> TrainState:
    """The inverse of `state_tensors`, in place: copy every (name, tensor)
    of `items` (an iterable, so a reader can stream them) into `state`'s
    tensors and set its scalars. The accumulator is rebuilt when
    `mini_step` > 0. Raises on a name `state` has no place for, a shape
    that differs or a name missing from `items`."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    o = state.opt_state
    mini_step = int(scalars["mini_step"])
    o.acc = [torch.empty_like(p) for p in trainable(state.model)] if mini_step else None
    dest = {f"params/{k}": v for k, v in state.model.state_dict().items()}
    for group in _OPT_GROUPS:
        values = getattr(o, group)
        if values is not None:
            dest.update({f"{group}/{n}": v for n, v in zip(names, values)})
    seen = set()
    with torch.no_grad():
        for name, value in items:
            if name not in dest:
                raise KeyError(f"checkpoint tensor {name!r} has no place in this train state "
                               "(another model, or an EMA the optimizer does not keep)")
            if tuple(value.shape) != tuple(dest[name].shape):
                raise ValueError(f"checkpoint tensor {name!r} is {tuple(value.shape)}, the "
                                 f"state's {tuple(dest[name].shape)}")
            dest[name].copy_(value)
            seen.add(name)
    missing = sorted(set(dest) - seen)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensor(s) of this train state: "
                       f"{missing[:5]}")
    state.step, o.count, o.mini_step = int(scalars["step"]), int(scalars["count"]), mini_step
    return state
