"""CogVideoX diffusion schedules (DDIM + DPM-solver++ steps) in PyTorch.

Counterpart of `orv_tpu/schedulers/scheduling.py`. The schedule is a table
of f32 `alphas_cumprod`; the step functions are pure. Timesteps may be
Python ints or 0-d tensors: the per-step coefficients are 0-d f32 tensors
on the schedule's device (the CPU by default), which PyTorch applies to a
sample on any device as scalars, so a step costs no host-device round trip.

Conventions (CogVideoX-2b checkpoint schedule):
  betas: "scaled_linear" — linspace(sqrt(b0), sqrt(bT), T)^2,
         b0=0.00085, bT=0.012, T=1000
  SNR shift: abar <- abar / (s + (1-s)·abar), s=3.0
  zero-terminal-SNR rescale of sqrt(abar)
  prediction_type: v_prediction; timestep_spacing: "trailing"
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

Timestep = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed noise-schedule tables."""

    alphas_cumprod: torch.Tensor  # [num_train_timesteps] f32
    final_alpha_cumprod: torch.Tensor  # 0-d f32
    num_train_timesteps: int
    init_noise_sigma: float
    prediction_type: str


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift/scale sqrt(abar) so the terminal step has exactly zero SNR."""
    abar_sqrt = np.sqrt(alphas_cumprod)
    a0, aT = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = abar_sqrt - aT
    abar_sqrt = abar_sqrt * a0 / (a0 - aT)
    return abar_sqrt**2


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    snr_shift_scale: float = 3.0,
    rescale_betas_zero_snr: bool = True,
    set_alpha_to_one: bool = True,
    prediction_type: str = "v_prediction",
) -> DiffusionSchedule:
    if beta_schedule == "scaled_linear":
        betas = (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64) ** 2
        )
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"unsupported beta_schedule {beta_schedule}")

    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod = alphas_cumprod / (snr_shift_scale + (1 - snr_shift_scale) * alphas_cumprod)
    if rescale_betas_zero_snr:
        alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)
        # exact zero at the terminal step makes 1/(1-abar) & logSNR blow up
        alphas_cumprod = np.clip(alphas_cumprod, 1e-8, 1.0)

    final_alpha = np.float32(1.0) if set_alpha_to_one else np.float32(alphas_cumprod[0])
    return DiffusionSchedule(
        alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32),
        final_alpha_cumprod=torch.tensor(final_alpha, dtype=torch.float32),
        num_train_timesteps=num_train_timesteps,
        init_noise_sigma=1.0,
        prediction_type=prediction_type,
    )


def get_inference_timesteps(
    schedule: DiffusionSchedule,
    num_inference_steps: int,
    timestep_spacing: str = "trailing",
) -> np.ndarray:
    """Descending int timesteps for sampling (host-side)."""
    T = schedule.num_train_timesteps
    if timestep_spacing == "trailing":
        step = T / num_inference_steps
        ts = np.round(np.arange(T, 0, -step)).astype(np.int64) - 1
    elif timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps).round().astype(np.int64)[::-1]
    elif timestep_spacing == "leading":
        step = T // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step).round().astype(np.int64)[::-1]
    else:
        raise ValueError(f"unknown timestep_spacing {timestep_spacing}")
    return ts.copy()


# ---------------------------------------------------------------------------
# Forward process + v-parameterization (the training loss's pieces)
# ---------------------------------------------------------------------------

def _gather_abar(schedule: DiffusionSchedule, timesteps: torch.Tensor, ndim: int):
    """(sqrt(abar[t]), sqrt(1 - abar[t])) for int timesteps [B], shaped to
    broadcast over a [B, ...] sample of `ndim` dims, on the timesteps'
    device."""
    abar = schedule.alphas_cumprod.to(timesteps.device)[timesteps]
    shape = abar.shape + (1,) * (ndim - abar.dim())
    return torch.sqrt(abar).reshape(shape), torch.sqrt(1.0 - abar).reshape(shape)


def add_noise(schedule: DiffusionSchedule, sample, noise, timesteps):
    """x_t = sqrt(abar)·x0 + sqrt(1-abar)·eps."""
    sa, sm = _gather_abar(schedule, timesteps, sample.dim())
    return sa * sample + sm * noise


def get_velocity(schedule: DiffusionSchedule, sample, noise, timesteps):
    """v = sqrt(abar)·eps - sqrt(1-abar)·x0."""
    sa, sm = _gather_abar(schedule, timesteps, sample.dim())
    return sa * noise - sm * sample


def pred_x0_from_v(schedule: DiffusionSchedule, v, x_t, timesteps):
    """x0 = sqrt(abar)·x_t − sqrt(1−abar)·v."""
    sa, sm = _gather_abar(schedule, timesteps, x_t.dim())
    return sa * x_t - sm * v


def loss_weights(schedule: DiffusionSchedule, timesteps):
    """The v-prediction training weights 1/(1-abar_t)."""
    return 1.0 / (1.0 - schedule.alphas_cumprod.to(timesteps.device)[timesteps])


# ---------------------------------------------------------------------------
# DDIM step (CogVideoX formulation)
# ---------------------------------------------------------------------------

def _pred_x0(schedule: DiffusionSchedule, model_output, sample, alpha_prod_t):
    beta_prod_t = 1.0 - alpha_prod_t
    if schedule.prediction_type == "v_prediction":
        return (alpha_prod_t**0.5) * sample - (beta_prod_t**0.5) * model_output
    if schedule.prediction_type == "epsilon":
        return (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
    if schedule.prediction_type == "sample":
        return model_output
    raise ValueError(schedule.prediction_type)


def _abar_at(schedule: DiffusionSchedule, t: Timestep) -> torch.Tensor:
    """abar[t] with t < 0 mapping to final_alpha_cumprod (0-d f32)."""
    t = torch.as_tensor(t, device=schedule.alphas_cumprod.device)
    safe_t = torch.clamp(t, 0, schedule.num_train_timesteps - 1)
    return torch.where(t >= 0, schedule.alphas_cumprod[safe_t], schedule.final_alpha_cumprod)


def ddim_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    timestep: Timestep,
    prev_timestep: Timestep,
    sample: torch.Tensor,
) -> torch.Tensor:
    """One deterministic CogVideoX-DDIM update x_t -> x_{t_prev}:
      x_prev = a_t·x_t + b_t·x0,  a_t = sqrt((1-abar_prev)/(1-abar_t)),
      b_t = sqrt(abar_prev) - sqrt(abar_t)·a_t."""
    alpha_prod_t = _abar_at(schedule, timestep)
    alpha_prod_t_prev = _abar_at(schedule, prev_timestep)

    x0 = _pred_x0(schedule, model_output, sample, alpha_prod_t)

    a_t = ((1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t)) ** 0.5
    b_t = alpha_prod_t_prev**0.5 - alpha_prod_t**0.5 * a_t
    return a_t * sample + b_t * x0


# ---------------------------------------------------------------------------
# DPM-solver++ (2M) step, CogVideoX formulation with old_pred threading
# ---------------------------------------------------------------------------

def _dpm_variables(alpha_prod_t, alpha_prod_t_prev, alpha_prod_t_back):
    """(h, r): the log-SNR step and the ratio of the previous step to it."""
    lamb = torch.log((alpha_prod_t / (1.0 - alpha_prod_t)) ** 0.5)
    lamb_next = torch.log((alpha_prod_t_prev / (1.0 - alpha_prod_t_prev)) ** 0.5)
    lamb_previous = torch.log((alpha_prod_t_back / (1.0 - alpha_prod_t_back)) ** 0.5)
    h = lamb_next - lamb
    return h, (lamb - lamb_previous) / h


def _dpm_mult(h, r, alpha_prod_t, alpha_prod_t_prev):
    mult1 = ((1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t)) ** 0.5 * torch.exp(-h)
    mult2 = torch.expm1(-2.0 * h) * alpha_prod_t_prev**0.5
    return mult1, mult2, 1.0 + 1.0 / (2.0 * r), 1.0 / (2.0 * r)


def dpm_step(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    old_pred_original_sample: Optional[torch.Tensor],
    timestep: Timestep,
    back_timestep: Optional[Timestep],
    prev_timestep: Timestep,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SDE-DPM-solver++(2M) update; returns (x_prev, pred_x0).

    `old_pred_original_sample` is threaded between steps as the reference
    denoise loop does: None (the first step) takes the first-order update
    and leaves `back_timestep` unread; otherwise the 2M correction, which
    falls back to first order on the terminal step (prev_timestep < 0,
    h == inf). `noise` adds the stochastic term; None is the ODE limit.
    The step is `dpm_step_scan` with `have_old` read off the first input."""
    have_old = old_pred_original_sample is not None
    return dpm_step_scan(schedule, model_output, old_pred_original_sample, have_old, timestep,
                         back_timestep if have_old else timestep, prev_timestep, sample, noise)


def dpm_step_scan(
    schedule: DiffusionSchedule,
    model_output: torch.Tensor,
    old_pred_original_sample: torch.Tensor,
    have_old: Union[bool, torch.Tensor],
    timestep: Timestep,
    back_timestep: Timestep,
    prev_timestep: Timestep,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SDE-DPM-solver++(2M) update; returns (x_prev, pred_x0).

    `have_old` selects the multistep branch (step 0 is first order). The
    terminal step (abar_prev == 1, h == inf) falls back to first order, and
    the unused branch's `r` is replaced by 1 so no coefficient is inf."""
    alpha_prod_t = _abar_at(schedule, timestep)
    alpha_prod_t_prev = _abar_at(schedule, prev_timestep)
    x0 = _pred_x0(schedule, model_output, sample, alpha_prod_t)

    alpha_prod_t_back = _abar_at(schedule, back_timestep)
    h, r = _dpm_variables(alpha_prod_t, alpha_prod_t_prev, alpha_prod_t_back)
    prev_t = torch.as_tensor(prev_timestep)
    use_multi = bool(have_old) and bool(prev_t >= 0) and bool(torch.isfinite(h))
    r_safe = r if use_multi else torch.ones_like(r)
    m1, m2, m3, m4 = _dpm_mult(h, r_safe, alpha_prod_t, alpha_prod_t_prev)
    denoised = m3 * x0 - m4 * old_pred_original_sample if use_multi else x0

    prev_sample = m1 * sample - m2 * denoised
    if noise is not None:
        mult_noise = (1.0 - alpha_prod_t_prev) ** 0.5 * (1.0 - torch.exp(-2.0 * h)) ** 0.5
        prev_sample = prev_sample + mult_noise * noise
    return prev_sample, x0
