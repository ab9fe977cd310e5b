from orv_tpu_torch.schedulers.scheduling import (
    DiffusionSchedule,
    add_noise,
    ddim_step,
    dpm_step_scan,
    get_inference_timesteps,
    get_velocity,
    loss_weights,
    make_schedule,
    pred_x0_from_v,
)

__all__ = [
    "DiffusionSchedule",
    "add_noise",
    "ddim_step",
    "dpm_step_scan",
    "get_inference_timesteps",
    "get_velocity",
    "loss_weights",
    "make_schedule",
    "pred_x0_from_v",
]
