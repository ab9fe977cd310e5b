from orv_tpu_torch.schedulers.scheduling import (
    DiffusionSchedule,
    ddim_step,
    dpm_step_scan,
    get_inference_timesteps,
    make_schedule,
)

__all__ = [
    "DiffusionSchedule",
    "ddim_step",
    "dpm_step_scan",
    "get_inference_timesteps",
    "make_schedule",
]
