from orv_tpu_torch.parallel.train_step import (
    EvalDraws,
    LossDraws,
    TrainState,
    diffusion_loss,
    load_state_tensors,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    state_tensors,
)

__all__ = ["EvalDraws", "LossDraws", "TrainState", "diffusion_loss", "load_state_tensors",
           "make_lr_schedule", "make_optimizer", "make_train_step", "state_tensors"]
