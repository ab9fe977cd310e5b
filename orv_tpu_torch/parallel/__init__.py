from orv_tpu_torch.parallel.train_step import (
    LossDraws,
    TrainState,
    diffusion_loss,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)

__all__ = ["LossDraws", "TrainState", "diffusion_loss", "make_lr_schedule", "make_optimizer",
           "make_train_step"]
