"""repro_torch.training — AdamW, its schedules and the train step on one
device (the port of ``repro.training``)."""

from .optim import (OptConfig, adamw_init, adamw_update, global_norm,
                    opt_state_axes, schedule_lr)
from .train import (TrainConfig, init_state, make_jitted_train_step,
                    make_train_step, state_axes)

__all__ = ["OptConfig", "TrainConfig", "adamw_init", "adamw_update",
           "global_norm", "init_state", "make_jitted_train_step",
           "make_train_step", "opt_state_axes", "schedule_lr", "state_axes"]
