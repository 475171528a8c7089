"""repro_torch.training — AdamW, its schedules and the train step on one
device or over a mesh of ranks (the port of ``repro.training``)."""

from .optim import (OptConfig, adamw_init, adamw_update, global_norm,
                    opt_state_axes, schedule_lr)
from .train import (CapturedTrainStep, StateLayout, TrainConfig, init_state, local_batch,
                    make_jitted_train_step, make_mesh_train_step,
                    make_train_step, rank_rows, shard_state, state_axes)

__all__ = ["CapturedTrainStep", "OptConfig", "StateLayout", "TrainConfig", "adamw_init",
           "adamw_update", "global_norm", "init_state", "local_batch",
           "make_jitted_train_step", "make_mesh_train_step",
           "make_train_step", "opt_state_axes", "rank_rows", "schedule_lr",
           "shard_state", "state_axes"]
