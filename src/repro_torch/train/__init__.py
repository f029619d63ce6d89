"""Training: AdamW with the reference's schedule and clipping, and the
train step with microbatch accumulation over an f32 master tree."""
from .optim import OptConfig, adamw_update, init_opt_state, lr_at
from .step import TrainConfig, init_train_state, make_train_step

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "lr_at",
           "TrainConfig", "init_train_state", "make_train_step"]
