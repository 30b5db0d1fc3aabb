"""Training on the card: AdamW, the train step, checkpoints, gradient
compression and elastic planning (the reference's ``train/``)."""
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, lr_schedule)
from .train_step import TrainConfig, build_train_step

__all__ = [
    "AdamWConfig", "TrainConfig", "adamw_init", "adamw_update",
    "build_train_step", "clip_by_global_norm", "lr_schedule",
]
