from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_warmup_lr,
    global_norm,
)
from repro_torch.training.steps import TrainState, init_train_state, make_train_step

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_warmup_lr",
    "global_norm",
    "TrainState",
    "init_train_state",
    "make_train_step",
]
