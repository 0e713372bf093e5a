from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import make_schedule

__all__ = [
    "Optimizer", "adam", "adamw", "momentum", "sgd", "make_optimizer",
    "make_schedule", "global_norm", "clip_by_global_norm",
]
