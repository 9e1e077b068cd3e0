"""Optimizers and learning-rate schedules of the trainer: port of
``src/repro/optim/``."""
from repro_torch.optim.optimizers import (
    Optimizer, sgd, adam, adamw, clip_by_global_norm, apply_updates,
)
from repro_torch.optim.schedules import (
    constant, linear_warmup, cosine_decay, warmup_cosine,
)
