"""Optimizers and learning-rate schedules (counterpart of agrl_tpu/optim)."""

from agrl_torch.optim.optimizers import OPTIMIZER_NAMES, init_optim
from agrl_torch.optim.schedules import (
    multistep_lr,
    per_step,
    warmup_multistep_lr,
    zero_wd_schedule,
)

__all__ = [
    "OPTIMIZER_NAMES", "init_optim", "multistep_lr", "per_step", "warmup_multistep_lr",
    "zero_wd_schedule",
]
