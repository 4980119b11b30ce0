"""Learning-rate schedules (copy of the Python-number branches of
agrl_tpu/optim/schedules.py).

Parity targets:
  * multistep_lr       — torch MultiStepLR (re-exported by the reference at
    torchreid/lr_scheduler.py:6): lr = base * gamma^(#milestones <= epoch).
  * warmup_multistep_lr — torchreid/lr_scheduler.py:9-51: linear or constant
    warmup for `warmup_iters` epochs, multiplied by the multistep decay.

`zero_wd_schedule` is the CLI's `--zero-wd` rule
(agrl_tpu/cli/train_vidreid_xent_htri.py:409-413).

The reference steps its scheduler once per EPOCH; `per_step` converts an
epoch schedule to a per-update-step one. As in agrl_tpu, the decay applies
AT the milestone epoch (torch's post-1.1 `scheduler.step()` after each
epoch applies it from milestone + 1).
"""

from __future__ import annotations

from bisect import bisect_right
from collections.abc import Callable, Sequence


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
    """Epoch -> lr."""
    milestones = sorted(milestones)

    def schedule(epoch):
        return base_lr * gamma ** bisect_right(milestones, epoch)

    return schedule


def warmup_multistep_lr(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 3,
    warmup_iters: int = 500,
    warmup_method: str = "linear",
):
    """Epoch -> lr with warmup, matching WarmupMultiStepLR.get_lr()."""
    if list(milestones) != sorted(milestones):
        raise ValueError(f"Milestones must be increasing, got {milestones}")
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"Unknown warmup method: {warmup_method}")
    decay = multistep_lr(base_lr, milestones, gamma)

    def schedule(epoch):
        factor = 1.0
        if epoch < warmup_iters:
            if warmup_method == "constant":
                factor = warmup_factor
            else:
                alpha = epoch / warmup_iters
                factor = warmup_factor * (1 - alpha) + alpha
        return decay(epoch) * factor

    return schedule


def per_step(epoch_schedule: Callable, steps_per_epoch: int):
    """Convert an epoch-indexed schedule into a step-indexed one."""

    def schedule(step):
        return epoch_schedule(step // steps_per_epoch)

    return schedule


def zero_wd_schedule(weight_decay: float, zero_wd: int):
    """Epoch -> weight decay for `--zero-wd N`: 0 from epoch N on when
    N > 0, else `weight_decay` throughout. agrl_tpu switches at step
    N * steps_per_epoch, the first step of epoch N, so setting the groups
    at each epoch's start is the same rule."""

    def schedule(epoch):
        return 0.0 if 0 < zero_wd <= epoch else weight_decay

    return schedule
