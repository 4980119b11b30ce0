"""Optimizers (counterpart of agrl_tpu/optim/optimizers.py).

The reference's table (torchreid/optimizers.py:7-23) names adam, amsgrad,
sgd, nesterov, rmsprop, adabound and radam. Only adam, which the paper
recipe uses, is ported; the other names raise NotImplementedError.

agrl_tpu's adam is optax.chain(_l2_weight_decay_schedule, optax.adam):
grad += wd * param (torch-style coupled L2), then Adam with b1 0.9,
b2 0.999, eps 1e-8 outside the square root — what torch.optim.Adam with
`weight_decay` computes. optax reads lr(count) before it counts the step;
the trainer sets each group's lr to lr_fn(step) before `step()` to match.
"""

from __future__ import annotations

import torch

OPTIMIZER_NAMES = ("adam", "amsgrad", "sgd", "nesterov", "rmsprop", "adabound", "radam")


def init_optim(optim: str, params, lr: float, weight_decay: float = 0.0):
    """Build an optimizer by name over the parameters that require a
    gradient (the BNNecks' frozen biases stay out, as flax's BNNeck has
    none)."""
    if optim not in OPTIMIZER_NAMES:
        raise KeyError(f"Unsupported optimizer: {optim}. Choices: {OPTIMIZER_NAMES}")
    if optim != "adam":
        raise NotImplementedError(f"optimizer {optim!r} is not ported yet (adam only)")
    trainable = [p for p in params if p.requires_grad]
    return torch.optim.Adam(
        trainable, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
