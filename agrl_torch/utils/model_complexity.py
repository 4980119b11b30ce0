"""Model size for the startup line (counterpart of
agrl_tpu/utils/model_complexity.py:count_num_param).

FLOPs (agrl_tpu's `compute_model_complexity`, an XLA cost analysis) are
not ported yet; the CLI prints the parameter count alone.
"""

from __future__ import annotations

from torch import nn


def count_num_param(model: nn.Module, exclude_heads=("classifier",)) -> float:
    """Parameters in millions. The reference (torchtools.py:62-67) excludes
    ONLY a head attribute literally named `classifier`: vmgn (whose heads
    are global_/att_classifier) excludes nothing.

    `exclude_heads`: exact top-level module names, or prefixes ending in
    '_'. Counts what agrl_tpu counts over its params tree: every
    nn.Parameter (the BNNecks' frozen zero biases have no flax leaf, so
    they are left out), no buffers."""
    total = 0
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        if any(top.startswith(h) if h.endswith("_") else top == h for h in exclude_heads):
            continue
        if not p.requires_grad:
            continue
        total += p.numel()
    return total / 1e6
