"""Top-k classification accuracy over one or many heads (a copy of
agrl_tpu/metrics/accuracy.py; reference torchreid/metrics/accuracy.py:
9-33): a single (B, C) logits array or a list of per-head ones, and (B,)
integer labels, give a list (per head) of top-k precision FRACTIONS (the
reference multiplies by 1 / batch_size; its training script prints them
raw, e.g. 'Top1 0.1250'). NumPy on the host: tensors are read through
np.asarray.
"""

from __future__ import annotations

import numpy as np


def _single_head_accuracy(output: np.ndarray, target: np.ndarray, topk=(1,)):
    maxk = max(topk)
    # top-maxk predictions, ordered best-first
    pred = np.argsort(-output, axis=1)[:, :maxk]  # (B, maxk)
    correct = pred == target[:, None]
    batch_size = target.shape[0]
    res = []
    for k in topk:
        correct_k = correct[:, :k].any(axis=1).sum()
        res.append(correct_k * 1.0 / batch_size)
    return res


def accuracy(output, target, topk=(1,)):
    """`output`: (B, C) logits or list of them; `target`: (B,) int labels."""
    target = np.asarray(target)
    if isinstance(output, (list, tuple)):
        return [_single_head_accuracy(np.asarray(o), target, topk) for o in output]
    return [_single_head_accuracy(np.asarray(output), target, topk)]
