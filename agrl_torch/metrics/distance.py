"""Pairwise distance matrices (host-side NumPy oracle).

A copy of agrl_tpu/metrics/distance.py (NumPy only). Parity with
reference torchreid/metrics/distance.py:11-89:
  * 'euclidean': SQUARED euclidean distance (||q||^2 + ||g||^2 - 2 q.g).
  * 'cosine': 1 - <q/||q||, g/||g||>.

The on-device equivalents live in agrl_torch.ops.distmat; this module is
the host-side oracle.
"""

from __future__ import annotations

import numpy as np


def euclidean_squared_distance(input1: np.ndarray, input2: np.ndarray) -> np.ndarray:
    input1 = np.asarray(input1, dtype=np.float64)
    input2 = np.asarray(input2, dtype=np.float64)
    sq1 = (input1**2).sum(axis=1, keepdims=True)  # (Q, 1)
    sq2 = (input2**2).sum(axis=1, keepdims=True).T  # (1, G)
    return sq1 + sq2 - 2.0 * input1 @ input2.T


def cosine_distance(input1: np.ndarray, input2: np.ndarray) -> np.ndarray:
    input1 = np.asarray(input1, dtype=np.float64)
    input2 = np.asarray(input2, dtype=np.float64)
    n1 = input1 / np.maximum(np.linalg.norm(input1, axis=1, keepdims=True), 1e-12)
    n2 = input2 / np.maximum(np.linalg.norm(input2, axis=1, keepdims=True), 1e-12)
    return 1.0 - n1 @ n2.T


def compute_distance_matrix(
    input1: np.ndarray, input2: np.ndarray, metric: str = "euclidean"
) -> np.ndarray:
    """(Q, D) x (G, D) -> (Q, G) distance matrix."""
    input1 = np.asarray(input1)
    input2 = np.asarray(input2)
    assert input1.ndim == 2 and input2.ndim == 2
    assert input1.shape[1] == input2.shape[1]
    if metric == "euclidean":
        return euclidean_squared_distance(input1, input2)
    if metric == "cosine":
        return cosine_distance(input1, input2)
    raise ValueError(f"Unknown distance metric: {metric}")
