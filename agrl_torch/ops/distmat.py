"""Q x G distance matrices (counterpart of agrl_tpu/ops/distmat.py).

Conventions match agrl_tpu.metrics.distance:
  * euclidean -> SQUARED distances
  * cosine    -> 1 - <q_hat, g_hat>
Both are one plain matrix product (torch.matmul). On the card, fp32
products run in full fp32 only with TF32 off, which the eval entry points
set (engine/evaluator.py). `sharded_distmat` splits the gallery axis over
a process group's ranks (agrl_tpu/ops/distmat.py:55-77).
"""

from __future__ import annotations

import torch


def euclidean_sq_distmat(qf: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
    """(Q, D), (G, D) -> (Q, G) squared euclidean distances."""
    q_sq = (qf * qf).sum(dim=1, keepdim=True)  # (Q, 1)
    g_sq = (gf * gf).sum(dim=1, keepdim=True).T  # (1, G)
    return q_sq + g_sq - 2.0 * torch.matmul(qf, gf.T)


def cosine_distmat(qf: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
    """(Q, D), (G, D) -> (Q, G) cosine distances (1 - cos)."""
    qn = qf / torch.clamp(torch.linalg.vector_norm(qf, dim=1, keepdim=True), min=1e-12)
    gn = gf / torch.clamp(torch.linalg.vector_norm(gf, dim=1, keepdim=True), min=1e-12)
    return 1.0 - torch.matmul(qn, gn.T)


def compute_distmat(qf, gf, metric: str = "euclidean") -> torch.Tensor:
    if metric == "euclidean":
        return euclidean_sq_distmat(qf, gf)
    if metric == "cosine":
        return cosine_distmat(qf, gf)
    raise ValueError(f"Unknown distance metric: {metric}")


def sharded_distmat(mesh, qf, gf, metric: str = "euclidean") -> torch.Tensor:
    """compute_distmat with the gallery axis split over the dp group of a
    process-group mesh (parallel.make_mesh): each dp rank computes the
    (Q, G / dp) stripe of its contiguous gallery rows (the gallery padded
    with zero rows to a multiple of dp, dropped after), and the stripes are
    gathered in order on every rank."""
    from agrl_torch.parallel import gather_rows

    G = gf.shape[0]
    pad = (-G) % mesh.dp
    if pad:
        gf = torch.cat([gf, gf.new_zeros((pad, gf.shape[1]))])
    k = gf.shape[0] // mesh.dp
    stripe = compute_distmat(qf, gf[mesh.dp_index * k:(mesh.dp_index + 1) * k], metric)
    return gather_rows(stripe.t(), mesh).t()[:, :G]
