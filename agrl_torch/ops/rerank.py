"""k-reciprocal re-ranking on the distances' device (counterpart of
agrl_tpu/ops/rerank.py).

The public algorithm (reference torchreid/utils/re_ranking.py:30-95, and
agrl_torch.metrics.rerank, the host copy it is held against) is a chain
of ragged per-row set operations. Here every set is a boolean
membership matrix and the set algebra is dense products:

  * top-(k+1) neighbour sets         -> one stable sort of the distance
    rows; F[i, j] = "j is in i's top-(k+1)"
  * k-reciprocal sets                -> R = F & F.T
  * candidate-expansion overlap test -> |R(i) n Rh(c)| = (R @ Rh.T)[i, c]
  * union of accepted half-sets      -> (cond @ Rh) > 0
  * local query expansion            -> the mean of k2 gathered rows
  * Jaccard min-sum sum_c min(V[q,c], V[j,c])
                                     -> ops/minsum.py min_sum_sparse: V is
    ~99% zeros by construction, so on the card the hand-written sparse
    min-plus kernels (csrc/minsum_sparse.cu) do only the terms whose two
    operands are non-zero; its plain version on the CPU, chosen by the
    tensor's device

Ties: equal distances keep the lower index first (stable sort), the
order lax.top_k gives agrl_tpu, so both pick the same neighbour sets
even where features repeat.
"""

from __future__ import annotations

import torch

from agrl_torch.ops.distmat import compute_distmat
from agrl_torch.ops.minsum import min_sum_sparse
from agrl_torch.ops.rank import nearest

# Largest count bf16 holds exactly: integers up to 2^8.
_BF16_EXACT = 256


def _membership(idx: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Boolean (N, N): True where column j is among row i's k nearest.

    `idx` is one (N, kmax) neighbour table sorted by distance, so every
    smaller-k membership is a column slice of it; k clamps to N like the
    host path's `rank[i, :k]` slice does."""
    m = torch.zeros((n, n), dtype=torch.bool, device=idx.device)
    return m.scatter_(1, idx[:, : min(k, n)], True)


def _bool_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counts of a 0/1 product, as fp32. The operands are bf16, which
    holds 0 and 1 exactly; the result and any reduction cuBLAS keeps in
    bf16 stay exact because every count here, and every partial sum of
    its non-negative terms, is at most half_k + 1 <= 256 (see
    re_ranking_device), and bf16 holds the integers up to 256 exactly."""
    return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).float()


def original_dist(q_g_dist, q_q_dist, g_g_dist) -> torch.Tensor:
    """The (N, N) squared distance over queries then gallery, N = Q + G,
    divided by its column maxima and transposed, as the public
    implementation does; made contiguous once, since every later step
    reads rows."""
    top = torch.cat([q_q_dist, q_g_dist], dim=1)
    bottom = torch.cat([q_g_dist.T, g_g_dist], dim=1)
    dist = torch.cat([top, bottom], dim=0).float() ** 2
    return (dist / dist.amax(dim=0)).T.contiguous()


def expanded_membership(dist: torch.Tensor, k1: int = 20, k2: int = 6) -> torch.Tensor:
    """The (N, N) soft membership V of the public algorithm: Gaussian
    weights over each row's expanded k-reciprocal set, row-normalized,
    then averaged over the k2 nearest rows (local query expansion)."""
    n = dist.shape[0]
    half_k = int(round(k1 / 2))
    if half_k + 1 > _BF16_EXACT:
        raise ValueError(f"k1={k1}: the 0/1 counts (up to {half_k + 1}) must stay exact in bf16")

    # one sort serves all three neighbour sets (k1+1, half_k+1, k2): the
    # smaller sets are column slices
    kmax = min(max(k1 + 1, half_k + 1, k2), n)
    nn_idx = nearest(dist, kmax)

    # k-reciprocal membership at k1 and k1/2
    f_full = _membership(nn_idx, k1 + 1, n)
    r_full = f_full & f_full.T
    f_half = _membership(nn_idx, half_k + 1, n)
    r_half = f_half & f_half.T

    # candidate expansion: for each candidate c in R(i), adopt Rh(c) when
    # |Rh(c) n R(i)| > 2/3 |Rh(c)| (reference re_ranking.py:52-57), in
    # agrl_tpu's exact integer form 3 * overlap > 2 * |Rh(c)|.
    # Counts: overlap[i, c] <= |Rh(c)| <= half_k + 1, and
    # (cond @ Rh)[i, j] <= #{c : j in Rh(c)} = |Rh(j)| <= half_k + 1 (Rh is
    # symmetric), so both products stay exact in bf16 (_bool_matmul).
    overlap = _bool_matmul(r_full, r_half.T)  # (i, c) -> |R(i) n Rh(c)|
    rh_size = r_half.sum(dim=1).float()  # |Rh(c)|
    cond = r_full & (3.0 * overlap > 2.0 * rh_size[None, :])
    expanded = r_full | (_bool_matmul(cond, r_half) > 0)

    # soft membership: Gaussian weight over the expanded set, row-normalized
    w = torch.where(expanded, torch.exp(-dist), 0.0)
    v = w / w.sum(dim=1, keepdim=True)  # i in R(i) => row sum > 0

    # local query expansion: k2 row gathers (k2 N^2 reads), not an (N, N)
    # indicator product (N^3)
    if k2 != 1:
        k2 = min(k2, n)
        v = sum(v[nn_idx[:, k]] for k in range(k2)) / k2
    return v


def re_ranking_device(q_g_dist, q_q_dist, g_g_dist, k1: int = 20, k2: int = 6,
                      lambda_value: float = 0.3) -> torch.Tensor:
    """(Q, G), (Q, Q), (G, G) distances -> the re-ranked (Q, G) distance,
    on their device. On the card the Jaccard term is one min_sum_sparse
    call: v is sparse by construction (expanded_membership)."""
    num_q = q_g_dist.shape[0]
    dist = original_dist(q_g_dist, q_q_dist, g_g_dist)
    v = expanded_membership(dist, k1, k2)
    ms = min_sum_sparse(v[:num_q], v)  # (Q, N)
    jaccard = 1.0 - ms / (2.0 - ms)
    final = jaccard * (1.0 - lambda_value) + dist[:num_q] * lambda_value
    return final[:, num_q:].contiguous()


def re_ranking_from_features(qf, gf, metric: str = "euclidean", k1: int = 20, k2: int = 6,
                             lambda_value: float = 0.3) -> torch.Tensor:
    """Re-ranking straight from feature matrices (no host matrix): the
    three distance blocks on the features' device (squared euclidean or
    1 - cos, as the Evaluator's host path feeds the host algorithm), then
    re_ranking_device."""
    q_g = compute_distmat(qf, gf, metric)
    q_q = compute_distmat(qf, qf, metric)
    g_g = compute_distmat(gf, gf, metric)
    return re_ranking_device(q_g, q_q, g_g, k1=k1, k2=k2, lambda_value=lambda_value)
