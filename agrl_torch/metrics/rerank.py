"""k-reciprocal re-ranking (Zhong et al., CVPR 2017), host algorithm.

A copy of agrl_tpu/metrics/rerank.py (NumPy only); the Evaluator's host
path runs it, and agrl_torch.ops.rerank is held against it. Behavioral
parity with reference torchreid/utils/re_ranking.py:30-95 (the
standard public k-reciprocal algorithm): build the (Q+G) x (Q+G) distance,
expand each sample's k-reciprocal neighbor set with half-k reciprocal sets
that overlap by more than 2/3, soften membership with a Gaussian weight,
apply local query expansion over the k2 nearest neighbors, then blend the
Jaccard distance with the original distance:
    final = lambda * original + (1 - lambda) * jaccard.

Implementation notes: neighbor-set expansion is ragged so it runs as a
host-side loop over rows (O((Q+G) * k1^2), tiny); the Jaccard accumulation
uses sparse row structure like the public implementation.
"""

from __future__ import annotations

import numpy as np


def _k_reciprocal_set(rank: np.ndarray, i: int, k: int) -> np.ndarray:
    """Indices j s.t. j is in i's top-(k+1) AND i is in j's top-(k+1)."""
    fwd = rank[i, : k + 1]
    back = rank[fwd, : k + 1]
    return fwd[np.any(back == i, axis=1)]


def sparse_min_sum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Q, J) sums_c min(a[q, c], b[j, c]) of non-negative a (Q, C) and b
    (J, C) over the non-zero entries only, as the public implementation
    accumulates the Jaccard term: an inverted index of the rows that are
    non-zero in each column of b (ascending); each row q of a adds
    min(a[q, c], b[rows, c]) into those rows, over its non-zero columns c
    ascending, in fp32. agrl_torch.ops.minsum.min_sum_sparse keeps this
    order on the card."""
    rows, cols = np.nonzero(b)  # row-major: a stable sort by column keeps rows ascending
    order = np.argsort(cols, kind="stable")
    rows = rows[order]
    col_ptr = np.searchsorted(cols[order], np.arange(b.shape[1] + 1))
    out = np.zeros((a.shape[0], b.shape[0]), dtype=np.float32)
    for q in range(a.shape[0]):
        for c in np.flatnonzero(a[q]):
            r = rows[col_ptr[c]:col_ptr[c + 1]]
            out[q, r] += np.minimum(a[q, c], b[r, c])
    return out


def re_ranking(
    q_g_dist: np.ndarray,
    q_q_dist: np.ndarray,
    g_g_dist: np.ndarray,
    k1: int = 20,
    k2: int = 6,
    lambda_value: float = 0.3,
) -> np.ndarray:
    """Returns the re-ranked (Q, G) distance matrix."""
    num_q = q_g_dist.shape[0]
    top = np.hstack([q_q_dist, q_g_dist])
    bottom = np.hstack([q_g_dist.T, g_g_dist])
    dist = np.vstack([top, bottom]).astype(np.float32) ** 2
    # per-column max normalization, then transpose (matches public impl)
    dist = (dist / dist.max(axis=0)).T
    n = dist.shape[0]

    rank = np.argsort(dist, axis=1).astype(np.int32)
    half_k = int(np.around(k1 / 2))

    # soft k-reciprocal membership matrix
    member = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        rset = _k_reciprocal_set(rank, i, k1)
        expanded = [rset]
        for cand in rset:
            half = _k_reciprocal_set(rank, cand, half_k)
            if len(np.intersect1d(half, rset)) > (2.0 / 3.0) * len(half):
                expanded.append(half)
        idx = np.unique(np.concatenate(expanded))
        w = np.exp(-dist[i, idx])
        member[i, idx] = w / w.sum()

    # local query expansion: average membership over the k2 nearest neighbors
    if k2 != 1:
        member = np.stack([member[rank[i, :k2]].mean(axis=0) for i in range(n)])

    orig_qg = dist[:num_q]

    # Jaccard distance via sparse min-sum accumulation
    min_sum = sparse_min_sum(member[:num_q], member)
    jaccard = 1.0 - min_sum / (2.0 - min_sum)

    final = jaccard * (1.0 - lambda_value) + orig_qg * lambda_value
    return final[:, num_q:]
